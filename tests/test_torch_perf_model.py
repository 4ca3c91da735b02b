"""The port's performance model on the CPU: it prices exactly the
strategies the port's feasibility admits, its picks match the winners
measured on the H100, and its host term follows the launches a path issues.

The pins are measured facts (PERF.md, chip_smoke.py and the sweep on an
H100 80GB HBM3 at 700 W), not the JAX model's v5e winners
(tests/test_perf_model.py): on the H100 SPLIT_FOREST beats RANK_MXU on
SUSY-class, where the v5e preferred RANK_MXU."""
import dataclasses

import pytest

from tahoe_tpu_torch import Forest, Output, Strategy
from tahoe_tpu_torch.forest import synthetic
from tahoe_tpu_torch.forest.train import train_forest
from tahoe_tpu_torch.perf_model import model
from tahoe_tpu_torch.perf_model.calibrate import Calibration
from tahoe_tpu_torch.scripts.run_sweep import family_spec, shape_by_name

# tests/test_torch_forest.py's SWEEP_SHAPES families
FEASIBILITY_FAMILIES = ["susy_like", "allstate_like", "cup98_like",
                        "gisette_like", "mnist_like", "deep13_like",
                        "deep15_like", "stumps_like"]
ROWS = 65536


@pytest.mark.parametrize("name", FEASIBILITY_FAMILIES)
def test_cost_is_none_exactly_where_feasibility_refuses(name):
    spec = family_spec(shape_by_name(name))
    f = Forest(spec, device="cpu")
    cal = Calibration.default()
    for s in Strategy:
        cost = model.predict_cost(s, spec, ROWS, cal)
        assert (cost is None) == (f.feasible(s) is not None), s
        if cost is not None:
            assert cost.total > 0 and cost.device_s > 0 and cost.launches > 0


def test_sparse_over_the_gather_tier_on_a_deep_trained_forest():
    """rf_deep18-class at a few trees: the model prices exactly what the
    port's feasibility admits, and of the two strategies the full family
    admits (SPARSE and the HBM_DIRECT gather tier: every dense table of 200
    depth-18 trees passes the caps) it prices SPARSE lower, as measured
    (PERF.md section 5)."""
    spec = train_forest(3, 18, 24, rows=2048, seed=1)
    f = Forest(spec, device="cpu")
    cal = Calibration.default()
    costs = {s: model.predict_cost(s, spec, ROWS, cal) for s in Strategy}
    for s, c in costs.items():
        assert (c is None) == (f.feasible(s) is not None), s
    assert costs[Strategy.SPARSE].total < costs[Strategy.HBM_DIRECT].total


# measured on the H100 at 65,536 rows: (family, faster, slower), PERF.md
# section 5
ORDERS = [
    ("susy_like", Strategy.SPLIT_FOREST, Strategy.RANK_MXU),  # 0.003557, 0.004997
    ("trained_mix_like", Strategy.RANK_MXU, Strategy.DEPTH_BUCKETED),  # 0.004823, 0.005542
]


@pytest.mark.parametrize("name,faster,slower", ORDERS)
def test_orders_measured_pairs(name, faster, slower):
    spec = family_spec(shape_by_name(name))
    cal = Calibration.default()
    assert (model.predict_cost(faster, spec, ROWS, cal).total
            < model.predict_cost(slower, spec, ROWS, cal).total)


# measured winners on the H100 at 65,536 rows, every kernel strategy
# enumerated (PERF.md section 6: run_sweep on make_fixtures' pairs);
# a set where the two run one launch. svhn is not pinned: VMEM_FOREST ran
# 10% ahead of SPLIT_FOREST there, and the model prices it the other way
PINS = [
    ("susy_like", {Strategy.SPLIT_FOREST}),
    ("cup98_like", {Strategy.SPLIT_FOREST}),
    ("trained_mix_like", {Strategy.RANK_MXU}),
    ("stumps_like", {Strategy.SPLIT_FOREST, Strategy.VMEM_FOREST}),
]


@pytest.mark.parametrize("name,want", PINS)
def test_predicts_measured_best(name, want):
    spec = family_spec(shape_by_name(name))
    best, costs = model.choose_strategy(spec, ROWS, Calibration.default())
    assert best in want, {s.name: (c.total if c else None)
                          for s, c in costs.items()}


def test_more_launches_raise_the_host_term():
    cal = Calibration.default()
    mix = family_spec(shape_by_name("trained_mix_like"))
    rank = model.predict_cost(Strategy.RANK_MXU, mix, ROWS, cal)
    bucketed = model.predict_cost(Strategy.DEPTH_BUCKETED, mix, ROWS, cal)
    # kernel A, then kernel B a bucket (4), and the buckets' sum
    assert bucketed.launches > rank.launches
    assert bucketed.host_s > rank.host_s
    susy = synthetic.susy_class_forest(seed=0)
    # the tensor engine issues a depth-long chain a row chunk
    one, many = (model.predict_cost(Strategy.TENSOR, susy, r, cal)
                 for r in (64, ROWS))
    assert many.launches > 100 * one.launches and many.host_s > 100 * one.host_s
    # a finite sentinel and an output transform cost ops of their own
    edge = dataclasses.replace(
        susy, missing=-999.0,
        output=int(Output.AVG | Output.SIGMOID | Output.THRESHOLD))
    for s in (Strategy.SPLIT_FOREST, Strategy.RANK_MXU, Strategy.HBM_DIRECT):
        plain, more = (model.predict_cost(s, f, ROWS, cal) for f in (susy, edge))
        assert more.launches > plain.launches and more.host_s > plain.host_s, s
    # host time, not device time, decides a host-bound call
    c = model.predict_cost(Strategy.ROW_TILED, susy, ROWS, cal)
    assert c.total == pytest.approx(max(c.device_s, c.host_s) + c.latency_s)


def test_measure_needs_a_card():
    from tahoe_tpu_torch.perf_model import calibrate

    with pytest.raises((RuntimeError, ValueError)):
        calibrate.measure("cpu")
