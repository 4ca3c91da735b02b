"""The port's performance model on the CPU: it prices exactly the
strategies the port's feasibility admits, its picks match the winners
measured on the H100, and its host term follows the launches a path issues.

The pins are measured facts (PERF.md, chip_smoke.py and the sweep on an
H100 80GB HBM3 at 700 W), not the JAX model's v5e winners
(tests/test_perf_model.py): on the H100 SPLIT_FOREST beats RANK_MXU on
SUSY-class, where the v5e preferred RANK_MXU."""
import dataclasses

import pytest

from tahoe_tpu_torch import Forest, GpuLimits, Output, Strategy
from tahoe_tpu_torch.forest import synthetic
from tahoe_tpu_torch.forest.train import train_forest
from tahoe_tpu_torch.ops.fold_kernel import fold_leveled, fold_plan, row_width
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
# a set where the two run one launch. svhn: VMEM_FOREST 0.0731 ms against
# SPLIT_FOREST 0.0807 in three sweeps (0.06895 against 0.07638 device ms,
# scripts/pair_time.py)
PINS = [
    ("susy_like", {Strategy.SPLIT_FOREST}),
    ("cup98_like", {Strategy.SPLIT_FOREST}),
    ("trained_mix_like", {Strategy.RANK_MXU}),
    ("stumps_like", {Strategy.SPLIT_FOREST, Strategy.VMEM_FOREST}),
    ("svhn_like", {Strategy.VMEM_FOREST}),
]


@pytest.mark.parametrize("name,want", PINS)
def test_predicts_measured_best(name, want):
    spec = family_spec(shape_by_name(name))
    best, costs = model.choose_strategy(spec, ROWS, Calibration.default())
    assert best in want, {s.name: (c.total if c else None)
                          for s, c in costs.items()}


def test_registers_bound_the_blocks_an_sm_holds():
    """65,536 registers an SM, granted a warp at a time in units of 256:
    256-thread blocks at 128 registers fit two, at 136 one; every kernel
    instance the model prices on the sweep's families has its count."""
    limits = GpuLimits()
    assert model.blocks_per_sm(1024, 256, limits, 128) == 2
    assert model.blocks_per_sm(1024, 256, limits, 136) == 1
    assert model.blocks_per_sm(1024, 256, limits, 32) == model.SM_THREADS // 256
    for name in FEASIBILITY_FAMILIES + ["svhn_like", "deep12_like"]:
        spec = family_spec(shape_by_name(name))
        lev, _, form = fold_leveled(spec)
        for whole in (False, True):
            plan = fold_plan(form, row_width(form, lev.num_cols), lev.depth,
                             spec.num_trees, limits, whole_forest=whole)
            if plan is not None:
                assert model.register_query(form, plan) in model.KERNEL_REGISTERS
    for groups in (1, 2, 16):
        assert model.rank_register_query(groups) in model.KERNEL_REGISTERS
        assert model.sparse_register_query(groups) in model.KERNEL_REGISTERS


def test_kernel_c_batched_and_tiled_as_measured():
    """svhn-class at 65,536 rows (PERF.md section 6): VMEM_FOREST's
    one block an SM batches its block loads, at the batched floor;
    SPLIT_FOREST's two blocks an SM wait on 19 tiles each in their wave."""
    spec = family_spec(shape_by_name("svhn_like"))
    lev, _, form = fold_leveled(spec)
    w = row_width(form, lev.num_cols)
    vmem = fold_plan(form, w, lev.depth, spec.num_trees, GpuLimits(),
                     whole_forest=True)
    split = fold_plan(form, w, lev.depth, spec.num_trees, GpuLimits())
    assert model.fold_batches(vmem.smem_bytes)
    assert not model.fold_batches(split.smem_bytes)
    cal = Calibration.default()
    assert cal.fold_c_batch_floor_ns < cal.fold_c_floor_ns
    costs = {s: model.predict_cost(s, spec, ROWS, cal)
             for s in (Strategy.VMEM_FOREST, Strategy.SPLIT_FOREST)}
    assert (costs[Strategy.VMEM_FOREST].device_s
            < 0.95 * costs[Strategy.SPLIT_FOREST].device_s)


def test_more_launches_raise_the_host_term():
    """A call is one graph replay: each node (a launch or an op) adds to the
    host's issue of it, and each op also to the card's time."""
    cal = Calibration.default()
    assert cal.node_us > 0 and cal.op_device_us > 0
    mix = family_spec(shape_by_name("trained_mix_like"))
    rank = model.predict_cost(Strategy.RANK_MXU, mix, ROWS, cal)
    bucketed = model.predict_cost(Strategy.DEPTH_BUCKETED, mix, ROWS, cal)
    # kernel A, then kernel B a bucket (4), and the buckets' sum
    assert bucketed.launches > rank.launches
    assert bucketed.host_s > rank.host_s
    susy = synthetic.susy_class_forest(seed=0)
    # the tensor engine holds a depth-long chain a row chunk
    one, many = (model.predict_cost(Strategy.TENSOR, susy, r, cal)
                 for r in (64, ROWS))
    assert many.launches > 100 * one.launches and many.host_s > one.host_s
    assert many.device_s > 100 * one.device_s
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


def test_a_call_is_priced_as_one_graph_replay():
    """The host issues one graphed call: the calibrated call of the
    shortest kernel path (its CALL_NODES nodes), and each node past them."""
    cal = Calibration.default()
    susy = synthetic.susy_class_forest(seed=0)
    split = model.predict_cost(Strategy.SPLIT_FOREST, susy, ROWS, cal)
    assert split.launches == model.CALL_NODES  # dual rows: two ops, kernel C
    assert split.host_s == pytest.approx(cal.call_us * 1e-6)
    for s in Strategy:
        c = model.predict_cost(s, susy, ROWS, cal)
        if c is not None:
            assert c.host_s == pytest.approx(
                (cal.call_us + max(0, c.launches - model.CALL_NODES) * cal.node_us)
                * 1e-6), s


# VMEM_FOREST against SPLIT_FOREST at the sweep's rows, by device time
# (scripts/pair_time.py, 7 interleaved rounds, H100 80GB HBM3, 700.00 W,
# PERF.md section 5): mnist 0.02059 against 0.02364 ms, cifar 0.02158
# against 0.03571; the event pairs of the sweep's eager calls had read the
# pair the other way round (fault 4)
SWEEP_PAIRS = [("mnist_like", 2000), ("cifar_like", 3000)]


@pytest.mark.parametrize("name,rows", SWEEP_PAIRS)
def test_vmem_forest_at_the_sweep_rows_as_measured(name, rows):
    """mnist's pick, pinned: at these rows one block an SM binds, and
    VMEM_FOREST's 64-row blocks (two warps) step their chains faster than
    SPLIT_FOREST's blocks of 128 or 256 rows (fold_c_warp_ns), which also
    wait on 22- or 45-tree tiles."""
    spec = family_spec(shape_by_name(name))
    cal = Calibration.default()
    best, costs = model.choose_strategy(spec, rows, cal)
    assert best == Strategy.VMEM_FOREST, {
        s.name: (c.total if c else None) for s, c in costs.items()}
    assert (costs[Strategy.VMEM_FOREST].device_s
            < 0.95 * costs[Strategy.SPLIT_FOREST].device_s)


def test_wide_rows_cost_a_block_its_staging():
    """Kernel C's least time pays for the rows a block stages: where one
    block an SM binds, staging adds to a wave as it is."""
    cal = Calibration.default()
    assert cal.fold_c_stage_ns > 0
    limits = GpuLimits()
    base, staged = (model._descent_s(
        cal.fold_c_ns, cal.fold_c_row_ns, cal.fold_c_batch_floor_ns,
        cal.fold_c_batch_floor_us, limits.sm_count * 64, 600, 64, 1, limits,
        stage_us=us) for us in (0.0, 3.0))
    assert staged - base == pytest.approx(3e-6)


def test_measure_needs_a_card():
    from tahoe_tpu_torch.perf_model import calibrate

    with pytest.raises((RuntimeError, ValueError)):
        calibrate.measure("cpu")
