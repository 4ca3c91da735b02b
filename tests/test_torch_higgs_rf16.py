"""The cuML-default HIGGS forest (portbench/configs/higgs_rf16.json) on the
port's deep route, at its published widths: 100 complete trees of depth 16
over 28 columns, AVG out.

``fold_plan`` sends it to the deep kernel, whose tables pass the H100's
L2; ``Forest.predict`` under ``SPLIT_FOREST`` is held to the benchmark's
plain reference (portbench/reference.py). On the CPU the engine runs the
deep kernel's plain version on a few rows; the ``cuda`` case runs the
kernel on a batch of the benchmark's size under the program's own pick,
on the rows where they lie (ops/graphed.py's in-place route).
The file imports no JAX, so the card case also runs where there is none:

    python -m pytest --noconftest -q -m cuda tests/test_torch_higgs_rf16.py
"""
import json
from pathlib import Path

import pytest
import torch

from portbench import drive, reference
from portbench.generators import forest_of, rows_of
from tahoe_tpu_torch import Forest, GpuLimits, Strategy
from tahoe_tpu_torch.forest.spec import from_arrays
from tahoe_tpu_torch.ops import graphed
from tahoe_tpu_torch.ops.fold_kernel import (
    DeepLaunch,
    deep_block_walk,
    fold_plan,
    fold_table_bytes,
    row_width,
)
from tahoe_tpu_torch.ops.transform import apply_output_transform
from tahoe_tpu_torch.perf_model.model import choose_strategy

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                     / "higgs_rf16.json").read_text())
# both sides compare the same f32 values with the same thresholds, so each
# row reaches the same 100 leaves; the port sums them in f32 and divides
# by 100, the reference sums them in f64: only the f32 sum's rounding,
# a few 1e-8 on values within [-1, 1), differs
CPU_ATOL = 1e-6
BATCH_ROWS = 65536


@pytest.fixture(scope="module")
def forest():
    return forest_of(CONFIG, [7, drive.FOREST_STREAM])


@pytest.fixture(scope="module")
def cpu_prog(forest):
    return Forest(from_arrays(forest), device="cpu")


def test_the_published_widths():
    assert (CONFIG["trees"], CONFIG["depth"], CONFIG["num_cols"]) == (100, 16, 28)
    assert CONFIG["output"] == "AVG" and CONFIG["leaf_prob"] == 0.0
    assert CONFIG["reduced"] == []


def test_the_plan_is_the_deep_kernel_past_the_l2():
    limits = GpuLimits()
    plan = fold_plan("dual", row_width("dual", 28), 16, 100, limits)
    assert isinstance(plan, DeepLaunch)
    assert (plan.rows_per_block, plan.lanes) == (256, 1)
    assert fold_table_bytes(100, 16) == 113_594_400
    assert fold_table_bytes(100, 16) > limits.l2_bytes


@pytest.mark.parametrize("seed, rows", [(1, 16), (2**31 + 11, 64)])
def test_split_forest_matches_the_reference_on_the_cpu(forest, cpu_prog, seed,
                                                      rows):
    eng = cpu_prog.engine(Strategy.SPLIT_FOREST)
    assert isinstance(eng.launch, DeepLaunch) and eng.form == "dual"
    x = torch.from_numpy(rows_of(CONFIG, rows, [seed, drive.ROWS_STREAM]))
    got = cpu_prog.predict(x, Strategy.SPLIT_FOREST)
    want, visits = reference.predict(forest, x)
    assert got.dtype == torch.float32 and got.shape == (rows,)
    assert torch.all(visits == 100 * 16)  # complete trees
    assert torch.max(torch.abs(got.double() - want)).item() <= CPU_ATOL


@pytest.mark.cuda
def test_the_pick_matches_the_reference_on_the_card(forest):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    spec = from_arrays(forest)
    strategy, _ = choose_strategy(spec, BATCH_ROWS)
    prog = Forest(spec, device=dev)
    x = torch.from_numpy(rows_of(CONFIG, BATCH_ROWS, [3, drive.ROWS_STREAM])).to(dev)
    # the pick's engine reads the rows in place: each call one direct
    # launch of the deep kernel, no graph captured, nothing staged
    eng = prog.engine(strategy)
    assert eng._predict.in_place is not None
    prog.predict(x, strategy)
    before = graphed.counters()
    got = prog.predict(x, strategy)
    after = graphed.counters()
    assert after["direct_calls"] - before["direct_calls"] == 1
    assert after["captures"] == before["captures"]
    assert after["staged_bytes"] == before["staged_bytes"]
    assert eng._predict.graphs == {}
    want, _ = reference.predict(forest, x)
    gap = drive.max_gap(got.cpu().numpy(), want.cpu().numpy())
    assert gap <= CONFIG["max_abs_gap"], (strategy.name, gap)
    # the deep kernel reads its heap-ordered tables: the predictions are the
    # walk's leaves summed in tree order, AVG out, bit for bit
    assert eng.heap is not None and eng.tables.leaf is eng.heap.leaf
    walk = deep_block_walk(eng.canonicalize(x), eng.tables, eng.heap)
    assert torch.equal(got, apply_output_transform(walk, eng.num_trees, eng.output,
                                                   eng.global_bias, eng.threshold))
