"""The port's CLI on the CPU: tests/test_cli_smoke.py's fixture through both
CLIs, the same verdicts, and the output contract in its order
(tahoe_tpu/cli.py:48-124)."""
import re

import pytest

from tahoe_tpu import cli as jax_cli
from tahoe_tpu.forest import io, synthetic
from tahoe_tpu_torch import cli

VERDICT = re.compile(r"^Using the #\d strategy \((\w+)\): .*results are correct")


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    forest = synthetic.generate_forest(12, 4, 8, leaf_prob=0.1, seed=161)
    data = synthetic.generate_data(60, 8, missing_prob=0.1, seed=162)
    mp, dp = str(tmp / "model.txt"), str(tmp / "data.txt")
    io.save_model(mp, forest)
    io.save_data(dp, data, missing=float("nan"))
    return mp, dp


def _correct(out: str) -> set:
    return {m.group(1) for line in out.splitlines()
            if (m := VERDICT.match(line))}


def test_cli_protocol_matches_jax(fixture_files, capsys):
    mp, dp = fixture_files
    common = ["--no-calibrate", "--epochs", "2", "--warmup", "1"]
    assert jax_cli.main([mp, dp, "--no-isolation", *common]) == 0
    want = capsys.readouterr().out
    report = {}
    assert cli.main([mp, dp, "--device", "cpu", *common], report=report) == 0
    got = capsys.readouterr().out
    assert _correct(got) == _correct(want)
    assert _correct(got)
    lines = got.splitlines()
    best = re.search(r"^Best strategy: #\d (\w+) at ", got, re.M).group(1)
    # both CLIs print the speedup over the gather tier only where another
    # strategy beat it (tahoe_tpu/cli.py:118-122); on the CPU the plain
    # torch gather tier is at times the measured best
    gather_tier = r"^\(.*x over the naive direct-HBM gather tier"
    contract = [r"^Model: .* , Data: ", r"^Loaded forest: 12 trees, depth 4, ",
                r"^Calibration: ", r"^Performance model chooses #\d strategy \(\w+\)\.$",
                *[rf"^Using the #{n} strategy " for n in range(1, 9)],
                r"^Performance model predicts (correctly|incorrectly)",
                *([gather_tier] if best != "HBM_DIRECT" else []),
                r"^Best strategy: #\d \w+ at "]
    if best == "HBM_DIRECT":
        assert not any(re.match(gather_tier, line) for line in lines), got
    at = 0
    for pattern in contract:
        while at < len(lines) and not re.match(pattern, lines[at]):
            at += 1
        assert at < len(lines), f"no line {pattern!r} in order:\n{got}"
        at += 1
    # the model prices only what runs
    assert report["results"][report["predicted"]].ran


def test_cli_subset_and_exit_code(fixture_files, capsys, monkeypatch):
    """--strategies limits the enumeration; with no correct strategy the
    CLI exits 1, as the JAX CLI does."""
    mp, dp = fixture_files
    args = [mp, dp, "--device", "cpu", "--no-calibrate", "--epochs", "1",
            "--warmup", "0", "--strategies", "HBM_DIRECT", "SPLIT_FOREST"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert _correct(out) == {"HBM_DIRECT", "SPLIT_FOREST"}
    assert "Using the #6 strategy" not in out

    from tahoe_tpu_torch.ops.gather_engine import GatherEngine
    from tahoe_tpu_torch.ops.fold_kernel import FoldKernelEngine

    for engine in (GatherEngine, FoldKernelEngine):
        monkeypatch.setattr(engine, "predict",
                            lambda self, rows: self.margins(rows) + 1.0)
    assert cli.main(args) == 1
    out = capsys.readouterr().out
    assert "results are INCORRECT" in out
    assert "No strategy produced correct results" in out


def test_cli_cuda_without_a_card(fixture_files):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    mp, dp = fixture_files
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main([mp, dp, "--device", "cuda", "--no-calibrate"])
