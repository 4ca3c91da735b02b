"""The benchmark's frozen generators give the port's generators' arrays,
bit for bit, at three seeds."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from portbench import generators
from portbench.tests.conftest import ROOT
from tahoe_tpu_torch.forest import synthetic

SEEDS = (0, 7, 2**31 + 3)


def config(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def assert_same_forest(ours: dict, spec) -> None:
    theirs = dataclasses.asdict(spec)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        if isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), k
        elif isinstance(v, float) and np.isnan(v):
            assert np.isnan(ours[k])
        else:
            assert ours[k] == v, k


@pytest.mark.parametrize("seed", SEEDS)
def test_susy_forest_is_the_ports(seed):
    assert_same_forest(generators.forest_of(config("susy"), seed),
                       synthetic.generate_forest(500, 8, 18, seed=seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_cup98_forest_is_the_ports(seed):
    assert_same_forest(generators.forest_of(config("cup98"), seed),
                       synthetic.generate_forest(150, 8, 479, active_cols=300, seed=seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_forest_with_early_leaves_and_transform_is_the_ports(seed):
    kw = dict(leaf_prob=0.1, output=0x11, global_bias=0.25, threshold=0.3,
              missing=-999.0)
    assert_same_forest(generators.generate_forest(40, 7, 30, seed=seed, **kw),
                       synthetic.generate_forest(40, 7, 30, seed=seed, **kw))


@pytest.mark.parametrize("seed", SEEDS)
def test_susy_rows_are_the_ports(seed):
    ours = generators.rows_of(config("susy"), 5000, seed)
    theirs = synthetic.generate_data(5000, 18, missing_prob=0.02, seed=seed)
    assert ours.dtype == theirs.dtype
    assert np.array_equal(ours, theirs, equal_nan=True)
    assert np.isnan(ours).any()


@pytest.mark.parametrize("seed", SEEDS)
def test_cup98_rows_are_the_ports(seed):
    ours = generators.rows_of(config("cup98"), 300, seed)
    assert np.array_equal(ours, synthetic.generate_data(300, 479, seed=seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_rows_with_a_finite_sentinel_are_the_ports(seed):
    ours = generators.generate_data(400, 12, missing=-999.0, missing_prob=0.1, seed=seed)
    theirs = synthetic.generate_data(400, 12, missing=-999.0, missing_prob=0.1, seed=seed)
    assert np.array_equal(ours, theirs)
