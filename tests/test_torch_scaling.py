"""The port's scaling model (tahoe_tpu_torch/perf_model/scaling.py): the
data axis is free, tree sharding pays one all-reduce of 4 bytes a row and
a collective's issue, and a ring across nodes is slower than NVLink."""
import pytest

from tahoe_tpu_torch.forest import synthetic
from tahoe_tpu_torch.perf_model import scaling

ROWS = 65536


@pytest.fixture(scope="module")
def susy():
    return synthetic.susy_class_forest(seed=0)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_the_data_axis_scales_at_one(susy, n):
    p = scaling.predict_scaling(susy, ROWS, n_data=n)
    assert p.efficiency == 1.0 and p.psum_bytes == 0 and p.psum_s == 0.0
    assert p.total_s == pytest.approx(p.compute_s)


def test_efficiency_falls_in_n_model(susy):
    effs = [scaling.predict_scaling(susy, ROWS, n_model=n).efficiency
            for n in (1, 2, 4, 8)]
    assert effs[0] == 1.0
    assert all(a > b for a, b in zip(effs, effs[1:])), effs
    # the data axis does not change a (., n_model) mesh's efficiency
    assert (scaling.predict_scaling(susy, ROWS, n_data=2, n_model=2).efficiency
            == pytest.approx(effs[1]))


@pytest.mark.parametrize("rows", [1000, 16384, ROWS])
def test_the_all_reduce_moves_4_bytes_a_row(susy, rows):
    p = scaling.predict_scaling(susy, rows, n_model=2)
    assert p.psum_bytes == 4 * rows
    # two shards: a ring step of half the bytes each way, and one hop
    assert p.psum_s == pytest.approx(rows * 4 / (scaling.NVLINK_GBPS * 1e9)
                                     + scaling.NVLINK_HOP_LATENCY_S)


def test_across_nodes_is_slower_than_nvlink(susy):
    nv = scaling.predict_scaling(susy, ROWS, n_model=4)
    ib = scaling.predict_scaling(susy, ROWS, n_model=4, cross_host=True)
    assert ib.psum_s > nv.psum_s
    assert ib.efficiency <= nv.efficiency
    assert scaling.INFINIBAND_GBPS < scaling.NVLINK_GBPS
    slow = scaling.predict_scaling(susy, ROWS, n_model=4, link_gbps=10.0)
    assert slow.psum_s > nv.psum_s and slow.efficiency <= nv.efficiency


def test_the_collective_is_issued_by_the_host(susy):
    one = scaling.predict_scaling(susy, ROWS)
    two = scaling.predict_scaling(susy, ROWS, n_model=2)
    free = scaling.predict_scaling(susy, ROWS, n_model=2, collective_us=0.0)
    assert two.host_s == pytest.approx(free.host_s + scaling.COLLECTIVE_ISSUE_US * 1e-6)
    assert two.host_s > one.host_s
    assert "NVLink" in two.explain() and "eff=" in two.explain()
