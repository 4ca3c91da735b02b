"""The port's native text loader (tahoe_tpu_torch/forest/native_io.py) held
bit for bit to the port's numpy parser, the format of record, and to the
JAX package's native loader, on generated model and data files with NaN
and finite-sentinel missing values; and its errors."""
import dataclasses

import numpy as np
import pytest

from tahoe_tpu.forest import native_io as jax_native_io
from tahoe_tpu.forest import synthetic as jax_synthetic
from tahoe_tpu_torch.forest import io, native_io, synthetic
from tahoe_tpu_torch.forest.spec import SPEC_FIELDS

needs_jax_native = pytest.mark.skipif(not jax_native_io.available(),
                                      reason="the JAX package's libtahoe_io.so is not built")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype != bool else a


def test_the_loader_builds_here():
    """g++ is present: the library builds, and says nothing is wrong."""
    assert native_io.available(), native_io.build_error()
    assert native_io.build_error() is None
    assert native_io.library_path().exists()


@pytest.mark.parametrize("leaf_prob,output,missing", [
    (0.0, 0, float("nan")), (0.2, 0x111, -999.0)])
def test_model_bit_equal_to_the_numpy_parser(tmp_path, leaf_prob, output, missing):
    spec = synthetic.generate_forest(23, 5, 11, leaf_prob=leaf_prob, seed=31)
    path = str(tmp_path / "model.txt")
    io.save_model(path, spec)
    kw = dict(output=output, global_bias=0.5, threshold=0.25, missing=missing,
              num_cols=11)
    want = io.load_model(path, **kw)
    got = native_io.load_spec(path, **kw)
    for name in SPEC_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), name
        else:
            assert a == b or (a != a and b != b), name
    nt, depth, table = native_io.load_model(path)
    assert (nt, depth, table.shape) == (23, 5, (23 * 63, 5))


@pytest.mark.parametrize("missing,sentinel", [(float("nan"), float("nan")),
                                              (-999.0, -999.0)])
def test_data_bit_equal_to_the_numpy_parser(tmp_path, missing, sentinel):
    """Rows with missing values as NaN, and as a finite sentinel written in
    place of them; extreme magnitudes and denormals too."""
    rows = synthetic.generate_data(300, 9, missing_prob=0.15, seed=32)
    if not np.isnan(sentinel):
        rows = np.where(np.isnan(rows), np.float32(sentinel), rows)
    rows[0, :4] = [1e-42, -3.4e38, 3.4e38, -0.0]
    path = str(tmp_path / "data.txt")
    io.save_data(path, rows, missing)
    want, want_missing = io.load_data(path)
    got, got_missing = native_io.load_data(path)
    assert got.dtype == np.float32 and got.shape == (300, 9)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert got_missing == want_missing or (np.isnan(got_missing) and np.isnan(want_missing))


@needs_jax_native
def test_agrees_with_the_jax_native_loader(tmp_path):
    jf = jax_synthetic.generate_forest(17, 4, 9, leaf_prob=0.2, seed=3)
    from tahoe_tpu.forest import io as jax_io

    mp, dp = str(tmp_path / "model.txt"), str(tmp_path / "data.txt")
    jax_io.save_model(mp, jf)
    jax_io.save_data(dp, jax_synthetic.generate_data(64, 9, missing_prob=0.1, seed=4),
                     missing=-7.5)
    nt, depth, table = native_io.load_model(mp)
    jnt, jdepth, jtable = jax_native_io.load_model(mp)
    assert (nt, depth) == (jnt, jdepth)
    assert np.array_equal(table.view(np.int64), jtable.view(np.int64))
    rows, miss = native_io.load_data(dp)
    jrows, jmiss = jax_native_io.load_data(dp)
    assert miss == jmiss == -7.5
    assert np.array_equal(rows.view(np.int32), jrows.view(np.int32))
    assert dataclasses.asdict(jf)["num_cols"] == 9


def test_malformed_files_raise(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("10\n9\n1\n2.5\n")  # the header promises far more nodes
    with pytest.raises(IOError, match="truncated or malformed"):
        native_io.load_model(str(bad))
    bad.write_text("4\n2\nnan\n1.0\n2.0\nnot-a-number\n")
    with pytest.raises(IOError, match="truncated or malformed"):
        native_io.load_data(str(bad))
    bad.write_text("")
    with pytest.raises(IOError, match="cannot read"):
        native_io.load_data(str(bad))
    with pytest.raises(IOError, match="cannot read"):
        native_io.load_model(str(tmp_path / "missing.txt"))


def test_a_failed_build_is_reported(monkeypatch, tmp_path):
    """No compiler: available() is False, build_error() says why, and the
    loaders raise with that reason rather than return None."""
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_error", None)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_io.shutil, "which", lambda name: None)
    assert not native_io.available()
    assert "no host C++ compiler" in native_io.build_error()
    with pytest.raises(RuntimeError, match="not available: .*no host C\\+\\+ compiler"):
        native_io.load_data(str(tmp_path / "d.txt"))
