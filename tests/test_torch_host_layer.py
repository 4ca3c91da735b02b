"""The port's own numpy host layer against the JAX package's, bit for bit.

``tahoe_tpu_torch`` imports nothing of ``tahoe_tpu``: it keeps a copy of the
numpy host layer (config enums, forest spec, compiler passes, rank
quantization, text IO, synthetic generators, training, the CSR form and the
oracle). Each copy is held here to its original on sweep-shaped forests
(scripts/run_sweep.py SHAPES, fewer trees) made from numpy seeds: the same
seed through both generators, then every pass on both sides, compared array
for array, dtype included.
"""
import dataclasses
import enum

import numpy as np
import pytest

from tahoe_tpu import config as jax_config
from tahoe_tpu.forest import compiler as jax_compiler
from tahoe_tpu.forest import io as jax_io
from tahoe_tpu.forest import quantize as jax_quantize
from tahoe_tpu.forest import sparse as jax_sparse
from tahoe_tpu.forest import synthetic as jax_synthetic
from tahoe_tpu.forest import train as jax_train
from tahoe_tpu.forest.spec import ForestSpec as JaxForestSpec
from tahoe_tpu.ops import oracle as jax_oracle
from tahoe_tpu_torch import config
from tahoe_tpu_torch.forest import compiler, io, quantize, sparse, synthetic, train
from tahoe_tpu_torch.forest.spec import ForestSpec, from_arrays, to_arrays
from tahoe_tpu_torch.ops import oracle

# (generator, args, kwargs) per sweep family, cut to a few trees
FORESTS = {
    "susy_like": ("forest", (24, 8, 18), dict(leaf_prob=0.05, seed=1)),
    "cup98_like": ("forest", (10, 8, 479), dict(active_cols=300, seed=2)),
    "svhn_like": ("forest", (16, 6, 100), dict(leaf_prob=0.1, seed=3)),
    "stumps_like": ("forest", (60, 3, 10),
                    dict(leaf_prob=0.05, missing=-999.0, seed=4)),
    "deep12_like": ("forest", (3, 12, 28), dict(leaf_prob=0.02, seed=5)),
    "trained_mix_like": ("mixed", (20, 10, 26), dict(seed=6)),
    "rf_trained_like": ("train", (6, 10, 24), dict(rows=512, seed=7)),
}
# a band narrow enough that the wider families split into virtual features
BAND = 64


def _make(mods, name):
    kind, args, kw = FORESTS[name]
    synth, trainer = mods
    if kind == "forest":
        return synth.generate_forest(*args, **kw)
    if kind == "mixed":
        return synth.generate_mixed_depth_forest(*args, **kw)
    return trainer.train_forest(*args, **kw)


def _pair(name):
    return (_make((jax_synthetic, jax_train), name),
            _make((synthetic, train), name))


def _rows(forest, seed=11, n=200):
    data = jax_synthetic.generate_data(n, forest.num_cols,
                                       missing=forest.missing,
                                       missing_prob=0.05, seed=seed)
    k = min(forest.num_cols, forest.nodes_per_tree)
    data[0, :k] = forest.values[0, :k]  # exact threshold hits
    return data


def assert_same(a, b, path="value"):
    """Equal type shape, dtype and bits (NaN equal to NaN), recursively
    through dataclasses, tuples, lists and dicts."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    elif isinstance(a, enum.Enum):
        assert a.name == b.name and a.value == b.value, path
    else:
        assert a == b and type(a) is type(b), path


@pytest.mark.parametrize("name", sorted(FORESTS))
def test_generators_agree(name):
    jf, pf = _pair(name)
    assert isinstance(pf, ForestSpec)
    assert_same(jf, pf)
    assert_same(jax_synthetic.generate_data(64, jf.num_cols, missing_prob=0.1,
                                            seed=3),
                synthetic.generate_data(64, jf.num_cols, missing_prob=0.1,
                                        seed=3))


@pytest.mark.parametrize("name", sorted(FORESTS))
def test_compiler_passes_agree(name):
    jf, pf = _pair(name)
    depth = int(jax_compiler.reachable_depths(jf).max(initial=0))
    assert depth == int(compiler.reachable_depths(pf).max(initial=0))
    assert_same(jax_compiler.reachable_mask(jf), compiler.reachable_mask(pf))
    assert_same(jax_compiler.truncate_depth(jf, depth),
                compiler.truncate_depth(pf, depth))
    assert_same(jax_compiler.compact_features(jf), compiler.compact_features(pf))
    js, ps = jax_compiler.hot_child_swap(jf), compiler.hot_child_swap(pf)
    assert_same(js, ps)
    assert_same(jax_compiler.cluster_trees(js), compiler.cluster_trees(ps))
    for jx, px in ((jf, pf), (js, ps)):
        jl, pl = jax_compiler.levelize(jx), compiler.levelize(px)
        assert_same(jl, pl)
        assert_same(jax_compiler.ge_normalize(jl), compiler.ge_normalize(pl))
        assert_same(jax_compiler.compact_leveled(jl), compiler.compact_leveled(pl))
    assert_same(jax_compiler.compile_forest(jf), compiler.compile_forest(pf))


@pytest.mark.parametrize("name", sorted(FORESTS))
def test_pack_unpack_agree(name):
    jf, pf = _pair(name)
    jp, pp = jax_compiler.pack(jf), compiler.pack(pf)
    assert_same(jp, pp)
    assert_same(jax_compiler.unpack(jp), compiler.unpack(pp))
    assert jax_compiler.select_width(jf).value == compiler.select_width(pf).value


@pytest.mark.parametrize("band", [None, BAND])
@pytest.mark.parametrize("name", sorted(FORESTS))
def test_rank_quantization_agrees(name, band):
    jf, pf = _pair(name)
    depth = int(compiler.reachable_depths(pf).max(initial=0))
    jc, _ = jax_compiler.compact_features(jax_compiler.truncate_depth(jf, depth))
    pc, _ = compiler.compact_features(compiler.truncate_depth(pf, depth))
    jq, pq = jax_quantize.quantize(jc), quantize.quantize(pc)
    assert_same(jq, pq)
    jb, pb = jax_quantize.band_split(jq, band), quantize.band_split(pq, band)
    assert_same(jb, pb)
    jq, pq = jb[0], pb[0]
    jspec = jax_quantize.quantized_spec_for_engines(jq)
    pspec = quantize.quantized_spec_for_engines(pq)
    assert_same(jspec, pspec)
    if pq.spec.num_cols <= compiler.RANK_MAX_COLS:
        assert_same(jax_compiler.rank_normalize(jax_compiler.levelize(jspec)),
                    compiler.rank_normalize(compiler.levelize(pspec)))
        data = _rows(jc)
        jr = jax_quantize.transform_rows_np(jq, data)
        pr = quantize.transform_rows_np(pq, data)
        assert_same(jr, pr)
        assert_same(jax_quantize.encode_rank_planes_np(jr),
                    quantize.encode_rank_planes_np(pr))


@pytest.mark.parametrize("name", sorted(FORESTS))
def test_sparse_form_and_oracles_agree(name):
    jf, pf = _pair(name)
    data = _rows(jf)
    js, ps = jax_sparse.from_dense(jf), sparse.from_dense(pf)
    assert_same(js, ps)
    assert_same(jax_sparse.predict_margins_np(js, data),
                sparse.predict_margins_np(ps, data))
    assert_same(jax_sparse.predict_np(js, data), sparse.predict_np(ps, data))
    assert_same(jax_oracle.predict_margins(jf, data),
                oracle.predict_margins(pf, data))
    assert_same(jax_oracle.predict(jf, data), oracle.predict(pf, data))


@pytest.mark.parametrize("output", [0, 0x1, 0x10, 0x111])
def test_oracle_output_transforms_agree(output):
    jf = jax_synthetic.generate_forest(9, 4, 6, leaf_prob=0.1, output=output,
                                       global_bias=0.05, threshold=0.52,
                                       missing=-999.0, seed=12)
    pf = synthetic.generate_forest(9, 4, 6, leaf_prob=0.1, output=output,
                                   global_bias=0.05, threshold=0.52,
                                   missing=-999.0, seed=12)
    data = _rows(jf, seed=13)
    data[1, 2] = np.float32(-999.0 + 5e-7)  # within MISSING_EPS of the sentinel
    assert_same(jax_oracle.predict(jf, data), oracle.predict(pf, data))
    assert_same(jax_oracle.predict_scalar(jf, data[:20]),
                oracle.predict_scalar(pf, data[:20]))


@pytest.mark.parametrize("name", ["susy_like", "stumps_like", "rf_trained_like"])
def test_io_round_trip_agrees(tmp_path, name):
    """Each package writes the same bytes, and reads the other's files to
    the same forest and rows."""
    jf, pf = _pair(name)
    data = _rows(jf, n=50)
    paths = {k: str(tmp_path / k) for k in ("jm", "pm", "jd", "pd")}
    jax_io.save_model(paths["jm"], jf)
    io.save_model(paths["pm"], pf)
    jax_io.save_data(paths["jd"], data, jf.missing)
    io.save_data(paths["pd"], data, pf.missing)
    for a, b in (("jm", "pm"), ("jd", "pd")):
        assert open(paths[a], "rb").read() == open(paths[b], "rb").read()
    kw = dict(missing=jf.missing, num_cols=jf.num_cols)
    assert_same(jax_io.load_model(paths["pm"], **kw), io.load_model(paths["jm"], **kw))
    assert_same(jax_io.load_data(paths["pd"]), io.load_data(paths["jd"]))
    jax_io.save_forest_npz(paths["jm"] + ".npz", jf)
    io.save_forest_npz(paths["pm"] + ".npz", pf)
    assert_same(jax_io.load_forest_npz(paths["pm"] + ".npz"),
                io.load_forest_npz(paths["jm"] + ".npz"))


def test_enums_and_constants_agree():
    for ours, theirs in ((config.Strategy, jax_config.Strategy),
                         (config.Output, jax_config.Output),
                         (config.NodeWidth, jax_config.NodeWidth)):
        assert {m.name: m.value for m in ours} == {m.name: m.value for m in theirs}
    for s in config.Strategy:
        assert s.strategy_number == jax_config.Strategy[s.name].strategy_number
    for w in config.NodeWidth:
        jw = jax_config.NodeWidth[w.name]
        assert w.fid_bits == jw.fid_bits
        for fn in ("fid_mask", "def_left_mask", "is_leaf_mask", "exchange_mask"):
            assert getattr(config, fn)(w) == getattr(jax_config, fn)(jw)
    for fid in (0, 31, 32, 8191, 8192, (1 << 29) - 1):
        assert (config.NodeWidth.for_max_fid(fid).value
                == jax_config.NodeWidth.for_max_fid(fid).value)
    for d in range(20):
        assert config.tree_num_nodes(d) == jax_config.tree_num_nodes(d)
        assert config.forest_num_nodes(7, d) == jax_config.forest_num_nodes(7, d)
    assert config.MISSING_EPS == jax_config.MISSING_EPS
    assert config.ORACLE_ATOL == jax_config.ORACLE_ATOL
    with pytest.raises(ValueError):
        config.Output.validate(0x2)


@pytest.mark.parametrize("name", sorted(FORESTS))
def test_forest_crosses_both_ways(name):
    """from_arrays takes a JAX ForestSpec's fields; to_arrays gives the
    fields back, and the JAX constructor takes them."""
    jf, pf = _pair(name)
    jf.exchange = jax_compiler.hot_child_swap(jf).exchange
    jf.output, jf.global_bias = int(jax_config.Output.AVG), 0.25
    carried = from_arrays(dataclasses.asdict(jf))
    assert isinstance(carried, ForestSpec)
    assert_same(jf, carried)
    back = JaxForestSpec(**to_arrays(carried))
    assert_same(jf, back)
    carried.values[0, 0] += 1  # the arrays are copies, not views
    assert jf.values[0, 0] != carried.values[0, 0]
    with pytest.raises(ValueError, match="missing"):
        from_arrays({k: v for k, v in dataclasses.asdict(jf).items()
                     if k != "fids"})
