"""The port's graph builders and neighbour sampler
(repro_torch.data.{graphs,sampler}) and its shape cells
(repro_torch.configs.shapes) against the JAX package's: host numpy, so
equal seeds and the same np.random.Generator calls give equal arrays
(compared bitwise, dtypes included)."""

import dataclasses

import numpy as np
import pytest

from repro.data import graphs as jg
from repro.data import sampler as js
from repro_torch.data import graphs as tg
from repro_torch.data import sampler as ts


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("d_feat", [0, 24])
def test_synth_graph_equals_jax(d_feat):
    for seed in (0, 5):
        _same(tg.synth_graph(seed, 300, 2000, d_feat=d_feat),
              jg.synth_graph(seed, 300, 2000, d_feat=d_feat))


def test_synth_molecules_equals_jax():
    for args in ((1234, 8, 12, 32, 8), (3, 128, 30, 64, 32), (7, 2, 5, 64, 4)):
        seed, g, n, e, s = args
        _same(tg.synth_molecules(seed, g, n, e, n_species=s),
              jg.synth_molecules(seed, g, n, e, n_species=s))


def _graph(seed=0, n=500, e=4000):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src[:50] = 7                      # a hub, and nodes with no out-edges
    return src, dst, n


@pytest.mark.parametrize("n", [500, 300_000], ids=["one_digit",
                                                   "two_digits"])
def test_csr_graph_equals_jax(n):
    """Node ids above 2^16 take the port's second radix pass."""
    src, dst, n = _graph(n=n)
    a, b = ts.CSRGraph.from_edges(src, dst, n), js.CSRGraph.from_edges(
        src, dst, n)
    _same(dataclasses.asdict(a), dataclasses.asdict(b))
    for u in (0, 7, n - 1):
        assert a.degree(u) == b.degree(u)
        assert a.neighbors(u).tobytes() == b.neighbors(u).tobytes()


def test_sample_fanout_equals_jax():
    src, dst, n = _graph(1)
    ga, gb = ts.CSRGraph.from_edges(src, dst, n), js.CSRGraph.from_edges(
        src, dst, n)
    seeds = np.random.default_rng(2).choice(n, 32, replace=False)
    for fanout in ((15, 10), (3,), (25, 5, 2)):
        ra, rb = np.random.default_rng(9), np.random.default_rng(9)
        for x, y in zip(ts.sample_fanout(ga, seeds, fanout, ra),
                        js.sample_fanout(gb, seeds, fanout, rb)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        # the generators are left in the same state
        assert ra.integers(1 << 30) == rb.integers(1 << 30)


def test_padded_batch_equals_jax_and_checks_its_budget():
    src, dst, n = _graph(3)
    feats = np.random.default_rng(4).standard_normal((n, 6)) \
        .astype(np.float32)
    targets = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    g_t, g_j = ts.CSRGraph.from_edges(src, dst, n), js.CSRGraph.from_edges(
        src, dst, n)
    seeds = np.arange(16)
    kw = dict(max_nodes=400, max_edges=400)
    for tgt in (None, targets):
        _same(ts.padded_batch(g_t, feats, seeds, (5, 3),
                              np.random.default_rng(6), targets=tgt, **kw),
              js.padded_batch(g_j, feats, seeds, (5, 3),
                              np.random.default_rng(6), targets=tgt, **kw))
    with pytest.raises(ValueError, match="pad budget"):
        ts.padded_batch(g_t, feats, seeds, (5, 3), np.random.default_rng(6),
                        max_nodes=20, max_edges=400)


def test_shapes_equal_jax():
    from repro.configs import shapes as jsh
    from repro_torch.configs import shapes as tsh

    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES",
                 "RETRIEVAL_SHAPES"):
        a, b = getattr(tsh, name), getattr(jsh, name)
        assert list(a) == list(b)
        assert [dataclasses.asdict(x) for x in a.values()] == \
            [dataclasses.asdict(x) for x in b.values()]
    assert list(tsh.FAMILY_SHAPES) == list(jsh.FAMILY_SHAPES)
    for fam in tsh.FAMILY_SHAPES:
        assert list(tsh.shapes_for(fam)) == list(jsh.shapes_for(fam))


def test_cells_and_skips_equal_jax():
    from repro import configs as jc
    from repro_torch import configs as tc

    assert tc.ASSIGNED_ARCHS == jc.ASSIGNED_ARCHS
    assert tc.list_archs() == jc.list_archs()
    for skipped in (True, False):
        a = [(arch, dataclasses.asdict(s), r)
             for arch, s, r in tc.cells(include_skipped=skipped)]
        b = [(arch, dataclasses.asdict(s), r)
             for arch, s, r in jc.cells(include_skipped=skipped)]
        assert a == b
    skips = [(a, s.name) for a, s, r in tc.cells() if r]
    assert ("mixtral-8x7b", "long_500k") not in skips
    assert ("qwen2-1.5b", "long_500k") in skips
    assert tc.cell_is_skipped(tc.get_config("nequip"),
                              tc.shapes_for("gnn")["molecule"]) is None


def test_every_arch_resolves_to_jax_config():
    from repro.configs import get_config as jget
    from repro_torch.configs import ARCH_REGISTRY, get_config as tget

    for arch in ARCH_REGISTRY:
        for variant in ("full", "smoke"):
            a, b = tget(arch, variant), jget(arch, variant)
            assert type(a).__name__ == type(b).__name__
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(KeyError):
        tget("no-such-arch")
    with pytest.raises(KeyError):
        tget("nequip", "medium")
