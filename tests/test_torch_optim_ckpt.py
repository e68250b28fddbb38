"""The port's optimizers, tree helpers and npz checkpoints against the
JAX package's, on the CPU.

  * adamw_update / sgd_update on a nested tree, several steps, with and
    without grad_clip and weight_decay: rtol 1e-6, atol 1e-7 against
    JAX (the same float32 operations in the same order; XLA's pow and
    its fused elementwise loops may round the last bit otherwise).
  * leaf paths: JAX's keystr and flatten order (sorted keys per level).
  * checkpoints: manifest.json byte for byte JAX's for the same tree,
    the npz members' .npy bytes equal; restore casts to the target's
    dtype and raises KeyError on a missing leaf; the async writer works
    on copies taken before `save_checkpoint` returns.
"""

import json
import os
import threading
import zipfile

import _torch_parity  # noqa: F401  (first: it caps torch at 2 threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.common import tree as jtree
from repro.optim import adam as jadam
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.common import tree as tu
from repro_torch.optim import adam


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"wx": (scale * rng.standard_normal((6, 8))).astype(np.float32),
            "b": (scale * rng.standard_normal(8)).astype(np.float32),
            "head": {"w": (scale * rng.standard_normal((4, 1))).astype(
                np.float32),
                "b": np.zeros(1, np.float32)}}


def _t(tree):
    return tu.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, rtol=1e-6, atol=1e-7):
    for (p, g), (_, w) in zip(tu.leaf_paths(got),
                              tu.leaf_paths(jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(np.asarray(g), w, rtol=rtol, atol=atol,
                                   err_msg=p)


@pytest.mark.parametrize("kw", [{}, {"grad_clip": 0.5},
                                {"weight_decay": 0.1, "b2": 0.999}],
                         ids=["plain", "clip", "decay"])
def test_adamw_update_matches_jax(kw):
    params = _np_tree(0)
    tp, jp = _t(params), _j(params)
    tst, jst = adam.adamw_init(tp), jadam.adamw_init(jp)
    assert tst["count"].dtype == torch.int32 and tst["count"].shape == ()
    for step in range(5):
        grads = _np_tree(10 + step, scale=3.0)
        tp, tst, tstats = adam.adamw_update(_t(grads), tst, tp, lr=1e-2,
                                            **kw)
        jp, jst, jstats = jadam.adamw_update(_j(grads), jst, jp, lr=1e-2,
                                             **kw)
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
    _close(tp, jp)
    _close(tst["mu"], jst["mu"])
    _close(tst["nu"], jst["nu"])
    assert int(tst["count"]) == int(jst["count"]) == 5


def test_sgd_update_and_tree_helpers_match_jax():
    params, grads = _np_tree(1), _np_tree(2, scale=4.0)
    tp, _, ts = adam.sgd_update(_t(grads), adam.sgd_init(_t(params)),
                                _t(params), lr=0.1, grad_clip=1.0)
    jp, _, js = jadam.sgd_update(_j(grads), jadam.sgd_init(_j(params)),
                                 _j(params), lr=0.1, grad_clip=1.0)
    _close(tp, jp)
    np.testing.assert_allclose(float(ts["grad_norm"]),
                               float(js["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tu.global_norm(_t(grads))),
                               float(jtree.global_norm(_j(grads))),
                               rtol=1e-6)
    _close(tu.tree_scale(_t(grads), 0.5), jtree.tree_scale(_j(grads), 0.5))


def test_leaf_paths_are_jax_keystr_in_jax_order():
    tree = {"params": {"wx": 1, "b": 2, "head_w": 3},
            "opt": {"mu": {"b": 4, "wx": 5}, "count": 6}}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = [(jax.tree_util.keystr(p), v) for p, v in flat]
    assert tu.leaf_paths(tree) == want
    assert want[0][0] == "['opt']['count']"
    back = tu.tree_unflatten_like(tree, [v for _, v in want])
    assert back == tree


def _trainer_tree(seed):
    params = _np_tree(seed)
    return {"params": params,
            "opt": {"mu": _np_tree(seed + 1), "nu": _np_tree(seed + 2),
                    "count": np.asarray(7, np.int32)}}


def test_checkpoint_layout_is_jax_byte_for_byte(tmp_path):
    tree = _trainer_tree(3)
    extra = {"epoch": 2, "batch": 1, "selector": "lstm", "pos_weight": 4.0}
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, _j(tree), extra=extra)
    ckpt.save_checkpoint(str(tmp_path / "t"), 7, _t(tree), extra=extra)
    jd, td = tmp_path / "j" / "step_7", tmp_path / "t" / "step_7"
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    assert (jd / "manifest.json").read_bytes() == \
        (td / "manifest.json").read_bytes()
    paths = [leaf["path"] for leaf in
             json.loads((td / "manifest.json").read_text())["leaves"]]
    assert paths[0] == "['opt']['count']" and "['params']['wx']" in paths
    for name in os.listdir(jd):
        if name.endswith(".npz"):
            with zipfile.ZipFile(jd / name) as zj, \
                    zipfile.ZipFile(td / name) as zt:
                assert zj.namelist() == zt.namelist()
                for m in zj.namelist():
                    assert zj.read(m) == zt.read(m), m
    assert ckpt.latest_step(str(tmp_path / "t")) == 7


def test_restore_casts_to_the_target_and_raises_on_a_missing_leaf(tmp_path):
    tree = _trainer_tree(4)
    jckpt.save_checkpoint(str(tmp_path), 3, _j(tree), extra={"k": 1})
    target = _t(tree)
    target["params"]["wx"] = target["params"]["wx"].double()
    got, extra = ckpt.restore_checkpoint(str(tmp_path), 3, target)
    assert extra == {"k": 1}
    assert got["params"]["wx"].dtype == torch.float64
    assert got["opt"]["count"].dtype == torch.int32
    np.testing.assert_array_equal(got["opt"]["nu"]["head"]["w"].numpy(),
                                  tree["opt"]["nu"]["head"]["w"])
    # and the JAX reader restores the port's write of it
    ckpt.save_checkpoint(str(tmp_path / "t"), 3, got)
    back, _ = jckpt.restore_checkpoint(str(tmp_path / "t"), 3, _j(tree))
    np.testing.assert_array_equal(np.asarray(back["params"]["wx"]),
                                  tree["params"]["wx"])
    target["params"]["extra_leaf"] = torch.zeros(2)
    with pytest.raises(KeyError, match="extra_leaf"):
        ckpt.restore_checkpoint(str(tmp_path), 3, target)


def test_async_save_writes_the_values_at_save_time(tmp_path, monkeypatch):
    """np.asarray of a CPU tensor shares its memory, so an
    in-place optimizer step right after an async save would rewrite the
    checkpoint while it is written. The writer below is held until the
    params have been changed in place."""
    go = threading.Event()
    real_savez = ckpt_mod.np.savez

    def held_savez(*a, **k):
        assert go.wait(10)
        return real_savez(*a, **k)

    monkeypatch.setattr(ckpt_mod.np, "savez", held_savez)
    tree = _t(_trainer_tree(5))
    want = tree["params"]["wx"].clone()
    t = ckpt.save_checkpoint(str(tmp_path), 1, tree, async_save=True)
    assert isinstance(t, threading.Thread)
    with torch.no_grad():
        tree["params"]["wx"].add_(100.0)       # the in-place update
    go.set()
    t.join()
    got, _ = ckpt.restore_checkpoint(str(tmp_path), 1, tree)
    assert torch.equal(got["params"]["wx"], want)


def test_checkpoint_manager_keeps_gc_and_restores_latest(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = _t(_trainer_tree(6))
    for step in (1, 2, 3, 4):
        tree["opt"]["count"] = torch.tensor(step, dtype=torch.int32)
        mgr.save(step, tree, extra={"step": step})
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    step, got, extra = mgr.restore_latest(tree)
    assert step == 4 and extra == {"step": 4}
    assert int(got["opt"]["count"]) == 4
    # the JAX manager reads the same directory the same way
    jmgr = jckpt.CheckpointManager(str(tmp_path), keep=2)
    jstep, jgot, _ = jmgr.restore_latest(_j(_trainer_tree(6)))
    assert jstep == 4 and int(jgot["opt"]["count"]) == 4
    empty = ckpt.CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest(tree) == (None, None, None)
