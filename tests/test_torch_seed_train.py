"""The port's seed training stack against the JAX package's: schedules,
the synthetic LM stream, the Prefetcher, MetricLogger, the fault-tolerant
driver (restartable_train; a checkpoint written by JAX's driver resumed
by the port's) and the `repro_torch.launch.train` CLI on the CPU.

Tolerances: schedules within 1 float32 ulp (XLA's and torch's cos may
round apart); the token stream, metric records and restored leaves
equal; losses after a cross-package resume rtol 1e-4 (float32 sums in
another order on the CPU).
"""

import contextlib
import dataclasses
import io
import json
import re
import sys

import numpy as np
import pytest
import torch

ARCH = "qwen2-1.5b"


def test_schedules_match_jax():
    import jax.numpy as jnp

    from repro.optim.schedules import make_schedule as jsched
    from repro_torch.optim import make_schedule as tsched

    for kind in ("cosine", "linear", "constant"):
        for warm, total in ((10, 100), (1, 7), (0, 50)):
            j, t = jsched(kind, 3e-4, warm, total), tsched(kind, 3e-4, warm,
                                                           total)
            w = max(warm, 1)
            for step in sorted({0, w - 1, w, (w + total) // 2, total,
                                total + 5}):
                want = np.float32(j(jnp.int32(step)))
                got = t(torch.tensor(step, dtype=torch.int32))
                assert got.dtype == torch.float32 and got.shape == ()
                assert abs(int(np.float32(got).view(np.int32))
                           - int(want.view(np.int32))) <= 1, (kind, step)


def test_lm_synthetic_batches_are_bitwise_jax():
    from repro.data.pipeline import lm_synthetic_batches as jb
    from repro_torch.data.pipeline import lm_synthetic_batches as tb

    for a, b in zip(jb(151, 3, 17, 4, seed=1000), tb(151, 3, 17, 4,
                                                     seed=1000)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and (a[k] == b[k]).all()


def test_prefetcher_keeps_order_and_lands_on_the_device():
    from repro_torch.data.pipeline import Prefetcher, lm_synthetic_batches

    host = list(lm_synthetic_batches(97, 2, 5, 9, seed=3))
    got = list(Prefetcher(iter(host), device="cpu", depth=2))
    assert len(got) == len(host)
    for h, g in zip(host, got):
        assert all(isinstance(g[k], torch.Tensor) and g[k].device.type
                   == "cpu" and (g[k].numpy() == h[k]).all() for k in h)


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(ln).items() if k != "t"}
                for ln in f]


def test_metric_logger_records_match_jax(tmp_path):
    import jax.numpy as jnp

    from repro.common.metrics import MetricLogger as JL
    from repro_torch.common.metrics import MetricLogger as TL

    jl, tl = JL(str(tmp_path / "j.jsonl")), TL(str(tmp_path / "t.jsonl"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for step, (loss, lr) in enumerate(((2.5, 1e-4), (1.25, 3e-4))):
            jl.log(step=step, loss=jnp.float32(loss), lr=jnp.asarray(lr),
                   straggler=False, event="x")
            tl.log(step=step, loss=torch.tensor(loss), lr=torch.tensor(lr),
                   straggler=False, event="x")
        jl.log(event="restart", restarts=1)
        tl.log(event="restart", restarts=1)
    jl.close()
    tl.close()
    assert _records(tmp_path / "t.jsonl") == _records(tmp_path / "j.jsonl")
    lines = [re.sub(r"^t=\S+ ", "", ln) for ln in out.getvalue().splitlines()]
    assert lines[0::2] == lines[1::2]


def test_failure_injector_and_straggler_monitor_match_jax():
    from repro.runtime import fault as jf
    from repro_torch.runtime import fault as tf

    for mod in (jf, tf):
        inj = mod.FailureInjector([2, 5])
        inj.check(1)
        with pytest.raises(mod.SimulatedFailure, match="step 2"):
            inj.check(2)
        inj.check(2)               # trips once
    times = [1.0, 1.1, 0.9, 1.0, 1.0, 5.0, 1.0, 3.5]
    flags = []
    for mod in (jf, tf):
        mon = mod.StragglerMonitor()
        flags.append([mon.observe(i, t) for i, t in enumerate(times)])
    assert flags[0] == flags[1] and any(flags[1])


def _lm_setup(tmp=None):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_synthetic_batches
    from repro_torch.models import transformer as tt
    from repro_torch.optim import adamw_init, make_schedule

    cfg = get_config(ARCH, "smoke")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    step = tt.make_train_step(cfg, make_schedule("cosine", 3e-3, 1, 8))

    def step_fn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    def batches_at(start):
        it = ({k: torch.from_numpy(np.array(v)) for k, v in b.items()}
              for b in lm_synthetic_batches(cfg.vocab_size, 2, 16, 8,
                                            seed=1000))
        for _ in range(start):
            next(it)
        return it
    return {"params": params, "opt": adamw_init(params)}, step_fn, batches_at


def test_restartable_train_with_a_failure_equals_an_uninterrupted_run(
        tmp_path):
    from repro_torch.common.tree import tree_leaves
    from repro_torch.runtime.fault import FailureInjector, restartable_train

    init, step_fn, batches_at = _lm_setup()
    runs = {}
    for name, fail in (("straight", ()), ("failed", (5,))):
        runs[name] = restartable_train(
            init_state=init, step_fn=step_fn, batches_fn=batches_at,
            total_steps=8, ckpt_dir=str(tmp_path / name), ckpt_every=3,
            failure_injector=FailureInjector(fail))
    (s1, h1, r1), (s2, h2, r2) = runs["straight"], runs["failed"]
    assert (r1, r2) == (0, 1)
    assert [h["step"] for h in h2] == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
    by_step = {h["step"]: h["loss"] for h in h2}
    assert [h["loss"] for h in h1] == [by_step[s] for s in range(8)]
    for a, b in zip(tree_leaves(s1), tree_leaves(s2)):
        assert torch.equal(a, b)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    import shutil

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.data.pipeline import lm_synthetic_batches as jbatches
    from repro.models import transformer as jt
    from repro.optim import adamw_init as jadam, make_schedule as jsched
    from repro.runtime.fault import restartable_train as jtrain
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.common.tree import tree_leaves
    from repro_torch.runtime.fault import restartable_train

    jc = jget(ARCH, "smoke")
    jp = jt.init_params(jc, jax.random.key(0))
    jstep = jax.jit(jt.make_train_step(jc, jsched("cosine", 3e-3, 1, 8)))

    def jstep_fn(state, batch):
        p, o, m = jstep(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    def jbatches_at(start):
        it = (jax.tree.map(jnp.asarray, b) for b in jbatches(
            jc.vocab_size, 2, 16, 8, seed=1000))
        for _ in range(start):
            next(it)
        return it
    jinit = {"params": jp, "opt": jadam(jp)}
    ck = tmp_path / "ck"
    jstate, _, _ = jtrain(init_state=jinit, step_fn=jstep_fn,
                          batches_fn=jbatches_at, total_steps=4,
                          ckpt_dir=str(ck), ckpt_every=2)
    shutil.copytree(ck, tmp_path / "ck_jax")
    init, step_fn, batches_at = _lm_setup()
    # the port reads JAX's last checkpoint leaf for leaf
    restored, extra = restore_checkpoint(str(ck), 3, init)
    assert extra == {"step": 3}
    for a, b in zip(tree_leaves(restored), jax.tree.leaves(jstate)):
        assert a.dtype == init["opt"]["count"].dtype or a.dtype \
            == torch.float32
        assert (a.numpy() == np.asarray(b)).all()
    # and goes on from it as JAX's own driver does
    _, th, _ = restartable_train(init_state=init, step_fn=step_fn,
                                 batches_fn=batches_at, total_steps=8,
                                 ckpt_dir=str(ck), ckpt_every=2)
    _, jh, _ = jtrain(init_state=jinit, step_fn=jstep_fn,
                      batches_fn=jbatches_at, total_steps=8,
                      ckpt_dir=str(tmp_path / "ck_jax"), ckpt_every=2)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [4, 5, 6, 7]
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-4)


def _help(main, argv0=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        main(["--help"]) if argv0 is None else main()
    assert e.value.code == 0
    return out.getvalue()


def test_train_help_pins_jax_flags_plus_device(monkeypatch):
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    def flags(text):
        return set(re.findall(r"(--[a-z][a-z-]+)",
                              text.split("\n\n", 2)[2].split("Usage:")[0]))
    monkeypatch.setattr(sys, "argv", ["train", "--help"])
    jflags = flags(_help(jtrain.main, argv0="train"))
    thelp = _help(ttrain.main)
    assert jflags and flags(thelp) == jflags | {"--device"}
    assert ttrain.__doc__.strip().splitlines()[0] in thelp
    assert "repro_torch.launch.train" in thelp


def _cli(argv):
    from repro_torch.launch import train as ttrain

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ttrain.main(argv)
    return rc, out.getvalue()


def test_train_cli_on_the_cpu_recovers_from_a_failure(tmp_path):
    rc, out = _cli(["--arch", ARCH, "--variant", "smoke", "--steps", "8",
                    "--batch", "4", "--seq", "32", "--ckpt-every", "3",
                    "--fail-at", "4", "--ckpt-dir", str(tmp_path / "ck"),
                    "--log", str(tmp_path / "m.jsonl"), "--device", "cpu"])
    assert rc == 0
    done = re.search(r"done: steps=(\d+) restarts=(\d+) loss (\S+) -> (\S+)",
                     out)
    assert done and done.group(1, 2) == ("9", "1")   # 0-3, then 3-7
    assert np.isfinite(float(done.group(3))) and np.isfinite(
        float(done.group(4)))
    recs = _records(tmp_path / "m.jsonl")
    assert [r.get("event") for r in recs].count("restart") == 1
    assert sorted(k for k in recs[0] if k not in ("step", "time_s",
                                                  "straggler")) \
        == ["aux_loss", "grad_norm", "loss", "lr"]


def test_train_cli_runs_recsys_and_refuses_unported_archs(tmp_path):
    rc, out = _cli(["--arch", "wide-deep", "--variant", "smoke", "--steps",
                    "3", "--batch", "16", "--ckpt-dir", str(tmp_path / "r"),
                    "--device", "cpu"])
    assert rc == 0 and "done: steps=3 restarts=0" in out
    # every arch of the registry is ported; an unknown arch or variant
    # is refused before anything runs
    for argv in (["--arch", "no-such-arch"],
                 ["--arch", "nequip", "--variant", "medium"]):
        with pytest.raises(KeyError):
            _cli(argv + ["--steps", "1", "--ckpt-dir",
                         str(tmp_path / "refused"), "--device", "cpu"])
    assert not (tmp_path / "refused").exists()
    from repro_torch.configs import get_config
    assert get_config(ARCH).family == "lm"
    assert dataclasses.replace(get_config(ARCH, "smoke"),
                               microbatch=2).microbatch == 2


def test_new_entry_points_with_the_default_device_need_the_card(
        monkeypatch, tmp_path):
    """device=None means the card: without one these raise, and run only
    when the CPU is asked for."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.models import transformer as tt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH, "smoke")
    for fn in (lambda: tt.init_params(cfg),
               lambda: tt.init_cache(cfg, 1, 8),
               lambda: Prefetcher(iter([])),
               lambda: _cli(["--steps", "1", "--ckpt-dir",
                             str(tmp_path / "ck")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert tt.init_cache(cfg, 1, 8, device="cpu")["k"].device.type == "cpu"
