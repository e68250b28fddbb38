"""The port's int8 error-feedback compression (repro_torch.optim.
compression) against the JAX package's `repro.optim.compression`.

  * compress_roundtrip bitwise JAX's op-by-op result; under jax.jit XLA
    may contract the carry g32 - q * scale into one FMA (it does on most
    vectors here, not on a single element), so there the carry is held
    within one float32 ulp of q * scale, the rounding the FMA skips
  * error feedback: over many steps the carries never grow past half a
    step's scale, and the dequantized sum plus the last carry is the
    true sum (rtol 1e-6)
  * compressed_psum on 4 gloo ranks (torch.multiprocessing, a FileStore)
    against JAX's inside shard_map on 4 host devices (a subprocess with
    --xla_force_host_platform_device_count=4): the sums bitwise (the int8
    payload is summed exactly in int32), the carries as for the
    roundtrip; a second step from each rank's carry bitwise a numpy
    recomputation; the sum is the SUM over the ranks, as JAX's is
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

import jax
import jax.numpy as jnp

from _torch_parity import compression_worker
from repro.optim import compression as jc
from repro_torch.optim import compression as tc

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SHAPES = {"w": (64, 33), "b": (7,), "s": (1,)}


def _carry_close(jax_carry, port_carry, q, scale):
    """The jitted reference's carry within one ulp of q * scale of the
    port's (an FMA skips the rounding of the product)."""
    ulp = np.spacing(np.abs(q * scale).astype(np.float32))
    assert (np.abs(jax_carry - port_carry) <= ulp).all()


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * 3).astype(np.float32)
    e = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    return g, e


@pytest.mark.parametrize("shape", [(1000,), (64, 33), (1,)])
def test_compress_roundtrip_is_bitwise_jax(shape):
    g, e = _arrays(shape, len(shape))
    td, te = tc.compress_roundtrip(torch.from_numpy(g), torch.from_numpy(e))
    jd, je = jc.compress_roundtrip(jnp.asarray(g), jnp.asarray(e))
    assert td.numpy().tobytes() == np.asarray(jd).tobytes()
    assert te.numpy().tobytes() == np.asarray(je).tobytes()
    jd, je = jax.jit(jc.compress_roundtrip)(jnp.asarray(g), jnp.asarray(e))
    assert td.numpy().tobytes() == np.asarray(jd).tobytes()
    g32 = g + e
    scale = np.float32(np.abs(g32).max() / np.float32(127.0)
                      + np.float32(1e-12))
    q = np.asarray(np.round(td.numpy() / scale))
    assert np.abs(q).max() <= 127
    _carry_close(np.asarray(je), te.numpy(), q, scale)
    # the carry is the residual: float32(g32 - deq)
    assert te.numpy().tobytes() == (g32 - td.numpy()).tobytes()


def test_ef_init_and_the_error_feedback_contraction():
    params = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
              "b": {"c": torch.ones(5)}}
    e = tc.ef_init(params)
    je = jc.ef_init({"a": jnp.zeros((3, 4), jnp.bfloat16),
                     "b": {"c": jnp.ones(5)}})
    assert e["a"].dtype == e["b"]["c"].dtype == torch.float32
    assert e["a"].shape == je["a"].shape and not e["b"]["c"].any()
    rng = np.random.default_rng(0)
    carry = torch.zeros(256)
    total_g = np.zeros(256)
    total_d = np.zeros(256)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
        deq, new = tc.compress_roundtrip(g, carry)
        scale = float((g + carry).abs().max()) / 127.0
        assert float(new.abs().max()) <= 0.5 * scale * (1 + 1e-5)
        carry = new
        total_g += g.double().numpy()
        total_d += deq.double().numpy()
    np.testing.assert_allclose(total_d + carry.double().numpy(), total_g,
                               rtol=1e-6, atol=1e-5)


_JAX_PSUM = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.optim.compression import compressed_psum
job = dict(np.load("{job}"))
names = sorted(k[2:] for k in job if k.startswith("g_"))
mesh = jax.make_mesh((4,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
f = jax.jit(jax.shard_map(lambda g, e: compressed_psum(g, e, "data", 4),
                          mesh=mesh, in_specs=(P("data"), P("data")),
                          out_specs=(P("data"), P("data"))))
g = {{n: jnp.asarray(job["g_" + n].reshape(-1, *job["g_" + n].shape[2:]))
     for n in names}}
e = {{n: jnp.asarray(job["e_" + n].reshape(-1, *job["e_" + n].shape[2:]))
     for n in names}}
s, e = f(g, e)
out = {{}}
for n in names:
    out["s0_" + n] = np.asarray(s[n]).reshape(job["g_" + n].shape)
    out["e0_" + n] = np.asarray(e[n]).reshape(job["g_" + n].shape)
np.savez("{out}", **out)
"""


def test_compressed_psum_on_gloo_ranks_matches_jax_shard_map(tmp_path):
    world = 4
    rng = np.random.default_rng(3)
    arrays = {}
    for n, shape in SHAPES.items():
        # one leading row per rank (JAX shards it over the mesh axis)
        arrays["g_" + n] = (rng.standard_normal((world, 1) + shape)
                            * rng.uniform(0.1, 5, (world, 1) + (1,)
                                          * len(shape))).astype(np.float32)
        arrays["e_" + n] = (rng.standard_normal((world, 1) + shape)
                            * 0.01).astype(np.float32)
    job = str(tmp_path / "job.npz")
    np.savez(job, **arrays)
    want = str(tmp_path / "jax.npz")
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(
        _JAX_PSUM.format(job=job, out=want))], capture_output=True,
        text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr
    want = dict(np.load(want))
    out_dir = tmp_path / "torch"
    out_dir.mkdir()
    job_t = str(tmp_path / "job_t.npz")
    np.savez(job_t, **{k: v[:, 0] for k, v in arrays.items()})
    tmp.spawn(compression_worker, args=(world, str(tmp_path / "store"),
                                        job_t, str(out_dir)), nprocs=world)
    ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]
    for n in SHAPES:
        e_prev = arrays["e_" + n][:, 0]
        for step in (0, 1):
            # the step from the port's own carries, recomputed in numpy
            g32 = arrays["g_" + n][:, 0] + e_prev
            scale = np.float32(np.abs(g32).max() / np.float32(127.0)
                               + np.float32(1e-12))
            q = np.clip(np.round(g32 / scale), -127, 127)
            s_np = q.astype(np.int32).sum(0).astype(np.float32) * scale
            for r, got in enumerate(ranks):
                assert got[f"s{step}_{n}"].tobytes() == s_np.tobytes()
                assert got[f"e{step}_{n}"].tobytes() == (
                    g32[r] - (q[r] * scale).astype(np.float32)).tobytes()
                if step == 0:     # JAX's step from the same inputs
                    assert want[f"s0_{n}"][r, 0].tobytes() == \
                        s_np.tobytes(), (n, r)
                    _carry_close(want[f"e0_{n}"][r, 0], got[f"e0_{n}"],
                                 q[r], scale)
            # the SUM over the ranks, within n_shards * scale / 2
            assert np.abs(s_np - g32.sum(0)).max() <= \
                world * scale / 2 * 1.001
            e_prev = np.stack([got[f"e{step}_{n}"] for got in ranks])
    with pytest.raises(ValueError, match="n_shards"):
        torch.distributed.init_process_group(
            "gloo", store=torch.distributed.FileStore(
                str(tmp_path / "one"), 1), rank=0, world_size=1)
        try:
            tc.compressed_psum({"a": torch.ones(2)}, {"a": torch.zeros(2)},
                               None, 2)
        finally:
            torch.distributed.destroy_process_group()
