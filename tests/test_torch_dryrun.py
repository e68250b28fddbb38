"""The port's dry run (repro_torch.launch.dryrun): smoke cells of every
family counted on one rank of a fake 2 x 2 process group, the counted
FLOPs of a 1 x 1 cell against torch's FlopCounterMode on a real CPU
step, the counted collective bytes of 2 x 2 cells against the bytes
`collectives.TRAFFIC` records when the same cells run on 4 gloo ranks,
and the command lines of the dry run and the breakdown against the
JAX package's.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from _torch_mesh import SRC, run_jax, spawn

_SMOKE = r"""
import json
from repro_torch.configs import cells, get_config
from repro_torch.configs.shapes import shapes_for
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
dryrun.fake_process_group(4)
mesh = make_debug_mesh((2, 2), ("data", "model"))
todo = [(a, s, None) for a, s, skip in cells() if not skip] + [
    ("clusd-msmarco", s, None) for s in shapes_for("retrieval").values()] + [
    ("clusd-msmarco", s, {"impl": "pjit"})
    for s in shapes_for("retrieval").values()]
out = []
for arch, shape, over in todo:
    rec = dryrun.run_cell(arch, shape, False, mesh=mesh, variant="smoke",
                          overrides=over)
    out.append({"arch": arch, "shape": shape.name, "family":
                get_config(arch).family, "status": rec["status"],
                "flops": rec["roofline"]["flops_per_device"],
                "bytes": rec["roofline"]["bytes_per_device"],
                "peak": rec["memory"]["peak_gb"], "coll": rec["collectives"],
                "kernels": rec["kernels"], "over": rec["overrides"]})
print("JSON" + json.dumps(out))
"""


def _sub(code, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.split("JSON", 1)[1])


@pytest.fixture(scope="module")
def smoke():
    return _sub(_SMOKE)


@pytest.mark.parametrize("family", ["lm", "gnn", "recsys", "retrieval"])
def test_smoke_cells_of_each_family_run_on_a_fake_2x2(smoke, family):
    recs = [r for r in smoke if r["family"] == family]
    assert recs
    for r in recs:
        assert r["status"] == "ok" and r["kernels"] == "plain", r
        assert r["bytes"] > 0 and r["peak"] > 0, r
        # every cell of a 2 x 2 mesh talks to the other ranks
        assert r["coll"]["count"] > 0, r


def test_the_gathered_cells_show_their_gather(smoke):
    """retrieval_cand and CluSD impl="pjit" gather their sharded operands:
    the pjit cell's all-gathers return exactly the whole embedding store
    and posting lists (float32 and int32) on the rank."""
    from repro_torch.configs import get_config
    cfg = get_config("clusd-msmarco", "smoke")
    by = {(r["arch"], r["shape"], r["over"].get("impl")): r for r in smoke}
    pjit = by[("clusd-msmarco", "serve_256", "pjit")]["coll"]
    docs = cfg.n_clusters * cfg.cluster_cap
    assert pjit["all-gather_raw"] == 4 * (docs * cfg.dim
                                          + 2 * cfg.vocab * cfg.max_postings)
    for arch in ("wide-deep", "din", "deepfm", "dlrm-mlperf"):
        c = by[(arch, "retrieval_cand", None)]["coll"]
        assert c["all-gather_raw"] > 0


def test_one_rank_flops_equal_flop_counter_on_a_real_cpu_step():
    """A 1 x 1 cell's counted FLOPs (meta tensors) equal FlopCounterMode
    over the same step on real CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    from _torch_mesh import real_args
    from repro_torch.analysis.cost import count_step
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import local_args
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import sharding as sh

    mesh = make_debug_mesh((1, 1), ("data", "model"))
    for arch, shape in (
            ("qwen2-1.5b", ShapeSpec("t", "train", seq_len=32,
                                     global_batch=4)),
            ("mixtral-8x7b", ShapeSpec("p", "prefill", seq_len=32,
                                       global_batch=2)),
            ("wide-deep", ShapeSpec("t", "train", batch=16)),
            ("din", ShapeSpec("s", "serve", batch=16))):
        cell = build_cell(arch, shape, mesh, False, None, "smoke")
        meta = local_args(list(cell.args), list(cell.in_shardings))
        with sh.rules_ctx(cell.rules, mesh=mesh):
            _, mode = count_step(cell.fn, meta)
            fc = FlopCounterMode(display=False)
            with fc:
                cell.fn(*real_args(meta, torch.Generator().manual_seed(0)))
        assert mode.cost()["flops"] == fc.get_total_flops() > 0, arch


CASES = [
    dict(arch="qwen2-1.5b", shape=dict(name="t", mode="train", seq_len=32,
                                       global_batch=8)),
    dict(arch="qwen2-1.5b", shape=dict(name="d", mode="decode", seq_len=32,
                                       global_batch=8)),
    dict(arch="mixtral-8x7b", shape=dict(name="t", mode="train", seq_len=16,
                                         global_batch=8)),
    # the global microbatch: the rows' all-gather, then 2 rows a rank
    dict(arch="mixtral-8x7b", shape=dict(name="t", mode="train", seq_len=16,
                                         global_batch=8),
         over={"microbatch": 2}),
    dict(arch="wide-deep", shape=dict(name="t", mode="train", batch=16)),
    dict(arch="din", shape=dict(name="s", mode="serve", batch=16)),
]

_DRY = r"""
import json
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.specs import build_cell
dryrun.fake_process_group(4)
mesh = make_debug_mesh((2, 2), ("data", "model"))
out = []
for c in CASES:
    cell = build_cell(c["arch"], ShapeSpec(**c["shape"]), mesh, False,
                      c.get("over"), "smoke")
    m, _ = dryrun.count_cell(cell, mesh, False, cell.rules)
    out.append(m.collectives())
print("JSON" + json.dumps(out))
"""


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c['arch']}_{c['shape']['mode']}"
                              + ("_microbatch" if c.get("over") else "")
                              for c in CASES])
def test_2x2_collective_bytes_equal_traffic_on_4_gloo_ranks(tmp_path, i):
    got = _sub(_DRY.replace("CASES", repr([CASES[i]])))[0]
    real = spawn("task_cell_traffic", {"cases": [CASES[i]]}, tmp_path)
    names = {"all_gather": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter": "reduce-scatter"}
    for r in real:
        assert {names[k]: float(v) for k, v in r[0].items() if v} == {
            k[:-4]: v for k, v in got.items() if k.endswith("_raw")}


def _flags(text):
    return sorted(set(re.findall(r"(--[a-z][a-z\-]*)", text)))


@pytest.mark.parametrize("mod", ["launch.dryrun", "analysis.breakdown"])
def test_help_flags_are_the_reference_flags(mod):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", f"repro_torch.{mod}",
                        "--help"], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    want = run_jax(f"import runpy, sys\nsys.argv = ['x', '--help']\n"
                   f"try:\n    runpy.run_module('repro.{mod}', "
                   f"run_name='__main__')\nexcept SystemExit:\n    pass\n",
                   1)
    assert _flags(r.stdout) == _flags(want) != []
