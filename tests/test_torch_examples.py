"""The port's four examples (examples/torch_*.py) run to exit 0 on the
CPU (`--device cpu`), each in its own process, and print their result
lines."""

import os
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")

EXAMPLES = {
    "torch_quickstart": "S + CluSD",
    "torch_serve_retrieval": "on-disk engine:",
    "torch_recsys_clusd_retrieval": "top-100 overlap vs brute force",
    "torch_train_with_failures": "restarts=2",
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", f"{name}.py"),
         "--device", "cpu"], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert EXAMPLES[name] in out.stdout, out.stdout[-3000:]
