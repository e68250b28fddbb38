"""Fault-tolerant LM training demo on the PyTorch port (the card by
default, `--device cpu` to run on the CPU): trains a reduced qwen2-1.5b
for 60 steps with failures injected at steps 22 and 41; the restartable
driver restores from the latest async checkpoint and finishes the run.

  PYTHONPATH=src python examples/torch_train_with_failures.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None):
    from repro_torch.launch import train as train_mod
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ft_") as ckpt:
        argv = ["--arch", "qwen2-1.5b", "--variant", "smoke",
                "--steps", "60", "--batch", "4", "--seq", "64",
                "--ckpt-dir", ckpt, "--ckpt-every", "10",
                "--fail-at", "22", "41"]
        if args.device is not None:
            argv += ["--device", args.device]
        return train_mod.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
