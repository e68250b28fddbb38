"""CluSD serving demo on the PyTorch port's RetrievalEngine (the card by
default, `--device cpu` to run on the CPU): builds the index, trains the
selector, serves batched queries through power-of-two request buckets,
and exercises the on-disk backend (LRU block cache + async Stage-I
prefetch), reporting latency percentiles, I/O ops, and hit rate.

  PYTHONPATH=src python examples/torch_serve_retrieval.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None):
    from repro_torch.launch import serve as serve_mod
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    argv = ["--docs", "12000", "--clusters", "192", "--queries", "128",
            "--epochs", "30", "--ondisk", "--cache-blocks", "256"]
    if args.device is not None:
        argv += ["--device", args.device]
    return serve_mod.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
