"""Command-line entry points of the port (`python -m
repro_torch.launch.<name>`); each runs on the CUDA card unless asked for
the CPU with `--device cpu`."""
