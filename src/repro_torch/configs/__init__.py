"""The port's configs, looked up by name as `repro.configs.get_config`
does: `get_config("<arch-id>", "full" | "smoke")`. Each module keeps the
JAX module's `full()` and `smoke()`."""

import importlib

from repro_torch.configs.base import (CluSDConfig, RecsysConfig,
                                      TrainConfig)

# arch-id -> module name (the subset of the JAX registry that is ported)
ARCH_REGISTRY = {
    "wide-deep": "wide_deep",
    "din": "din",
    "deepfm": "deepfm",
    "dlrm-mlperf": "dlrm_mlperf",
    "clusd-msmarco": "clusd_msmarco",
}


def get_config(arch, variant="full"):
    if arch not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: "
                       f"{sorted(ARCH_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_REGISTRY[arch]}")
    if not hasattr(mod, variant):
        raise KeyError(f"arch {arch!r} has no variant {variant!r}")
    return getattr(mod, variant)()


__all__ = ["ARCH_REGISTRY", "CluSDConfig", "RecsysConfig", "TrainConfig",
           "get_config"]
