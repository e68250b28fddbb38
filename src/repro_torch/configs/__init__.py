"""The port's configs, looked up by name as `repro.configs.get_config`
does: `get_config("<arch-id>", "full" | "smoke")`. Each module keeps the
JAX module's `full()` and `smoke()`.

Also the JAX registry's assigned archs and its dry-run cells: every
(arch, shape) pair of `configs/shapes.py` with its skip reason."""

import importlib

from repro_torch.configs.base import (CluSDConfig, NequIPConfig,
                                      RecsysConfig, TrainConfig,
                                      TransformerConfig)
from repro_torch.configs.shapes import (FAMILY_SHAPES, ShapeSpec,
                                        cell_is_skipped, shapes_for)

# arch-id -> module name
ARCH_REGISTRY = {
    "arctic-480b": "arctic_480b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-1.5b": "qwen2_1_5b",
    "deepseek-67b": "deepseek_67b",
    "qwen2.5-32b": "qwen2_5_32b",
    "nequip": "nequip",
    "wide-deep": "wide_deep",
    "din": "din",
    "deepfm": "deepfm",
    "dlrm-mlperf": "dlrm_mlperf",
    # the paper's own retrieval system
    "clusd-msmarco": "clusd_msmarco",
}

ASSIGNED_ARCHS = [a for a in ARCH_REGISTRY if a != "clusd-msmarco"]


def get_config(arch, variant="full"):
    if arch not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: "
                       f"{sorted(ARCH_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_REGISTRY[arch]}")
    if not hasattr(mod, variant):
        raise KeyError(f"arch {arch!r} has no variant {variant!r}")
    return getattr(mod, variant)()


def list_archs():
    return list(ARCH_REGISTRY)


def cells(include_skipped=True):
    """All (arch, shape_spec, skip_reason) dry-run cells."""
    out = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in shapes_for(cfg.family).values():
            reason = cell_is_skipped(cfg, shape)
            if reason and not include_skipped:
                continue
            out.append((arch, shape, reason))
    return out


__all__ = ["ARCH_REGISTRY", "ASSIGNED_ARCHS", "CluSDConfig", "FAMILY_SHAPES",
           "NequIPConfig", "RecsysConfig", "ShapeSpec", "TrainConfig",
           "TransformerConfig", "cell_is_skipped", "cells", "get_config",
           "list_archs", "shapes_for"]
