"""LSTM selector training (paper §2.3): the seed API, re-exported from
repro_torch.train as the JAX package's `repro.core.train_lstm` re-exports
it from `repro.train`.

  make_labels(cfg, index, ...)   needs index.embeddings on the index's
                                 device; corpus-scale callers use
                                 repro_torch.train.make_labels_streaming
  train_selector(cfg, generator, ...)  one-shot trainer; the BCE positive
                                 weight comes from cfg.pos_weight
  selection_quality(...)         label-level precision/recall at theta
"""

from repro_torch.train.calibrate import selection_quality  # noqa: F401
from repro_torch.train.labels import make_labels  # noqa: F401
from repro_torch.train.trainer import train_selector  # noqa: F401

__all__ = ["make_labels", "selection_quality", "train_selector"]
