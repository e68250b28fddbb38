"""Selector training, the JAX package's `repro.train` in PyTorch: index-
backed label generation (streamed full-dense top-k, a label cache),
bucketed LSTM training with checkpoints and resume (the lstm_sequence
kernel forward on the card, its backward through the plain version),
threshold/budget calibration, and atomic selector publishing into a
built index. `python -m repro_torch.launch.train_selector` drives the
whole loop against a built index."""

from repro_torch.train.calibrate import (
    calibration_table, choose_operating_point, expansion_sweep,
    recall_at_budget, select_at, selection_quality, selector_probs)
from repro_torch.train.data import (
    Batch, bucket_lengths, bucketed_batches, effective_lengths,
    n_batches_per_epoch)
from repro_torch.train.labels import (
    LabelCache, LabelConfig, LabelGenStats, LabelSet, label_cache_key,
    make_labels, make_labels_streaming, query_fingerprint,
    relabel_for_config, stage1_for_queries, streaming_full_dense_topk)
from repro_torch.train.publish import publish_selector
from repro_torch.train.trainer import (
    SelectorTrainConfig, SelectorTrainer, derive_pos_weight,
    resolve_pos_weight, selector_apply, train_selector)

__all__ = [
    "Batch", "LabelCache", "LabelConfig", "LabelGenStats", "LabelSet",
    "SelectorTrainConfig", "SelectorTrainer", "bucket_lengths",
    "bucketed_batches", "calibration_table", "choose_operating_point",
    "derive_pos_weight", "effective_lengths", "expansion_sweep",
    "label_cache_key", "make_labels", "make_labels_streaming",
    "n_batches_per_epoch", "publish_selector", "query_fingerprint",
    "recall_at_budget", "relabel_for_config", "resolve_pos_weight",
    "select_at", "selection_quality", "selector_apply", "selector_probs",
    "stage1_for_queries", "streaming_full_dense_topk", "train_selector",
]
