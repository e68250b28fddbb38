"""The paper's own system config: CluSD on MS MARCO passages (a copy of
repro.configs.clusd_msmarco's `full()` and `smoke()`)."""

from repro_torch.configs.base import CluSDConfig


def full() -> CluSDConfig:
    return CluSDConfig(name="clusd-msmarco")


def smoke() -> CluSDConfig:
    return CluSDConfig(
        name="clusd-smoke",
        n_docs=4096, dim=32, n_clusters=64, vocab=512,
        max_postings=256, doc_terms=16,
        k_sparse=128, bins=(10, 25, 50, 128), n_candidates=16,
        lstm_hidden=16, n_neighbors=16, u_bins=4,
        max_selected=8, k_final=64,
        train_queries=64, epochs=10,
    )
