from repro_torch.data.synthetic import (Corpus, QuerySet, mrr_at, recall_at,
                                         synth_corpus, synth_queries)

__all__ = ["Corpus", "QuerySet", "mrr_at", "recall_at", "synth_corpus",
           "synth_queries"]
