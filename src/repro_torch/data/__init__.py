from repro_torch.data.recsys_stream import RecsysStream
from repro_torch.data.synthetic import (Corpus, QuerySet, mrr_at, recall_at,
                                         recipe_corpus, synth_corpus,
                                         synth_queries)

__all__ = ["Corpus", "QuerySet", "RecsysStream", "mrr_at", "recall_at",
           "recipe_corpus", "synth_corpus", "synth_queries"]
