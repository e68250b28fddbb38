from repro_torch.data.recsys_stream import RecsysStream
from repro_torch.data.synthetic import (Corpus, QuerySet, keep_corpus,
                                         mrr_at, recall_at, recipe_corpus,
                                         synth_corpus, synth_queries)

__all__ = ["Corpus", "QuerySet", "RecsysStream", "keep_corpus", "mrr_at",
           "recall_at", "recipe_corpus", "synth_corpus", "synth_queries"]
