"""The synthetic-corpus recipe an index directory carries (its manifest's
extra["corpus"]): the port's `recipe_corpus` against the JAX package's
synth_corpus, the recipe's topic_noise honoured, and the one kept corpus
that the update, train and serve CLIs of the port share in a process.

Tolerance: exact — the same numpy generator, draw for draw.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from repro.data import synth_corpus as jax_synth_corpus
from repro.data import synth_queries as jax_synth_queries
from repro_torch.data import recipe_corpus
from repro_torch.launch import train_selector, update_index

RECIPE = {"kind": "synthetic", "seed": 3, "n_docs": 512, "dim": 16,
          "vocab": 300}


def _reader(recipe):
    return SimpleNamespace(manifest={"extra": {"corpus": recipe}})


@pytest.mark.parametrize("noise", [None, 0.5])
def test_recipe_corpus_matches_jax(noise):
    recipe = dict(RECIPE) if noise is None else dict(RECIPE,
                                                     topic_noise=noise)
    kw = {} if noise is None else {"topic_noise": noise}
    got = recipe_corpus(recipe)
    want = jax_synth_corpus(3, 512, 16, 300, **kw)
    for f in ("embeddings", "doc_terms", "doc_weights", "topic_of"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_recipe_corpus_is_kept_and_noise_changes_it():
    a = recipe_corpus(dict(RECIPE, topic_noise=0.5))
    assert recipe_corpus(dict(RECIPE, topic_noise=0.5)) is a
    b = recipe_corpus(RECIPE)
    assert b is not a
    assert recipe_corpus(dict(RECIPE, topic_noise=0.55)) is b
    assert not np.array_equal(a.embeddings, b.embeddings)


def test_a_kept_corpus_made_elsewhere_is_the_recipes():
    """keep_corpus installs a corpus made from the recipe elsewhere (as
    another process hands it over): recipe_corpus returns that object
    for the recipe, and another recipe makes its own again."""
    from repro_torch.data import Corpus, keep_corpus, synth_corpus

    recipe = dict(RECIPE, topic_noise=0.5)
    c = synth_corpus(3, 512, 16, 300, topic_noise=0.5)
    made = Corpus(c.embeddings.copy(), c.doc_terms.copy(),
                  c.doc_weights.copy(), c.topic_of.copy(), c.vocab)
    keep_corpus(recipe, made)
    assert recipe_corpus(dict(recipe)) is made
    other = recipe_corpus(RECIPE)
    assert other is not made
    np.testing.assert_array_equal(
        other.embeddings, np.asarray(jax_synth_corpus(3, 512, 16, 300)
                                     .embeddings))


@pytest.mark.parametrize("cli", ["update", "train"])
def test_cli_queries_come_from_the_recipe_corpus(cli):
    recipe = dict(RECIPE, topic_noise=0.5)
    jc = jax_synth_corpus(3, 512, 16, 300, topic_noise=0.5)
    if cli == "update":
        got = [update_index._synthetic_queries(_reader(recipe), 24)]
        want = [jax_synth_queries(9, jc, 24)]
    else:
        _, tq, hq = train_selector._corpus_queries(
            _reader(recipe), SimpleNamespace(seed=0, train_queries=24,
                                             holdout_queries=8))
        got, want = [tq, hq], [jax_synth_queries(21, jc, 24),
                               jax_synth_queries(22, jc, 8)]
    for g, w in zip(got, want):
        for f in ("q_dense", "q_terms", "q_weights", "rel_doc"):
            np.testing.assert_array_equal(getattr(g, f),
                                          np.asarray(getattr(w, f)),
                                          err_msg=f)
