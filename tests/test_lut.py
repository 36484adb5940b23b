"""``ops.lut.lookup`` is plain indexing, for every score table the
precompute in ``ops/scores.py`` reads through it."""

import numpy as np
import jax.numpy as jnp
import pytest

from rna_algos_tpu.ops import lut
from rna_algos_tpu.ops import scores as S
from rna_algos_tpu.params import build_fold_score_sets

TURNER_TABLES = ("tm_hairpin", "tm_multibranch", "dangle5", "dangle3",
                 "tm_interior", "tm_1xmany", "tm_2x3")
CONTRA_TABLES = ("helix_close_scores", "terminal_mismatch_scores",
                 "dangling_scores_left", "dangling_scores_right",
                 "basepair_scores")


def _table(model, name):
    tbl = (S.turner_table_pytree() if model == "turner"
           else S.contra_table_pytree(build_fold_score_sets()))
    return tbl[name]


@pytest.mark.parametrize(
    "model,name",
    [("turner", t) for t in TURNER_TABLES]
    + [("contra", t) for t in CONTRA_TABLES],
)
def test_lookup_is_plain_indexing(model, name):
    table = np.asarray(_table(model, name))
    rng = np.random.default_rng(table.size)
    # index arrays of the precompute's broadcast shapes: (N, 1) rows
    # against (1, N) or (N, N) columns
    idx = [rng.integers(0, s, size=(12, 1)) for s in table.shape[:1]]
    idx += [rng.integers(0, s, size=(12, 12)) for s in table.shape[1:]]
    got = np.asarray(lut.lookup(jnp.asarray(table), *idx))
    want = table[tuple(np.broadcast_arrays(*idx))]
    assert got.shape == (12, 12)
    np.testing.assert_array_equal(got, want)


def test_lookup_rejects_wrong_index_count():
    with pytest.raises(ValueError, match="2 index arrays for a 3-d table"):
        lut.lookup(jnp.zeros((5, 5, 5)), jnp.zeros(3, int), jnp.zeros(3, int))
