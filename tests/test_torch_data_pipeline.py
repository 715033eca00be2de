"""The LM data pipeline of the PyTorch port against the JAX package: the
three cases of test_data_pipeline.py on the same corpus (512 documents of
32 tokens, blocks of 128 rows, partition 32, 8 domains, seed 5), each with
the same selection, seed and batch size in both packages.

Tolerances: none.  ``used_index``, the selected tokens in order and the
first three batches are bit-equal; the port's tokens and batches are int32
tensors on the store's device (the CPU here).  Every selection is also held
to the documents the generated columns select (a numpy filter).

One case differs by the JAX package's known index-scan fault (ROADMAP §3):
its scan starts at the last partition whose minimum is <= lo, so where a
run of keys equal to lo crosses a partition boundary it skips the run's
rows before the boundary.  The point query domain = 3 hits that on this
corpus (37 of the 70 documents selected).  For that case the JAX
package's selection is held to the port's with exactly those rows taken
out, and the port's batches to the JAX package's batch sampler run over the
port's selection."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import pipeline as jpl  # noqa: E402
from repro_torch.core import query as q  # noqa: E402
from repro_torch.core import schema as sc  # noqa: E402
from repro_torch.data import pipeline as pl  # noqa: E402

SEED = 5
CFG = dict(n_docs=512, seq_width=32, rows_per_block=128, partition_size=32,
           n_domains=8)
CASES = {"domain": (("domain", 3, 3), 4),
         "quality": (("quality", 500, 1000), 4),
         "unfiltered": (None, 2)}


@pytest.fixture(scope="module")
def corpora():
    jcfg, cfg = jpl.CorpusConfig(**CFG), pl.CorpusConfig(**CFG)
    jstore, _ = jpl.build_corpus(jcfg, seed=SEED)
    store, _ = pl.build_corpus(cfg, seed=SEED, device="cpu")
    return (jcfg, jstore), (cfg, store)


def _rows(tokens: np.ndarray) -> np.ndarray:
    """Token rows in a canonical (lexicographic) order."""
    return tokens[np.lexsort(tokens.T[::-1])]


def _selected_by_the_data(cfg, select) -> np.ndarray:
    cols = sc.gen_tokens_corpus(cfg.n_docs, cfg.seq_width, cfg.vocab,
                                cfg.n_domains, SEED)
    keep = np.ones(cfg.n_docs, bool)
    if select is not None:
        c, lo, hi = select
        keep = (cols[c] >= lo) & (cols[c] <= hi)
    return np.stack([cols[f"tok{i}"] for i in range(cfg.seq_width)],
                    axis=1)[keep]


def _kept_by_the_jax_scan(store, select) -> np.ndarray:
    """Over the port's selection, in its read order: True where the JAX
    package's index scan reads the row too (from the last partition whose
    minimum is <= lo; the port counts minima < lo)."""
    col, lo, hi = select
    qplan = q.plan(store, q.HailQuery(filter=select, projection=(col,)))
    kept = []
    for b in range(store.n_blocks):
        rep = store.replicas[int(qplan.replica_for_block[b])]
        keys = rep.cols[col][b].numpy()
        mins = rep.mins[b].numpy()
        start = max(int((mins <= lo).sum()) - 1, 0) * store.partition_size
        rows = np.nonzero((keys >= lo) & (keys <= hi))[0]
        kept.append(rows >= start)
    return np.concatenate(kept)


def _batches(src, n=3):
    it = iter(src)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("case", list(CASES))
def test_data_source_matches_reference(corpora, case):
    (jcfg, jstore), (cfg, store) = corpora
    select, batch = CASES[case]
    want = jpl.HailDataSource(jstore, jcfg, select=select, batch_size=batch)
    got = pl.HailDataSource(store, cfg, select=select, batch_size=batch)
    assert got.used_index == want.used_index == (select is not None)
    assert got.tokens.dtype == torch.int32
    assert got.tokens.device == torch.device("cpu")
    toks = got.tokens.numpy()
    np.testing.assert_array_equal(_rows(toks),
                                  _rows(_selected_by_the_data(cfg, select)))
    if case == "domain":
        # the JAX package's lower-bound fault: its rows are the port's
        # without those before each block's scan start
        kept = _kept_by_the_jax_scan(store, select)
        assert not kept.all()
        np.testing.assert_array_equal(want.tokens, toks[kept])
        # its batch sampler, from the same seed, over the port's selection
        want.tokens = toks
        want.rng = np.random.default_rng(0)
    else:
        assert got.n_selected == want.n_selected
        np.testing.assert_array_equal(toks, want.tokens)
    for wb, gb in zip(_batches(want), _batches(got)):
        for k in ("tokens", "labels"):
            assert gb[k].dtype == torch.int32
            assert gb[k].shape == (batch, cfg.seq_width - 1)
            np.testing.assert_array_equal(gb[k].numpy(), np.asarray(wb[k]))
        np.testing.assert_array_equal(gb["tokens"][:, 1:].numpy(),
                                      gb["labels"][:, :-1].numpy())
    if case == "unfiltered":
        assert got.n_selected == 512
