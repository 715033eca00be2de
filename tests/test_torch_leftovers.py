"""Small functions of modules already ported, against the JAX package: the
paper's cluster presets (``configs/hail_demo``), ``ClusteredIndex``, the
block-size helpers of ``core/parse`` and ``checksum.verify_block``, and the
LM corpus schema and generator of ``core/schema``.

Tolerances: none; every comparison is exact.  Schemas are compared column
by column on name, ASCII width and scale (the dtype is numpy's in one
package and torch's in the other, int32 in both)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.configs import hail_demo as jdemo  # noqa: E402
from repro.core import checksum as jck  # noqa: E402
from repro.core import index as jidx  # noqa: E402
from repro.core import parse as jps  # noqa: E402
from repro.core import schema as jsc  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.configs import hail_demo as demo  # noqa: E402
from repro_torch.core import checksum as ck  # noqa: E402
from repro_torch.core import index as idx  # noqa: E402
from repro_torch.core import parse as ps  # noqa: E402
from repro_torch.core import schema as sc  # noqa: E402

PRESETS = ["USERVISITS_DEMO", "SYNTHETIC_DEMO", "SCALEOUT_50",
           "SCALEOUT_100"]


def _columns(schema):
    return schema.name, [(c.name, c.ascii_width, c.scale)
                         for c in schema.columns]


@pytest.mark.parametrize("name", PRESETS)
def test_hail_demo_presets_match_reference(name):
    want, got = getattr(jdemo, name), getattr(demo, name)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in ("name", "sort_keys", "rows_per_block", "n_blocks",
              "partition_size"):
        assert getattr(got, f) == getattr(want, f), f
    assert _columns(got.schema) == _columns(want.schema)
    assert dataclasses.asdict(got.cluster) == dataclasses.asdict(want.cluster)


def test_clustered_index_matches_reference():
    want = jidx.ClusteredIndex(key="visitDate", partition_size=1024)
    got = tcore.ClusteredIndex(key="visitDate", partition_size=1024)
    assert got is not None and tcore.ClusteredIndex is idx.ClusteredIndex
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.key = "sourceIP"


@pytest.mark.parametrize("which", ["USERVISITS", "SYNTHETIC", "tokens513"])
def test_block_bytes_match_reference(which):
    if which == "tokens513":
        jschema, schema = jsc.tokens_schema(513), sc.tokens_schema(513)
    else:
        jschema, schema = getattr(jsc, which), getattr(sc, which)
    for rows in (1, 4096, 1 << 19):
        assert ps.block_binary_bytes(schema, rows) == \
            jps.block_binary_bytes(jschema, rows)
        assert ps.block_ascii_bytes(schema, rows) == \
            jps.block_ascii_bytes(jschema, rows)


def test_verify_block_matches_reference():
    """Both packages find a clean block true and the block with one value
    flipped false, for each of its columns."""
    cols = sc.gen_uservisits(1024, seed=3)
    jsums = jck.block_checksums(cols)
    tcols = {c: torch.from_numpy(v) for c, v in cols.items()}
    sums = ck.block_checksums(tcols)
    for c in cols:
        np.testing.assert_array_equal(np.asarray(jsums[c]),
                                      sums[c].numpy().astype(np.uint32))
    ok = ck.verify_block(tcols, sums)
    assert ok.dim() == 0 and ok.dtype == torch.bool
    assert bool(ok) and bool(jck.verify_block(cols, jsums))
    for c in cols:
        bad = dict(cols)
        bad[c] = cols[c].copy()
        bad[c][517] ^= 1
        tbad = dict(tcols)
        tbad[c] = torch.from_numpy(bad[c])
        assert not bool(jck.verify_block(bad, jsums))
        assert not bool(ck.verify_block(tbad, sums))


@pytest.mark.parametrize("seq_width", [0, 32, 513])
def test_tokens_schema_matches_reference(seq_width):
    assert _columns(sc.tokens_schema(seq_width)) == \
        _columns(jsc.tokens_schema(seq_width))
    assert sc.tokens_schema(seq_width).row_ascii_width == \
        jsc.tokens_schema(seq_width).row_ascii_width


@pytest.mark.parametrize("n_rows,seq_width,vocab,n_domains,seed",
                         [(512, 32, 50_000, 8, 5), (300, 513, 128_256, 16, 0)])
def test_gen_tokens_corpus_matches_reference(n_rows, seq_width, vocab,
                                             n_domains, seed):
    want = jsc.gen_tokens_corpus(n_rows, seq_width, vocab, n_domains, seed)
    got = sc.gen_tokens_corpus(n_rows, seq_width, vocab, n_domains, seed)
    assert list(got) == list(want)
    for c in want:
        assert got[c].dtype == want[c].dtype == np.int32
        np.testing.assert_array_equal(got[c], want[c])
