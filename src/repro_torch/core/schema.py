"""Schemas for the HAIL block store.

A *logical row* is a tuple of typed attributes.  A *block* holds a fixed
number of rows in PAX (column-major) layout: one tensor per column.  An
implicit ``__rowid__`` column (original upload position) is carried through
every per-replica sort so any replica can reconstruct the logical block —
the paper's failover invariant.

Fixed-width ASCII encoding (for the upload parse stage): each column is a
zero-padded decimal of ``ascii_width`` chars; a row is the concatenation plus
a newline.  Floats are stored as scaled integers (cents).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

ROWID = "__rowid__"


@dataclasses.dataclass(frozen=True)
class Column:
    name: str
    dtype: object = torch.int32
    ascii_width: int = 10          # chars in the text encoding
    scale: float = 1.0             # value = int / scale (adRevenue cents)


@dataclasses.dataclass(frozen=True)
class Schema:
    name: str
    columns: tuple[Column, ...]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    @property
    def row_ascii_width(self) -> int:
        return sum(c.ascii_width for c in self.columns) + 1  # + newline

    def col(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def index_of(self, name: str) -> int:
        return self.names.index(name)


# The paper's UserVisits table (Pavlo et al. [27]); strings dictionary-encoded.
USERVISITS = Schema("UserVisits", (
    Column("sourceIP"),                 # IPv4 packed to int32
    Column("destURL"),                  # dictionary id
    Column("visitDate"),                # days since epoch
    Column("adRevenue", scale=100.0),   # cents
    Column("userAgent"),                # dictionary id
    Column("countryCode"),
    Column("languageCode"),
    Column("searchWord"),               # dictionary id
    Column("duration"),
))

# The paper's Synthetic dataset: 19 integer attributes.
SYNTHETIC = Schema("Synthetic",
                   tuple(Column(f"attr{i}") for i in range(19)))

SCHEMAS = {s.name: s for s in (USERVISITS, SYNTHETIC)}


def tokens_schema(seq_width: int = 0) -> Schema:
    """LM-training corpus blocks: selection attributes + token payload ids.

    Token payloads are stored as ``seq_width`` extra columns (tok0..tokN) so
    the whole row stays PAX-decomposable; ``data.pipeline.HailDataSource``
    reassembles (rows, seq_width) token matrices from qualifying rows.
    """
    cols = [Column("doc_id"), Column("domain"), Column("quality", scale=1000.0),
            Column("timestamp"), Column("length")]
    cols += [Column(f"tok{i}", ascii_width=6) for i in range(seq_width)]
    return Schema("TokensCorpus", tuple(cols))


# ---------------------------------------------------------------------------
# Synthetic data generation (host side, numpy)
# ---------------------------------------------------------------------------


def gen_uservisits(n_rows: int, seed: int = 0) -> dict[str, np.ndarray]:
    r = np.random.default_rng(seed)
    return {
        "sourceIP": r.integers(0, 2**31 - 1, n_rows, dtype=np.int32),
        "destURL": r.integers(0, 1_000_000, n_rows, dtype=np.int32),
        "visitDate": r.integers(7000, 12000, n_rows, dtype=np.int32),  # ~1989-2002
        "adRevenue": r.integers(0, 100_000, n_rows, dtype=np.int32),   # cents
        "userAgent": r.integers(0, 10_000, n_rows, dtype=np.int32),
        "countryCode": r.integers(0, 250, n_rows, dtype=np.int32),
        "languageCode": r.integers(0, 100, n_rows, dtype=np.int32),
        "searchWord": r.integers(0, 100_000, n_rows, dtype=np.int32),
        "duration": r.integers(0, 10_000, n_rows, dtype=np.int32),
    }


def gen_synthetic(n_rows: int, seed: int = 0) -> dict[str, np.ndarray]:
    r = np.random.default_rng(seed)
    return {f"attr{i}": r.integers(0, 2**20, n_rows, dtype=np.int32)
            for i in range(19)}


def gen_tokens_corpus(n_rows: int, seq_width: int, vocab: int = 50000,
                      n_domains: int = 16, seed: int = 0) -> dict[str, np.ndarray]:
    r = np.random.default_rng(seed)
    d = {
        "doc_id": np.arange(n_rows, dtype=np.int32),
        "domain": r.integers(0, n_domains, n_rows, dtype=np.int32),
        "quality": r.integers(0, 1000, n_rows, dtype=np.int32),
        "timestamp": r.integers(0, 1 << 20, n_rows, dtype=np.int32),
        "length": r.integers(seq_width // 2, seq_width, n_rows, dtype=np.int32),
    }
    for i in range(seq_width):
        d[f"tok{i}"] = r.integers(0, vocab, n_rows, dtype=np.int32)
    return d
