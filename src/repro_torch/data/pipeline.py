"""HailDataSource: the paper's data plane feeding the LM training loop.

A tokenized corpus lives in the HAIL block store (selection attributes +
token payload columns, see ``schema.tokens_schema``).  Training-data
selection ("train on domain=3", "quality >= 900") becomes an indexed HAIL
query: the planner routes to the replica clustered on the filter attribute,
the record reader touches only qualifying partitions, and the loader
assembles fixed-shape (batch, seq) token matrices.

The port of the JAX package's ``data/pipeline.py``.  It plans and reads
through the port's ``plan`` and plain ``read_hail`` (no kernel lies on this
path in either package: the eager upload sorts with a library sort), keeps
the selected tokens as one int32 tensor on the store's device, and draws
batch rows from the same ``np.random.default_rng(seed)`` sequence, so its
batches equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import query as q
from repro_torch.core import schema as sc
from repro_torch.core import upload as up
from repro_torch.core.store import BlockStore


@dataclasses.dataclass
class CorpusConfig:
    n_docs: int = 4096
    seq_width: int = 128          # tokens per document row
    rows_per_block: int = 1024
    vocab: int = 50_000
    n_domains: int = 16
    replication_keys: tuple = ("domain", "quality", "timestamp")
    partition_size: int = 256


def build_corpus(cfg: CorpusConfig, seed: int = 0, device=None
                 ) -> tuple[BlockStore, up.UploadStats]:
    """Generate + HAIL-upload a tokenized corpus; ``device`` None means the
    card."""
    from repro_torch.core.parse import format_rows

    schema = sc.tokens_schema(cfg.seq_width)
    cols = sc.gen_tokens_corpus(cfg.n_docs, cfg.seq_width, cfg.vocab,
                                cfg.n_domains, seed)
    enc = format_rows(schema, cols)
    n_blocks = cfg.n_docs // cfg.rows_per_block
    raw = enc.reshape(n_blocks, cfg.rows_per_block, -1)
    return up.hail_upload(schema, raw, list(cfg.replication_keys),
                          cfg.partition_size, device=device)


class HailDataSource:
    """Iterator of token batches selected by a HAIL query."""

    def __init__(self, store: BlockStore, cfg: CorpusConfig,
                 select: Optional[tuple[str, int, int]] = None,
                 batch_size: int = 8, seq_len: Optional[int] = None,
                 seed: int = 0):
        self.store = store
        self.cfg = cfg
        self.batch = batch_size
        self.seq = seq_len or cfg.seq_width
        assert self.seq <= cfg.seq_width
        query = q.HailQuery(filter=select,
                            projection=tuple(f"tok{i}" for i in range(self.seq)))
        qplan = q.plan(store, query)
        self.used_index = bool(qplan.index_scan.all()) and select is not None
        res = q.read_hail(store, query, qplan)
        toks = torch.stack([res.cols[f"tok{i}"].reshape(-1)
                            for i in range(self.seq)], dim=1)
        # (n_selected, seq) int32, qualifying rows in read order
        self.tokens = toks[res.mask.reshape(-1)]
        self.rng = np.random.default_rng(seed)

    @property
    def n_selected(self) -> int:
        return self.tokens.shape[0]

    def __iter__(self) -> Iterator[dict]:
        assert self.n_selected >= self.batch, "selection smaller than batch"
        while True:
            idx = self.rng.integers(0, self.n_selected, self.batch)
            t = self.tokens[torch.as_tensor(idx, device=self.tokens.device)]
            yield {"tokens": t[:, :-1], "labels": t[:, 1:]}
