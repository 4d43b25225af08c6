"""Deterministic, shard-aware, resumable data pipeline: a numpy-only
copy of the JAX package's ``repro.data.pipeline`` (the port imports
nothing of that package), whose batches it equals bit for bit.

The batch for global step ``s`` is a pure function of (seed, s): restart
from any checkpoint reproduces the exact token stream with no iterator
state to persist — the checkpoint's step counter IS the data cursor.

Two sources:
  * synthetic: order-k Markov token chains (fast, endless; gives a real
    learnable signal so loss curves are meaningful);
  * corpus: a memory-mapped int32 token array sampled at deterministic
    offsets.

Sharding: each data-parallel rank materialises only its slice
(``batch_at(step, shard, n_shards)``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"  # synthetic | corpus
    corpus_path: str | None = None
    markov_order: int = 2


class Pipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.source == "corpus":
            if not cfg.corpus_path:
                raise ValueError("corpus source needs corpus_path")
            self.corpus = np.memmap(cfg.corpus_path, dtype=np.int32, mode="r")
        else:
            # fixed random transition structure for the Markov chain
            rng = np.random.default_rng(cfg.seed)
            self._trans = rng.integers(
                0, cfg.vocab_size, size=(min(cfg.vocab_size, 4096), 4), dtype=np.int64
            )

    # ------------------------------------------------------------------
    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Batch (tokens, labels) for a global step; pure in (step, shard)."""
        cfg = self.cfg
        per = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard, 0xDA4])
        )
        if cfg.source == "corpus":
            max_start = self.corpus.size - cfg.seq_len - 1
            starts = rng.integers(0, max_start, size=per)
            toks = np.stack(
                [self.corpus[s : s + cfg.seq_len + 1] for s in starts]
            ).astype(np.int32)
        else:
            toks = self._markov(rng, per, cfg.seq_len + 1)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def _markov(self, rng, batch: int, length: int) -> np.ndarray:
        cfg = self.cfg
        n_states = self._trans.shape[0]
        out = np.empty((batch, length), dtype=np.int64)
        state = rng.integers(0, n_states, size=batch)
        noise = rng.random((batch, length))
        choices = rng.integers(0, 4, size=(batch, length))
        rand_tok = rng.integers(0, cfg.vocab_size, size=(batch, length))
        for t in range(length):
            nxt = self._trans[state % n_states, choices[:, t]]
            tok = np.where(noise[:, t] < 0.1, rand_tok[:, t], nxt)
            out[:, t] = tok
            state = tok
        return out
