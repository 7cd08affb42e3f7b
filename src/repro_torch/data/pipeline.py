"""Deterministic, shardable, **resumable** synthetic LM data pipeline.

Production shape: the pipeline is a pure function of
``(seed, host_shard, step)`` so that (a) every host generates exactly
its shard with no coordination, (b) restoring ``state`` after a
failure reproduces the exact batch stream (checkpoint includes it),
(c) elastic re-sharding just changes ``(shard, num_shards)``.

The token distribution is a order-2 Markov chain over the vocab so the
loss actually decreases during the end-to-end example runs (unlike
uniform noise).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_states: int = 64


@dataclasses.dataclass
class DataState:
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    @staticmethod
    def from_dict(d: Dict[str, int]) -> "DataState":
        return DataState(step=int(d["step"]))


class SyntheticLM:
    """Markov-chain token stream, shard-deterministic."""

    def __init__(self, cfg: DataConfig, shard: int = 0,
                 num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        base = np.random.default_rng(cfg.seed)
        m = cfg.markov_states
        # sparse-ish row-stochastic transition over m macro states
        logits = base.normal(size=(m, m)) * 2.0
        self.trans = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        self.state_tok = base.integers(0, cfg.vocab, size=m)

    def batch(self, state: DataState) -> Tuple[Dict[str, np.ndarray],
                                               DataState]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, self.shard, state.step, 0xDA7A))
        B, S = self.local_batch, cfg.seq_len
        m = cfg.markov_states
        s = rng.integers(0, m, size=B)
        toks = np.empty((B, S + 1), dtype=np.int32)
        for t in range(S + 1):
            toks[:, t] = self.state_tok[s] % cfg.vocab
            u = rng.random((B, 1))
            s = (self.trans[s].cumsum(1) > u).argmax(1)
        batch = {"tokens": toks[:, :-1],
                 "labels": toks[:, 1:].astype(np.int32)}
        return batch, DataState(step=state.step + 1)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        st = DataState()
        while True:
            b, st = self.batch(st)
            yield b
