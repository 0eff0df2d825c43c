"""Deterministic synthetic data pipeline.

Stateless by construction: batch ``i`` is a pure function of
``(seed, step i, host slice)``, so restarts resume exactly, stragglers can
skip ahead deterministically, and elastic re-sharding never replays or
drops data.  The token stream follows a fixed sparse Markov chain so a
real model's loss measurably decreases (``launch/train.py`` trains on it).

numpy only: for the same ``(seed, step, host slice)`` every batch,
frontend ``embeds`` included, is bit for bit the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    markov_degree: int = 4      # successors per token (learnable structure)


class SyntheticLM:
    """Markov-chain token stream + stub frontend embeddings."""

    def __init__(self, cfg: DataConfig, arch: Optional[ArchConfig] = None):
        self.cfg = cfg
        self.arch = arch
        rng = np.random.default_rng(cfg.seed)
        # fixed random transition structure
        self.succ = rng.integers(0, cfg.vocab,
                                 size=(cfg.vocab, cfg.markov_degree),
                                 dtype=np.int32)

    def batch(self, step: int, host_slice: slice = slice(None)
              ) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        B = c.global_batch
        toks = np.empty((B, c.seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, c.vocab, size=B)
        choices = rng.integers(0, c.markov_degree,
                               size=(B, c.seq_len))
        for t in range(c.seq_len):
            toks[:, t + 1] = self.succ[toks[:, t], choices[:, t]]
        out = {"tokens": toks[host_slice, :-1],
               "labels": toks[host_slice, 1:].astype(np.int32)}
        if self.arch is not None and self.arch.frontend_tokens:
            F = self.arch.frontend_tokens
            out["embeds"] = rng.standard_normal(
                (B, F, self.arch.d_model)).astype(np.float32)[host_slice]
        return out


def specs_for_shape(arch: ArchConfig, shape: ShapeConfig,
                    dtype=np.int32) -> Dict[str, tuple]:
    """Input array shapes for a given (arch, shape) cell — the contract
    shared by the data pipeline and launch.input_specs."""
    B, S = shape.global_batch, shape.seq_len
    F = arch.frontend_tokens
    if shape.kind == "train":
        out = {"tokens": (B, S - F), "labels": (B, S - F)}
        if F:
            out["embeds"] = (B, F, arch.d_model)
        return out
    if shape.kind == "prefill":
        out = {"tokens": (B, S - F)}
        if F:
            out["embeds"] = (B, F, arch.d_model)
        return out
    # decode: one new token against a cache of length S
    return {"tokens": (B, 1)}
