"""Vectorized evaluation cache over (C, F) depth matrices.

DSE optimizers revisit configurations constantly (annealing plateaus,
frontier refinement, shared baselines), and several optimizers run against
the same design in one advisor session.  This cache memoizes exact
``(latency, bram, deadlock)`` triples keyed by the full depth row, shared
across every optimizer via :class:`~repro_torch.core.advisor.FifoAdvisor`.

Lookups are batched: a whole (C, F) matrix is hashed in one vectorized
pass (multiply-accumulate over uint64 lanes), then resolved through an
int-keyed dict with exact row verification against the stored config
matrix — hash collisions degrade to misses, never to wrong results.
Results live in flat, geometrically-grown arrays, so hits are gathered
with one fancy-index per batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

_HASH_SEED = 0x9E3779B97F4A7C15


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    collisions: int = 0       # true hash collisions (counted as misses)

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)


class ConfigCache:
    """Exact result memo over depth vectors, shared across optimizers."""

    def __init__(self, n_fifos: int, initial_capacity: int = 1024):
        self.n_fifos = int(n_fifos)
        self.stats = CacheStats()
        # odd multipliers -> bijective per-lane mixing before the fold
        rng = np.random.default_rng(0xF1F0)
        self._mults = (rng.integers(1, 2**63, size=max(self.n_fifos, 1),
                                    dtype=np.int64).astype(np.uint64)
                       | np.uint64(1))
        self._map: Dict[int, int] = {}
        self._n = 0
        cap = max(int(initial_capacity), 16)
        self._rows = np.zeros((cap, self.n_fifos), dtype=np.int64)
        self._lat = np.zeros(cap, dtype=np.int64)
        self._bram = np.zeros(cap, dtype=np.int64)
        self._dead = np.zeros(cap, dtype=bool)
        self._hashes = np.zeros(cap, dtype=np.uint64)
        # lazily (re)built sorted hash index for vectorized lookups;
        # entries in [_tail_start, _n) are not indexed yet
        self._sorted_h: np.ndarray = np.zeros(0, dtype=np.uint64)
        self._sorted_idx: np.ndarray = np.zeros(0, dtype=np.int64)
        self._tail_start = 0

    def __len__(self) -> int:
        return self._n

    # ------------------------------------------------------------- hashing
    def _hash_rows(self, m: np.ndarray) -> np.ndarray:
        """(C, F) int64 -> (C,) uint64 row hashes, fully vectorized.

        Multiply-shift per lane folded with one wrapping column sum (no
        per-column python loop), then a murmur-style finalizer.  Exact
        row verification backs every hit, so hash quality only affects
        the collision-miss rate, never correctness.
        """
        u = m.astype(np.uint64, copy=False)
        h = (u * self._mults[None, :]).sum(axis=1, dtype=np.uint64)
        h ^= np.uint64(_HASH_SEED)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xFF51AFD7ED558CCD)
        h ^= h >> np.uint64(29)
        return h

    # ------------------------------------------------------------- lookup
    def lookup(self, depth_matrix: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(C, F) depths -> (lat, bram, dead, miss_mask).

        Hit rows are filled from the cache; rows flagged in ``miss_mask``
        must be evaluated and then recorded via :meth:`insert`.
        """
        m = np.atleast_2d(np.asarray(depth_matrix, dtype=np.int64))
        C = m.shape[0]
        lat = np.zeros(C, dtype=np.int64)
        bram = np.zeros(C, dtype=np.int64)
        dead = np.zeros(C, dtype=bool)
        miss = np.ones(C, dtype=bool)
        if self._n:
            hashes = self._hash_rows(m)
            # vectorized hit resolution: one searchsorted over the lazily
            # maintained sorted hash index replaces the per-row dict loop
            # (the stable sort keeps the first-inserted entry first, so a
            # duplicate hash resolves to the same winner the insert-time
            # dict keeps)
            sh, sidx = self._index()
            if sh.size:
                pos = np.minimum(np.searchsorted(sh, hashes), sh.size - 1)
                idx = np.where(sh[pos] == hashes, sidx[pos], -1)
            else:
                idx = np.full(C, -1, dtype=np.int64)
            if self._tail_start < self._n:
                # entries inserted since the last index rebuild: resolve
                # the (few) rows the sorted part missed through the dict
                for i in np.flatnonzero(idx < 0):
                    idx[i] = self._map.get(int(hashes[i]), -1)
            cand = np.flatnonzero(idx >= 0)
            if cand.size:
                # exact verification: collisions fall back to miss
                ok = (self._rows[idx[cand]] == m[cand]).all(axis=1)
                self.stats.collisions += int((~ok).sum())
                hit_rows = cand[ok]
                src = idx[hit_rows]
                lat[hit_rows] = self._lat[src]
                bram[hit_rows] = self._bram[src]
                dead[hit_rows] = self._dead[src]
                miss[hit_rows] = False
        n_miss = int(miss.sum())
        self.stats.misses += n_miss
        self.stats.hits += C - n_miss
        return lat, bram, dead, miss

    def _index(self):
        """The sorted hash index, rebuilt lazily and AMORTIZED: a rebuild
        only happens once the unsorted insert tail outgrows an eighth of
        the indexed part — small tails are resolved through the dict in
        :meth:`lookup`, so the miss-heavy DSE pattern (lookup ->
        evaluate -> insert, every round) never pays an O(n log n) argsort
        per round."""
        tail = self._n - self._tail_start
        if tail > max(256, self._tail_start // 8):
            order = np.argsort(self._hashes[: self._n], kind="stable")
            self._sorted_h = self._hashes[: self._n][order]
            self._sorted_idx = order.astype(np.int64)
            self._tail_start = self._n
        return self._sorted_h, self._sorted_idx

    # ------------------------------------------------------------- insert
    def _grow_to(self, n: int):
        cap = self._rows.shape[0]
        if n <= cap:
            return
        new_cap = cap
        while new_cap < n:
            new_cap *= 2
        for name in ("_rows", "_lat", "_bram", "_dead", "_hashes"):
            old = getattr(self, name)
            shape = (new_cap,) + old.shape[1:]
            new = np.zeros(shape, dtype=old.dtype)
            new[: self._n] = old[: self._n]
            setattr(self, name, new)

    def load_rows(self, rows: np.ndarray, lat: np.ndarray,
                  bram: np.ndarray, dead: np.ndarray) -> None:
        """Bulk-restore cache contents (the snapshot warm-start path).

        ``rows`` must be the insertion-order contents of a previously
        populated cache (as snapshotted from ``_rows[:_n]``) — already
        deduplicated, so every row hash is unique and the restored
        first-winner ``_map`` matches the original insert order exactly.
        One vectorized pass instead of :meth:`insert`'s per-row loop;
        the sorted lookup index is rebuilt eagerly so the first lookup
        after a warm restart pays no argsort.
        """
        if self._n:
            raise ValueError("load_rows requires an empty cache")
        m = np.atleast_2d(np.asarray(rows, dtype=np.int64))
        C = m.shape[0]
        if C == 0:
            return
        self._grow_to(C)
        hashes = self._hash_rows(m)
        self._rows[:C] = m
        self._lat[:C] = np.asarray(lat, dtype=np.int64)
        self._bram[:C] = np.asarray(bram, dtype=np.int64)
        self._dead[:C] = np.asarray(dead, dtype=bool)
        self._hashes[:C] = hashes
        self._n = C
        self._map = {}
        for i, h in enumerate(hashes.tolist()):
            self._map.setdefault(int(h), i)
        order = np.argsort(hashes, kind="stable")
        self._sorted_h = hashes[order]
        self._sorted_idx = order.astype(np.int64)
        self._tail_start = C

    def insert(self, depth_matrix: np.ndarray, lat: np.ndarray,
               bram: np.ndarray, dead: np.ndarray):
        """Record evaluated rows (duplicates of cached rows are skipped)."""
        m = np.atleast_2d(np.asarray(depth_matrix, dtype=np.int64))
        C = m.shape[0]
        self._grow_to(self._n + C)
        hashes = self._hash_rows(m)
        for i in range(C):
            h = int(hashes[i])
            j = self._map.get(h)
            if j is not None:
                # already present (or a collision slot: keep first winner)
                continue
            j = self._n
            self._rows[j] = m[i]
            self._lat[j] = lat[i]
            self._bram[j] = bram[i]
            self._dead[j] = dead[i]
            self._hashes[j] = hashes[i]
            self._map[h] = j
            self._n += 1
