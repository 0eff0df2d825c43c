"""Event-graph condensation: exact super-event compression of the hot path.

Every evaluator in the repo pays per-event cost on raw traces of 8k-13k
events even though designs have only 32-60 FIFOs: in any realistic
schedule the vast majority of events never stall — they are pure delay
links whose completion time is exactly ``previous event + delta``.  This
module collapses each maximal run of such non-stalling events inside a
task segment into ONE super-event carrying the aggregated delta (the
max-plus composition of the chain), keeping only the *anchors*: segment
starts, task-final events, and the FIFO reads/writes whose cross edge
(data arrival or back-pressure) can actually bind.

Exactness is *not* a property of the anchor choice — it is enforced per
evaluation by a sound O(E) vectorized certificate:

1.  The condensed system is a **relaxation** of the raw one: folded
    events contribute their chain inequality (which always holds) and
    drop their cross constraint, so the condensed least fixpoint is a
    per-event **lower bound** on the raw least fixpoint.
2.  Expanding the condensed solution back to raw index space
    (``t[e] = t_cond[cond_of[e]] + off_of[e]``) and *checking* every
    folded event's dropped cross constraint makes the expansion a
    fixpoint of the **raw** system when all checks pass.  A fixpoint
    that is also a lower bound of the least fixpoint *is* the least
    fixpoint — bit-exact latency, and (since a finite raw fixpoint
    exists iff the design does not deadlock at those depths) an exact
    deadlock verdict, with no assumption on how anchors were picked.
3.  Rows whose certificate fails simply fall through to the next rung of
    the cascade and ultimately to the raw evaluator: condensation can
    only ever change *speed*, never results.

Anchor sets are therefore chosen heuristically, from stall profiles of a
few representative *probe* solves (box corner, upper bounds, occupancy,
random rows) plus a per-FIFO occupancy-profile rule for back-pressure
(a write can only stall when the FIFO can be full near its rank), tuned
for high certificate pass rates on the depth box ``row >= floor``.

See ``docs/performance.md`` for the full exactness argument, the index
mapping semantics, and measured compression/speedup numbers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bram import read_latency_np as _read_latencies
from repro_torch.core.design import READ, WRITE
from repro_torch.core.simgraph import SimGraph

__all__ = ["CondensedGraph", "condense", "condense_auto", "expand_times",
           "verify_rows"]


@dataclasses.dataclass
class CondensedGraph:
    """A :class:`~repro_torch.core.simgraph.SimGraph` compressed to its anchors.

    Duck-compatible with ``SimGraph`` (same per-event / per-fifo /
    per-task array fields, in *condensed* event space) so the worklist
    solver and the lane-aligned operand builder consume it directly.
    Extra tables carry the folded structure:

    ================  =========  ========================================
    ``orig_of``       (Ec,)      raw index of each anchor
    ``cond_of``       (E,)       covering anchor (condensed idx) per raw
                                 event; every raw event's exact time is
                                 ``t_cond[cond_of[e]] + off_of[e]``
    ``off_of``        (E,)       delta-chain offset from covering anchor
    ``data_off``      (Ec,)      offset of each anchor read's data source
                                 relative to the source's covering anchor
    ``read_off_flat`` (R,)       same, for every raw read slot (the
                                 back-pressure gather table); the paired
                                 ``read_evt_flat`` holds *condensed*
                                 anchor indices
    ``w_anchor_flat``/``w_off_flat``  write-side rank tables (delta path)
    ``cov_*``         (Nfold,)   folded ops grouped by covering anchor —
                                 the worklist scatters their stream times
                                 in bulk when the anchor completes
    ``vr_*`` / ``vw_*``          folded-read / folded-write certificate
                                 tables consumed by :func:`verify_rows`
    ================  =========  ========================================

    ``floor`` is the routing box: rows at or above it (coordinate-wise)
    have a high certificate pass rate; any row may still be attempted —
    exactness never depends on the box.
    """

    raw: SimGraph
    floor: np.ndarray
    # SimGraph-compatible per-event arrays (condensed index space)
    kind: np.ndarray
    fifo: np.ndarray
    delta: np.ndarray
    seg_start: np.ndarray
    rank: np.ndarray
    data_src: np.ndarray
    # per-fifo (raw rank semantics: streams keep full size)
    read_evt_flat: np.ndarray
    read_base: np.ndarray
    n_reads: np.ndarray
    n_writes: np.ndarray
    widths: np.ndarray
    # per-task
    last_evt: np.ndarray
    end_delay: np.ndarray
    # metadata mirrored from raw
    upper_bounds: np.ndarray
    max_occupancy: np.ndarray
    unbounded_latency: int
    # condensation extras
    data_off: np.ndarray
    read_off_flat: np.ndarray
    w_anchor_flat: np.ndarray
    w_off_flat: np.ndarray
    w_base: np.ndarray
    orig_of: np.ndarray
    cond_of: np.ndarray
    off_of: np.ndarray
    cov_ptr: np.ndarray
    cov_is_read: np.ndarray
    cov_fifo: np.ndarray
    cov_rank: np.ndarray
    cov_off: np.ndarray
    vr_idx: np.ndarray
    vr_src: np.ndarray
    vr_fifo: np.ndarray
    vw_idx: np.ndarray
    vw_fifo: np.ndarray
    vw_rank: np.ndarray
    _bound: int
    #: cascade role: "occ" (above-occupancy box: back-pressure waves
    #: vanish, so even the per-row worklist wins), "aggressive" (maximum
    #: compression, scan backends only — the worklist's cost is bound by
    #: wake-wave count, not event count), or "safe" (high pass rate)
    tag: str = "safe"

    @property
    def design(self):
        return self.raw.design

    @property
    def n_events(self) -> int:
        return int(self.kind.shape[0])

    @property
    def n_raw_events(self) -> int:
        return int(self.raw.n_events)

    @property
    def n_fifos(self) -> int:
        return int(self.widths.shape[0])

    @property
    def n_tasks(self) -> int:
        return int(self.last_evt.shape[0])

    @property
    def compression(self) -> float:
        """Raw-to-condensed event ratio (>= 1)."""
        return self.n_raw_events / max(self.n_events, 1)

    def groups(self):
        return self.raw.groups()

    def latency_upper_bound(self) -> int:
        # the RAW bound: the condensed fixpoint is a lower bound on the
        # raw one, so exceeding the raw bound still certifies deadlock,
        # while a smaller condensed-only bound could misflag feasible
        # rows whose (exact) times sit between the two bounds
        return self._bound

    def in_box(self, depth_matrix: np.ndarray) -> np.ndarray:
        """(C, F) rows -> bool mask of rows inside the routing box."""
        m = np.atleast_2d(np.asarray(depth_matrix, dtype=np.int64))
        return (m >= self.floor[None, :]).all(axis=1)


def expand_times(cg: CondensedGraph, t_cond: np.ndarray) -> np.ndarray:
    """Condensed anchor times -> exact raw per-event times.

    ``t_cond`` is (Ec,) or (C, Ec); returns (E,) or (C, E).  Only valid
    for solutions whose certificate passed (:func:`verify_rows`).
    """
    t_cond = np.asarray(t_cond)
    if t_cond.ndim == 1:
        return t_cond[cg.cond_of] + cg.off_of
    return t_cond[:, cg.cond_of] + cg.off_of[None, :]


def _stall_profile(g: SimGraph, depths: np.ndarray, state,
                   margin: int) -> Optional[tuple]:
    """Per-event near-stall masks + per-fifo occupancy profiles for one
    solved probe configuration.  Returns None when the probe deadlocked.
    """
    if state.deadlocked:
        return None
    t = state.t
    E = g.n_events
    depths = np.asarray(depths, dtype=np.int64)
    rd_lat = _read_latencies(depths, np.asarray(g.widths, dtype=np.int64))

    chain = np.empty(E, dtype=np.int64)
    chain[0] = g.delta[0]
    chain[1:] = t[:-1] + g.delta[1:]
    seg_heads = np.flatnonzero(g.seg_start)
    chain[seg_heads] = g.delta[seg_heads]

    kind = g.kind
    fifo = g.fifo.astype(np.int64)
    rank = g.rank

    read_stall = np.zeros(E, dtype=bool)
    rmask = kind == READ
    if rmask.any():
        ri = np.flatnonzero(rmask)
        cross = t[g.data_src[ri]] + rd_lat[fifo[ri]]
        read_stall[ri] = cross > chain[ri] - margin

    write_stall = np.zeros(E, dtype=bool)
    wmask = kind == WRITE
    wi = np.flatnonzero(wmask)
    if wi.size:
        f = fifo[wi]
        j = rank[wi]
        d = depths[f]
        act = (j >= d) & (j - d < g.n_reads[f])
        if act.any():
            ai = wi[act]
            fa = f[act]
            pos = g.read_base[fa] + rank[ai] - depths[fa]
            cross = t[g.read_evt_flat[pos]] + 1
            write_stall[ai] = cross > chain[ai] - margin

    # occupancy profile: in-flight element count at completion of each
    # write (rank order); a write can only back-pressure-stall at depth d
    # when the profile can reach d near its rank
    prof: List[np.ndarray] = []
    for f in range(g.n_fifos):
        wsel = wi[fifo[wi] == f]
        tw = t[wsel]                       # rank order (SPSC, one segment)
        tr = np.sort(t[np.flatnonzero(rmask & (fifo == f))])
        done = np.searchsorted(tr, tw, side="left")
        prof.append(np.arange(tw.size, dtype=np.int64) + 1 - done)
    return read_stall, write_stall, prof


def _solve(g: SimGraph, depths: np.ndarray):
    from repro_torch.core.backends.worklist import solve
    return solve(g, depths)


def _default_probes(g: SimGraph, floor: np.ndarray,
                    n_random: int, seed: int) -> List[np.ndarray]:
    """Representative in-box probe rows: box corner, upper bounds,
    midpoint, occupancy, and a few random rows — all clipped to the box
    (stalls of out-of-box schedules would pollute the anchor set with
    events that cannot stall for any admissible row)."""
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    occ = np.maximum(g.max_occupancy, 1)
    rng = np.random.default_rng(seed)
    probes = [floor, np.maximum(u, floor),
              np.maximum((floor + u) // 2, floor),
              np.maximum(occ, floor)]
    for _ in range(n_random):
        frac = rng.uniform(0.0, 1.0, g.n_fifos)
        row = floor + ((np.maximum(u, floor) - floor)
                       * frac).astype(np.int64)
        probes.append(np.maximum(row, floor))
    return probes


def condense(g: SimGraph, floor: Optional[np.ndarray] = None,
             margin: int = 2, occ_slack: int = 2, bp_rule: bool = True,
             probes: Optional[Sequence[np.ndarray]] = None,
             n_random_probes: int = 3, seed: int = 0,
             _solve_cache: Optional[dict] = None) -> CondensedGraph:
    """Build a :class:`CondensedGraph` for the box ``depths >= floor``.

    ``floor`` defaults to ``max(1, upper_bounds // 2)`` — the region DSE
    optimizers spend most of their budget in.  ``margin`` widens the
    near-stall test on probe schedules (guards the ±1-cycle SRL/BRAM
    read-latency wobble between rows); ``bp_rule``/``occ_slack`` control
    the occupancy-profile back-pressure rule (a write's stall *rank*
    moves with its depth, so point probes alone cannot cover it — the
    rule anchors every write whose in-flight profile approaches the
    floor; disabling it trades certificate pass rate for compression).
    ``probes`` overrides the probe configurations.

    The result is exact for EVERY depth row — the per-row certificate,
    not the anchor choice, carries correctness (module docstring).
    """
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    if floor is None:
        floor = np.maximum(1, u // 2)
    floor = np.asarray(floor, dtype=np.int64)
    E = g.n_events
    if E == 0:
        return _build(g, np.zeros(0, dtype=bool), floor)

    if probes is None:
        probes = _default_probes(g, floor, n_random_probes, seed)
    profiles = []
    for p in probes:
        p = np.asarray(p, dtype=np.int64)
        if _solve_cache is not None:
            key = p.tobytes()
            st = _solve_cache.get(key)
            if st is None:
                st = _solve_cache[key] = _solve(g, p)
        else:
            st = _solve(g, p)
        prof = _stall_profile(g, p, st, margin)
        if prof is not None:
            profiles.append(prof)

    anchors = np.zeros(E, dtype=bool)
    anchors[np.flatnonzero(g.seg_start)] = True
    anchors[g.last_evt[g.last_evt >= 0]] = True

    F = g.n_fifos
    prof_max: List[Optional[np.ndarray]] = [None] * F
    for read_stall, write_stall, prof in profiles:
        anchors |= read_stall
        anchors |= write_stall
        for f in range(F):
            prof_max[f] = (prof[f] if prof_max[f] is None
                           else np.maximum(prof_max[f], prof[f]))

    if bp_rule:
        wi = np.flatnonzero(g.kind == WRITE)
        for f in range(F):
            if prof_max[f] is None:
                continue
            ws = wi[g.fifo[wi] == f]
            hot = prof_max[f] + occ_slack >= floor[f]
            anchors[ws[hot[: ws.size]]] = True

    return _build(g, anchors, floor)


def _build(g: SimGraph, anchors: np.ndarray,
           floor: np.ndarray) -> CondensedGraph:
    """Materialize the condensed arrays for a given anchor set."""
    E = g.n_events
    delta = g.delta.astype(np.int64)
    anc_idx = np.flatnonzero(anchors)
    cmap = np.cumsum(anchors) - 1            # raw idx -> condensed idx
    # covering anchor per raw event (always exists: segment heads anchor)
    lastanc = np.maximum.accumulate(np.where(anchors, np.arange(E), -1))
    cond_of = cmap[lastanc]
    D = np.cumsum(delta)
    off_of = D - D[lastanc]

    # condensed deltas: the max-plus composition of the folded chain
    # between consecutive anchors (segment heads keep their own delta)
    delta_c = delta[anc_idx].copy()
    tail = anc_idx[g.seg_start[anc_idx] == 0]
    delta_c[g.seg_start[anc_idx] == 0] = delta[tail] + off_of[tail - 1]

    kind_c = g.kind[anc_idx]
    data_src_raw = g.data_src[anc_idx]
    has = data_src_raw >= 0
    data_src_c = np.where(has, cond_of[np.clip(data_src_raw, 0, E - 1)], -1)
    data_off_c = np.where(has, off_of[np.clip(data_src_raw, 0, E - 1)], 0)

    read_evt_flat_c = cond_of[g.read_evt_flat]
    read_off_flat = off_of[g.read_evt_flat]

    # write-side rank tables (incremental-solver base-stream snapshots)
    wi = np.flatnonzero(g.kind == WRITE)
    order = np.argsort(g.fifo[wi], kind="stable")   # rank order per fifo
    wflat = wi[order]
    w_anchor_flat = cond_of[wflat]
    w_off_flat = off_of[wflat]
    w_base = np.zeros(g.n_fifos, dtype=np.int64)
    np.cumsum(g.n_writes[:-1], out=w_base[1:])

    folded = np.flatnonzero(~anchors)
    cov_anchor = cond_of[folded]                    # nondecreasing
    Ec = anc_idx.size
    counts = np.bincount(cov_anchor, minlength=Ec)
    cov_ptr = np.zeros(Ec + 1, dtype=np.int64)
    np.cumsum(counts, out=cov_ptr[1:])

    fr = folded[g.kind[folded] == READ]
    fw = folded[g.kind[folded] == WRITE]

    last_evt_c = np.where(g.last_evt >= 0,
                          cmap[np.clip(g.last_evt, 0, E - 1)], -1)

    return CondensedGraph(
        raw=g, floor=floor.copy(),
        kind=kind_c.astype(np.int8),
        fifo=g.fifo[anc_idx].astype(np.int32),
        delta=delta_c,
        seg_start=g.seg_start[anc_idx].astype(np.int8),
        rank=g.rank[anc_idx].astype(np.int64),
        data_src=data_src_c.astype(np.int64),
        read_evt_flat=read_evt_flat_c.astype(np.int64),
        read_base=g.read_base.copy(), n_reads=g.n_reads.copy(),
        n_writes=g.n_writes.copy(), widths=g.widths.copy(),
        last_evt=last_evt_c.astype(np.int64), end_delay=g.end_delay.copy(),
        upper_bounds=g.upper_bounds.copy(),
        max_occupancy=g.max_occupancy.copy(),
        unbounded_latency=g.unbounded_latency,
        data_off=data_off_c.astype(np.int64),
        read_off_flat=read_off_flat.astype(np.int64),
        w_anchor_flat=w_anchor_flat.astype(np.int64),
        w_off_flat=w_off_flat.astype(np.int64),
        w_base=w_base,
        orig_of=anc_idx.astype(np.int64),
        cond_of=cond_of.astype(np.int64),
        off_of=off_of.astype(np.int64),
        cov_ptr=cov_ptr,
        cov_is_read=(g.kind[folded] == READ),
        cov_fifo=g.fifo[folded].astype(np.int64),
        cov_rank=g.rank[folded].astype(np.int64),
        cov_off=off_of[folded].astype(np.int64),
        vr_idx=fr.astype(np.int64),
        vr_src=g.data_src[fr].astype(np.int64),
        vr_fifo=g.fifo[fr].astype(np.int64),
        vw_idx=fw.astype(np.int64),
        vw_fifo=g.fifo[fw].astype(np.int64),
        vw_rank=g.rank[fw].astype(np.int64),
        _bound=int(g.latency_upper_bound()),
    )


_VERIFY_CHUNK = 128


def verify_rows(cg: CondensedGraph, depth_matrix: np.ndarray,
                t_cond: np.ndarray) -> np.ndarray:
    """The exactness certificate: (C,) bool, True where the expanded
    condensed solution is provably the raw least fixpoint.

    Checks every folded event's dropped cross constraint against the
    expanded times (module docstring, step 2).  A folded write whose
    back-pressure partner does not exist (structural deadlock at that
    row) fails the certificate, routing the row to the raw evaluator.
    """
    m = np.atleast_2d(np.asarray(depth_matrix, dtype=np.int64))
    t_cond = np.atleast_2d(np.asarray(t_cond, dtype=np.int64))
    C = m.shape[0]
    ok = np.ones(C, dtype=bool)
    g = cg.raw
    widths = np.asarray(g.widths, dtype=np.int64)
    for lo in range(0, C, _VERIFY_CHUNK):
        sl = slice(lo, min(lo + _VERIFY_CHUNK, C))
        t_hat = expand_times(cg, t_cond[sl])          # (c, E) int64
        rows = m[sl]
        good = ok[sl]
        if cg.vr_idx.size:
            lat = _read_latencies(rows, widths)       # (c, F)
            cross = t_hat[:, cg.vr_src] + lat[:, cg.vr_fifo]
            good &= ~(cross > t_hat[:, cg.vr_idx]).any(axis=1)
        if cg.vw_idx.size:
            d = rows[:, cg.vw_fifo]                   # (c, Nw)
            j = cg.vw_rank[None, :]
            act = j >= d
            nr = g.n_reads[cg.vw_fifo][None, :]
            overrun = act & (j - d >= nr)
            good &= ~overrun.any(axis=1)
            pos = np.clip(g.read_base[cg.vw_fifo][None, :] + j - d, 0,
                          max(g.read_evt_flat.size - 1, 0))
            pev = g.read_evt_flat[pos] if g.read_evt_flat.size else pos
            cross = np.take_along_axis(t_hat, pev, axis=1) + 1
            good &= ~(act & ~overrun & (cross > t_hat[:, cg.vw_idx])
                      ).any(axis=1)
        ok[sl] = good
    return ok


# --------------------------------------------------------------------------
# the auto cascade
# --------------------------------------------------------------------------

#: (tag, floor-kind, margin, occ_slack, bp_rule) per rung.  Both rungs
#: share the feasible-leaning "half" box and the back-pressure rule;
#: they differ in how wide the near-stall margins are cast:
#: "aggressive" — exact stall profiles only (margin 0, zero bp slack):
#:     25-150x compression, moderate certificate pass rate
#: "safe" — wide margins + generous bp slack: near-total pass rate at
#:     2-3x compression, the pre-raw backstop
_AUTO_RUNGS: Tuple[Tuple[str, str, int, int, bool], ...] = (
    ("aggressive", "half", 0, 0, True),
    ("safe", "half", 6, 8, True),
)


def condense_auto(g: SimGraph,
                  rungs: Sequence[Tuple[str, str, int, int, bool]]
                  = _AUTO_RUNGS,
                  seed: int = 0) -> List[CondensedGraph]:
    """Build the default condensation cascade for ``g``.

    Rungs differ in routing floor and anchor aggressiveness; probe
    solves are shared across rungs through one cache.  The cascade is
    ordered most-aggressive-first: evaluation tries each rung a row's
    box admits, falling through on certificate failure, and lands on the
    raw evaluator as the unconditional backstop.
    """
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    occ = np.maximum(g.max_occupancy, 1)
    floors = {"occ": np.maximum(occ, 2), "half": np.maximum(1, u // 2)}
    cache: dict = {}
    out = []
    for tag, kind, margin, slack, bp in rungs:
        cg = condense(g, floor=floors[kind], margin=margin,
                      occ_slack=slack, bp_rule=bp, seed=seed,
                      _solve_cache=cache)
        cg.tag = tag
        # a rung that barely compresses only adds verification overhead
        if cg.compression >= 1.25:
            out.append(cg)
    return out
