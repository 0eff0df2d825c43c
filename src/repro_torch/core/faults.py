"""Deterministic fault-injection plane for chaos testing.

A :class:`FaultPlan` is a *schedule* of faults — crash worker lane ``k``
at its ``j``-th job, hang an evaluation past its deadline, corrupt byte
``b`` of a snapshot member, drop a client connection after frame ``n``,
delay a dispatch, abort a snapshot save mid-write — installed through
:class:`~repro_torch.core.config.EvalConfig` (``faults=`` holds the plan's
JSON) or the ``REPRO_FAULTS`` environment variable, and consulted at
fixed injection points.  The plan format, the kinds and the variable are
the reference package's, so one plan file drives both packages: the
worker-pool kinds (``crash_worker``, ``hang_worker``,
``delay_dispatch``) fire in the campaign pool, ``hang_eval`` in the
service's cross-session batcher, ``corrupt_snapshot`` and ``crash_save``
in the snapshot writer, and ``drop_conn`` in the server's connection
sender (:mod:`repro_torch.launch.serve`).

Everything is deterministic: a plan is a finite, ordered tuple of
:class:`Fault` records with explicit trigger indices, each fault fires
at most once, and :meth:`FaultPlan.random` derives a schedule from a
seed so the chaos harness (``python -m repro_torch.launch.fuzz --mode
chaos``) can replay any failing schedule exactly.  The recovery
machinery the plan exercises (lane respawn + requeue, E_TIMEOUT
deadlines, snapshot quarantine) is held to the repo-wide bar: the final
result under an injected fault schedule must be bit-identical to the
fault-free run (or, where work is genuinely lost, fail loudly with a
stable error code and keep the evaluated prefix).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Fault", "FaultPlan", "InjectedFault", "FAULT_KINDS",
           "resolve_plan", "check_worker_faults"]

#: every injection point the runtime consults, and what ``at`` indexes:
#:
#: ``crash_worker``     worker lane exits hard (``os._exit``) right
#:                      before evaluating its ``at``-th job since (re)spawn.
#: ``hang_worker``      worker lane sleeps ``value`` seconds before its
#:                      ``at``-th job — past the pool's recv deadline it
#:                      is declared dead and replaced.
#: ``delay_dispatch``   parent sleeps ``value`` seconds before shipping
#:                      job ``at`` to lane ``lane`` (scheduling jitter).
#: ``hang_eval``        a service evaluation round stalls ``value``
#:                      seconds at session round ``at`` (per-request
#:                      deadline -> E_TIMEOUT).
#: ``corrupt_snapshot`` flip byte ``value`` of the ``at``-th snapshot
#:                      member written (torn write: the manifest keeps
#:                      the good hash, so load quarantines the member).
#: ``crash_save``       abort a snapshot save (InjectedFault) before
#:                      writing member ``at`` (``at == n_designs``
#:                      aborts just before the manifest replace).
#: ``drop_conn``        server closes a client connection after sending
#:                      ``at`` frames (client re-attaches + replays).
FAULT_KINDS = ("crash_worker", "hang_worker", "delay_dispatch",
               "hang_eval", "corrupt_snapshot", "crash_save",
               "drop_conn")

#: fault kinds executed *inside* worker processes (shipped to the lane
#: at spawn; everything else fires in the parent)
_WORKER_KINDS = ("crash_worker", "hang_worker")


class InjectedFault(RuntimeError):
    """Raised at an injection point that simulates a hard process death
    (e.g. ``crash_save``).  Never raised unless a plan schedules it."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    Args:
        kind: one of :data:`FAULT_KINDS`.
        at: trigger index — what it counts depends on ``kind`` (job #
            within a worker incarnation, session round #, snapshot
            member #, frames sent on a connection).
        lane: worker lane the fault targets; ``-1`` matches any lane.
        target: design / session the fault targets; ``""`` matches any.
        value: kind-specific magnitude — seconds to hang/delay, or the
            byte offset to corrupt.
    """

    kind: str
    at: int = 0
    lane: int = -1
    target: str = ""
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}")
        object.__setattr__(self, "at", int(self.at))
        object.__setattr__(self, "lane", int(self.lane))
        object.__setattr__(self, "value", float(self.value))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Fault":
        return cls(**d)


class FaultPlan:
    """An ordered schedule of faults with fire-once consumption.

    The plan itself is immutable; the *fired* set is runtime state, so a
    plan instance belongs to one run (rebuild from JSON to rerun the
    same schedule).
    """

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self._fired = [False] * len(self.faults)

    # ------------------------------------------------------------ querying
    def take(self, kind: str, *, lane: Optional[int] = None,
             at: Optional[int] = None,
             targets: Sequence[str] = ()) -> Optional[Fault]:
        """Consume and return the first unfired fault matching the
        caller's injection point, or None.

        A fault field set to its wildcard (``lane=-1`` / ``target=""``)
        matches any caller value; ``at`` always matches exactly, so
        callers consult the plan at every step of their counter.
        """
        for i, f in enumerate(self.faults):
            if self._fired[i] or f.kind != kind:
                continue
            if lane is not None and f.lane >= 0 and f.lane != lane:
                continue
            if at is not None and f.at != at:
                continue
            if targets and f.target and f.target not in targets:
                continue
            self._fired[i] = True
            return f
        return None

    def consume_worker_fault(self, lane: int) -> Optional[Fault]:
        """Mark the worker-side fault that just killed/hung ``lane`` as
        fired (the one with the smallest ``at`` among that lane's unfired
        worker faults — the first its incarnation would have hit), so the
        respawned lane is shipped only the remaining schedule."""
        best = None
        for i, f in enumerate(self.faults):
            if self._fired[i] or f.kind not in _WORKER_KINDS:
                continue
            if f.lane >= 0 and f.lane != lane:
                continue
            if best is None or f.at < self.faults[best].at:
                best = i
        if best is None:
            return None
        self._fired[best] = True
        return self.faults[best]

    def worker_payload(self, lane: int) -> List[dict]:
        """The unfired worker-side faults for ``lane``, as plain dicts a
        spawned child can act on without importing this module's state."""
        return [f.to_dict() for i, f in enumerate(self.faults)
                if not self._fired[i] and f.kind in _WORKER_KINDS
                and (f.lane < 0 or f.lane == lane)]

    @property
    def n_fired(self) -> int:
        return sum(self._fired)

    @property
    def all_fired(self) -> bool:
        return all(self._fired)

    def __len__(self) -> int:
        return len(self.faults)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FaultPlan({len(self.faults)} faults, "
                f"{self.n_fired} fired)")

    # ------------------------------------------------------ serialization
    def to_dict(self) -> dict:
        return {"faults": [f.to_dict() for f in self.faults]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls([Fault.from_dict(f) for f in d.get("faults", ())])

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.from_dict(json.loads(s))

    # ----------------------------------------------------------- factories
    @classmethod
    def random(cls, seed: int, *, n_lanes: int = 2, n_jobs: int = 2,
               kinds: Sequence[str] = _WORKER_KINDS + ("delay_dispatch",),
               n_faults: Optional[int] = None, hang_s: float = 1.0,
               delay_s: float = 0.01) -> "FaultPlan":
        """A seeded schedule of pool faults, each guaranteed to be
        *reachable* (lane < n_lanes, at < n_jobs) so chaos runs can
        assert the whole schedule fired."""
        import numpy as np

        rng = np.random.default_rng(seed)
        n = int(n_faults if n_faults is not None
                else 1 + rng.integers(0, 2))
        faults = []
        for _ in range(n):
            kind = kinds[int(rng.integers(len(kinds)))]
            value = {"hang_worker": hang_s,
                     "delay_dispatch": delay_s}.get(kind, 0.0)
            faults.append(Fault(kind, at=int(rng.integers(n_jobs)),
                                lane=int(rng.integers(n_lanes)),
                                value=value))
        return cls(faults)


def check_worker_faults(faults: List[dict], job_index: int) -> None:
    """Worker-side injection point: called by ``_worker_main`` before
    evaluating its ``job_index``-th job.  ``crash_worker`` exits the
    process hard (no cleanup — exactly how a segfault or OOM-kill
    looks to the parent); ``hang_worker`` sleeps past the pool's recv
    deadline."""
    import time

    for f in faults:
        if f["at"] != job_index:
            continue
        if f["kind"] == "crash_worker":
            os._exit(23)
        if f["kind"] == "hang_worker":
            time.sleep(float(f["value"]))


def resolve_plan(config=None,
                 env: Optional[Dict[str, str]] = None
                 ) -> Optional[FaultPlan]:
    """The plan installed for this run, or None (the overwhelmingly
    common case — no plan means every injection point is a no-op).

    Precedence: ``config.faults`` (an :class:`EvalConfig` carrying the
    plan's JSON) beats the ``REPRO_FAULTS`` environment variable, which
    holds either inline JSON or ``@/path/to/plan.json``.
    """
    spec = getattr(config, "faults", None)
    if not spec:
        spec = (env if env is not None else os.environ).get(
            "REPRO_FAULTS", "")
    if not spec:
        return None
    if spec.startswith("@"):
        with open(spec[1:], "r", encoding="utf-8") as f:
            spec = f.read()
    return FaultPlan.from_json(spec)
