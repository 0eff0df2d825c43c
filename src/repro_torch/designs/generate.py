"""Seeded random design generator for design-space fuzzing.

Generates Stream-HLS-like affine loader/compute/store pipelines (via the
stage builders in :mod:`repro_torch.designs.builder`) interleaved with
data-dependent control-flow motifs in the style of
:mod:`repro_torch.designs.ddcf` — value-dependent branches, phase-alternating
producers, run-length expanders — so the evaluator stack can be stressed
far beyond the hand-written benchmark suite.

Every generated design is described by a fully *serializable*
:class:`DesignSpec` (plain ints/floats/strings), which buys three things
at once:

* **determinism** — ``build_design(spec)`` always reconstructs the same
  :class:`~repro_torch.core.design.Design`;
* **shrinking** — a mismatch found by the fuzzer is minimized by
  structural reductions over the spec (:func:`shrink_spec`), not over
  opaque Python closures;
* **corpus files** — minimal reproducing specs serialize to JSON and are
  replayed by CI as regression tests (``docs/fuzzing.md``).

Every design also carries a **numpy functional reference**: the expected
value stream is computed stage by stage with plain numpy while the design
is being built, so the functional outputs recorded by the tracer and the
oracle (``ctx.result``) can be checked against an independent model.

Grammar (see ``docs/fuzzing.md`` for the full write-up)::

    design  := source stage* sink
    source  := plain(n, lanes, ii, start_delay)      # memory loader
             | phase(n, lanes)                       # mult_by_2-style DDCF
    stage   := map(fn, ii, extra_delay)              # elementwise
             | conv(taps, ii)                        # sliding window
             | residual(fn, ii)                      # fork + map + join
             | matvec(rows, ii, row_overhead)        # count-changing
             | expand(ii)                            # DDCF run-length
             | router(ii)                            # DDCF value branch
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.design import Design
from repro_torch.designs.builder import (conv_stage, fork_stage,
                                         join_stage, map_stage,
                                         matvec_stage, producer, sink,
                                         streams)

__all__ = [
    "DesignSpec", "GeneratedDesign", "StageSpec", "build_design",
    "generate_design", "shrink_spec", "spec_from_seed",
]

#: elementwise functions usable by map/residual stages, by name (specs
#: store the name so they stay JSON-serializable)
MAP_FNS: Dict[str, Callable[[float], float]] = {
    "relu": lambda v: v if v > 0 else 0.0,
    "halve": lambda v: 0.5 * v,
    "offset": lambda v: v + 0.25,
    "negate": lambda v: -v,
}

_MAP_FNS_NP: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "relu": lambda v: np.maximum(v, 0.0),
    "halve": lambda v: 0.5 * v,
    "offset": lambda v: v + 0.25,
    "negate": lambda v: -v,
}

STAGE_KINDS = ("map", "conv", "residual", "matvec", "expand", "router")


@dataclasses.dataclass
class StageSpec:
    """One pipeline stage: a kind from the grammar plus its parameters."""

    kind: str
    params: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, object]:
        return {"kind": self.kind, "params": dict(self.params)}

    @staticmethod
    def from_json(obj: Dict[str, object]) -> "StageSpec":
        return StageSpec(kind=str(obj["kind"]),
                         params=dict(obj.get("params", {})))


@dataclasses.dataclass
class DesignSpec:
    """Serializable description of one generated design.

    ``seed`` drives only the input *values*; the structure is entirely
    explicit, so shrinking can edit it field by field.
    """

    seed: int
    n: int                      # source token count
    lanes: int                  # stream-array width for affine stages
    ii: int                     # source initiation interval
    start_delay: int            # source start offset (cycles)
    source: str                 # "plain" | "phase"
    stages: List[StageSpec] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict[str, object]:
        return {
            "seed": self.seed, "n": self.n, "lanes": self.lanes,
            "ii": self.ii, "start_delay": self.start_delay,
            "source": self.source,
            "stages": [s.to_json() for s in self.stages],
        }

    @staticmethod
    def from_json(obj: Dict[str, object]) -> "DesignSpec":
        return DesignSpec(
            seed=int(obj["seed"]), n=int(obj["n"]), lanes=int(obj["lanes"]),
            ii=int(obj["ii"]), start_delay=int(obj["start_delay"]),
            source=str(obj["source"]),
            stages=[StageSpec.from_json(s) for s in obj.get("stages", [])])

    @property
    def affine_only(self) -> bool:
        """True when every stage is affine (static trip counts and FIFO
        access order fixed at build time): a plain source and no
        ``expand``/``router`` stages.  On these designs the analytical
        channel bounds (:mod:`repro_torch.core.bounds`) are closed-form and
        exact — the fuzz ``bounds`` mode asserts it."""
        return (self.source == "plain"
                and all(s.kind not in ("expand", "router")
                        for s in self.stages))

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=1, sort_keys=True)

    @staticmethod
    def loads(text: str) -> "DesignSpec":
        return DesignSpec.from_json(json.loads(text))


@dataclasses.dataclass
class GeneratedDesign:
    """A built design plus its independently computed expected outputs."""

    spec: DesignSpec
    design: Design
    expected: Dict[str, float]   # result key -> numpy-reference value

    def check_results(self, results: Dict[str, float],
                      rtol: float = 1e-8, atol: float = 1e-9) -> bool:
        """True when ``results`` (from the tracer or the oracle) matches
        the numpy reference on every expected key."""
        for key, want in self.expected.items():
            got = results.get(key)
            if got is None:
                return False
            if not np.isclose(float(got), want, rtol=rtol, atol=atol):
                return False
        return True


# ---------------------------------------------------------------------------
# seed -> spec
# ---------------------------------------------------------------------------

def spec_from_seed(seed: int, quick: bool = False) -> DesignSpec:
    """Derive a :class:`DesignSpec` deterministically from ``seed``.

    ``quick`` shrinks token counts and stage counts so CI-bounded fuzz
    campaigns stay within their time budget.
    """
    rng = random.Random(seed * 2654435761 + 17)
    n = rng.randrange(6, 25) if quick else rng.randrange(8, 65)
    lanes = rng.choice((1, 2, 4))
    ii = rng.choice((1, 1, 2))
    start_delay = rng.choice((0, 0, 1, 4, 8))
    source = "phase" if rng.random() < 0.3 else "plain"
    n_stages = rng.randrange(1, 4) if quick else rng.randrange(1, 5)
    stages: List[StageSpec] = []
    for _ in range(n_stages):
        kind = rng.choices(
            STAGE_KINDS, weights=(25, 20, 15, 10, 15, 15))[0]
        if kind == "map":
            stages.append(StageSpec("map", {
                "fn": rng.choice(sorted(MAP_FNS)),
                "ii": rng.choice((1, 2)),
                "extra_delay": rng.choice((0, 0, 1, 3)),
            }))
        elif kind == "conv":
            stages.append(StageSpec("conv", {
                "taps": rng.choice((3, 5)),
                "ii": rng.choice((1, 2)),
            }))
        elif kind == "residual":
            stages.append(StageSpec("residual", {
                "fn": rng.choice(sorted(MAP_FNS)),
                "ii": rng.choice((1, 2)),
            }))
        elif kind == "matvec":
            stages.append(StageSpec("matvec", {
                "rows": rng.randrange(4, 13) if quick
                else rng.randrange(4, 33),
                "ii": 1,
                "row_overhead": rng.choice((0, 2, 4)),
            }))
        elif kind == "expand":
            stages.append(StageSpec("expand", {"ii": rng.choice((1, 2))}))
        else:  # router
            stages.append(StageSpec("router", {"ii": rng.choice((1, 2))}))
    return DesignSpec(seed=seed, n=n, lanes=lanes, ii=ii,
                      start_delay=start_delay, source=source, stages=stages)


def _source_values(spec: DesignSpec) -> np.ndarray:
    """Deterministic input values in [-1, 1) (exact dyadic floats, so the
    python-loop design arithmetic and the numpy reference agree bit for
    bit)."""
    rng = random.Random(spec.seed ^ 0x5EED)
    return np.asarray([rng.randrange(-512, 512) / 512.0
                       for _ in range(max(spec.n, 1))], dtype=np.float64)


# ---------------------------------------------------------------------------
# DDCF stage task programs (lane-1 streams; affine stages carry the lanes)
# ---------------------------------------------------------------------------

def _phase_source(d: Design, out, a_vals: Sequence[float],
                  b_vals: Sequence[float]) -> None:
    """mult_by_2-style two-phase producer + alternating consumer: stream A
    is filled completely before stream B, the consumer interleaves reads —
    deadlock-free sizing of A requires knowing ``n`` at runtime."""
    pa = d.fifo("phase_a", width=32)
    pb = d.fifo("phase_b", width=32)

    def prod(ctx, a=tuple(a_vals), b=tuple(b_vals)):
        for v in a:
            yield ctx.delay(1)
            yield ctx.write(pa, v)
        for v in b:
            yield ctx.delay(1)
            yield ctx.write(pb, v)

    def cons(ctx, out=tuple(out), n=len(a_vals)):
        for i in range(n):
            yield ctx.delay(1)
            x = yield ctx.read(pa)
            y = yield ctx.read(pb)
            yield ctx.write(out[i % len(out)], x + y)

    d.add_task("phase_src", prod, data_dependent=True)
    d.add_task("phase_mix", cons, data_dependent=True)


def _expand_stage(d: Design, k: int, inp, out, count: int, ii: int) -> None:
    """DDCF run-length expander/contractor pair.

    The expander derives a per-element repeat count from the *value* it
    reads (``1 + floor(|v| * 8) % 3``), announces it on a count stream,
    and emits that many copies; the contractor's inner trip count is
    therefore known only at kernel runtime (the paper's §IV-D argument).
    """
    cnt = d.fifo(f"exp{k}_cnt", width=8)
    data = d.fifo(f"exp{k}_data", width=32)

    def expander(ctx, inp=tuple(inp), n=count, ii=ii):
        for i in range(n):
            yield ctx.delay(ii)
            v = yield ctx.read(inp[i % len(inp)])
            r = 1 + int(abs(v) * 8.0) % 3
            yield ctx.write(cnt, r)
            for _ in range(r):
                yield ctx.delay(1)
                yield ctx.write(data, v)

    def contractor(ctx, out=tuple(out), n=count):
        for i in range(n):
            yield ctx.delay(1)
            r = yield ctx.read(cnt)
            acc = 0.0
            for _ in range(r):
                v = yield ctx.read(data)
                acc += v
            yield ctx.write(out[i % len(out)], acc)

    d.add_task(f"expand{k}", expander, data_dependent=True)
    d.add_task(f"contract{k}", contractor, data_dependent=True)


def _expand_ref(vals: np.ndarray) -> np.ndarray:
    r = 1 + np.floor(np.abs(vals) * 8.0).astype(np.int64) % 3
    return vals * r


def _router_stage(d: Design, k: int, inp, out, count: int, ii: int) -> None:
    """DDCF value-dependent branch: route positives/non-positives onto two
    streams, then publish the positive count; the merger reads the count
    FIRST, so both branch FIFOs must buffer their whole partition before
    any draining starts — the branch split (and thus the minimal safe
    depths) is a property of the runtime values.
    """
    pos = d.fifo(f"rt{k}_pos", width=32)
    neg = d.fifo(f"rt{k}_neg", width=32)
    cnt = d.fifo(f"rt{k}_cnt", width=16)

    def route(ctx, inp=tuple(inp), n=count, ii=ii):
        n_pos = 0
        for i in range(n):
            yield ctx.delay(ii)
            v = yield ctx.read(inp[i % len(inp)])
            if v > 0:
                yield ctx.write(pos, v)
                n_pos += 1
            else:
                yield ctx.write(neg, v)
        yield ctx.write(cnt, n_pos)

    def merge(ctx, out=tuple(out), n=count):
        c = yield ctx.read(cnt)
        for i in range(c):
            yield ctx.delay(1)
            v = yield ctx.read(pos)
            yield ctx.write(out[i % len(out)], v)
        for i in range(n - c):
            yield ctx.delay(1)
            v = yield ctx.read(neg)
            yield ctx.write(out[(c + i) % len(out)], v)

    d.add_task(f"route{k}", route, data_dependent=True)
    d.add_task(f"merge{k}", merge, data_dependent=True)


def _router_ref(vals: np.ndarray) -> np.ndarray:
    return np.concatenate([vals[vals > 0], vals[vals <= 0]])


def _conv_ref(vals: np.ndarray, taps: int, weight: float) -> np.ndarray:
    out = np.empty_like(vals)
    for i in range(vals.shape[0]):
        out[i] = weight * float(vals[max(0, i - taps + 1): i + 1].sum())
    return out


# ---------------------------------------------------------------------------
# spec -> design + reference
# ---------------------------------------------------------------------------

def build_design(spec: DesignSpec) -> GeneratedDesign:
    """Construct the :class:`~repro_torch.core.design.Design` for ``spec`` and,
    in lockstep, its numpy functional reference.

    The returned :class:`GeneratedDesign` carries the expected value of
    every ``ctx.result`` key the design records, computed purely with
    numpy over the known source values — never by running either
    simulation engine.
    """
    d = Design(f"fuzz_{spec.seed}")
    vals = _source_values(spec)
    lanes = max(1, spec.lanes)

    cur = streams(d, "src", lanes)
    if spec.source == "phase":
        b_vals = -0.5 * vals
        _phase_source(d, cur, vals.tolist(), b_vals.tolist())
        vals = vals + b_vals
    else:
        producer(d, "load", cur, vals.tolist(), ii=spec.ii,
                 start_delay=spec.start_delay)

    for k, st in enumerate(spec.stages):
        p = st.params
        count = vals.shape[0]
        if st.kind == "map":
            out = streams(d, f"s{k}", lanes)
            map_stage(d, f"map{k}", cur, out, count,
                      fn=MAP_FNS[str(p["fn"])], ii=int(p.get("ii", 1)),
                      extra_delay=int(p.get("extra_delay", 0)))
            vals = _MAP_FNS_NP[str(p["fn"])](vals)
        elif st.kind == "conv":
            out = streams(d, f"s{k}", lanes)
            conv_stage(d, f"conv{k}", cur, out, count,
                       taps=int(p["taps"]), weight=0.125,
                       ii=int(p.get("ii", 1)))
            vals = _conv_ref(vals, int(p["taps"]), 0.125)
        elif st.kind == "residual":
            skip = streams(d, f"s{k}_skip", lanes)
            main = streams(d, f"s{k}_main", lanes)
            mapped = streams(d, f"s{k}_map", lanes)
            out = streams(d, f"s{k}", lanes)
            fork_stage(d, f"fork{k}", cur, skip, main, count,
                       ii=int(p.get("ii", 1)))
            map_stage(d, f"rmap{k}", main, mapped, count,
                      fn=MAP_FNS[str(p["fn"])])
            join_stage(d, f"join{k}", skip, mapped, out, count)
            vals = vals + _MAP_FNS_NP[str(p["fn"])](vals)
        elif st.kind == "matvec":
            rows = int(p["rows"])
            out = streams(d, f"s{k}", lanes)
            matvec_stage(d, f"mv{k}", cur, out, rows=rows, cols=count,
                         weight=0.0625, ii=int(p.get("ii", 1)),
                         row_overhead=int(p.get("row_overhead", 2)),
                         reuse_input=True)
            vals = np.full(rows, 0.0625 * float(vals.sum()))
        elif st.kind == "expand":
            out = streams(d, f"s{k}", lanes)
            _expand_stage(d, k, cur, out, count, ii=int(p.get("ii", 1)))
            vals = _expand_ref(vals)
        elif st.kind == "router":
            out = streams(d, f"s{k}", lanes)
            _router_stage(d, k, cur, out, count, ii=int(p.get("ii", 1)))
            vals = _router_ref(vals)
        else:
            raise ValueError(f"unknown stage kind {st.kind!r}")
        cur = out

    sink(d, "store", cur, vals.shape[0], result_key="out")
    expected = {"out": float(vals.sum())}
    return GeneratedDesign(spec=spec, design=d, expected=expected)


def generate_design(seed: int, quick: bool = False) -> GeneratedDesign:
    """One-call front door: seed -> spec -> built design + reference."""
    return build_design(spec_from_seed(seed, quick=quick))


# ---------------------------------------------------------------------------
# shrinking
# ---------------------------------------------------------------------------

def _reductions(spec: DesignSpec) -> List[DesignSpec]:
    """Candidate one-step structural reductions of ``spec``, most
    aggressive first (drop whole stages before shrinking scalars)."""
    out: List[DesignSpec] = []
    for i in range(len(spec.stages)):
        r = DesignSpec.from_json(spec.to_json())
        del r.stages[i]
        out.append(r)
    if spec.n > 2:
        r = DesignSpec.from_json(spec.to_json())
        r.n = max(2, spec.n // 2)
        out.append(r)
    if spec.lanes > 1:
        r = DesignSpec.from_json(spec.to_json())
        r.lanes = 1
        out.append(r)
    if spec.source == "phase":
        r = DesignSpec.from_json(spec.to_json())
        r.source = "plain"
        out.append(r)
    if spec.start_delay or spec.ii > 1:
        r = DesignSpec.from_json(spec.to_json())
        r.start_delay, r.ii = 0, 1
        out.append(r)
    for i, st in enumerate(spec.stages):
        if st.kind == "matvec" and int(st.params["rows"]) > 2:
            r = DesignSpec.from_json(spec.to_json())
            r.stages[i].params["rows"] = max(2, int(st.params["rows"]) // 2)
            out.append(r)
    return out


def shrink_spec(spec: DesignSpec,
                still_fails: Callable[[DesignSpec], bool],
                max_steps: int = 200) -> DesignSpec:
    """Greedy structural shrink: repeatedly apply the first reduction that
    still reproduces the failure (``still_fails``) until none does.

    ``still_fails`` must treat a design that errors during build/trace as
    NOT reproducing (the shrink must preserve the original failure mode,
    not trade it for a different crash).
    """
    cur = spec
    for _ in range(max_steps):
        for cand in _reductions(cur):
            try:
                reproduced = still_fails(cand)
            except Exception:
                reproduced = False
            if reproduced:
                cur = cand
                break
        else:
            return cur
    return cur


def load_corpus_specs(paths: Sequence[str]) -> List[DesignSpec]:
    """Parse corpus JSON files (written by the fuzzer's shrink stage).

    Accepts full corpus entries (``{"spec": ...}``) and bare spec
    objects; anything else in the corpus directory is a hard error with
    the offending filename (a campaign report dropped there by mistake
    must not be silently skipped OR cryptically crash the replay).
    """
    specs = []
    for path in paths:
        with open(path) as f:
            obj = json.load(f)
        try:
            if not isinstance(obj, dict):
                raise TypeError(f"expected a JSON object, got "
                                f"{type(obj).__name__}")
            specs.append(DesignSpec.from_json(obj.get("spec", obj)))
        except (KeyError, TypeError, ValueError) as exc:
            raise ValueError(
                f"corpus file {path!r} is not a DesignSpec corpus entry "
                f"({type(exc).__name__}: {exc})") from exc
    return specs


def corpus_entry(spec: DesignSpec, note: str,
                 mismatch: Optional[Dict[str, object]] = None
                 ) -> Dict[str, object]:
    """JSON payload for one corpus file: the minimal spec + provenance."""
    out: Dict[str, object] = {"spec": spec.to_json(), "note": note}
    if mismatch is not None:
        out["mismatch"] = mismatch
    return out
