"""Reusable dataflow-stage builders mirroring Stream-HLS output structure.

Stream-HLS lowers affine kernels (PolyBench linear algebra, small DNN
blocks) to dataflow graphs in a recognizable shape: *loader* tasks stream
array elements from memory, *compute* tasks are pipelined loop nests
(II=1 unless noted) reading/writing stream arrays round-robin, *store*
tasks drain results.  Stream arrays (``hls::stream<T> v[L]``) carry the
``group`` tag the grouped optimizers exploit.

All builders take and return *stream array* handles (lists of FIFO names)
and register tasks on the shared :class:`repro_torch.core.design.Design`.
Values flowing through the FIFOs are real numbers, so every design's
functional output can be checked against a numpy reference in tests.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from repro_torch.core.design import Design

Streams = List[str]


def streams(d: Design, name: str, lanes: int, width: int = 32,
            depth: Optional[int] = None) -> Streams:
    if lanes == 1:
        return [d.fifo(name, width=width, group=name, depth=depth)]
    return d.fifo_array(name, lanes, width=width, depth=depth)


# ---------------------------------------------------------------------------
# stage builders
# ---------------------------------------------------------------------------

def producer(d: Design, name: str, out: Streams, values: Sequence[float],
             ii: int = 1, start_delay: int = 0) -> None:
    """Memory loader: streams ``values`` round-robin over ``out``."""
    def prog(ctx, out=tuple(out), values=tuple(values), ii=ii,
             start_delay=start_delay):
        if start_delay:
            yield ctx.delay(start_delay)
        for i, v in enumerate(values):
            yield ctx.delay(ii)
            yield ctx.write(out[i % len(out)], v)
    d.add_task(name, prog)


def sink(d: Design, name: str, inp: Streams, count: int, ii: int = 1,
         result_key: Optional[str] = None) -> None:
    """Memory store: drains ``count`` elements round-robin; checksums."""
    def prog(ctx, inp=tuple(inp), count=count, ii=ii, key=result_key):
        acc = 0.0
        for i in range(count):
            yield ctx.delay(ii)
            v = yield ctx.read(inp[i % len(inp)])
            acc += v
        if key is not None:
            ctx.result(key, acc)
    d.add_task(name, prog)


def map_stage(d: Design, name: str, inp: Streams, out: Streams, count: int,
              fn: Callable[[float], float] = lambda v: v, ii: int = 1,
              extra_delay: int = 0) -> None:
    """Elementwise stage (ReLU, copy, cast): read 1 -> write 1, II cycles."""
    def prog(ctx, inp=tuple(inp), out=tuple(out), count=count, fn=fn,
             ii=ii, extra_delay=extra_delay):
        for i in range(count):
            yield ctx.delay(ii)
            v = yield ctx.read(inp[i % len(inp)])
            if extra_delay:
                yield ctx.delay(extra_delay)
            yield ctx.write(out[i % len(out)], fn(v))
    d.add_task(name, prog)


def fork_stage(d: Design, name: str, inp: Streams, out_a: Streams,
               out_b: Streams, count: int, ii: int = 1) -> None:
    """Duplicate a stream (residual skip paths): read 1 -> write to both."""
    def prog(ctx, inp=tuple(inp), a=tuple(out_a), b=tuple(out_b),
             count=count, ii=ii):
        for i in range(count):
            yield ctx.delay(ii)
            v = yield ctx.read(inp[i % len(inp)])
            yield ctx.write(a[i % len(a)], v)
            yield ctx.write(b[i % len(b)], v)
    d.add_task(name, prog)


def join_stage(d: Design, name: str, in_a: Streams, in_b: Streams,
               out: Streams, count: int,
               fn: Callable[[float, float], float] = lambda a, b: a + b,
               ii: int = 1) -> None:
    """Binary elementwise combine (residual add)."""
    def prog(ctx, a=tuple(in_a), b=tuple(in_b), out=tuple(out), count=count,
             fn=fn, ii=ii):
        for i in range(count):
            yield ctx.delay(ii)
            x = yield ctx.read(a[i % len(a)])
            y = yield ctx.read(b[i % len(b)])
            yield ctx.write(out[i % len(out)], fn(x, y))
    d.add_task(name, prog)


def matvec_stage(d: Design, name: str, inp: Streams, out: Streams,
                 rows: int, cols: int, weight: float = 0.01,
                 ii: int = 1, row_overhead: int = 2,
                 reuse_input: bool = False) -> None:
    """Dense matrix-vector row loop: per row read ``cols`` (unless the
    input vector is buffered locally after the first row — ``reuse_input``),
    accumulate at II, write 1 output."""
    def prog(ctx, inp=tuple(inp), out=tuple(out), rows=rows, cols=cols,
             w=weight, ii=ii, oh=row_overhead, reuse=reuse_input):
        xbuf: List[float] = []
        for r in range(rows):
            acc = 0.0
            if r == 0 or not reuse:
                for c in range(cols):
                    yield ctx.delay(ii)
                    v = yield ctx.read(inp[c % len(inp)])
                    if reuse:
                        xbuf.append(v)
                    acc += w * v
            else:
                yield ctx.delay(max(1, cols // 4))  # local-buffer MACs
                acc = sum(w * v for v in xbuf)
            if oh:
                yield ctx.delay(oh)
            yield ctx.write(out[r % len(out)], acc)
    d.add_task(name, prog)


def matmul_stage(d: Design, name: str, inp: Streams, out: Streams,
                 m: int, k: int, n: int, weight: float = 0.01,
                 ii: int = 1, row_overhead: int = 2) -> None:
    """Streaming matmul: A arrives row-major (m*k reads); B is a local
    buffer; each of the m rows emits n outputs.  Read-burst then
    write-burst per row — the bursty pattern that makes FIFO sizing
    non-trivial downstream."""
    def prog(ctx, inp=tuple(inp), out=tuple(out), m=m, k=k, n=n, w=weight,
             ii=ii, oh=row_overhead):
        for r in range(m):
            acc = 0.0
            for c in range(k):
                yield ctx.delay(ii)
                v = yield ctx.read(inp[(r * k + c) % len(inp)])
                acc += w * v
            if oh:
                yield ctx.delay(oh)
            for j in range(n):
                yield ctx.delay(ii)
                yield ctx.write(out[(r * n + j) % len(out)], acc)
    d.add_task(name, prog)


def conv_stage(d: Design, name: str, inp: Streams, out: Streams,
               length: int, taps: int, weight: float = 0.1,
               ii: int = 1) -> None:
    """1-D sliding-window "same" conv (line-buffer style): reads 1/cycle,
    emits 1/cycle (partial windows at the boundary), so in/out counts match
    — which keeps residual skip paths length-compatible."""
    def prog(ctx, inp=tuple(inp), out=tuple(out), n=length, taps=taps,
             w=weight, ii=ii):
        win: List[float] = []
        for i in range(n):
            yield ctx.delay(ii)
            v = yield ctx.read(inp[i % len(inp)])
            win.append(v)
            if len(win) > taps:
                win.pop(0)
            yield ctx.write(out[i % len(out)], w * sum(win))
    d.add_task(name, prog)


def buffered_matmul_stage(d: Design, name: str, a_in: Streams, b_in: Streams,
                          out: Streams, m: int, k: int, n: int,
                          weight: float = 0.01, ii: int = 1,
                          row_overhead: int = 2,
                          b_col_order: bool = False) -> None:
    """Two-streamed-input matmul: B (k*n elements) is buffered first, then
    A streams row-major.  This is the Stream-HLS reduction-tree node.

    With ``b_col_order`` the node consumes B column-major while the
    producer emits row-major — the transpose-between-stages pattern.  The
    B-side FIFOs then act as a reorder buffer and must hold nearly the
    whole operand, or the design deadlocks: the paper's Baseline-Min
    deadlock case (k15mmtree).  The reduction below is order-insensitive,
    so only *timing* (which lane is popped when) depends on the order.
    """
    def prog(ctx, a_in=tuple(a_in), b_in=tuple(b_in), out=tuple(out),
             m=m, k=k, n=n, w=weight, ii=ii, oh=row_overhead,
             col=b_col_order):
        bsum = 0.0
        L = len(b_in)
        if col:
            order = [i2 * n + j2 for j2 in range(n) for i2 in range(k)]
        else:
            order = range(k * n)
        for flat in order:
            yield ctx.delay(ii)
            v = yield ctx.read(b_in[flat % L])
            bsum += v
        for r in range(m):
            acc = 0.0
            for c in range(k):
                yield ctx.delay(ii)
                v = yield ctx.read(a_in[(r * k + c) % len(a_in)])
                acc += w * v
            acc += w * bsum / max(k * n, 1)
            if oh:
                yield ctx.delay(oh)
            for j in range(n):
                yield ctx.delay(ii)
                yield ctx.write(out[(r * n + j) % len(out)], acc)
    d.add_task(name, prog)
