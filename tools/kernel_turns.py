#!/usr/bin/env python3
"""Time both kernels of this tree, K2 (``csrc/fifo_eval.cu``) and K1
(``csrc/condensed.cu``), against those of another checkout of the
repository, in turns on one card.

    python3 tools/kernel_turns.py --parent DIR [--out FILE]

``DIR`` is a checkout of an earlier commit (for example ``git archive``
of the parent unpacked into a git-ignored directory).  Its kernel library
is built from its own sources with its own ``build.py``, into its own
build directory, and called through its own C entry point, and so is
this tree's K2 (at the shape its chooser picks), so that both times are
the kernels' and not the wrappers'.  Where the earlier entry point also
takes a launch shape (cluster, threads, events per thread), it gets this
tree's.  At each shape (the main path's 8 rows below the routing box's
floor, and the 512-row bucket, on the raw streams and on ResidualBlock's
aggressive rung) both kernels run on the same operands,
must give equal outputs, and are timed with CUDA events in the order
earlier, this, this, earlier.  This tree's K2 is then also timed at every
cluster size its chooser allows for the shape (``by_cluster``), beside
how many clusters of that size the card holds at once (``active``), and
in its per-design-table mode on the same work (one table, every row's
table index 0 and its bound the shared one; ``table_mode_ms``), which
must give the same outputs, and on the raw streams also with no
``bp_base`` (the raw stream's add of 1, as a cross-design dispatch
launches it; ``table_mode_unit_bp_ms``): the shared-table (null-pointer)
path is the one the earlier tree's K2 is held against.

K1 runs the same way on the aggressive rungs of gemm, FeedForward,
k15mmseq and k15mmtree, on rows inside the routing box: the main path's
1- and 8-row batches and the 512-row bucket.  Its launches are timed as
CUDA graphs of 20 launches (``chip_smoke.graph_ms``), so that the host's
launch overhead is not counted; this tree's K1 gets the shape its chooser
picks, and is then also timed at every shape the chooser allows
(``by_shape``).

Prints one JSON line per kernel and shape, then the ``nvidia-smi`` name
and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

REPS = 5


def load_parent_lib(parent: str):
    """The earlier checkout's kernel library, built by its own build.py."""
    path = os.path.join(parent, "src", "repro_torch", "kernels", "fifo_eval",
                        "build.py")
    spec = importlib.util.spec_from_file_location("parent_kernel_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load(), mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.fifo_eval import build
    from repro_torch.kernels.fifo_eval.condensed import k1_shapes
    from repro_torch.kernels.fifo_eval.condensed import (
        launch_shape as k1_launch_shape)
    from repro_torch.kernels.fifo_eval.fifo_eval import (k2_cluster_sizes,
                                                         launch_shape)
    lib, pbuild = load_parent_lib(os.path.abspath(a.parent))
    # the entry point grew from 17 arguments by (cluster, threads, k)
    # after the bound, then by (table_of_row, bounds) after the times
    n_parent_args = len(pbuild.SIGNATURES["fifo_eval_launch"])
    parent_takes_shape = n_parent_args >= 20
    parent_tables = (None, None) if n_parent_args >= 22 else ()
    this_lib = build.load()
    dev = torch.device("cuda")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    out_file = open(a.out, "w") if a.out else None

    def emit(obj):
        line = json.dumps(obj) if not isinstance(obj, str) else obj
        print(line, flush=True)
        if out_file:
            out_file.write(line + "\n")

    # (shape, label, graph, rows, c): the raw streams, and ResidualBlock's
    # aggressive rung, which runs on clusters of one CTA
    rb = cs.rung("ResidualBlock", "aggressive")
    cases = [("main_path", n, cs.raw_graph(n), cs.low_rows, cs.MAIN_ROWS)
             for n in cs.K2_DESIGNS]
    cases += [("bucket", n, cs.raw_graph(n), cs.box_rows, 512)
              for n in cs.K2_DESIGNS]
    cases += [(shape, "ResidualBlock/aggressive", rb, rows_of, c)
              for shape, rows_of, c in (("main_path", cs.low_rows,
                                         cs.MAIN_ROWS),
                                        ("bucket", cs.box_rows, 512))]
    for shape, name, g, rows_of, c in cases:
        args, _, bound = cs.kernel_args(g, rows_of(g, c, seed=0), dev,
                                        cert=False)
        e_pad = int(args[6].shape[1])
        shape_ = launch_shape(c, e_pad, dev)
        p_out = torch.empty((c, 4), dtype=torch.float32, device=dev)
        out = torch.empty_like(p_out)
        ptrs = [x.data_ptr() for x in args]
        stream = torch.cuda.current_stream(dev).cuda_stream

        p_shape = shape_ if parent_takes_shape else ()
        # the per-design-table mode on the same work: one table
        tor = torch.zeros(c, dtype=torch.int32, device=dev)
        bounds = torch.full((c,), float(bound), dtype=torch.float32,
                            device=dev)

        def parent():
            pbuild.check(lib.fifo_eval_launch(
                *ptrs, p_out.data_ptr(), None, *parent_tables, c, e_pad,
                256, float(bound), *p_shape, stream), "parent fifo_eval")

        def this(shape_=shape_, tables=(None, None)):
            build.check(this_lib.fifo_eval_launch(
                *ptrs, out.data_ptr(), None, *tables, c, e_pad, 256,
                float(bound), *shape_, stream), "fifo_eval")

        def this_tables():
            this(tables=(tor.data_ptr(), bounds.data_ptr()))

        def this_hetero():
            # as a cross-design dispatch calls it: no bp_base, add 1
            build.check(this_lib.fifo_eval_launch(
                *ptrs[:9], None, out.data_ptr(), None, tor.data_ptr(),
                bounds.data_ptr(), c, e_pad, 256, float(bound), *shape_,
                stream), "fifo_eval")

        parent()
        this()
        torch.cuda.synchronize()
        if not torch.equal(out, p_out):
            raise AssertionError(f"{name} {shape}: outputs differ")
        slowest = int(out[:, 3].max())
        t_p1 = cs.cuda_ms(parent, REPS)
        t_n1 = cs.cuda_ms(this, REPS)
        t_h = cs.cuda_ms(this_tables, REPS)
        if not torch.equal(out, p_out):
            raise AssertionError(f"{name} {shape}: per-design-table mode "
                                 f"differs")
        # a raw stream's back-pressure add is 1 everywhere
        t_u = cs.cuda_ms(this_hetero, REPS) if g is not rb else None
        if not torch.equal(out, p_out):
            raise AssertionError(f"{name} {shape}: per-design-table mode "
                                 f"without bp_base differs")
        t_n2 = cs.cuda_ms(this, REPS)
        t_p2 = cs.cuda_ms(parent, REPS)
        by_cluster = {}
        for s in k2_cluster_sizes(e_pad, cs.max_cluster(dev)):
            sh = launch_shape(c, e_pad, dev, cluster=s)
            by_cluster[s] = cs.cuda_ms(lambda: this(sh), REPS)
            if not torch.equal(out, p_out):
                raise AssertionError(f"{name} {shape} cluster {s}: outputs "
                                     f"differ")
        b, by = cs.bound_ms(args, out)
        emit({"kernel": "fifo_eval", "shape": shape, "design": name,
              "rows": c, "e_pad": e_pad,
              "cluster": shape_[0], "threads": shape_[1], "k": shape_[2],
              "iters_max": slowest, "iters_sum": int(out[:, 3].sum()),
              "parent_ms": [t_p1, t_p2], "ms": [t_n1, t_n2],
              "table_mode_ms": t_h, "table_mode_unit_bp_ms": t_u,
              "parent_us_per_iter": min(t_p1, t_p2) * 1e3 / slowest,
              "us_per_iter": min(t_n1, t_n2) * 1e3 / slowest,
              "speedup": min(t_p1, t_p2) / min(t_n1, t_n2),
              "by_cluster": by_cluster, "active": cs.k2_active(dev, e_pad),
              "bound_ms": b, "bound_by": by, "equal": True})

    # K1: an entry point that takes this tree's shape (warps, k, split)
    # after the bound
    k1_takes_shape = len(pbuild.SIGNATURES["fifo_eval_condensed_launch"]) \
        == len(build.SIGNATURES["fifo_eval_condensed_launch"])
    for name in cs.K1_DESIGNS:
        cg = cs.rung(name, "aggressive")
        for shape, c in [("main_path", c) for c in cs.K1_MAIN_ROWS] + [
                ("bucket", 512)]:
            args, _, bound = cs.kernel_args(cg, cs.box_rows(cg, c, seed=0),
                                            dev, cert=True)
            e_pad, v_pad = int(args[6].shape[1]), int(args[10].shape[1])
            chosen = tuple(k1_launch_shape(c, e_pad, v_pad, dev))
            p_out = torch.empty((c, 5), dtype=torch.float32, device=dev)
            out = torch.empty_like(p_out)
            ptrs = [x.data_ptr() for x in args]

            def parent():
                pbuild.check(lib.fifo_eval_condensed_launch(
                    *ptrs, p_out.data_ptr(), None, c, e_pad, v_pad, 256,
                    float(bound), *(chosen if k1_takes_shape else ()),
                    torch.cuda.current_stream(dev).cuda_stream),
                    "parent fifo_eval_condensed")

            def this(sh=chosen):
                build.check(this_lib.fifo_eval_condensed_launch(
                    *ptrs, out.data_ptr(), None, c, e_pad, v_pad, 256,
                    float(bound), *sh,
                    torch.cuda.current_stream(dev).cuda_stream),
                    "fifo_eval_condensed")

            parent()
            this()
            torch.cuda.synchronize()
            if not torch.equal(out, p_out):
                raise AssertionError(f"K1 {name} {c} rows: outputs differ")
            t_p1 = cs.graph_ms(parent)
            t_n1 = cs.graph_ms(this)
            t_n2 = cs.graph_ms(this)
            t_p2 = cs.graph_ms(parent)
            by_shape = {}
            for sh in k1_shapes(e_pad, v_pad):
                out.zero_()
                by_shape[str(list(sh))] = cs.graph_ms(lambda: this(sh))
                if not torch.equal(out, p_out):
                    raise AssertionError(f"K1 {name} {c} rows shape {sh}: "
                                         f"outputs differ")
            b, by = cs.bound_ms(args, out, cert_slots=args[10].numel())
            emit({"kernel": "fifo_eval_condensed", "shape": shape,
                  "design": name, "rows": c, "e_pad": e_pad, "v_pad": v_pad,
                  "launch": list(chosen),
                  "iters_max": int(out[:, 3].max()),
                  "iters_sum": int(out[:, 3].sum()),
                  "parent_ms": [t_p1, t_p2], "ms": [t_n1, t_n2],
                  "speedup": min(t_p1, t_p2) / min(t_n1, t_n2),
                  "by_shape": by_shape, "bound_ms": b, "bound_by": by,
                  "equal": True})
    emit(cs.nvidia_smi_line())
    if out_file:
        out_file.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
