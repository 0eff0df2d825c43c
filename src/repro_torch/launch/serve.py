"""FIFO-sizing advisory service: JSON lines over TCP or stdio.

The always-on, multi-client face of the advisor: designs are traced once
into a shared registry, each client session is a stepwise optimizer, and
outstanding evaluation requests from *different* clients and *different*
designs are packed into single batched dispatches
(:mod:`repro_torch.core.service`).  Progress streams back as
frontier/hypervolume delta events while the search runs.

  # serve two preloaded designs on TCP, on the card, every full-solve
  # row of a round in one K2 launch
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --designs gemm,FeedForward --hetero --port 7733

  # one-shot stdio session (requests in, responses + events out)
  printf '%s\n' \
      '{"op":"open","design":"gemm","optimizer":"grouped_sa","budget":200}' \
      '{"op":"run"}' \
      '{"op":"result","session":"s0"}' \
      | PYTHONPATH=src python -m repro_torch.launch.serve --stdio

The tensor backends and the hetero dispatch run on the CUDA device
(``--backend cuda --device cuda`` by default; the kernels are built or
loaded before the registry is prepared, so no client's first request
waits for nvcc); ``--device cpu`` runs them on the CPU (the kernels'
plain versions).  The wire protocol is the reference's v2 (its
``docs/service.md``).
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from typing import Dict, Optional


class _BlockingWriter:
    """StreamWriter look-alike over a plain text stream (stdio mode
    with stdout redirected to a file, where pipe transports refuse)."""

    def __init__(self, stream):
        self._stream = stream

    def write(self, data: bytes) -> None:
        self._stream.write(data.decode())

    async def drain(self) -> None:
        self._stream.flush()

    def close(self) -> None:
        self._stream.flush()


class AdvisoryServer:
    """Asyncio front-end over the synchronous service core.

    One background *pump* task advances the service one batched round at
    a time and routes each session's progress events to the connection
    that opened it.  Rounds run inline on the event loop: evaluation is
    millisecond-scale (that is the paper's point), and single-threaded
    stepping keeps the core deterministic — no locks, no races between
    ``open``/``cancel`` and the round in flight.
    """

    def __init__(self, service=None, idle_sleep_s: float = 0.02,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every_s: Optional[float] = None,
                 **service_kwargs):
        from repro_torch.core.service import (AdvisoryService,
                                              ProtocolHandler)
        self.service = service or AdvisoryService(**service_kwargs)
        self.handler = ProtocolHandler(self.service,
                                       snapshot_dir=snapshot_dir)
        self.idle_sleep_s = float(idle_sleep_s)
        self.snapshot_dir = snapshot_dir
        #: auto-snapshot cadence (needs snapshot_dir); None disables
        self.snapshot_every_s = snapshot_every_s
        self._last_snapshot = 0.0
        self._owners: Dict[str, asyncio.Queue] = {}   # sid -> out queue
        self._shutdown = asyncio.Event()
        self._pump_task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------- pump
    def _route_events(self) -> None:
        """Deliver queued session events to their owning connections.

        Only *owned* sessions are drained: events for sessions whose
        connection has gone (or that were opened in-process) stay queued
        on the session until someone drains them — nothing is silently
        discarded, and the pump's per-tick work is bounded by the number
        of live connections, not by every session ever opened.
        """
        for sid, q in list(self._owners.items()):
            if sid not in self.service.sessions:   # released
                self._owners.pop(sid, None)
                continue
            for ev in self.service.drain_events(sid):
                q.put_nowait(ev)

    async def _pump(self) -> None:
        """Advance the service and fan events out to session owners.

        A failure inside a round (evaluation-engine error, worker
        death) must not die unobserved — it is reported to stderr and
        to every connected session owner, and the server shuts down
        rather than sit silently idle while clients wait on events.
        """
        try:
            while not self._shutdown.is_set():
                advanced = self.service.step()
                self._route_events()
                self._maybe_snapshot()
                # yield to the loop every round; back off only when idle
                await asyncio.sleep(0 if advanced else self.idle_sleep_s)
        except Exception as exc:   # noqa: BLE001 — terminal server fault
            import traceback
            traceback.print_exc(file=sys.stderr)
            fault = {"event": "error",
                     "error": f"{type(exc).__name__}: {exc}",
                     "fatal": True}
            for q in self._owners.values():
                q.put_nowait(dict(fault))
            self._shutdown.set()

    def _maybe_snapshot(self) -> None:
        """Periodic auto-snapshot: the crash-recovery complement of the
        explicit ``snapshot`` op.  A failed save is reported and retried
        next period — persistence trouble must not take down serving."""
        if not (self.snapshot_dir and self.snapshot_every_s):
            return
        import time
        now = time.perf_counter()
        if now - self._last_snapshot < self.snapshot_every_s:
            return
        self._last_snapshot = now
        if not len(self.service.registry):
            return
        from repro_torch.core.service import save_snapshot
        try:
            save_snapshot(self.service.registry, self.snapshot_dir)
        except Exception as exc:   # noqa: BLE001 — keep serving
            print(f"auto-snapshot failed ({type(exc).__name__}: {exc}); "
                  f"will retry", file=sys.stderr)

    def ensure_pump(self) -> None:
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.ensure_future(self._pump())

    async def aclose(self) -> None:
        self._shutdown.set()
        if self._pump_task is not None:
            self._pump_task.cancel()
            try:
                await self._pump_task
            except asyncio.CancelledError:
                pass
        self.service.close()

    # ------------------------------------------------------ connections
    async def _run_cooperative(self, msg: dict) -> dict:
        """``{"op": "run"}`` with an ``await`` between rounds."""
        max_rounds = msg.get("max_rounds")
        rounds = 0
        while not self._shutdown.is_set():
            if not self.service.step():
                break
            rounds += 1
            self._route_events()
            if max_rounds is not None and rounds >= max_rounds:
                break
            await asyncio.sleep(0)
        out = {"ok": True, "rounds": rounds,
               "running": len(self.service.running)}
        if msg.get("id") is not None:
            out["id"] = msg["id"]
        return out

    async def _sender(self, q: asyncio.Queue, writer) -> None:
        from repro_torch.core.service import encode_line
        faults = getattr(self.service, "faults", None)
        sent = 0
        while True:
            frame = await q.get()
            if frame is None:
                break
            writer.write(encode_line(frame).encode())
            await writer.drain()
            sent += 1
            if faults is not None and faults.take(
                    "drop_conn", at=sent) is not None:
                # simulated network drop mid-stream: hard-close the
                # transport; the client reconnects and replays its
                # event suffix via the 'attach' op
                writer.close()
                return

    async def handle_connection(self, reader, writer) -> None:
        """One JSON-lines client: requests in, responses + events out."""
        from repro_torch.core.service import ProtocolError, decode_line
        q: asyncio.Queue = asyncio.Queue()
        sender = asyncio.ensure_future(self._sender(q, writer))
        opened = []
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                if not line.strip():
                    continue
                try:
                    msg = decode_line(line)
                except ProtocolError as exc:
                    q.put_nowait({"ok": False, "error": str(exc)})
                    continue
                if msg.get("op") == "run":
                    # drive cooperatively: handler._op_run would block
                    # the event loop (and every other connection) until
                    # ALL sessions finish; yielding between rounds keeps
                    # the server responsive while preserving semantics
                    resp = await self._run_cooperative(msg)
                else:
                    resp = self.handler.handle(msg)
                if msg.get("op") in ("open", "attach") and resp.get("ok"):
                    # attach re-homes the session's live event stream to
                    # the reconnected client (the replayed suffix rides
                    # in the attach response itself)
                    self._owners[resp["session"]] = q
                    if resp["session"] not in opened:
                        opened.append(resp["session"])
                q.put_nowait(resp)
                # synchronous ops ("run") may have produced events —
                # deliver them now, not at the pump's next tick
                self._route_events()
                if resp.get("shutdown"):
                    self._shutdown.set()
                    break
        finally:
            self._route_events()
            for sid in opened:
                self._owners.pop(sid, None)
            q.put_nowait(None)
            await sender
            writer.close()
            if hasattr(writer, "wait_closed"):
                try:
                    await writer.wait_closed()
                except (ConnectionError, NotImplementedError):
                    pass

    async def serve_tcp(self, host: str = "127.0.0.1", port: int = 7733):
        """Start the TCP listener (port 0 = ephemeral); returns the
        ``asyncio.Server`` — callers own its lifetime."""
        self.ensure_pump()
        return await asyncio.start_server(self.handle_connection,
                                          host, port)

    async def serve_stdio(self) -> None:
        """Serve stdin/stdout as one connection; at EOF, finish any
        still-running sessions and flush their events before exiting."""
        from repro_torch.core.service import encode_line
        self.ensure_pump()
        loop = asyncio.get_event_loop()
        reader = asyncio.StreamReader()
        await loop.connect_read_pipe(
            lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)
        try:
            w_transport, w_protocol = await loop.connect_write_pipe(
                asyncio.streams.FlowControlMixin, sys.stdout)
            writer = asyncio.StreamWriter(w_transport, w_protocol,
                                          reader, loop)
        except ValueError:
            # stdout redirected to a regular file: pipe transports
            # refuse it, but a blocking writer is perfectly fine there
            writer = _BlockingWriter(sys.stdout)
        await self.handle_connection(reader, writer)
        # piped usage: the input script may end while sessions run;
        # finish them and emit EVERYTHING still queued (the connection
        # teardown stops routing, so events pile up on the sessions)
        while self.service.running and not self._shutdown.is_set():
            self.service.step()
        for ev in self.service.drain_events():
            sys.stdout.write(encode_line(ev))
        sys.stdout.flush()


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve FIFO-sizing DSE sessions over JSON lines.")
    p.add_argument("--designs", default=None,
                   help="comma-list of designs to trace at startup "
                        "(others are traced lazily on first open)")
    p.add_argument("--port", type=int, default=7733,
                   help="TCP port (0 = ephemeral; printed at startup)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--stdio", action="store_true",
                   help="serve stdin/stdout instead of TCP")
    p.add_argument("--backend", default="cuda",
                   help="evaluator backend for every design "
                        "(cuda/pallas, fixpoint/jax, numpy/worklist, "
                        "auto)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the tensor backends and the "
                        "hetero dispatch (cuda, or cpu)")
    p.add_argument("--max-iters", type=int, default=256)
    p.add_argument("--hetero", action="store_true",
                   help="pack cross-design batches into one fixpoint "
                        "dispatch (one K2 launch on the card)")
    p.add_argument("--workers", type=int, default=0,
                   help="worklist worker processes (0 = inline)")
    p.add_argument("--shards", type=int, default=None, metavar="N",
                   help="with --hetero: shard the packed cross-design "
                        "dispatch over N devices (with --device cpu the "
                        "CPU is repeated N times)")
    p.add_argument("--no-progress", action="store_true",
                   help="disable per-round progress events")
    p.add_argument("--snapshot-dir", default=None, metavar="DIR",
                   help="warm-restart snapshot directory: loaded at "
                        "startup when it holds a valid snapshot, and "
                        "the default target of the 'snapshot' op")
    p.add_argument("--snapshot-every", type=float, default=None,
                   metavar="S",
                   help="auto-snapshot the registry to --snapshot-dir "
                        "every S seconds (crash recovery; default off)")
    p.add_argument("--fault-plan", default=None, metavar="JSON|@FILE",
                   help="install a FaultPlan for chaos testing (inline "
                        "JSON or @path)")
    p.add_argument("--max-sessions", type=int, default=None, metavar="N",
                   help="admission cap on concurrently running sessions "
                        "(overload replies carry E_OVERLOADED + a "
                        "retry-after hint; default unbounded)")
    return p.parse_args(argv)


def load_kernels(service) -> None:
    """Build or load the CUDA kernels before the first request when the
    service will launch them (a cuda-family backend or the hetero
    dispatch on a CUDA device): the pump steps the service on the event
    loop, so a build there would stall every connection."""
    if service.registry.device.type != "cuda":
        return
    if not (service.batcher.want_hetero
            or service.config.backend in ("cuda", "pallas", "auto",
                                          "mesh", "sharded")):
        return
    import time

    from repro_torch.kernels.fifo_eval import build
    t0 = time.perf_counter()
    build.load()
    how = "built" if build.BUILD_INFO.get("built") else "loaded"
    print(f"kernels {how} in {time.perf_counter() - t0:.6f}s from "
          f"{build.BUILD_INFO.get('path')}", file=sys.stderr)


async def amain(args) -> int:
    if args.shards and not args.hetero:
        print("note: --shards only shards the --hetero dispatch; "
              "use --backend mesh for per-design sharding",
              file=sys.stderr)
    if args.hetero and args.workers:
        print("note: --workers is ignored with --hetero (the fused "
              "dispatch owns every full-solve row in this process)",
              file=sys.stderr)
    import os
    import time

    from repro_torch.core.service import (EvalConfig, SnapshotError,
                                          load_snapshot)

    config = EvalConfig(backend=args.backend, max_iters=args.max_iters)
    faults = None
    if args.fault_plan:
        from repro_torch.core.faults import resolve_plan
        faults = resolve_plan(env={"REPRO_FAULTS": args.fault_plan})
        print(f"fault plan installed: {faults!r}", file=sys.stderr)
    server = AdvisoryServer(config=config, snapshot_dir=args.snapshot_dir,
                            snapshot_every_s=args.snapshot_every,
                            hetero=args.hetero, workers=args.workers,
                            progress_events=not args.no_progress,
                            max_sessions=args.max_sessions,
                            shards=args.shards, faults=faults,
                            device=args.device)
    load_kernels(server.service)
    # registry-ready timing: everything between here and the "ready"
    # line is design preparation (snapshot load or cold trace), the part
    # warm restarts compress — interpreter/torch start-up and the kernel
    # build or load are excluded
    t0 = time.perf_counter()
    restored = []
    if args.snapshot_dir and os.path.exists(
            os.path.join(args.snapshot_dir, "MANIFEST.json")):
        try:
            load_snapshot(args.snapshot_dir, server.service.registry)
            restored = server.service.registry.names()
            for name in restored:
                server.service.batcher.add_design(name)
            report = server.service.registry.restore_report or {}
            for name, reason in report.get("quarantined", {}).items():
                print(f"snapshot member quarantined ({reason}); "
                      f"{name} will re-trace on first use",
                      file=sys.stderr)
        except SnapshotError as exc:
            print(f"snapshot load failed ({exc}); cold-starting",
                  file=sys.stderr)
    if args.designs:
        for name in args.designs.split(","):
            name = name.strip()
            if name and name not in server.service.registry:
                server.service.registry.register(name)
                server.service.batcher.add_design(name)
        print(f"preloaded designs: {server.service.registry.names()}",
              file=sys.stderr)
    state = f"warm, {len(restored)} restored" if restored else "cold"
    print(f"registry ready in {time.perf_counter() - t0:.6f}s ({state})",
          file=sys.stderr)
    try:
        if args.stdio:
            await server.serve_stdio()
            return 0
        tcp = await server.serve_tcp(args.host, args.port)
        addr = tcp.sockets[0].getsockname()
        print(f"advisory service listening on {addr[0]}:{addr[1]}",
              file=sys.stderr)
        async with tcp:
            await self_shutdown_wait(server, tcp)
        return 0
    finally:
        await server.aclose()


async def self_shutdown_wait(server: AdvisoryServer, tcp) -> None:
    """Run until a client sends ``{"op": "shutdown"}``."""
    await server._shutdown.wait()
    tcp.close()


def main(argv=None) -> int:
    return asyncio.run(amain(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
