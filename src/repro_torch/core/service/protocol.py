"""Advisory-service wire protocol v2: JSON lines, transport-agnostic.

One message per line, one JSON object per message.  Requests carry an
``op`` and an optional ``id`` (echoed back verbatim, so clients can
correlate responses over a shared connection); responses carry
``ok: true/false``; server-pushed events carry an ``event`` key instead
of ``ok``.  The protocol is the reference package's, unchanged: its
full message reference and v1 -> v2 migration table are in the
repository's ``docs/service.md``.

Protocol v2 adds, on top of v1:

* a ``hello`` handshake (``{"op": "hello", "proto": 2}``) that
  negotiates the protocol version and advertises the server's ops —
  clients that skip it are treated as v1;
* **stable error codes**: every error frame carries a ``code`` from
  :data:`ERROR_CODES` next to the human-readable ``error`` string, so
  clients branch on codes, not message prose;
* **explicit backpressure**: when the service is at its session cap,
  ``open`` fails fast with ``E_OVERLOADED`` and a ``retry_after_s``
  hint measured from live round times — clients back off instead of
  queueing invisibly;
* ``release`` as the canonical name for dropping a session, and a
  ``snapshot`` op that persists the registry for warm restarts
  (:mod:`repro_torch.core.service.snapshot`).

Protocol v1 remains fully accepted: :func:`adapt_v1` rewrites the one
renamed op (``close`` -> ``release``) and v1 clients simply ignore the
extra ``code`` key in error frames (v1's ``error`` string is still
always present).

The :class:`ProtocolHandler` maps request dicts to response dicts
against an :class:`~repro_torch.core.service.batcher.AdvisoryService` — the
asyncio server (``repro_torch.launch.serve``), the stdio loop, and the
in-process :class:`AdvisorClient` all share it, so the protocol is
exercised end-to-end even in fully in-process tests.
"""

from __future__ import annotations

import json
import warnings
from typing import Iterator, List, Optional

from repro_torch.core.service.batcher import (AdvisoryService,
                                              ServiceOverloaded)

__all__ = ["AdvisorClient", "ERROR_CODES", "PROTO", "ProtocolError",
           "ProtocolHandler", "SessionHandle", "SUPPORTED_PROTOS",
           "adapt_v1", "decode_line", "encode_line"]

#: current protocol version; ``hello`` negotiates within SUPPORTED_PROTOS
PROTO = 2
SUPPORTED_PROTOS = (1, 2)

#: requests the handler understands (anything else is E_PROTO).
#: ``close`` is the deprecated v1 spelling of ``release``.
#: ``attach`` is the reconnect/resume path: replay a session's event
#: suffix after a dropped connection.
OPS = ("hello", "open", "attach", "run", "step", "cancel", "release",
       "close", "status", "result", "designs", "stats", "snapshot",
       "shutdown")

# ------------------------------------------------------------ error codes
#: the stable error vocabulary; codes never change meaning across
#: releases (new codes may be added), so clients can branch on them
E_PROTO = "E_PROTO"              # malformed frame / unknown op / bad proto
E_BAD_REQUEST = "E_BAD_REQUEST"  # well-formed op, invalid arguments
E_BAD_DESIGN = "E_BAD_DESIGN"    # unknown design name
E_BAD_OPTIMIZER = "E_BAD_OPTIMIZER"  # unknown optimizer name
E_BAD_SESSION = "E_BAD_SESSION"  # unknown/released session id
E_OVERLOADED = "E_OVERLOADED"    # admission refused; see retry_after_s
E_INTERNAL = "E_INTERNAL"        # engine failure behind a valid request
E_TIMEOUT = "E_TIMEOUT"          # evaluation exceeded the session deadline

ERROR_CODES = (E_PROTO, E_BAD_REQUEST, E_BAD_DESIGN, E_BAD_OPTIMIZER,
               E_BAD_SESSION, E_OVERLOADED, E_INTERNAL, E_TIMEOUT)


class ProtocolError(ValueError):
    """Malformed or unanswerable client message.

    ``code`` is the stable :data:`ERROR_CODES` entry for the error
    frame; ``extra`` keys (e.g. ``retry_after_s``) are merged into it.
    """

    def __init__(self, message: str, code: str = E_PROTO, **extra):
        super().__init__(message)
        self.code = code
        self.extra = extra


def encode_line(msg: dict) -> str:
    """One message -> one newline-terminated JSON line."""
    return json.dumps(msg, separators=(",", ":")) + "\n"


def decode_line(line) -> dict:
    """One line -> one message dict (:class:`ProtocolError` if not)."""
    if isinstance(line, bytes):
        line = line.decode("utf-8", errors="replace")
    try:
        msg = json.loads(line)
    except json.JSONDecodeError as exc:
        raise ProtocolError(f"not valid JSON: {exc}") from None
    if not isinstance(msg, dict):
        raise ProtocolError("message must be a JSON object")
    return msg


def adapt_v1(msg: dict) -> dict:
    """Rewrite a protocol-v1 request as its v2 equivalent.

    v1 differs from v2 only in naming (``close`` -> ``release``) and in
    lacking ``hello``/``snapshot``; every v1 frame therefore maps 1:1
    and old clients keep working unchanged against a v2 server.
    """
    if msg.get("op") == "close":
        msg = dict(msg, op="release")
    return msg


class ProtocolHandler:
    """Maps one decoded request to one response dict.

    Stateless beyond the service it fronts; safe to share across
    connections (sessions are service-global — a connection may query
    any session id it knows).

    Args:
        service: the :class:`AdvisoryService` to front.
        snapshot_dir: default directory for the ``snapshot`` op (the
            op's ``dir`` argument overrides it; with neither, the op
            fails with ``E_BAD_REQUEST``).
    """

    def __init__(self, service: AdvisoryService,
                 snapshot_dir: Optional[str] = None):
        self.service = service
        self.snapshot_dir = snapshot_dir

    def handle(self, msg: dict) -> dict:
        """Answer one request; never raises — errors become
        ``{"ok": false, "code": ..., "error": ...}`` frames."""
        rid = msg.get("id")
        try:
            out = self._dispatch(adapt_v1(msg))
        except ProtocolError as exc:
            out = {"ok": False, "code": exc.code, "error": str(exc),
                   **exc.extra}
        except ServiceOverloaded as exc:
            out = {"ok": False, "code": E_OVERLOADED, "error": str(exc),
                   "retry_after_s": exc.retry_after_s,
                   "max_sessions": exc.max_sessions}
        except Exception as exc:   # noqa: BLE001 — server boundary: an
            # engine failure (worker death, bad optimizer kwargs) must
            # become an error frame, never a dropped connection
            out = {"ok": False, "code": E_INTERNAL,
                   "error": f"{type(exc).__name__}: {exc}"}
        if rid is not None:
            out["id"] = rid
        return out

    def poll_events(self, sid: Optional[str] = None) -> List[dict]:
        """Drain queued progress/done events (push frames)."""
        return self.service.drain_events(sid)

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, msg: dict) -> dict:
        op = msg.get("op")
        if op not in OPS:
            raise ProtocolError(
                f"unknown op {op!r}; expected one of {list(OPS)}")
        return getattr(self, f"_op_{op}")(msg)

    def _session_of(self, msg: dict):
        sid = msg.get("session")
        if not sid:
            raise ProtocolError(f"op {msg.get('op')!r} needs a 'session'",
                                code=E_BAD_REQUEST)
        try:
            return self.service.session(sid)
        except KeyError as exc:
            raise ProtocolError(str(exc), code=E_BAD_SESSION) from None

    def _op_hello(self, msg: dict) -> dict:
        proto = msg.get("proto", 1)
        if proto not in SUPPORTED_PROTOS:
            raise ProtocolError(
                f"unsupported proto {proto!r}; server supports "
                f"{list(SUPPORTED_PROTOS)}")
        return {"ok": True, "proto": int(proto), "server": "fifoadvisor",
                "ops": [o for o in OPS if o != "close"],
                "max_sessions": self.service.max_sessions}

    def _op_open(self, msg: dict) -> dict:
        design = msg.get("design")
        if not design:
            raise ProtocolError("op 'open' needs a 'design'",
                                code=E_BAD_REQUEST)
        kwargs = msg.get("kwargs") or {}
        if not isinstance(kwargs, dict):
            raise ProtocolError("'kwargs' must be an object",
                                code=E_BAD_REQUEST)
        deadline = msg.get("deadline")
        try:
            sess = self.service.open_session(
                design, optimizer=msg.get("optimizer", "grouped_sa"),
                budget=int(msg.get("budget", 300)),
                seed=int(msg.get("seed", 0)),
                progress_events=msg.get("progress"),
                deadline_s=None if deadline is None else float(deadline),
                request_id=msg.get("req"), **kwargs)
        except KeyError as exc:
            code = (E_BAD_OPTIMIZER if "optimizer" in str(exc)
                    else E_BAD_DESIGN)
            raise ProtocolError(str(exc), code=code) from None
        return {"ok": True, "session": sess.id, "design": sess.design,
                "optimizer": sess.optimizer, "budget": sess.budget,
                "seed": sess.seed, "state": sess.state}

    def _op_attach(self, msg: dict) -> dict:
        """Reconnect/resume: replay the session's retained event-stream
        suffix after the last ``seq`` the client saw (``after_seq``;
        -1 replays everything retained).  ``replay_complete`` is false
        when events between ``after_seq`` and the log floor already
        aged out of the bounded log — the client should then fall back
        to ``status``/``result`` for ground truth."""
        sess = self._session_of(msg)
        after = int(msg.get("after_seq", -1))
        events = sess.events_after(after)
        complete = not (sess.event_log
                        and sess.replay_floor > after + 1)
        return {"ok": True, "session": sess.id, "state": sess.state,
                "events": events, "replay_complete": complete,
                "next_seq": sess.status()["next_seq"]}

    def _op_run(self, msg: dict) -> dict:
        rounds = self.service.run_until_idle(msg.get("max_rounds"))
        return {"ok": True, "rounds": rounds,
                "running": len(self.service.running)}

    def _op_step(self, msg: dict) -> dict:
        return {"ok": True, "advanced": self.service.step(),
                "running": len(self.service.running)}

    def _op_cancel(self, msg: dict) -> dict:
        sess = self._session_of(msg)
        sess.cancel()
        return {"ok": True, "session": sess.id, "state": sess.state,
                "n_evals": int(sess.ctx.n_evals)}

    def _op_release(self, msg: dict) -> dict:
        """Release a session entirely (fetch ``result`` first — the id
        becomes unknown afterwards)."""
        sess = self._session_of(msg)
        self.service.release(sess.id)
        return {"ok": True, "session": sess.id, "state": sess.state,
                "released": True}

    def _op_status(self, msg: dict) -> dict:
        return {"ok": True, **self._session_of(msg).status()}

    def _op_result(self, msg: dict) -> dict:
        sess = self._session_of(msg)
        dse = sess.dse_result()
        alpha = float(msg.get("alpha", 0.7))
        out = dse.summary(alpha)
        out["frontier"] = dse.frontier_points.tolist()
        out["hypervolume"] = float(dse.hypervolume())
        sel = dse.selected(alpha)
        if sel is not None:
            out["selected_depths"] = [int(d) for d in sel[1]]
        return {"ok": True, "session": sess.id, "state": sess.state,
                "result": out}

    def _op_designs(self, msg: dict) -> dict:
        return {"ok": True, "designs": self.service.registry.stats()}

    def _op_stats(self, msg: dict) -> dict:
        return {"ok": True, "stats": self.service.stats()}

    def _op_snapshot(self, msg: dict) -> dict:
        directory = msg.get("dir") or self.snapshot_dir
        if not directory:
            raise ProtocolError(
                "op 'snapshot' needs a 'dir' (or a server --snapshot-dir)",
                code=E_BAD_REQUEST)
        from repro_torch.core.service.snapshot import save_snapshot
        manifest = save_snapshot(self.service.registry, directory)
        return {"ok": True, "dir": directory,
                "designs": sorted(manifest["designs"]),
                "skipped": manifest["skipped"]}

    def _op_shutdown(self, msg: dict) -> dict:
        return {"ok": True, "shutdown": True}


class SessionHandle(str):
    """A live session: the v2 client-side handle.

    Subclasses ``str`` (its value IS the session id), so every API that
    accepted a sid string — including JSON encoding and the deprecated
    sid-based client methods — keeps working on a handle unchanged,
    while new code gets methods scoped to the one session:

        with client.open("gemm", budget=300) as h:
            for event in h.stream():
                ...
            dse = h.result()

    Exiting the ``with`` block releases the session server-side.
    """

    def __new__(cls, sid: str, client: "AdvisorClient"):
        self = super().__new__(cls, sid)
        self._client = client
        return self

    def status(self) -> dict:
        return self._client._status(str(self))

    def stream(self, max_rounds: Optional[int] = None) -> Iterator[dict]:
        """Drive the service and yield this session's events as they
        appear, until the session finishes (or ``max_rounds``)."""
        rounds = 0
        while True:
            self._client.request({"op": "step"})
            rounds += 1
            yield from self._client.events(str(self))
            if self.status()["state"] != "running":
                yield from self._client.events(str(self))
                return
            if max_rounds is not None and rounds >= max_rounds:
                return

    def result(self):
        """The real :class:`DseResult` object (in-process privilege)."""
        return self._client._result(str(self))

    def result_json(self, alpha: float = 0.7) -> dict:
        return self._client._result_json(str(self), alpha)

    def cancel(self) -> dict:
        return self._client._cancel(str(self))

    def release(self) -> dict:
        """Forget the session server-side (fetch results first)."""
        return self._client._release(str(self))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class AdvisorClient:
    """In-process client for tests, examples, and benchmarks.

    Speaks the same request/response dicts as the wire protocol (so
    protocol coverage comes for free) but drives the service loop
    itself — there is no server; :meth:`run` is a synchronous
    open-and-drive call returning the real
    :class:`~repro_torch.core.advisor.DseResult` object.

    :meth:`open` returns a :class:`SessionHandle`; the pre-v2 sid-string
    methods (``client.status(sid)`` etc.) still work but emit a
    :class:`DeprecationWarning` — use the handle's methods.
    """

    def __init__(self, service: Optional[AdvisoryService] = None,
                 **service_kwargs):
        self.service = service or AdvisoryService(**service_kwargs)
        self.handler = ProtocolHandler(self.service)
        #: protocol version negotiated with the handler (always the
        #: newest here; TCP clients get it from their hello reply)
        self.proto = self.request({"op": "hello", "proto": PROTO})["proto"]

    def request(self, msg: dict) -> dict:
        """Send one protocol request; raises on an error response (the
        raised :class:`ProtocolError` carries the frame's ``code``)."""
        out = self.handler.handle(msg)
        if not out.get("ok"):
            extra = {k: v for k, v in out.items()
                     if k not in ("ok", "code", "error", "id")}
            raise ProtocolError(out.get("error", "request failed"),
                                code=out.get("code", E_INTERNAL), **extra)
        return out

    # ------------------------------------------------------- conveniences
    def open(self, design: str, optimizer: str = "grouped_sa",
             budget: int = 300, seed: int = 0,
             progress: Optional[bool] = None, **kwargs) -> SessionHandle:
        """Open a session; returns its :class:`SessionHandle`."""
        msg = {"op": "open", "design": design, "optimizer": optimizer,
               "budget": budget, "seed": seed}
        if progress is not None:
            msg["progress"] = progress
        if kwargs:
            msg["kwargs"] = kwargs
        return SessionHandle(self.request(msg)["session"], self)

    def drive(self, max_rounds: Optional[int] = None) -> int:
        """Advance the service until idle; returns rounds executed."""
        return self.request({"op": "run", "max_rounds": max_rounds})[
            "rounds"]

    def run(self, design: str, optimizer: str = "grouped_sa",
            budget: int = 300, seed: int = 0, **kwargs):
        """Open + drive to completion; returns the session's
        :class:`DseResult` (bit-identical to ``FifoAdvisor.run``)."""
        handle = self.open(design, optimizer=optimizer, budget=budget,
                           seed=seed, **kwargs)
        self.drive()
        return handle.result()

    def events(self, sid: Optional[str] = None) -> List[dict]:
        """Drain queued progress/done events."""
        return self.handler.poll_events(sid)

    def attach(self, sid: str, after_seq: int = -1) -> dict:
        """Reconnect to a session: replay its event suffix after
        ``after_seq`` (see the ``attach`` op)."""
        return self.request({"op": "attach", "session": sid,
                             "after_seq": after_seq})

    # ------------------------------------------- private per-sid backends
    def _cancel(self, sid: str) -> dict:
        return self.request({"op": "cancel", "session": sid})

    def _release(self, sid: str) -> dict:
        return self.request({"op": "release", "session": sid})

    def _status(self, sid: str) -> dict:
        return self.request({"op": "status", "session": sid})

    def _result(self, sid: str):
        return self.service.result(sid)

    def _result_json(self, sid: str, alpha: float = 0.7) -> dict:
        return self.request({"op": "result", "session": sid,
                             "alpha": alpha})["result"]

    # --------------------------------------- deprecated sid-string methods
    def _deprecated_sid(self, name: str):
        warnings.warn(
            f"AdvisorClient.{name}(sid) is deprecated; use the "
            f"SessionHandle returned by open() — handle.{name}()",
            DeprecationWarning, stacklevel=3)

    def cancel(self, sid: str) -> dict:
        self._deprecated_sid("cancel")
        return self._cancel(sid)

    def release(self, sid: str) -> dict:
        """Deprecated: use ``handle.release()``."""
        self._deprecated_sid("release")
        return self._release(sid)

    def status(self, sid: str) -> dict:
        self._deprecated_sid("status")
        return self._status(sid)

    def result(self, sid: str):
        """Deprecated: use ``handle.result()``."""
        self._deprecated_sid("result")
        return self._result(sid)

    def result_json(self, sid: str, alpha: float = 0.7) -> dict:
        self._deprecated_sid("result_json")
        return self._result_json(sid, alpha)

    def close(self) -> None:
        self.service.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
