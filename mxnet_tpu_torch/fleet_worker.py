"""Fleet worker process: one server behind the gateway — the counterpart
of ``mxnet_tpu/fleet_worker.py``.

One worker process builds a :class:`~mxnet_tpu_torch.serving.ModelServer`
or :class:`~mxnet_tpu_torch.generation.GenerationServer` from a
``--builder`` factory (``module:function``, called with no arguments),
serves it over a slim stdlib HTTP/JSON endpoint, and publishes TTL'd load
reports (including its serving address) into the async-KV service
registry every heartbeat — the gateway routes on nothing else.  Run it
as::

    python -m mxnet_tpu_torch.fleet_worker --registry HOST:PORT --rid w0 \
        [--builder module:function]

The builder decides the device: the demo builders here default to the
card (``cuda:0``) and raise without one, as every entry point of the
package does; a builder that asks for the CPU gets the CPU.

Contracts this entrypoint honors:

* **rc-76 graceful drain** — SIGTERM/SIGINT installs the shared
  :func:`~mxnet_tpu_torch.elastic.install_preemption_drain` flow:
  admission closes immediately, active generation streams are parked for
  live migration, in-flight work finishes, the registry entry is
  withdrawn, and the process exits :data:`~mxnet_tpu_torch.elastic.
  PREEMPTED_EXIT_CODE` so the :class:`~mxnet_tpu_torch.fleet.
  WorkerSupervisor` restarts it for free.
* **registry partition tolerance** — a failed heartbeat publish is
  counted and retried next beat; when the partition heals, the next
  successful beat re-registers (TTL lapse -> reap -> re-register).
* **idempotency** — requests carry an idempotency key; a key already
  executing or executed on this worker replays the stored outcome
  instead of double-executing, so a gateway retry after a lost reply is
  safe.

HTTP surface (JSON bodies; one typed terminal outcome per request).
A worker hosts one or more **named model routes** (``model@version``
style): every verb below also exists route-qualified as
``POST /v1/<route>/<verb>``, the bare form aliasing route ``"default"``.
An unhosted route is a typed 404 ``UnknownRoute``; requests carry the
validated ``X-MXTPU-Tenant`` header (malformed -> typed 400
``BadTenant``, never a 500).

* ``POST /v1/predict``  — ``{"inputs": {name: nested-list}, ...}`` ->
  ``{"outputs": [...]}`` or ``{"error": <ServingError name>}``.
* ``POST /v1/generate`` — ``{"prompt": [ids], ...}`` -> a streamed
  NDJSON body: one ``{"token": t}`` line per generated token, then a
  terminal ``{"done": true, ...}`` or ``{"error": ...}`` line — or a
  non-terminal ``{"migrate": handle, ...}`` line when the stream was
  parked for live migration (the gateway carries it to a sibling).
* ``POST /v1/<route>/adapter`` — ``{"adapter": name}`` hot-swaps the
  route's resident adapter (same names/shapes/dtypes -> zero
  ``recompile``, asserted via the ``recompiles`` field the response and
  ``/healthz`` both carry).
* ``POST /v1/migrate_out`` — ``{"park": n}`` parks up to n streams and
  returns their handles; ``{"handle": h}`` exports one parked stream as
  a base64 KV blob.
* ``POST /v1/migrate_in`` — app-level chunked blob upload
  ``{"key", "seq", "total", "data"}``; the final chunk installs the
  blob and returns ``{"handle": h'}``.  Replayed chunks are safe.
* ``POST /v1/migrate_abort`` — ``{"key": k}`` and/or ``{"handle": h}``
  frees a half-assembled buffer / staged import (leakcheck-audited).
* ``POST /v1/defrag``   — compact fragmented KV page tables in place.
* ``GET /healthz``      — worker snapshot (state, inflight, beats).

Env knobs (``MXTPU_FLEET_WORKER_*``, ``MXTPU_MIGRATE_*``, read through
:mod:`~mxnet_tpu_torch.config`): heartbeat period, idempotency-cache
size, default deadline, transfer-buffer TTL, drain wait.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from . import racecheck as _racecheck
from .config import config as _config

__all__ = ["FleetWorker", "demo_model", "demo_generation", "demo_duo",
           "demo_params", "main"]

_DEF_HEARTBEAT_S = _config.fleet_worker_heartbeat_s
_DEF_IDEM_CACHE = _config.fleet_worker_idem_cache
_DEF_DEADLINE_MS = _config.fleet_worker_deadline_ms
# live KV migration: receiver transfer buffers expire on the same TTL the
# server uses for parked streams; the drain path waits this long for
# parked streams' export
_DEF_MIGR_TTL_S = _config.migrate_park_timeout_s
_DEF_MIGR_DRAIN_WAIT_S = _config.migrate_drain_wait_s

def _log(msg):
    print("[fleet-worker] %s" % msg, file=sys.stderr, flush=True)


def _count(name, delta=1):
    from . import profiler as _prof

    _prof.dispatch_count(name, delta)


# error type name -> HTTP status (the gateway keys retries off these)
_ERROR_STATUS = {
    "Overloaded": 429,
    "DeadlineExceeded": 504,
    "Draining": 503,
    "Unavailable": 503,
    "ReplicaLost": 502,
    # per-tenant shed: the flooding tenant's own outcome — 429 so naive
    # clients back off, but the gateway never spills it to a sibling
    "QuotaExceeded": 429,
    # no worker hosts the named route: a client error, not capacity
    "UnknownRoute": 404,
}


class _IdemEntry:
    """One idempotency-key slot: pending until the owner settles it."""

    __slots__ = ("event", "status", "body", "lines")

    def __init__(self):
        self.event = threading.Event()
        self.status = None
        self.body = None       # JSON-able dict (predict) or None
        self.lines = None      # list of NDJSON lines (generate) or None

    def settle(self, status, body=None, lines=None):
        self.status, self.body, self.lines = status, body, lines
        self.event.set()


@_racecheck.track("requests", "idem_replays", "streams_parked",
                  "migrations_in", "migrations_aborted",
                  "adapter_swaps")
class FleetWorker:
    """One worker process's runtime: HTTP endpoint + registry heartbeat
    around a built ``ModelServer``/``GenerationServer``.

    The server object is only touched through its own locked public
    surface; worker state is plain attributes plus one small lock around
    the idempotency dict (never held across anything blocking — the
    CC001 discipline, same as the fleet supervisor)."""

    def __init__(self, server, rid, registry=None, registry_addr=None,
                 service="default", host="127.0.0.1", port=0,
                 heartbeat_s=None, idem_cache=None, adapters=None):
        from .fleet import ServiceRegistry
        from .tenancy import parse_route

        # ``server`` is one server (hosted as route "default") or a
        # {route: server} dict — several builders multiplexed behind one
        # worker process, each addressable as POST /v1/<route>/<verb>
        if isinstance(server, dict):
            if not server:
                raise ValueError("route map must host at least one server")
            self.servers = {parse_route(r): s for r, s in server.items()}
        else:
            self.servers = {"default": server}
        self.kinds = {r: ("generate"
                          if type(s).__name__ == "GenerationServer"
                          else "predict")
                      for r, s in self.servers.items()}
        # back-compat: single-route callers keep .server / .kind
        _first = next(iter(self.servers))
        self.server = self.servers[_first]
        self.kind = self.kinds[_first]
        # resident adapter sets: {route: {name: params-or-factory}};
        # factories are called once and cached so a swap is O(assign)
        self._adapters = {parse_route(r): dict(a)
                          for r, a in (adapters or {}).items()}
        self._adapter_live = {r: "base" for r in self._adapters}
        self.adapter_swaps = 0
        self.rid = str(rid)
        self.registry = registry if registry is not None else \
            ServiceRegistry(addr=registry_addr, service=service)
        self.heartbeat_s = _DEF_HEARTBEAT_S if heartbeat_s is None \
            else float(heartbeat_s)
        self.beats = 0           # heartbeat-thread-only (single writer)
        self.beats_failed = 0
        # stats bumped from concurrent handler threads and read by the
        # heartbeat's load report: every access under _stats_lock
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.idem_replays = 0
        self._beat_seq = 0
        self._idem = OrderedDict()
        self._idem_cap = (_DEF_IDEM_CACHE if idem_cache is None
                          else int(idem_cache))  # immutable after __init__
        self._idem_lock = threading.Lock()
        self._drain_evt = threading.Event()
        self._stop_evt = threading.Event()
        self._preemption = None
        # live-migration receiver state: chunk-reassembly buffers keyed
        # by the gateway's transfer key, plus a bounded replay cache of
        # settled transfers (key -> terminal response dict).  The lock
        # guards only the dicts — blob install runs outside it.
        self._migr_lock = threading.Lock()
        self._migr_buf = {}           # key -> {"chunks", "total", "expires"}
        self._migr_done = OrderedDict()
        self.streams_parked = 0
        self.migrations_in = 0
        self.migrations_aborted = 0

        self.httpd = self._make_httpd(host, port)
        self.port = self.httpd.server_address[1]
        self.addr = "%s:%d" % (host, self.port)
        self._threads = [
            threading.Thread(target=self.httpd.serve_forever,
                             name="worker-http", daemon=True),
            threading.Thread(target=self._heartbeat_loop,
                             name="worker-heartbeat", daemon=True),
        ]

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        for t in self._threads:
            if not t.is_alive():
                t.start()
        _log("worker %s (%s) serving on %s" % (self.rid, self.kind,
                                               self.addr))
        return self

    def install_drain(self, handler=None):
        """Shared rc-76 wiring: the first SIGTERM/SIGINT sets the drain
        flag (async-signal safe), the main loop finishes the job."""
        from .elastic import install_preemption_drain

        self._preemption = install_preemption_drain(self._drain_evt.set,
                                                    handler=handler)
        return self._preemption

    def run(self):
        """Serve until a drain signal, then migrate out active streams,
        withdraw + drain + exit 76."""
        self.start()
        while not self._drain_evt.wait(0.1):
            pass
        self._migrate_on_drain()
        self.shutdown(drain_timeout=60)
        if self._preemption is not None:
            self._preemption.drain()          # exits rc 76

    def _migrate_on_drain(self, wait_s=None):
        """rc-76 zero-loss drain: withdraw from the registry (no new
        streams land here), park every active generation stream — each
        in-flight ``/v1/generate`` handler emits its ``migrate`` line —
        then keep the HTTP endpoint alive until the gateway has fetched
        every parked blob (or a bounded wait expires and the leftovers
        fall back to journal resume).  Returns how many streams parked."""
        gens = [s for r, s in self.servers.items()
                if self.kinds[r] == "generate"
                and hasattr(s, "park_streams")]
        if not gens:
            return 0
        try:
            self.registry.withdraw(self.rid)
        except Exception:
            pass
        handles = []
        parked_srvs = []
        for srv in gens:
            try:
                hs = srv.park_streams()
            except Exception as e:
                _log("drain park failed (%s: %s) — falling back to plain "
                     "drain" % (type(e).__name__, e))
                continue
            if hs:
                handles.extend(hs)
                parked_srvs.append(srv)
        if not handles:
            return 0
        with self._stats_lock:
            self.streams_parked += len(handles)
        _count("fleet_worker_drain_parked", len(handles))
        _log("drain: parked %d stream(s) for migration" % len(handles))
        wait_s = _DEF_MIGR_DRAIN_WAIT_S if wait_s is None \
            else float(wait_s)
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            try:
                if not any(s.snapshot().get("parked")
                           for s in parked_srvs):
                    break
            except Exception:
                break
            time.sleep(0.05)
        return len(handles)

    def shutdown(self, drain_timeout=30):
        """Withdraw from the registry, drain the server, stop serving."""
        self._stop_evt.set()
        try:
            self.registry.withdraw(self.rid)
        except Exception:
            pass                  # registry may be partitioned/gone
        for srv in self.servers.values():
            srv.drain(timeout=drain_timeout)
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            if t.is_alive() and t is not threading.current_thread():
                t.join(timeout=5.0)

    @staticmethod
    def _srv_inflight(kind, snap):
        if kind == "generate":
            return snap.get("pending", 0) + snap.get("active", 0)
        return sum(r["inflight"] for r in snap["replicas"]) \
            + snap.get("queue_depth", 0)

    def snapshot(self):
        from . import profiler as _prof

        inflight = parked = 0
        state = None
        for route, srv in self.servers.items():
            snap = srv.snapshot()
            inflight += self._srv_inflight(self.kinds[route], snap)
            parked += snap.get("parked", 0)
            # one lifecycle for the whole worker: all routes drain
            # together, so any non-SERVING route is the worker's state
            if state is None or snap["state"] != "SERVING":
                state = snap["state"]
        with self._stats_lock:
            stats = {"requests": self.requests,
                     "idem_replays": self.idem_replays,
                     "streams_parked": self.streams_parked,
                     "migrations_in": self.migrations_in,
                     "migrations_aborted": self.migrations_aborted,
                     "adapter_swaps": self.adapter_swaps,
                     "adapter_live": dict(self._adapter_live)}
        return {"rid": self.rid, "kind": self.kind, "addr": self.addr,
                "pid": os.getpid(), "state": state,
                "inflight": inflight, "beats": self.beats,
                "beats_failed": self.beats_failed,
                # route advertisement: the gateway routes on nothing but
                # these heartbeats, so hosted routes + resident adapter
                # sets travel in every load report
                "routes": dict(self.kinds),
                "adapters": {r: sorted(a)
                             for r, a in self._adapters.items()},
                **stats,
                "parked": parked,
                # the zero-recompile assertion reaches across the
                # process boundary through /healthz
                "recompiles": _prof.dispatch_value("recompile")}

    # -- heartbeat ---------------------------------------------------------
    def _heartbeat_loop(self):
        from . import chaos as _chaos

        while not self._stop_evt.is_set():
            beat = self._beat_seq
            self._beat_seq += 1
            n_adapters = sum(len(a) for a in self._adapters.values())
            if _chaos.adapter_swap_mid_burst(beat, n_adapters):
                self._chaos_adapter_swap()
            try:
                snap = self.snapshot()
                snap["beat"] = beat
                self.registry.publish(self.rid, snap)
                self.beats += 1
                _count("fleet_worker_beats")
            except Exception as e:
                # a partitioned registry must not kill the worker: keep
                # serving, re-register on the next successful beat
                self.beats_failed += 1
                _count("fleet_worker_beats_failed")
                _log("heartbeat %d failed (%s: %s) — will re-register "
                     "on heal" % (beat, type(e).__name__, e))
            self._sweep_migr_buffers()
            self._stop_evt.wait(self.heartbeat_s)

    # -- idempotency -------------------------------------------------------
    def _idem_claim(self, key):
        """(entry, owner): owner=True means this thread must execute and
        settle the entry; False means replay/wait on it."""
        with self._idem_lock:
            ent = self._idem.get(key)
            if ent is not None:
                return ent, False
            ent = _IdemEntry()
            self._idem[key] = ent
            while len(self._idem) > self._idem_cap:
                self._idem.popitem(last=False)
            return ent, True

    def _idem_forget(self, key):
        """Drop a pre-admission rejection so a later retry can succeed."""
        with self._idem_lock:
            self._idem.pop(key, None)

    # -- request handling --------------------------------------------------
    def _handle_predict(self, body, srv=None):
        from . import serving

        srv = self.server if srv is None else srv
        key = body.get("idempotency_key")
        ent = owner = None
        if key:
            ent, owner = self._idem_claim(key)
            if not owner:
                ent.event.wait(timeout=_DEF_DEADLINE_MS / 1e3)
                with self._stats_lock:
                    self.idem_replays += 1
                _count("fleet_worker_idem_replays")
                return ent.status or 500, dict(ent.body or
                                               {"error": "Unavailable"})
        try:
            inputs = {name: np.asarray(v, np.float32)
                      for name, v in dict(body["inputs"]).items()}
            out = srv.submit(
                inputs, deadline_ms=body.get("deadline_ms"),
                priority=body.get("priority"),
                tenant=body.get("tenant"))
            resp = {"outputs": [np.asarray(o).tolist() for o in out],
                    "rid": self.rid}
            status = 200
            if ent is not None:
                ent.settle(status, body=resp)
        except serving.ServingError as e:
            resp = {"error": type(e).__name__, "message": str(e),
                    "rid": self.rid}
            status = _ERROR_STATUS.get(type(e).__name__, 500)
            if ent is not None:
                if isinstance(e, (serving.Overloaded, serving.Draining,
                                  serving.QuotaExceeded)):
                    # pre-admission rejection: nothing executed, a retry
                    # elsewhere/later must not replay the rejection
                    ent.settle(status, body=resp)
                    self._idem_forget(key)
                else:
                    ent.settle(status, body=resp)
        except Exception as e:
            resp = {"error": "Internal", "message": "%s: %s"
                    % (type(e).__name__, e), "rid": self.rid}
            status = 500
            if ent is not None:
                ent.settle(status, body=resp)
                self._idem_forget(key)
        return status, resp

    def _handle_generate(self, body, write_line, srv=None):
        """Run one generation request, streaming one NDJSON line per
        token through ``write_line``.  Returns the list of lines (for
        idempotent replay) — the last line is the typed terminal."""
        from . import serving

        srv = self.server if srv is None else srv
        key = body.get("idempotency_key")
        ent = owner = None
        if key:
            ent, owner = self._idem_claim(key)
            if not owner:
                ent.event.wait(timeout=_DEF_DEADLINE_MS / 1e3)
                with self._stats_lock:
                    self.idem_replays += 1
                _count("fleet_worker_idem_replays")
                for line in (ent.lines or
                             [{"error": "Unavailable", "rid": self.rid}]):
                    write_line(line)
                return
        lines = []

        def emit(line):
            lines.append(line)
            write_line(line)

        resume = body.get("resume_from")
        if resume:
            cap = int(body.get("max_new_tokens")
                      or srv.cfg.max_new_tokens)
            if len(resume) >= cap:
                # the dead worker generated everything but its terminal
                # line — nothing left to decode, finish the stream here
                mh = body.get("migrate_handle")
                if mh and hasattr(srv, "release_import"):
                    srv.release_import(mh)  # nothing to attach
                emit({"done": True, "tokens": 0, "rid": self.rid})
                if ent is not None:
                    ent.settle(200, lines=lines)
                return
        try:
            # resume_from (gateway mid-decode failover), priority (QoS
            # class from X-MXTPU-Priority) and tenant (X-MXTPU-Tenant,
            # validated at the front door) pass through verbatim
            fut = srv.submit_async(
                np.asarray(body["prompt"], np.int32),
                max_new_tokens=body.get("max_new_tokens"),
                deadline_ms=body.get("deadline_ms"),
                temperature=body.get("temperature"),
                top_k=body.get("top_k"),
                seed=body.get("seed"),
                priority=body.get("priority"),
                resume_from=body.get("resume_from"),
                migrate_handle=body.get("migrate_handle"),
                tenant=body.get("tenant"))
        except serving.ServingError as e:
            emit({"error": type(e).__name__, "message": str(e),
                  "rid": self.rid})
            if ent is not None:
                ent.settle(_ERROR_STATUS.get(type(e).__name__, 500),
                           lines=lines)
                self._idem_forget(key)     # pre-admission: retryable
            return
        try:
            n = 0
            for tok in fut.tokens(timeout=_DEF_DEADLINE_MS / 1e3):
                n += 1
                emit({"token": int(tok)})
            emit({"done": True, "tokens": n, "rid": self.rid})
            if ent is not None:
                ent.settle(200, lines=lines)
        except serving.StreamMigrated as e:
            # NOT a client-terminal outcome: the stream was parked for
            # live migration.  Hand the gateway the export handle; it
            # carries the KV blob to a sibling and re-issues the request
            # there with no client-visible gap.  Replays of this key see
            # the same line and re-enter the same fetch-or-fallback path.
            emit({"migrate": e.handle, "tokens": n, "rid": self.rid})
            if ent is not None:
                ent.settle(200, lines=lines)
        except serving.ServingError as e:
            emit({"error": type(e).__name__, "message": str(e),
                  "rid": self.rid})
            if ent is not None:
                ent.settle(_ERROR_STATUS.get(type(e).__name__, 500),
                           lines=lines)
        except Exception as e:
            emit({"error": "Internal", "message": "%s: %s"
                  % (type(e).__name__, e), "rid": self.rid})
            if ent is not None:
                ent.settle(500, lines=lines)
                self._idem_forget(key)

    # -- live migration ----------------------------------------------------
    def _handle_migrate_out(self, body, srv=None):
        """Sender side.  ``{"park": n}`` parks up to n streams (their
        in-flight ``/v1/generate`` handlers emit the ``migrate`` lines);
        ``{"handle": h}`` exports one parked stream as a base64 blob —
        the export pops the record, so a replayed fetch of the same
        handle returns 404 and the gateway falls back to resume."""
        import base64

        srv = self.server if srv is None else srv
        if "handle" in body:
            try:
                blob = srv.export_stream(str(body["handle"]))
            except KeyError:
                return 404, {"error": "UnknownHandle", "rid": self.rid}
            except Exception as e:
                return 500, {"error": "Internal", "message": "%s: %s"
                             % (type(e).__name__, e), "rid": self.rid}
            return 200, {"blob": base64.b64encode(blob).decode("ascii"),
                         "rid": self.rid}
        n = body.get("park")
        try:
            handles = srv.park_streams(
                None if n in (None, "all") else int(n))
        except Exception as e:
            return 500, {"error": "Internal", "message": "%s: %s"
                         % (type(e).__name__, e), "rid": self.rid}
        with self._stats_lock:
            self.streams_parked += len(handles)
        if handles:
            _count("fleet_worker_parked", len(handles))
        return 200, {"handles": list(handles), "rid": self.rid}

    def _handle_migrate_in(self, body, srv=None):
        """Receiver side: app-level chunked upload (the stdlib server
        cannot parse chunked request bodies).  ``key`` is the transfer's
        idempotency key; the final chunk assembles + installs the blob
        and the settled outcome is cached so replays are safe.  The
        half-assembled buffer is a tracked ``migrations`` leakcheck
        resource until installed, aborted, or expired."""
        import base64

        from . import leakcheck, serving

        srv = self.server if srv is None else srv
        try:
            key = str(body["key"])
            seq = int(body["seq"])
            total = int(body["total"])
            data = base64.b64decode(body.get("data", "") or "")
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": "BadRequest", "message": str(e),
                         "rid": self.rid}
        if total < 1 or not 0 <= seq < total:
            return 400, {"error": "BadRequest",
                         "message": "chunk %d/%d out of range"
                         % (seq, total), "rid": self.rid}
        with self._migr_lock:
            done = self._migr_done.get(key)
            if done is not None:
                status, resp = done
                return status, dict(resp)       # idempotent replay
            buf = self._migr_buf.get(key)
            if buf is None:
                buf = self._migr_buf[key] = {
                    "chunks": {}, "total": total,
                    "expires": time.monotonic() + _DEF_MIGR_TTL_S}
                leakcheck.track("migrations", key)
            buf["chunks"][seq] = data
            buf["expires"] = time.monotonic() + _DEF_MIGR_TTL_S
            if len(buf["chunks"]) < buf["total"]:
                return 200, {"ok": True, "have": len(buf["chunks"]),
                             "rid": self.rid}
            # complete: consume the buffer, install outside the lock
            del self._migr_buf[key]
        leakcheck.untrack("migrations", key)
        blob = b"".join(buf["chunks"][i] for i in range(total))
        try:
            handle = srv.import_stream(blob)
        except ValueError as e:
            # corrupt/mismatched blob: checksum-or-version fallback —
            # the gateway degrades to re-prefill resume
            status, resp = 400, {"error": "BadBlob", "message": str(e),
                                 "rid": self.rid}
        except serving.ServingError as e:
            status = _ERROR_STATUS.get(type(e).__name__, 500)
            resp = {"error": type(e).__name__, "message": str(e),
                    "rid": self.rid}
        except Exception as e:
            status, resp = 500, {"error": "Internal", "message": "%s: %s"
                                 % (type(e).__name__, e), "rid": self.rid}
        else:
            status, resp = 200, {"handle": handle, "rid": self.rid}
            with self._stats_lock:
                self.migrations_in += 1
            _count("fleet_worker_migrations_in")
        with self._migr_lock:
            self._migr_done[key] = (status, resp)
            while len(self._migr_done) > self._idem_cap:
                self._migr_done.popitem(last=False)
        return status, dict(resp)

    def _handle_migrate_abort(self, body, srv=None):
        """Transfer-abort: drop a half-assembled buffer by ``key`` (and
        release its install if the final chunk already landed), and/or
        release a staged import by ``handle``.  Idempotent — aborting an
        unknown transfer is a no-op, not an error."""
        from . import leakcheck

        srv = self.server if srv is None else srv
        dropped = False
        key = body.get("key")
        if key is not None:
            with self._migr_lock:
                buf = self._migr_buf.pop(str(key), None)
                done = self._migr_done.pop(str(key), None)
            if buf is not None:
                leakcheck.untrack("migrations", str(key))
                dropped = True
            if done is not None and done[0] == 200 \
                    and "handle" in done[1]:
                # installed, but the gateway gave up before attaching
                dropped = srv.release_import(
                    done[1]["handle"]) or dropped
        handle = body.get("handle")
        if handle is not None \
                and hasattr(srv, "release_import"):
            dropped = srv.release_import(str(handle)) or dropped
        if dropped:
            with self._stats_lock:
                self.migrations_aborted += 1
            _count("fleet_worker_migrations_aborted")
        return 200, {"aborted": bool(dropped), "rid": self.rid}

    def _handle_defrag(self, body, srv=None):
        """In-worker defrag: migrate fragmented streams to this server
        itself, compacting page tables toward low page ids."""
        from . import serving

        srv = self.server if srv is None else srv
        try:
            moved = srv.defrag()
        except serving.ServingError as e:
            return _ERROR_STATUS.get(type(e).__name__, 500), \
                {"error": type(e).__name__, "message": str(e),
                 "rid": self.rid}
        except Exception as e:
            return 500, {"error": "Internal", "message": "%s: %s"
                         % (type(e).__name__, e), "rid": self.rid}
        return 200, {"moved": int(moved), "rid": self.rid}

    # -- adapter hot-multiplexing ------------------------------------------
    def _resolve_adapter(self, route, name):
        """Adapter params for (route, name); factories are called once
        and the materialized params cached in place."""
        params = self._adapters[route][name]
        if callable(params):
            params = params()          # blocking init: outside any lock
            with self._stats_lock:     # key set is fixed after __init__;
                self._adapters[route][name] = params  # value swap only
        return params

    def _handle_adapter(self, body, srv=None, route=None):
        """``{"adapter": name}`` hot-swaps ``route``'s resident weights
        over the atomic hot-swap contract — ``swap_params`` for a
        generation server, ``reload(params=...)`` for a model server.
        The response carries the process recompile counter before and
        after: equal values are the zero-recompile proof, asserted by
        the acceptance test across the process boundary."""
        from . import profiler as _prof
        from . import serving

        srv = self.server if srv is None else srv
        route = route or next(r for r, s in self.servers.items()
                              if s is srv)
        name = str(body.get("adapter", ""))
        if name not in self._adapters.get(route, ()):
            return 404, {"error": "UnknownAdapter",
                         "message": "route %r hosts adapters %s"
                         % (route,
                            sorted(self._adapters.get(route, ()))),
                         "rid": self.rid}
        before = _prof.dispatch_value("recompile")
        try:
            params = self._resolve_adapter(route, name)
            if hasattr(srv, "swap_params"):
                srv.swap_params(params)
            else:
                srv.reload(params=params)
        except (ValueError, serving.ServingError) as e:
            return 409, {"error": "BadAdapter", "message": str(e),
                         "rid": self.rid}
        except Exception as e:
            return 500, {"error": "Internal", "message": "%s: %s"
                         % (type(e).__name__, e), "rid": self.rid}
        with self._stats_lock:
            self.adapter_swaps += 1
            self._adapter_live[route] = name
        _count("fleet_worker_adapter_swaps")
        return 200, {"adapter": name, "route": route, "rid": self.rid,
                     "recompiles_before": before,
                     "recompiles_after": _prof.dispatch_value("recompile")}

    def _chaos_adapter_swap(self):
        """``adapter_swap_mid_burst@n`` fault: cycle the first
        adapter-bearing route to its next resident adapter, exactly the
        way an operator rollout would, while traffic is in flight."""
        for route in self._adapters:
            names = sorted(self._adapters[route])
            if not names:
                continue
            with self._stats_lock:
                live = self._adapter_live.get(route)
            nxt = names[(names.index(live) + 1) % len(names)] \
                if live in names else names[0]
            status, resp = self._handle_adapter(
                {"adapter": nxt}, srv=self.servers[route], route=route)
            _log("chaos adapter_swap_mid_burst: route %s -> %s (%d)"
                 % (route, nxt, status))
            return status == 200
        return False

    def _sweep_migr_buffers(self):
        """Expire abandoned chunk buffers (gateway died mid-transfer)
        so a lost sender cannot pin receiver memory forever."""
        from . import leakcheck

        now = time.monotonic()
        with self._migr_lock:
            if not self._migr_buf:
                return
            stale = [k for k, b in self._migr_buf.items()
                     if now >= b["expires"]]
            for k in stale:
                del self._migr_buf[k]
        for k in stale:
            leakcheck.untrack("migrations", k)
            _log("migrate_in buffer %r expired before completion" % k)

    # -- HTTP plumbing -----------------------------------------------------
    def _make_httpd(self, host, port):
        worker = self

        class _Handler(BaseHTTPRequestHandler):
            def _json(self, status, obj):
                data = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, worker.snapshot())
                else:
                    self._json(404, {"error": "NotFound"})

            def do_POST(self):
                with worker._stats_lock:
                    worker.requests += 1
                _count("fleet_worker_requests")
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, OSError) as e:
                    self._json(400, {"error": "BadRequest",
                                     "message": str(e)})
                    return
                prio = self.headers.get("X-MXTPU-Priority")
                if prio:
                    body.setdefault("priority", prio)
                # tenant rides the X-MXTPU-Tenant header (or the body,
                # on gateway-forwarded requests): validated HERE so a
                # hostile value is a typed 400, never a handler 500
                from .tenancy import parse_route, parse_tenant

                try:
                    body["tenant"] = parse_tenant(
                        body.get("tenant",
                                 self.headers.get("X-MXTPU-Tenant")))
                except ValueError as e:
                    self._json(400, {"error": "BadTenant",
                                     "message": str(e)})
                    return
                # /v1/<verb> aliases /v1/default/<verb>
                parts = self.path.strip("/").split("/")
                if len(parts) == 2 and parts[0] == "v1":
                    route, verb = "default", parts[1]
                elif len(parts) == 3 and parts[0] == "v1":
                    route, verb = parts[1], parts[2]
                else:
                    self._json(404, {"error": "NotFound",
                                     "message": "no %s here" % self.path})
                    return
                try:
                    route = parse_route(route)
                except ValueError as e:
                    self._json(404, {"error": "UnknownRoute",
                                     "message": str(e)})
                    return
                srv = worker.servers.get(route)
                if srv is None:
                    self._json(404, {"error": "UnknownRoute",
                                     "message":
                                         "worker hosts routes %s, not %r"
                                     % (sorted(worker.servers), route)})
                    return
                kind = worker.kinds[route]
                if verb == "predict" and kind == "predict":
                    status, resp = worker._handle_predict(body, srv=srv)
                    self._json(status, resp)
                elif verb == "generate" and kind == "generate":
                    # streamed NDJSON: no Content-Length, one JSON line
                    # per token, connection close marks the end
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.end_headers()

                    def write_line(obj):
                        self.wfile.write(
                            (json.dumps(obj) + "\n").encode())
                        self.wfile.flush()

                    try:
                        worker._handle_generate(body, write_line,
                                                srv=srv)
                    except OSError:
                        pass      # client went away mid-stream
                elif verb == "adapter":
                    status, resp = worker._handle_adapter(body, srv=srv,
                                                          route=route)
                    self._json(status, resp)
                elif verb in ("migrate_out", "migrate_in",
                              "migrate_abort", "defrag") \
                        and kind == "generate":
                    fn = {"migrate_out": worker._handle_migrate_out,
                          "migrate_in": worker._handle_migrate_in,
                          "migrate_abort": worker._handle_migrate_abort,
                          "defrag": worker._handle_defrag}[verb]
                    status, resp = fn(body, srv=srv)
                    self._json(status, resp)
                else:
                    self._json(404, {"error": "NotFound",
                                     "message":
                                         "no %s on a %s route (%s)"
                                     % (verb, kind, route)})

            def log_message(self, *a):  # noqa: D102
                pass

        class _Srv(ThreadingHTTPServer):
            daemon_threads = True
            # the stdlib default backlog (5) resets connections when the
            # gateway retries a burst into one surviving worker
            request_queue_size = 128

        return _Srv((host, port), _Handler)


# ---------------------------------------------------------------------------
# demo builders (tiny models: spawn tests and smoke runs).  Called with no
# arguments, as ``--builder`` calls them, they run on the card; ``device=
# "cpu"`` runs them on the CPU.  Parameters come from a numpy seed: the
# JAX package's builders draw from jax.random, which torch cannot replay.
# ---------------------------------------------------------------------------
def _ctx(device):
    from . import resolve_device
    from .context import cpu, gpu

    dev = resolve_device(device)
    return cpu() if dev.type == "cpu" else gpu(dev.index)


def demo_model(device=None):
    """Tiny FC ModelServer (the JAX package's demo model: 4 -> 5, batch
    rows of 1, max_batch 4)."""
    from . import nd, sym
    from .serving import ModelServer

    ctx = _ctx(device)
    data = sym.var("data")
    w = sym.var("fc_weight")
    b = sym.var("fc_bias")
    out = sym.FullyConnected(data, w, b, num_hidden=5, name="fc")
    rng = np.random.RandomState(3)
    params = {"arg:fc_weight": nd.array(rng.rand(5, 4).astype(np.float32),
                                        ctx=ctx),
              "arg:fc_bias": nd.zeros((5,), ctx=ctx)}
    return ModelServer(out, params, input_shapes={"data": (1, 4)}, ctx=ctx,
                       max_queue=64, max_batch=4, max_wait_ms=20,
                       deadline_ms=30_000)


def _demo_lm_config():
    from .models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=97, d_model=64, n_heads=4,
                             n_layers=2, d_ff=128, max_len=64,
                             dtype="float32", remat=False)


def demo_params(cfg, seed):
    """A TransformerLM's flat parameter dict under the JAX names, as f32
    numpy arrays drawn from ``np.random.RandomState(seed)``: each matrix
    ``N(0, 1) / sqrt(fan_in)``, every norm scale 1 (the JAX ``init``'s
    distribution; ``load_jax_params`` casts to the model dtype)."""
    rng = np.random.RandomState(seed)
    L, E, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    HD = cfg.n_heads * cfg.head_dim

    def norm(shape, fan_in):
        return (rng.standard_normal(shape).astype(np.float32)
                / np.float32(np.sqrt(fan_in)))

    return {
        "embed": norm((V, E), E),
        "blocks.ln1_scale": np.ones((L, E), np.float32),
        "blocks.ln2_scale": np.ones((L, E), np.float32),
        "blocks.wqkv": norm((L, E, 3 * HD), E),
        "blocks.wo": norm((L, HD, E), HD),
        "final_ln_scale": np.ones((E,), np.float32),
        "unembed": norm((E, V), E),
        "blocks.w_up": norm((L, E, F_), E),
        "blocks.w_down": norm((L, F_, E), F_),
    }


def _demo_gen_config():
    from .generation import GenerationConfig

    return GenerationConfig(page_size=8, max_pages=64, max_slots=4,
                            max_new_tokens=16)


def demo_generation(device=None):
    """Tiny transformer GenerationServer (the JAX package's demo: vocab
    97, d_model 64, 4 heads, 2 layers, f32) for streamed-decode spawn
    tests."""
    from .generation import GenerationServer
    from .models.transformer import TransformerLM

    cfg = _demo_lm_config()
    model = TransformerLM(cfg, device=device).load_jax_params(
        demo_params(cfg, 0))
    return GenerationServer(model, _demo_gen_config(), device=model.device)


def demo_duo(device=None):
    """Two named routes behind one worker — a generation route with two
    resident same-shape adapters plus a predict route.  Returns
    ``(route_map, adapters)``; ``main()`` unpacks the pair."""
    from .generation import GenerationServer
    from .models.transformer import TransformerLM

    cfg = _demo_lm_config()
    params = demo_params(cfg, 0)
    model = TransformerLM(cfg, device=device).load_jax_params(params)
    gen = GenerationServer(model, _demo_gen_config(), device=model.device)
    # "alt" is a lazily-built second adapter with identical names/shapes/
    # dtypes — different weights, zero recompiles on swap
    adapters = {"gen@v1": {
        "base": params,
        "alt": lambda: demo_params(cfg, 1),
    }}
    return {"gen@v1": gen, "fc@v1": demo_model(device)}, adapters


def _resolve_builder(spec):
    """``module:function`` -> the zero-arg server factory."""
    import importlib

    mod, _, fn = str(spec).partition(":")
    return getattr(importlib.import_module(mod), fn or "build")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.fleet_worker",
        description="fleet worker process of mxnet_tpu_torch")
    ap.add_argument("--registry", required=True,
                    help="async-KV registry address host:port")
    ap.add_argument("--service", default="default")
    ap.add_argument("--rid", required=True,
                    help="replica id to register under")
    ap.add_argument("--builder",
                    default="mxnet_tpu_torch.fleet_worker:demo_model",
                    help="module:function returning the server to host "
                         "— or a {route: server} map, or a (map, "
                         "adapters) pair (e.g. %(prog)s:demo_duo)")
    ap.add_argument("--route", action="append", default=[],
                    metavar="NAME=MODULE:FN",
                    help="host MODULE:FN's server under route NAME "
                         "(repeatable; overrides --builder)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--heartbeat-s", type=float, default=None)
    ap.add_argument("--ttl-s", type=float, default=None)
    args = ap.parse_args(argv)

    from .fleet import ServiceRegistry

    adapters = None
    if args.route:
        server = {}
        for item in args.route:
            name, eq, spec = item.partition("=")
            if not eq:
                ap.error("--route wants NAME=MODULE:FN, got %r" % item)
            server[name] = _resolve_builder(spec)()
    else:
        server = _resolve_builder(args.builder)()
        if isinstance(server, tuple):
            server, adapters = server
    registry = ServiceRegistry(addr=args.registry, service=args.service,
                               ttl_s=args.ttl_s)
    worker = FleetWorker(server, args.rid, registry=registry,
                         host=args.host, port=args.port,
                         heartbeat_s=args.heartbeat_s,
                         adapters=adapters)
    worker.install_drain()
    worker.run()                    # returns only via the rc-76 exit
    raise SystemExit("fleet worker run loop ended without drain")


if __name__ == "__main__":
    main()
