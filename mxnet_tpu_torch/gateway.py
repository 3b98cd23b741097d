"""Front-door HTTP/JSON gateway for the cross-process fleet: the
counterpart of ``mxnet_tpu/gateway.py``.

A slim stdlib ``ThreadingHTTPServer`` that routes every request to the
least-loaded live worker (``python -m mxnet_tpu_torch.fleet_worker``) and
owns the failover contract, so clients see exactly one typed terminal
outcome per admitted request no matter which worker dies underneath them.

Routing (``_pick``):

* candidates come from the last :class:`~mxnet_tpu_torch.fleet.FleetView`
  refresh — workers that published an ``addr`` and report ``SERVING``;
* **least-loaded** — reported ``inflight`` plus the gateway's own
  in-flight count per worker (reports lag a heartbeat);
* **breaker-aware** — a worker reporting an ``OPEN`` breaker is skipped;
* **session affinity** — a generation request carrying ``session``
  sticks to the worker holding its KV pages;
* workers that just failed a connection are *suspect* for a short
  window, so the gateway routes around a corpse the (possibly stale)
  view still lists.

Partition tolerance: the refresh loop polls the registry every
``MXTPU_GATE_REFRESH_S``; when the registry is unreachable (or the
``gateway_partition`` chaos kind fires) the gateway keeps serving from
the **last-known-good view**, marks responses ``X-Fleet-Stale: 1``, and
re-syncs on the first successful refresh (:meth:`Gateway.refresh_once`).

Failover: every request gets an idempotency key (client-supplied or
generated), so a retry on another worker never double-executes — the
worker replays its stored outcome for a duplicate key.  A connection
that dies **before any token streamed** is retried on another worker
(``gateway_retries``).  A generation stream that dies **mid-decode** is
*resumed*: the gateway journals each stream's prompt, sampling parameters
(it mints a concrete ``seed`` so seeded sampling replays exactly on any
worker), and every token already delivered (bounded by
``MXTPU_GATE_JOURNAL_CAP``); on worker death it re-submits to a healthy
sibling with a ``resume_from`` payload and a fresh idempotency key — the
worker re-prefills prompt+prefix and streams only the continuation
(``gateway_stream_resumed``).  ``ReplicaLost`` is the fallback: the
resumed incarnation died too, no sibling existed, or the journal
overflowed its cap (``gateway_stream_lost``).

Live migration: a draining or rebalancing worker *parks* a stream and
emits a non-terminal ``migrate`` line.  The gateway fetches the stream's
versioned KV blob from the sender (``/v1/migrate_out``), relays it to a
healthy sibling in chunks (``/v1/migrate_in``, ``MXTPU_MIGRATE_CHUNK_KB``)
and re-issues the request there with the import handle — the receiver
attaches the shipped KV pages + rng state with no re-prefill
(``gateway_stream_migrated``).  Any transfer failure aborts the receiver
side and degrades to the journal-resume path
(``gateway_migrate_fallbacks``).

Surface: ``POST /v1/predict`` (JSON in/out, typed errors as statuses),
``POST /v1/generate`` (NDJSON stream; the terminal line is the typed
outcome; the ``X-MXTPU-Priority`` request header becomes the worker-side
QoS class), ``GET /v1/fleet`` (view + staleness), ``GET /healthz``.

Telemetry: the ``gateway.route_ms`` histogram (admission -> request
handed to a worker) and ``gateway_requests`` / ``gateway_retries`` /
``gateway_stream_resumed`` / ``gateway_stream_lost`` /
``gateway_registry_errors`` counters.

Threading: refresh loop and handler threads share plain attributes;
the only lock guards the in-flight/session dicts and the stats counters,
and is never held across anything blocking.
"""
from __future__ import annotations

import http.client
import json
import os
import sys
import threading
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import chaos as _chaos
from . import clock as _clockmod
from . import leakcheck as _leakcheck
from . import racecheck as _racecheck
from . import telemetry as _telemetry
from .config import config as _config

__all__ = ["Gateway"]

# env-tunable defaults (MXTPU_GATE_*, read through config at import)
_DEF_REFRESH_S = _config.gate_refresh_s
_DEF_RETRIES = _config.gate_retries
_DEF_TIMEOUT_S = _config.gate_timeout_s
_DEF_SUSPECT_S = _config.gate_suspect_s
_DEF_SESSION_CAP = _config.gate_session_cap
# max tokens journaled per stream for mid-decode resume; a stream past
# the cap falls back to ReplicaLost on worker death
_DEF_JOURNAL_CAP = _config.gate_journal_cap
# live KV migration transfer chunk size: the gateway relays sender blobs
# to the receiver in app-level chunks of this many KiB under one
# idempotency key
_DEF_MIGR_CHUNK_KB = _config.migrate_chunk_kb
# a worker lost mid-response: a failed connection, or a response cut short
# (``http.client.IncompleteRead`` when the worker dies after its headers)
_WORKER_LOST = (OSError, http.client.HTTPException)

def _log(msg):
    print("[gateway] %s" % msg, file=sys.stderr, flush=True)


def _count(name, delta=1):
    from . import profiler as _prof

    _prof.dispatch_count(name, delta)


@_racecheck.track("requests", "retried", "streams_lost",
                  "streams_resumed", "streams_migrated",
                  "migrate_fallbacks", "tokens_streamed")
class Gateway:
    """Route requests across registered fleet workers (one instance =
    one HTTP listener + one registry refresh loop)."""

    def __init__(self, registry=None, registry_addr=None,
                 service="default", host="127.0.0.1", port=0,
                 refresh_s=None, retries=None, timeout_s=None,
                 suspect_s=None, start=True, clock=None):
        from .fleet import ServiceRegistry

        self.clock = _clockmod.resolve(clock)
        self.registry = registry if registry is not None else \
            ServiceRegistry(addr=registry_addr, service=service)
        self.refresh_s = _DEF_REFRESH_S if refresh_s is None \
            else float(refresh_s)
        self.retries = _DEF_RETRIES if retries is None else int(retries)
        self.timeout_s = _DEF_TIMEOUT_S if timeout_s is None \
            else float(timeout_s)
        self.suspect_s = _DEF_SUSPECT_S if suspect_s is None \
            else float(suspect_s)

        # refresh state: plain attributes (single writer, GIL-atomic)
        self._view = None
        self._view_at = None
        self._refresh_failures = 0
        self._refresh_seq = 0
        self.refreshes = 0
        self.requests = 0
        self.retried = 0
        self.streams_lost = 0
        self.streams_resumed = 0
        self.streams_migrated = 0   # live KV handoffs completed
        self.migrate_fallbacks = 0  # handoffs degraded to journal resume
        self.tokens_streamed = 0    # fleet-wide delivered-token counter
        #                             (worker_kill_mid_decode chaos probe)
        self._migrate_seq = 0       # chaos kill-point (migrate_interrupt)

        self._lock = threading.Lock()      # sessions, inflight, suspects
        #                                    + the stats counters above
        #                                    (handler threads bump them
        #                                    concurrently)
        self._sessions = OrderedDict()     # session -> rid
        self._inflight = {}                # rid -> gateway-local count
        self._suspect = {}                 # rid -> monotonic expiry

        self.httpd = self._make_httpd(host, port)
        self.port = self.httpd.server_address[1]
        self.addr = "%s:%d" % (host, self.port)
        self._stop_evt = threading.Event()
        self._threads = [
            threading.Thread(target=self.httpd.serve_forever,
                             name="gateway-http", daemon=True),
            threading.Thread(target=self._refresh_loop,
                             name="gateway-refresh", daemon=True),
        ]
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        for t in self._threads:
            if not t.is_alive():
                t.start()
        _log("gateway for service %r on %s"
             % (self.registry.service, self.addr))
        return self

    def stop(self):
        self._stop_evt.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=5.0)

    @property
    def stale(self):
        """True while serving from a last-known-good view (the registry
        has been unreachable since the last successful refresh)."""
        return self._refresh_failures > 0

    def view_age_s(self):
        return None if self._view_at is None \
            else self.clock.now() - self._view_at

    def snapshot(self):
        view = self._view
        with self._lock:
            return {"addr": self.addr, "stale": self.stale,
                    "view_age_s": self.view_age_s(),
                    "refreshes": self.refreshes,
                    "refresh_failures": self._refresh_failures,
                    "requests": self.requests, "retried": self.retried,
                    "streams_lost": self.streams_lost,
                    "streams_resumed": self.streams_resumed,
                    "streams_migrated": self.streams_migrated,
                    "migrate_fallbacks": self.migrate_fallbacks,
                    "tokens_streamed": self.tokens_streamed,
                    "workers": sorted(view.replicas) if view is not None
                    else [],
                    "sessions": len(self._sessions)}

    # -- registry refresh --------------------------------------------------
    def refresh_once(self):
        """One registry refresh (the loop body).  The simulator drives
        this directly under a :class:`~mxnet_tpu_torch.clock.SimClock`, so
        partition chaos and the last-known-good fallback run the exact
        production code path in simulated time."""
        reg = _telemetry.registry()
        n = self._refresh_seq
        self._refresh_seq += 1
        try:
            if _chaos.gateway_partition(n):
                raise ConnectionError(
                    "chaos: gateway partitioned from registry")
            view = self.registry.view(reap=True)
            self._view = view
            self._view_at = self.clock.now()
            if self._refresh_failures:
                _log("registry healed after %d failed refreshes "
                     "(%d workers live)"
                     % (self._refresh_failures, len(view)))
            self._refresh_failures = 0
            self.refreshes += 1
            reg.gauge("gateway.workers").set(len(view))
        except Exception as e:
            # partition: keep routing from the last-known-good view
            self._refresh_failures += 1
            _count("gateway_registry_errors")
            if self._refresh_failures == 1:
                _log("registry unreachable (%s: %s) — serving from "
                     "last-known-good view"
                     % (type(e).__name__, e))
        reg.gauge("gateway.stale").set(1 if self.stale else 0)

    def _refresh_loop(self):
        while not self._stop_evt.is_set():
            self.refresh_once()
            self._stop_evt.wait(self.refresh_s)

    # -- routing -----------------------------------------------------------
    def _note_suspect(self, rid):
        with self._lock:
            self._suspect[rid] = self.clock.now() + self.suspect_s

    def _track(self, rid, delta):
        with self._lock:
            self._inflight[rid] = self._inflight.get(rid, 0) + delta

    @staticmethod
    def _rep_routes(rep):
        """A worker's advertised route map; pre-route workers advertise
        nothing, so they implicitly host route "default" of their kind
        (kind ``None`` when they don't advertise that either — a legacy
        worker that matches any verb)."""
        return rep.get("routes") or {"default": rep.get("kind")}

    def _route_known(self, route, kind=None):
        """True when ANY worker in the view (healthy or not) advertises
        ``route`` — distinguishes the typed 404 ``UnknownRoute`` (no
        such model anywhere; retrying cannot help) from the capacity 503
        ``Unavailable`` (the route exists, its workers are down)."""
        view = self._view
        if view is None:
            return False
        for rep in view.replicas.values():
            routes = self._rep_routes(rep)
            if route in routes and (kind is None
                                    or routes[route] in (None, kind)):
                return True
        return False

    def _pick(self, session=None, exclude=(), route=None, kind=None):
        """(rid, addr) of the routing choice, or None when no live
        candidate exists.  With ``route``/``kind`` set, only workers
        advertising that named model route (of that kind) are
        candidates — the (route, load, affinity) routing contract."""
        view = self._view
        if view is None:
            return None
        now = self.clock.now()
        with self._lock:
            suspect = {r for r, t in self._suspect.items() if t > now}
            local = dict(self._inflight)
            sticky = self._sessions.get(session) if session else None
        cands = []
        for rid, rep in view.replicas.items():
            if rid in exclude or rid in suspect:
                continue
            addr = rep.get("addr")
            if not addr or rep.get("breaker") == "OPEN":
                continue
            if rep.get("state") not in (None, "SERVING"):
                continue
            if route is not None:
                routes = self._rep_routes(rep)
                if route not in routes:
                    continue
                if (kind is not None
                        and routes[route] not in (None, kind)):
                    continue
            cands.append((rep.get("inflight", 0) + local.get(rid, 0),
                          rid, addr))
        if not cands:
            return None
        if sticky is not None:
            for _, rid, addr in cands:
                if rid == sticky:
                    return rid, addr
        cands.sort()
        _, rid, addr = cands[0]
        if session:
            with self._lock:
                self._sessions[session] = rid
                while len(self._sessions) > _DEF_SESSION_CAP:
                    self._sessions.popitem(last=False)
        return rid, addr

    def _connect(self, addr, path, payload, t0):
        """Open a connection and send one POST; observing the routing
        overhead (admission -> request handed to the worker)."""
        host, _, port = addr.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port),
                                          timeout=self.timeout_s)
        conn.request("POST", path, body=payload,
                     headers={"Content-Type": "application/json"})
        _telemetry.registry().histogram("gateway.route_ms").observe(
            (self.clock.now() - t0) * 1e3)
        return conn

    # -- predict path ------------------------------------------------------
    @staticmethod
    def _verb_path(route, verb):
        """Worker-side path for (route, verb); the bare legacy path for
        route "default" so pre-route workers keep serving."""
        if route in (None, "default"):
            return "/v1/%s" % verb
        return "/v1/%s/%s" % (route, verb)

    def _forward_predict(self, payload, t0, route="default"):
        """(status, body_bytes, rid, stale) — exactly one terminal
        outcome; retries idempotent work across workers."""
        excluded = []
        attempt = 0
        while True:
            picked = self._pick(exclude=excluded, route=route,
                                kind="predict")
            if picked is None:
                if self._view is not None and self._view.replicas \
                        and not self._route_known(route, "predict"):
                    return 404, json.dumps(
                        {"error": "UnknownRoute",
                         "message": "no worker advertises route %r"
                         % route}).encode(), None
                return 503, json.dumps(
                    {"error": "Unavailable",
                     "message": "no live worker (tried %s)"
                     % (excluded or "none")}).encode(), None
            rid, addr = picked
            self._track(rid, 1)
            try:
                conn = self._connect(addr,
                                     self._verb_path(route, "predict"),
                                     payload, t0)
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
                conn.close()
            except _WORKER_LOST as e:
                # connection-level failure: the worker is gone; the
                # idempotency key makes a retry elsewhere safe
                self._note_suspect(rid)
                excluded.append(rid)
                attempt += 1
                with self._lock:
                    self.retried += 1
                _count("gateway_retries")
                _log("worker %s failed mid-predict (%s: %s) — "
                     "retrying elsewhere" % (rid, type(e).__name__, e))
                if attempt > self.retries:
                    return 503, json.dumps(
                        {"error": "Unavailable",
                         "message": "retries exhausted after %s"
                         % excluded}).encode(), None
                continue
            finally:
                self._track(rid, -1)
            if status in (429, 503) and attempt < self.retries \
                    and len(self._view.replicas) > len(excluded) + 1:
                # shed/draining on that worker: spill to a sibling —
                # EXCEPT a per-tenant QuotaExceeded, which every sibling
                # would return identically (the governor's verdict is
                # deterministic per tenant, not per replica): spilling
                # it would just multiply the flooder's offered load
                try:
                    err = json.loads(data or b"{}").get("error")
                except ValueError:
                    err = None
                if err != "QuotaExceeded":
                    excluded.append(rid)
                    attempt += 1
                    with self._lock:
                        self.retried += 1
                    _count("gateway_retries")
                    continue
            return status, data, rid

    # -- generate path (streamed) ------------------------------------------
    def _forward_generate(self, body, write_line, t0, route="default"):
        """Stream one generation request; the last line written is the
        one typed terminal outcome.

        Durable-stream contract: ``delivered`` journals every token value
        written to the
        client.  A worker death mid-decode re-submits the request to a
        healthy sibling with ``resume_from=delivered`` and a *fresh*
        idempotency key (a resume is new work, not a duplicate); the
        worker re-prefills prompt+prefix and streams only the
        continuation, so already-delivered tokens are suppressed by
        construction and the client sees each position exactly once.
        ``ReplicaLost`` survives only as the fallback: a second
        mid-stream loss, no healthy sibling, or a journal past
        ``MXTPU_GATE_JOURNAL_CAP`` tokens.

        Journal lifetime: the ``delivered`` journal lives exactly as
        long as the request that owns it — created here, dropped on
        every way out of the stream (terminal line written, fallback
        error, or handler crash).  The leakcheck ledger (``journal``
        kind) pins that eviction at runtime: after any burst, however
        resume-heavy, the live-journal count returns to zero."""
        delivered = []      # journal: token values already written
        _leakcheck.track("journal", id(delivered))
        try:
            self._stream_generate(body, write_line, t0, delivered,
                                  route=route)
        finally:
            _leakcheck.untrack("journal", id(delivered))

    def _stream_generate(self, body, write_line, t0, delivered,
                         route="default"):
        session = body.get("session")
        if session and route not in (None, "default"):
            # affinity is per named route: the same client session may
            # stream against several models without cross-pinning
            session = "%s|%s" % (route, session)
        excluded = []
        attempt = 0
        losses = 0          # mid-stream worker deaths for this request
        migrations = 0      # live KV handoffs completed for this request
        fallbacks = 0       # handoffs degraded to journal resume
        overflowed = False  # journal passed the cap — resume disarmed
        pending = None      # (rid, addr, handle) of a completed handoff
        while True:
            migrate_handle = None
            if pending is not None:
                # a live-migration transfer just landed on this sibling:
                # target it directly, attaching the imported KV state
                rid, addr = pending[0], pending[1]
                migrate_handle = pending[2]
                pending = None
                picked = (rid, addr)
            else:
                picked = self._pick(session=session, exclude=excluded,
                                    route=route, kind="generate")
            if picked is None:
                if delivered:
                    with self._lock:
                        self.streams_lost += 1
                    _count("gateway_stream_lost")
                    write_line({"error": "ReplicaLost",
                                "message": "no live worker to resume "
                                "after %d token(s) (tried %s)"
                                % (len(delivered), excluded or "none")})
                elif self._view is not None and self._view.replicas \
                        and not self._route_known(route, "generate"):
                    write_line({"error": "UnknownRoute",
                                "message": "no worker advertises route "
                                "%r" % route})
                else:
                    write_line({"error": "Unavailable",
                                "message": "no live worker (tried %s)"
                                % (excluded or "none")})
                return
            rid, addr = picked
            req = body
            if migrate_handle is not None:
                # migrated incarnation: the receiver attaches the
                # imported KV pages + rng state to this request and
                # continues decoding — no re-prefill.  Fresh key: this
                # is new work on a new worker.
                req = dict(body)
                req["migrate_handle"] = migrate_handle
                req["resume_from"] = [int(t) for t in delivered]
                req["idempotency_key"] = "gw-" + _telemetry.new_trace_id()
            elif delivered:
                # resume incarnation: ship the delivered prefix so the
                # sibling reconstructs the exact KV/rng state, under a
                # fresh idempotency key (this is new work — the old key
                # would replay the dead worker's stored outcome)
                req = dict(body)
                req["resume_from"] = [int(t) for t in delivered]
                req["idempotency_key"] = "gw-" + _telemetry.new_trace_id()
                with self._lock:
                    self.streams_resumed += 1
                _count("gateway_stream_resumed")
            payload = json.dumps(req).encode()
            self._track(rid, 1)
            streamed = 0
            try:
                conn = self._connect(addr,
                                     self._verb_path(route, "generate"),
                                     payload, t0)
                resp = conn.getresponse()
                if resp.status != 200:
                    raise OSError("worker %s: HTTP %d"
                                  % (rid, resp.status))
                first = True
                while True:
                    raw = resp.readline()
                    if not raw:
                        # a healthy stream ends with a terminal line,
                        # never bare EOF — the worker died (SIGKILL can
                        # look like a clean close, not a reset)
                        raise OSError("worker %s closed the stream "
                                      "with no terminal line" % rid)
                    line = json.loads(raw)
                    if first and not streamed \
                            and line.get("error") in ("Overloaded",
                                                      "Draining") \
                            and attempt < self.retries:
                        # pre-admission rejection: spill to a sibling
                        raise OSError("worker %s shed: %s"
                                      % (rid, line["error"]))
                    first = False
                    if "migrate" in line:
                        # live migration handoff: NOT client-terminal
                        # and never written to the client — handled
                        # below, outside the read loop
                        break
                    streamed += 1
                    if "token" in line:
                        if len(delivered) < _DEF_JOURNAL_CAP:
                            delivered.append(int(line["token"]))
                        else:
                            overflowed = True
                        with self._lock:
                            self.tokens_streamed += 1
                    elif "done" in line and (losses or migrations
                                             or fallbacks):
                        # terminal count covers every incarnation, not
                        # just the one that finished the stream
                        line = dict(line)
                        line["tokens"] = len(delivered)
                        if losses or fallbacks:
                            line["resumed"] = losses + fallbacks
                        if migrations:
                            line["migrated"] = migrations
                    write_line(line)
                    if "done" in line or "error" in line:
                        break
                conn.close()
                if "migrate" in line:
                    # the worker parked this stream for live migration
                    # (drain or rebalance).  Carry the KV blob to a
                    # sibling; ANY failure degrades to the plain
                    # journal-resume path — never worse than today.
                    excluded.append(rid)
                    moved = self._migrate_stream(addr, line["migrate"],
                                                 excluded, route=route)
                    if moved is not None:
                        migrations += 1
                        with self._lock:
                            self.streams_migrated += 1
                        _count("gateway_stream_migrated")
                        if session:
                            with self._lock:
                                self._sessions[session] = moved[0]
                        pending = moved
                    else:
                        fallbacks += 1
                        with self._lock:
                            self.migrate_fallbacks += 1
                        _count("gateway_migrate_fallbacks")
                        _log("migration of stream off worker %s failed "
                             "— falling back to journal resume" % rid)
                    continue
                return
            except _WORKER_LOST + (ValueError,) as e:
                self._note_suspect(rid)
                excluded.append(rid)
                if delivered or streamed > 0:
                    losses += 1
                    if losses >= 2 or overflowed or not delivered:
                        # second loss / uncapped journal: the fallback
                        with self._lock:
                            self.streams_lost += 1
                        _count("gateway_stream_lost")
                        write_line({"error": "ReplicaLost",
                                    "message": "worker %s lost "
                                    "mid-stream after %d token(s) (%s)"
                                    % (rid, len(delivered), e)})
                        return
                    _log("worker %s died mid-stream after %d token(s) "
                         "(%s: %s) — resuming on a sibling"
                         % (rid, len(delivered), type(e).__name__, e))
                    continue
                attempt += 1
                with self._lock:
                    self.retried += 1
                _count("gateway_retries")
                _log("worker %s failed pre-stream (%s: %s) — "
                     "retrying elsewhere" % (rid, type(e).__name__, e))
                if attempt > self.retries:
                    write_line({"error": "Unavailable",
                                "message": "retries exhausted after %s"
                                % excluded})
                    return
            finally:
                self._track(rid, -1)

    # -- live KV migration -------------------------------------------------
    def _post_json(self, addr, path, obj):
        """One JSON POST -> (status, parsed body).  Raises OSError on
        connection failure like every other worker call."""
        host, _, port = addr.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port),
                                          timeout=self.timeout_s)
        try:
            conn.request("POST", path, body=json.dumps(obj).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"{}")
        finally:
            conn.close()

    def _migrate_stream(self, sender_addr, handle, exclude,
                        route="default"):
        """Carry one parked stream's KV blob sender -> sibling.

        Fetches the versioned blob from the sender's ``/v1/migrate_out``,
        pushes it to a healthy sibling's ``/v1/migrate_in`` in
        ``MXTPU_MIGRATE_CHUNK_KB`` chunks under one transfer key, and
        returns ``(rid, addr, new_handle)`` for the caller to target.
        Returns None on ANY failure — after a best-effort
        ``/v1/migrate_abort`` so the receiver frees whatever it already
        buffered or installed (the leakcheck-audited contract); the
        caller then degrades to the journal-resume path.  The
        ``migrate_interrupt`` chaos kind severs the transfer between
        chunks to drill exactly that degradation."""
        import base64

        with self._lock:
            mseq = self._migrate_seq
            self._migrate_seq += 1
        target = self._pick(exclude=tuple(exclude), route=route,
                            kind="generate")
        if target is None:
            return None
        rid2, addr2 = target
        key = "mig-" + _telemetry.new_trace_id()
        try:
            status, resp = self._post_json(
                sender_addr, self._verb_path(route, "migrate_out"),
                {"handle": handle})
            if status != 200 or "blob" not in resp:
                raise OSError("export of %s failed: HTTP %d %s"
                              % (handle, status, resp.get("error")))
            blob = base64.b64decode(resp["blob"])
            chunk = max(1, _DEF_MIGR_CHUNK_KB) * 1024
            total = max(1, -(-len(blob) // chunk))
            resp = {}
            for i in range(total):
                if _chaos.migrate_interrupt(mseq):
                    raise OSError("chaos: migration interrupted after "
                                  "%d/%d chunk(s)" % (i, total))
                part = blob[i * chunk:(i + 1) * chunk]
                status, resp = self._post_json(
                    addr2, self._verb_path(route, "migrate_in"),
                    {"key": key, "seq": i, "total": total,
                     "data": base64.b64encode(part).decode("ascii")})
                if status != 200:
                    raise OSError("chunk %d/%d rejected: HTTP %d %s"
                                  % (i, total, status,
                                     resp.get("error")))
            new_handle = resp.get("handle")
            if not new_handle:
                raise OSError("transfer settled without a handle: %s"
                              % resp)
            return rid2, addr2, new_handle
        except _WORKER_LOST + (ValueError, KeyError) as e:
            _log("KV transfer %s -> %s failed (%s: %s) — aborting"
                 % (handle, rid2, type(e).__name__, e))
            try:
                # frees the receiver's buffer AND any installed-but-
                # unclaimed import under the same key
                self._post_json(addr2,
                                self._verb_path(route, "migrate_abort"),
                                {"key": key})
            except OSError:
                pass          # receiver gone too; its TTL sweep cleans up
            return None

    # -- HTTP plumbing -----------------------------------------------------
    def _make_httpd(self, host, port):
        gw = self

        class _Handler(BaseHTTPRequestHandler):
            def _json(self, status, obj):
                data = obj if isinstance(obj, bytes) \
                    else json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if gw.stale:
                    self.send_header("X-Fleet-Stale", "1")
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"ok": True, "stale": gw.stale})
                elif self.path == "/v1/fleet":
                    snap = gw.snapshot()
                    view = gw._view
                    snap["replicas"] = view.as_dict()["replicas"] \
                        if view is not None else {}
                    self._json(200, snap)
                else:
                    self._json(404, {"error": "NotFound"})

            def do_POST(self):
                t0 = gw.clock.now()
                with gw._lock:
                    gw.requests += 1
                _count("gateway_requests")
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, OSError) as e:
                    self._json(400, {"error": "BadRequest",
                                     "message": str(e)})
                    return
                # every request is retry-safe: give it an idempotency
                # key unless the client brought its own
                body.setdefault("idempotency_key",
                                "gw-" + _telemetry.new_trace_id())
                # the QoS class rides a header so load tools and
                # sidecars can set it without touching the body
                prio = self.headers.get("X-MXTPU-Priority")
                if prio:
                    body.setdefault("priority", prio)
                # tenant id likewise (X-MXTPU-Tenant): validated at the
                # front door — a hostile value is a typed 400 BadTenant,
                # never a handler 500, and never reaches a worker
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
                    self._json(404, {"error": "NotFound"})
                    return
                try:
                    route = parse_route(route)
                except ValueError as e:
                    self._json(404, {"error": "UnknownRoute",
                                     "message": str(e)})
                    return
                if verb == "predict":
                    status, data, rid = gw._forward_predict(
                        json.dumps(body).encode(), t0, route=route)
                    self._json(status, data)
                elif verb == "generate":
                    # pin a concrete seed: the worker-side default rng is
                    # keyed to per-worker admission order, which a resume
                    # on a different worker cannot replay
                    if body.get("seed") is None:
                        body["seed"] = int.from_bytes(os.urandom(4),
                                                      "big")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    if gw.stale:
                        self.send_header("X-Fleet-Stale", "1")
                    self.end_headers()

                    def write_line(obj):
                        self.wfile.write(
                            (json.dumps(obj) + "\n").encode())
                        self.wfile.flush()

                    try:
                        gw._forward_generate(body, write_line, t0,
                                             route=route)
                    except OSError:
                        pass      # client went away mid-stream
                else:
                    self._json(404, {"error": "NotFound"})

            def log_message(self, *a):  # noqa: D102
                pass

        class _Srv(ThreadingHTTPServer):
            daemon_threads = True
            # the stdlib default backlog (5) resets connections under a
            # burst of concurrent clients — the front door needs depth
            request_queue_size = 128

        return _Srv((host, port), _Handler)
