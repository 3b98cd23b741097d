"""Barrier-free async parameter server and TTL'd service registry: the
socket transport of ``mxnet_tpu/async_kv.py``.

The server is a thread serving a length-prefixed pickle protocol over TCP
(:func:`start_local_server`); :class:`AsyncKVClient` is the worker-side
handle.  The fleet plane's :class:`~mxnet_tpu_torch.fleet.ServiceRegistry`
rides its TTL'd keys (``rset`` / ``rget`` / ``rdel`` / ``rlist`` /
``rreap``).  Reference parity: ``kvstore_dist_server.h:346-348`` — in
async mode the server applies each worker's push to the stored weights
immediately (per push, no all-worker aggregation barrier) and pulls return
whatever state the server currently has.

Protocol: request = (client_id, seq, op, key, payload); reply = (seq, value).
  op ∈ {"init", "push", "pull", "set_optimizer",
        "init_rows", "push_rows", "pull_rows",
        "rset", "rget", "rdel", "rlist", "rreap"}
* ``init``  — store-if-absent (all workers init identically; first wins).
* ``push``  — ``updater(key, grad, stored)`` in place, per push (the async
  apply); a push before ``set_optimizer`` is an error reply.
* ``pull``  — returns the current stored value, never waits for anyone.
* row tables — the server owns a lazily-materialized row table per key;
  ``push_rows`` applies the optimizer per ROW (each row its own updater
  index), ``pull_rows`` gathers the requested rows only.

The store is numpy on the host, and the optimizer a ``set_optimizer``
payload installs (a pickled :class:`mxnet_tpu_torch.optimizer.Optimizer`)
updates it on the CPU: the server holds no tensor on a card.

Self-healing transport (ps-lite ``resender.h`` parity): every request
carries ``(client_id, seq)``; the client retries a failed call on a FRESH
connection with bounded exponential backoff + jitter, and the server keeps
a per-client ``(last_seq, last_reply)`` record so a retried mutating op is
applied exactly once.  The server closes a connection idle for
``MXTPU_KV_REAP_S``, so dead workers cannot pin threads forever.

Bootstrapping the server's address over a cluster's coordination store
(``AsyncKVClient()`` without ``addr``) is not ported: it raises
(ROADMAP Queue 1 item 9).  Pass ``addr='host:port'``.
"""
from __future__ import annotations

import pickle
import random as _pyrandom
import socket
import socketserver
import struct
import threading
import time
import uuid

import numpy as np

from .config import config as _config

__all__ = ["AsyncKVClient", "start_local_server", "backoff_delay"]

# transport knobs (MXTPU_KV_*, read through config)
_DEF_TIMEOUT = _config.kv_timeout
_DEF_RETRIES = _config.kv_retries
_DEF_BACKOFF = _config.kv_backoff
_DEF_BACKOFF_CAP = _config.kv_backoff_cap
_DEF_REAP_S = _config.kv_reap_s


def backoff_delay(attempt, base, cap, jitter=True):
    """Bounded exponential backoff for retry ``attempt`` (0-based):
    ``min(cap, base * 2**attempt)``, scaled by uniform [0.5, 1.0) jitter
    to decorrelate a gang of clients retrying off the same fault."""
    d = min(float(cap), float(base) * (2.0 ** attempt))
    if jitter:
        d *= 0.5 + 0.5 * _pyrandom.random()
    return d


def _send_msg(sock, obj):
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(blob)) + blob)


def _recv_msg(sock):
    hdr = b""
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    (n,) = struct.unpack("<Q", hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return pickle.loads(bytes(buf))


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, reap_s=None):
        super().__init__(addr, _Handler)
        self.store: dict = {}
        self.row_tables: dict = {}
        # service registry: key -> (value, expires_at) under TTL
        # (the fleet layer's heartbeat store)
        self.registry: dict = {}
        self.updater = None
        self.lock = threading.Lock()
        self._str_idx: dict = {}
        # per-client retransmit dedup: client_id -> [last_seq, last_reply,
        # last_seen].  One entry per client suffices (clients hold one
        # outstanding request), so memory is O(workers).
        self.sessions: dict = {}
        self.reap_s = _DEF_REAP_S if reap_s is None else float(reap_s)

    def _prune_sessions(self):
        """Drop dedup records for clients idle past the reap window
        (called under ``lock``; bounds the table if workers churn)."""
        if len(self.sessions) <= 1024:
            return
        now = time.monotonic()
        for cid in [c for c, s in self.sessions.items()
                    if now - s[2] > max(self.reap_s, 60.0)]:
            del self.sessions[cid]

    def key_index(self, key):
        """Same int-index convention the worker-side store uses for
        per-key optimizer state."""
        if isinstance(key, int):
            return key
        if key not in self._str_idx:
            self._str_idx[key] = len(self._str_idx)
        return self._str_idx[key]


def _row_of(tbl, i):
    """Lazily materialize row ``i`` of a server-side row table."""
    row = tbl["rows"].get(i)
    if row is None:
        if tbl["init"] is not None:
            row = np.asarray(tbl["init"](i),
                             tbl["dtype"]).reshape(tbl["shape"][1:])
        else:
            row = np.zeros(tbl["shape"][1:], tbl["dtype"])
        tbl["rows"][i] = row
    return row


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        srv: _Server = self.server  # type: ignore[assignment]
        # stale-connection reaper: a worker that died without closing its
        # socket must not pin this handler thread forever — recv blocks at
        # most reap_s, then the connection is closed (a live client that
        # was merely idle transparently reconnects on its next call)
        if srv.reap_s > 0:
            self.request.settimeout(srv.reap_s)
        try:
            while True:
                msg = _recv_msg(self.request)
                if len(msg) == 5:          # (client_id, seq, op, key, payload)
                    cid, seq, op, key, payload = msg
                else:                      # legacy stateless (op, key, payload)
                    cid, seq = None, None
                    op, key, payload = msg
                # compute the reply under the lock, send after release: a
                # slow client socket must not stall every other handler
                # thread contending for the store lock
                with srv.lock:
                    sess = srv.sessions.get(cid) if cid is not None else None
                    if sess is not None and seq <= sess[0]:
                        # retransmit of an op whose reply was lost:
                        # answer from the cache, do NOT re-apply
                        reply = sess[1]
                    else:
                        reply = self._apply(srv, op, key, payload)
                        if cid is not None:
                            srv.sessions[cid] = [seq, reply,
                                                 time.monotonic()]
                            srv._prune_sessions()
                _send_msg(self.request, (seq, reply))
        except (ConnectionError, EOFError, socket.timeout, OSError):
            pass

    @staticmethod
    def _apply(srv, op, key, payload):
        """Execute one op against the store (caller holds ``srv.lock``);
        returns the reply value (an Exception instance for error replies)."""
        if op == "init":
            if key not in srv.store:
                srv.store[key] = np.array(payload)
            return None
        if op == "push":
            grad = np.asarray(payload)
            cur = srv.store.get(key)
            if cur is None:
                return KeyError(key)
            if srv.updater is not None:
                # per-push apply — THE async semantics: no waiting for
                # other workers' contributions
                srv.updater(key, grad, cur)
                return None
            # without a server-side optimizer there is no meaningful
            # async aggregation (the reference requires
            # update_on_kvstore in async mode)
            return RuntimeError(
                "dist_async push before set_optimizer: "
                "async mode requires the optimizer to run "
                "on the kvstore (update_on_kvstore=True)")
        if op == "pull":
            cur = srv.store.get(key)
            return KeyError(key) if cur is None else cur.copy()
        if op == "init_rows":
            if key not in srv.row_tables:
                shape, dtype, init_blob = payload
                srv.row_tables[key] = {
                    "shape": tuple(shape),
                    "dtype": np.dtype(dtype),
                    "init": (pickle.loads(init_blob)
                             if init_blob is not None else None),
                    "rows": {},
                }
            return None
        if op == "push_rows":
            tbl = srv.row_tables.get(key)
            if tbl is None:
                return KeyError(key)
            if srv.updater is None:
                # assigning per-worker grads would resolve overlapping
                # ids last-writer-wins — the silent divergence this
                # server exists to prevent; same contract as dense push
                return RuntimeError(
                    "dist host-row push before "
                    "set_optimizer: the server-side sparse "
                    "reduce needs the optimizer on the "
                    "kvstore (update_on_kvstore=True)")
            ids, grads = payload
            grads = np.asarray(grads)
            for j, i in enumerate(np.asarray(ids)):
                i = int(i)
                # per-row updater index: per-row state AND update counts
                srv.updater("hostrow:%s:%d" % (key, i),
                            grads[j], _row_of(tbl, i))
            return None
        if op == "pull_rows":
            tbl = srv.row_tables.get(key)
            if tbl is None:
                return KeyError(key)
            ids = np.asarray(payload)
            return np.stack(
                [_row_of(tbl, int(i)).copy()
                 for i in ids]) if len(ids) else \
                np.zeros((0,) + tbl["shape"][1:], tbl["dtype"])
        # -- service registry (TTL'd keys; mxnet_tpu_torch.fleet) -------
        if op == "rset":
            value, ttl_s = payload
            srv.registry[key] = (value, time.monotonic() + float(ttl_s))
            return None
        if op == "rget":
            ent = srv.registry.get(key)
            if ent is None:
                return KeyError(key)
            value, expires = ent
            if time.monotonic() >= expires:
                del srv.registry[key]       # lazily reap on read
                return KeyError(key)
            return value
        if op == "rdel":
            srv.registry.pop(key, None)
            return None
        if op == "rlist":
            now = time.monotonic()
            prefix = key or ""
            # expired entries are invisible here but NOT purged: listing
            # must never mutate the store, so reap accounting (rreap ->
            # fleet.reaped) sees every TTL lapse exactly once
            return {k: (v, e - now)
                    for k, (v, e) in srv.registry.items()
                    if k.startswith(prefix) and e > now}
        if op == "rreap":
            now = time.monotonic()
            prefix = key or ""
            dead = [k for k, (_, e) in srv.registry.items()
                    if k.startswith(prefix) and e <= now]
            for k in dead:
                del srv.registry[k]
            return dead
        if op == "set_optimizer":
            from . import optimizer as opt

            optimizer = pickle.loads(payload)
            updater = opt.get_updater(optimizer)

            def np_updater(k, g, stored, _u=updater, _srv=srv):
                # the store is host numpy: the update runs on the CPU
                from .context import cpu
                from .ndarray import array

                w = array(stored, ctx=cpu())
                _u(_srv.key_index(k), array(g, ctx=cpu()), w)
                stored[...] = w.asnumpy()

            srv.updater = np_updater
            return None
        return ValueError("unknown op %r" % (op,))


def _chaos_note(kind, seq):
    """Report an armed transport fault actually firing to the chaos
    plan/counters (mxnet_tpu_torch.chaos)."""
    from . import chaos as _chaos

    _chaos.note_kv_fault(kind, seq)


class AsyncKVClient:
    """Worker-side handle on a running server at ``addr='host:port'``
    (:func:`start_local_server` starts one).

    The transport self-heals: a timed-out or reset call closes the
    socket, backs off (exponential + jitter, capped), reconnects, and
    retransmits the SAME sequence number — the server deduplicates, so
    a push whose reply was lost is applied exactly once."""

    def __init__(self, addr=None, timeout=None, max_retries=None,
                 backoff=None, backoff_cap=None):
        self._server = None
        if addr is None:
            raise NotImplementedError(
                "mxnet_tpu_torch: AsyncKVClient needs addr='host:port'; "
                "bootstrapping the server address over a cluster's "
                "coordination store (dist_async) is not ported (ROADMAP "
                "Queue 1 item 9)")
        h, p = addr.rsplit(":", 1)
        self._addr = (h, int(p))
        self._timeout = _DEF_TIMEOUT if timeout is None else float(timeout)
        self._retries = _DEF_RETRIES if max_retries is None \
            else int(max_retries)
        self._backoff = _DEF_BACKOFF if backoff is None else float(backoff)
        self._backoff_cap = _DEF_BACKOFF_CAP if backoff_cap is None \
            else float(backoff_cap)
        self._client_id = uuid.uuid4().hex
        self._seq = 0
        self._sock = None
        self._lock = threading.Lock()
        # chaos hooks (armed by chaos.arm_kv_client or directly
        # by tests): seq numbers whose send succeeds but whose reply is
        # "lost" (socket closed before recv) — exercises the retransmit+
        # dedup path deterministically; seq -> seconds delayed before the
        # send (reordering window); seqs transmitted twice (the server's
        # (client_id, seq) dedup must answer the duplicate from cache)
        self._fi_drop_after_send = set()
        self._fi_delay_before_send = {}
        self._fi_duplicate_send = set()
        self._connect()

    def _connect(self):
        self._sock = socket.create_connection(self._addr,
                                              timeout=self._timeout)
        self._sock.settimeout(self._timeout)

    def _close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call(self, op, key, payload=None):
        # _lock deliberately spans the whole request/reply round-trip:
        # the transport is a single connection carrying strictly one
        # outstanding request (seq-matched replies), so serializing
        # callers on the lock IS the protocol — releasing it mid-flight
        # would interleave frames from concurrent trainer threads and
        # tear the stream.  Nothing else is guarded by this lock, so a peer
        # needing the same lock (the deadlock shape) cannot occur.
        with self._lock:
            self._seq += 1
            seq = self._seq
            last_err = None
            for attempt in range(self._retries + 1):
                try:
                    if self._sock is None:
                        self._connect()
                    fi_delay = self._fi_delay_before_send.pop(seq, None)
                    if fi_delay:
                        _chaos_note("kv_delay", seq)
                        time.sleep(fi_delay)
                    _send_msg(
                        self._sock,
                        (self._client_id, seq, op, key, payload))
                    fi_dup = seq in self._fi_duplicate_send
                    if fi_dup:
                        self._fi_duplicate_send.discard(seq)
                        _chaos_note("kv_dup", seq)
                        # retransmit the identical frame: the server must
                        # answer both from its dedup cache; the spare
                        # reply is drained right after the real one
                        _send_msg(
                            self._sock,
                            (self._client_id, seq, op, key, payload))
                    if seq in self._fi_drop_after_send:
                        self._fi_drop_after_send.discard(seq)
                        _chaos_note("kv_drop", seq)
                        self._close()
                        raise ConnectionError(
                            "injected reply loss (seq %d)" % seq)
                    rseq, reply = _recv_msg(
                        self._sock)
                    if rseq != seq:  # torn stream: resync on a fresh conn
                        raise ConnectionError(
                            "reply seq %s != request seq %d" % (rseq, seq))
                    if fi_dup:
                        # drain the duplicate's reply so the stream stays
                        # aligned; the server's dedup answered it from
                        # the (client_id, seq) cache
                        dseq, _dreply = _recv_msg(
                            self._sock)
                        if dseq != seq:
                            raise ConnectionError(
                                "dup reply seq %s != request seq %d"
                                % (dseq, seq))
                    break
                except (ConnectionError, EOFError, socket.timeout,
                        OSError) as e:
                    last_err = e
                    self._close()
                    if attempt >= self._retries:
                        raise ConnectionError(
                            "async-KV call %r failed after %d retries: %s"
                            % (op, self._retries, last_err)) from last_err
                    delay = backoff_delay(attempt, self._backoff,
                                          self._backoff_cap)
                    time.sleep(delay)
        if isinstance(reply, Exception):
            raise reply
        return reply

    def init(self, key, value_np):
        self._call("init", key, value_np)

    def push(self, key, grad_np):
        self._call("push", key, grad_np)

    def pull(self, key):
        return self._call("pull", key)

    def set_optimizer(self, pickled_optimizer):
        self._call("set_optimizer", key=None, payload=pickled_optimizer)

    # -- service registry (TTL'd keys; the fleet layer's heartbeat
    #    store — mxnet_tpu_torch.fleet) -----------------------------------
    def registry_set(self, key, value, ttl_s):
        """Publish ``key`` with a TTL: a heartbeat that is not refreshed
        within ``ttl_s`` seconds expires and the reaper purges it."""
        self._call("rset", key, (value, float(ttl_s)))

    def registry_get(self, key):
        """Current live value (KeyError once the TTL lapsed)."""
        return self._call("rget", key)

    def registry_delete(self, key):
        """Withdraw a registry entry (clean deregistration on drain)."""
        self._call("rdel", key)

    def registry_list(self, prefix=""):
        """Live entries under ``prefix``: {key: (value, ttl_remaining)}."""
        return self._call("rlist", prefix)

    def registry_reap(self, prefix=""):
        """Purge expired entries under ``prefix``; returns the reaped
        keys (the supervisor counts them as ``fleet.reaped``)."""
        return self._call("rreap", prefix)

    # -- row tables (server-side sparse reduce) -------------------------
    def init_rows(self, key, shape, dtype, pickled_initializer):
        self._call("init_rows", key,
                   (tuple(shape), str(dtype), pickled_initializer))

    def push_rows(self, key, ids_np, grads_np):
        self._call("push_rows", key, (ids_np, grads_np))

    def pull_rows(self, key, ids_np):
        return self._call("pull_rows", key, ids_np)


def start_local_server(host="127.0.0.1", port=0, reap_s=None):
    """Start an in-process KV server on a daemon thread (tests, and the
    single-host fleet registry's default backing store); returns
    ``(server, "host:port")`` — pass the address to
    :class:`AsyncKVClient` / :class:`mxnet_tpu_torch.fleet.ServiceRegistry`,
    call ``server.shutdown()`` when done."""
    server = _Server((host, int(port)), reap_s=reap_s)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, "%s:%d" % (server.server_address[0],
                              server.server_address[1])
