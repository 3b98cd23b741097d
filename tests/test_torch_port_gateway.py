"""The port's gateway and fleet workers (``mxnet_tpu_torch.gateway``,
``mxnet_tpu_torch.fleet_worker``) against the JAX package's.

* ``_pick`` on the same views (least-loaded, breaker-aware, state and
  route filters, sticky sessions, suspect windows on a ``SimClock``) makes
  the same choices in both packages.
* A worker's idempotent replay and forget-on-failure behave alike, and
  the demo model (the same numpy-seeded weights in both) gives the same
  outputs.
* Generation streams through the gateway over in-process port workers on
  the CPU: a worker that dies mid-stream is resumed on its sibling and the
  client sees the uninterrupted greedy stream exactly once; with no
  sibling left the stream ends in one typed ``ReplicaLost``.
* A worker that dies after sending its response headers (the body cut
  short) is a lost worker to the port's gateway, which retries the
  idempotent predict on a sibling; the JAX package lets the
  ``http.client.IncompleteRead`` escape (ROADMAP Queue 3).
* The spawned acceptance scenario: two ``python -m
  mxnet_tpu_torch.fleet_worker`` processes (a CPU builder from
  ``torch_port_fleet_util``) behind a ``Gateway`` survive a SIGKILL and a
  registry partition mid-burst with one typed outcome per request, and the
  killed worker comes back within the restart budget.
"""
import http.client
import json
import socket
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401
from mxnet_tpu import chaos as jchaos
from mxnet_tpu import clock as jclock
from mxnet_tpu import fleet as jfleet
from mxnet_tpu import fleet_worker as jfw
from mxnet_tpu import gateway as jgw
from mxnet_tpu_torch import chaos as tchaos
from mxnet_tpu_torch import clock as tclock
from mxnet_tpu_torch import fleet as tfleet
from mxnet_tpu_torch import fleet_worker as tfw
from mxnet_tpu_torch import gateway as tgw
from mxnet_tpu_torch import leakcheck
from torch_port_fleet_util import (cpu_generation, cpu_model, get, post,
                                   stream, wait, worker_argv, worker_env)

torch.set_num_threads(1)

JAX = types.SimpleNamespace(fleet=jfleet, gw=jgw, fw=jfw, clock=jclock,
                            chaos=jchaos)
PORT = types.SimpleNamespace(fleet=tfleet, gw=tgw, fw=tfw, clock=tclock,
                             chaos=tchaos)


def both(scenario):
    return scenario(JAX), scenario(PORT)


def _offline_gateway(P, clock=None):
    """A gateway with no threads (routing driven directly)."""

    class _Reg:
        service = "test"

    return P.gw.Gateway(registry=_Reg(), start=False, refresh_s=0.05,
                        suspect_s=0.2, clock=clock)


def _view(P, reports):
    return P.fleet.FleetView("test", {rid: (rep, 1.0)
                                      for rid, rep in reports.items()})


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def _picks(P):
    clk = P.clock.SimClock()
    gw = _offline_gateway(P, clock=clk)
    try:
        out = [gw._pick()]
        gw._view = _view(P, {
            "w0": {"addr": "h:1", "inflight": 5},
            "w1": {"addr": "h:2", "inflight": 1},
            "w2": {"addr": "h:3", "inflight": 0, "breaker": "OPEN"},
            "w3": {"addr": "h:4", "inflight": 0, "state": "DRAINING"},
            "w4": {"inflight": 0},
            "g0": {"addr": "h:5", "inflight": 2, "kind": "generate",
                   "routes": {"gen@v1": "generate", "default": "generate"}},
            "p0": {"addr": "h:6", "inflight": 3,
                   "routes": {"fc@v1": "predict"}},
        })
        out.append(gw._pick())
        gw._track("w1", 5)
        out.append(gw._pick())
        out.append(gw._pick(exclude=("w0", "w1", "g0", "p0")))
        out.append(gw._pick(route="gen@v1", kind="generate"))
        out.append(gw._pick(route="fc@v1", kind="predict"))
        out.append(gw._pick(route="fc@v1", kind="generate"))
        out.append((gw._route_known("fc@v1"),
                    gw._route_known("fc@v1", "generate"),
                    gw._route_known("nope")))
        # sticky sessions and suspect windows, on the simulated clock
        out.append(gw._pick(session="s1"))
        gw._track("g0", 20)
        out.append(gw._pick(session="s1"))
        out.append(gw._pick())
        gw._note_suspect("w0")
        out.append(gw._pick(exclude=("g0",)))
        clk.advance(0.25)
        out.append(gw._pick(exclude=("g0",)))
        out.append(gw._verb_path("default", "predict"))
        out.append(gw._verb_path("gen@v1", "generate"))
        return out
    finally:
        gw.httpd.server_close()


def test_pick_makes_the_same_choices():
    ref, got = both(_picks)
    assert got == ref
    assert got[0] is None and got[1] == ("w1", "h:2")
    assert got[4] == ("g0", "h:5") and got[6] is None


def test_partition_serves_from_last_known_good_view_alike():
    """``refresh_once`` under ``gateway_partition``: the last-known-good
    view keeps routing, marked stale, and re-syncs when the window ends."""
    def scenario(P):
        reg = P.fleet.ServiceRegistry(service="lkg", ttl_s=30.0)
        gw = P.gw.Gateway(registry=reg, start=False,
                          clock=P.clock.SimClock())
        try:
            reg.publish("w0", {"addr": "h:1", "inflight": 0})
            seen = []
            with P.chaos.inject("gateway_partition@1,gateway_partition@2"):
                for _ in range(4):
                    gw.refresh_once()
                    seen.append((gw.stale, gw._pick(),
                                 gw.snapshot()["refresh_failures"]))
            return seen
        finally:
            gw.httpd.server_close()
            reg.close()

    ref, got = both(scenario)
    assert got == ref
    assert [s[0] for s in got] == [False, True, True, False]
    assert all(s[1] == ("w0", "h:1") for s in got)


# ---------------------------------------------------------------------------
# worker idempotency
# ---------------------------------------------------------------------------
def _idempotency(P, server):
    reg = P.fleet.ServiceRegistry(service="idem")
    worker = P.fw.FleetWorker(server, "w0", registry=reg)
    try:
        body = {"inputs": {"data": [[1.0, 2.0, 3.0, 4.0]]},
                "idempotency_key": "k1"}
        st1, r1 = worker._handle_predict(dict(body))
        st2, r2 = worker._handle_predict(dict(body))
        bad = {"inputs": {"data": "not-a-tensor"}, "idempotency_key": "k2"}
        st3, r3 = worker._handle_predict(dict(bad))
        good = {"inputs": {"data": [[1.0, 1.0, 1.0, 1.0]]},
                "idempotency_key": "k2"}
        st4, r4 = worker._handle_predict(dict(good))
        return {"st": [st1, st2, st3, st4], "same": r1 == r2,
                "err": r3["error"], "replays": worker.idem_replays,
                "out1": np.asarray(r1["outputs"]),
                "out4": np.asarray(r4["outputs"])}
    finally:
        worker.httpd.server_close()
        server.drain(timeout=30)
        reg.close()


def test_idempotent_replay_and_forget_alike():
    ref = _idempotency(JAX, jfw.demo_model())
    got = _idempotency(PORT, cpu_model())
    for k in ("st", "same", "err", "replays"):
        assert got[k] == ref[k], k
    assert got["st"] == [200, 200, 500, 200] and got["replays"] == 1
    # the same numpy-seeded weights in both demo models
    np.testing.assert_allclose(got["out1"], ref["out1"], rtol=1e-6)
    np.testing.assert_allclose(got["out4"], ref["out4"], rtol=1e-6)


def _read_request(conn):
    """Read one whole HTTP request from ``conn``: its headers, then as many
    body bytes as its Content-Length names."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = conn.recv(65536)
        if not chunk:
            return
        data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    length = 0
    for line in head.split(b"\r\n")[1:]:
        name, _, value = line.partition(b":")
        if name.strip().lower() == b"content-length":
            length = int(value)
    while len(body) < length:
        chunk = conn.recv(65536)
        if not chunk:
            return
        body += chunk


def _truncating_worker():
    """A worker that answers every request with headers promising a body
    of 125 bytes, and then closes: it died mid-response.  It reads the
    whole request first and half-closes before it closes, so that the
    client always sees the body end early (``IncompleteRead``), never a
    connection reset (which a close with unread request bytes sends)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            _read_request(conn)
            conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: "
                         b"application/json\r\nContent-Length: 125\r\n\r\n")
            conn.shutdown(socket.SHUT_WR)
            conn.close()

    threading.Thread(target=serve, daemon=True).start()
    return srv


def _answering_worker(body):
    class _H(BaseHTTPRequestHandler):
        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), _H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_a_response_cut_short_is_retried_on_a_sibling():
    body = b'{"outputs": [[1.0, 2.0]]}'
    bad, good = _truncating_worker(), _answering_worker(body)
    views = {"w0": {"addr": "127.0.0.1:%d" % bad.getsockname()[1],
                    "inflight": 0},
             "w1": {"addr": "127.0.0.1:%d" % good.server_port,
                    "inflight": 3}}
    try:
        for P in (PORT, JAX):
            gw = _offline_gateway(P)
            gw._view = _view(P, views)
            try:
                if P is PORT:
                    out = gw._forward_predict(b"{}", gw.clock.now())
                    assert out == (200, body, "w1") and gw.retried == 1
                else:
                    with pytest.raises(http.client.IncompleteRead):
                        gw._forward_predict(b"{}", gw.clock.now())
            finally:
                gw.httpd.server_close()
    finally:
        bad.close()
        good.shutdown()
        good.server_close()


def test_demo_builders_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfw.demo_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfw.demo_generation()


def _rebalance(P):
    """FleetRebalancer's tick over one view: the worker past the median
    by more than the band is asked to park streams, then rests."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    posts = []

    class _H(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            posts.append((self.path, body))
            data = json.dumps({"handles": ["h%d" % i for i in
                                           range(body["park"])]}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    addr = "127.0.0.1:%d" % httpd.server_address[1]
    view = _view(P, {
        "w0": {"addr": addr, "kind": "generate", "inflight": 9},
        "w1": {"addr": addr, "kind": "generate", "inflight": 1},
        "w2": {"addr": addr, "kind": "generate", "inflight": 2},
        "p0": {"addr": addr, "kind": "predict", "inflight": 50}})

    class _Reg:
        service = "test"

        def view(self, reap=True):
            return view

    clk = P.clock.SimClock()
    rb = P.fleet.FleetRebalancer(registry=_Reg(), band=2, cooldown_s=5.0,
                                 max_moves=2, start=False, clock=clk)
    try:
        parked = [rb.tick(), rb.tick()]       # the second: cooldown
        clk.advance(6.0)
        parked.append(rb.tick())
        return parked, rb.snapshot(), posts
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_rebalancer_parks_the_same_streams():
    ref, got = both(_rebalance)
    assert got == ref
    assert got[0] == [2, 0, 2]
    assert got[2][0] == ("/v1/migrate_out", {"park": 2})


def test_demo_duo_routes_and_zero_recompile_adapter_swap():
    routes, adapters = tfw.demo_duo(device="cpu")
    reg = tfleet.ServiceRegistry(service="duo")
    worker = tfw.FleetWorker(routes, "d0", registry=reg, adapters=adapters)
    try:
        assert worker.kinds == {"gen@v1": "generate", "fc@v1": "predict"}
        gen = routes["gen@v1"]
        st, resp = worker._handle_adapter({"adapter": "alt"}, srv=gen,
                                          route="gen@v1")
        assert st == 200
        assert resp["recompiles_before"] == resp["recompiles_after"]
        assert worker.snapshot()["adapter_live"] == {"gen@v1": "alt"}
        st, resp = worker._handle_adapter({"adapter": "nope"}, srv=gen,
                                          route="gen@v1")
        assert st == 404 and resp["error"] == "UnknownAdapter"
        lines = []
        worker._handle_generate({"prompt": [1, 2, 3],
                                 "max_new_tokens": 3}, lines.append,
                                srv=gen)
        assert lines[-1]["done"] is True and lines[-1]["tokens"] == 3
    finally:
        worker.httpd.server_close()
        for srv in routes.values():
            assert srv.drain(timeout=30)
        reg.close()


# ---------------------------------------------------------------------------
# generation streams over in-process port workers
# ---------------------------------------------------------------------------
class _DyingWorker(tfw.FleetWorker):
    """A FleetWorker whose streams die after ``after`` token lines: the
    handler thread ends (``SystemExit`` passes every ``except Exception``
    and the thread's exception hook) and the connection closes with no
    terminal line, as a SIGKILLed worker's does."""

    after = 3

    def _handle_generate(self, body, write_line, srv=None):
        sent = [0]

        def cut(line):
            if "token" in line and sent[0] >= self.after:
                raise SystemExit("worker died mid-stream")
            sent[0] += "token" in line
            write_line(line)

        return super()._handle_generate(body, cut, srv=srv)


@pytest.fixture(scope="module")
def gen_servers():
    servers = [cpu_generation() for _ in range(2)]
    yield servers
    for s in servers:
        assert s.drain(timeout=30)


def _gen_fleet(servers, dying_sibling=True):
    reg = tfleet.ServiceRegistry(service="gen", ttl_s=30.0)
    workers = [_DyingWorker(servers[0], "d0", registry=reg,
                            heartbeat_s=0.05).start()]
    if dying_sibling:
        workers.append(tfw.FleetWorker(servers[1], "h0", registry=reg,
                                       heartbeat_s=0.05).start())
    gw = tgw.Gateway(registry=reg, refresh_s=0.05, suspect_s=5.0)
    wait(lambda: gw._view is not None
         and len(gw._view.replicas) == len(workers), msg="workers")
    return reg, workers, gw


def _close(reg, workers, gw):
    gw.stop()
    for w in workers:
        w._stop_evt.set()
        w.httpd.shutdown()
        w.httpd.server_close()
    reg.close()


def test_mid_stream_death_resumes_on_the_sibling(gen_servers):
    prompt = [5, 17, 3, 60]
    ref = gen_servers[1].submit(np.asarray(prompt, np.int32),
                                max_new_tokens=10, timeout=60)
    reg, workers, gw = _gen_fleet(gen_servers)
    leakcheck.install("record")
    leakcheck.reset()
    try:
        # route the first incarnation to the dying worker
        gw._track("h0", 100)
        lines = stream(gw.addr, "/v1/generate",
                       {"prompt": prompt, "max_new_tokens": 10})
        toks = [l["token"] for l in lines if "token" in l]
        assert toks == ref                   # exactly once, bitwise
        assert lines[-1]["done"] is True
        assert lines[-1]["tokens"] == 10 and lines[-1]["resumed"] == 1
        assert gw.streams_resumed == 1 and gw.streams_lost == 0
        # the handler drops the journal just after the client's terminal
        # line: every journal is gone once it returns
        wait(lambda: leakcheck.live_count("journal") == 0, timeout=10,
             msg="the stream journal to be dropped")
    finally:
        leakcheck.uninstall()
        leakcheck.reset()
        _close(reg, workers, gw)


def test_no_sibling_left_is_one_typed_replica_lost(gen_servers):
    reg, workers, gw = _gen_fleet(gen_servers, dying_sibling=False)
    try:
        lines = stream(gw.addr, "/v1/generate",
                       {"prompt": [1, 2, 3], "max_new_tokens": 8})
        assert len([l for l in lines if "token" in l]) == 3
        assert lines[-1]["error"] == "ReplicaLost"
        assert sum("error" in l for l in lines) == 1
        assert gw.streams_lost == 1 and gw.streams_resumed == 0
    finally:
        _close(reg, workers, gw)


# ---------------------------------------------------------------------------
# the spawned acceptance scenario
# ---------------------------------------------------------------------------
@pytest.mark.chaos
def test_spawned_fleet_survives_worker_kill_and_partition():
    reg = tfleet.ServiceRegistry(service="accept", ttl_s=1.0)
    sup = tfleet.WorkerSupervisor(
        {rid: worker_argv(reg.addr, rid, "accept", "cpu_model")
         for rid in ("w0", "w1")},
        registry=reg, max_restarts=3, backoff=0.05, backoff_cap=0.5,
        poll_s=0.05, env=worker_env())
    gw = tgw.Gateway(registry=reg, refresh_s=0.1, suspect_s=0.5, retries=2)
    outcomes, lock = [], threading.Lock()
    try:
        sup.wait_registered(2, timeout=120)
        wait(lambda: gw._view is not None and len(gw._view.replicas) == 2,
             timeout=30, msg="gateway to see both workers")
        x = {"inputs": {"data": [[1.0, 2.0, 3.0, 4.0]]}}

        def one():
            try:
                status, body, _ = post(gw.addr, "/v1/predict", x,
                                       timeout=90)
                name = "ok" if status == 200 else body.get("error", "?")
            except Exception as e:
                name = "UNTYPED:%s" % type(e).__name__
            with lock:
                outcomes.append(name)

        for _ in range(6):
            one()
        before = {rid: get(rep["addr"], "/healthz")[1]
                  for rid, rep in gw._view.replicas.items()}
        assert all(b["recompiles"] >= 0 for b in before.values())
        threads = [threading.Thread(target=one) for _ in range(40)]
        n = gw._refresh_seq + 1
        spec = ",".join("gateway_partition@%d" % i for i in range(n, n + 8))
        with tchaos.inject(spec):
            for i, t in enumerate(threads):
                t.start()
                if i == 10:
                    killed = sup.kill_worker()
                    assert killed in ("w0", "w1")
            for t in threads:
                t.join(timeout=120)
        assert len(outcomes) == 46
        assert not (set(outcomes) - {"ok", "Overloaded", "Draining",
                                     "DeadlineExceeded", "Unavailable"}), \
            outcomes
        assert outcomes.count("ok") >= 30
        old_pid = before[killed]["pid"]
        wait(lambda: reg.view().replicas.get(killed, {})
             .get("pid", old_pid) != old_pid, timeout=120,
             msg="killed worker back in rotation")
        assert sup.restarts >= 1
        assert sup.snapshot()["failures"][killed] <= sup.max_restarts
        survivor = "w1" if killed == "w0" else "w0"
        _, after = get(reg.view().replicas[survivor]["addr"], "/healthz")
        assert after["recompiles"] == before[survivor]["recompiles"]
        assert after["kind"] == "predict"
    finally:
        gw.stop()
        sup.stop(timeout=20.0)
        reg.close()
