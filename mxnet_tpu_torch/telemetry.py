"""Runtime telemetry: one thread-safe metrics registry for the port, the
counterpart of ``mxnet_tpu/telemetry.py``.

* :class:`Counter` / :class:`Gauge` / :class:`Histogram` — typed,
  individually locked metrics.  Histograms are log-bucketed (geometric
  bucket bounds) with interpolated p50/p95/p99 readout; the same
  observations give the same snapshot as the JAX package's.
* :class:`MetricsRegistry` — the name->metric table.  The process-wide
  singleton is :func:`registry`; the profiler's ``dispatch_count``
  counters (prefix ``dispatch.``), the generation server's ``gen.*``
  histograms and gauges and the brownout gauge land here, under the JAX
  package's names.
* Export paths — :meth:`MetricsRegistry.dump_prometheus`,
  :class:`JsonlExporter` and
  :func:`serve_http` (a localhost-only stdlib endpoint serving
  ``/metrics`` and ``/metrics.json``).
* :class:`StepAccountant` — MFU / HBM-bandwidth / items-per-sec gauges
  from a per-step cost dict and host wall-clock, against the H100 peaks
  of :mod:`~mxnet_tpu_torch.config`.
* Trace-ID helpers — :func:`new_trace_id` plus chrome-trace async
  begin/end/instant emitters routed through the profiler's event ring.

Lock discipline: every metric has its own lock held only for the
arithmetic; the registry lock only guards the name table; no lock is held
across file or socket I/O.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import re
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "JsonlExporter", "start_exporter", "stop_exporter",
           "serve_http", "stop_http", "StepAccountant", "new_trace_id",
           "trace_begin", "trace_end", "trace_instant", "init_from_env"]


# ---------------------------------------------------------------------------
# typed metrics
# ---------------------------------------------------------------------------
class Counter:
    """Monotonic counter (resettable for tests/windows).  ``inc`` returns
    the post-increment value so call sites can publish it without a
    second locked read."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, delta=1):
        with self._lock:
            self._value += delta
            return self._value

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        """Zero the counter; returns the value it held."""
        with self._lock:
            old = self._value
            self._value = 0
            return old


class Gauge:
    """Last-writer-wins instantaneous value."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def add(self, delta):
        with self._lock:
            self._value += float(delta)
            return self._value

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Log-bucketed histogram with interpolated quantile readout.

    Bucket ``i`` spans ``(base*growth**(i-1), base*growth**i]``; bucket 0
    additionally absorbs everything ``<= base`` (so zeros/negatives never
    lose samples), and the last bucket absorbs everything beyond the
    range.  The geometric layout keeps relative quantile error bounded
    by ``growth - 1`` (default ~25%, tightened by linear interpolation
    inside the winning bucket and clamping to the observed min/max)
    across any number of decades at O(max_buckets) memory.
    """

    __slots__ = ("name", "base", "growth", "max_buckets", "_lg", "_lock",
                 "_buckets", "_count", "_sum", "_min", "_max")

    def __init__(self, name, base=1e-3, growth=1.25, max_buckets=120):
        if not growth > 1.0:
            raise ValueError("growth must be > 1, got %r" % growth)
        if not base > 0.0:
            raise ValueError("base must be > 0, got %r" % base)
        self.name = name
        self.base = float(base)
        self.growth = float(growth)
        self.max_buckets = int(max_buckets)
        self._lg = math.log(self.growth)
        self._lock = threading.Lock()
        self._buckets = {}            # index -> count
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- bucket math (exposed for tests) -----------------------------------
    def bucket_index(self, value):
        v = float(value)
        if not v > self.base:        # <= base, zero, negative, NaN
            return 0
        # round() absorbs float-log jitter at exact bucket bounds
        # (log2(8)/log2(2) -> 3.0000000000000004 must land in bucket 3)
        i = int(math.ceil(round(math.log(v / self.base) / self._lg, 9)))
        return min(max(i, 0), self.max_buckets - 1)

    def bucket_bounds(self, index):
        """(lo, hi] value bounds of bucket ``index``."""
        hi = self.base * self.growth ** index
        lo = 0.0 if index == 0 else self.base * self.growth ** (index - 1)
        return lo, hi

    # -- recording ---------------------------------------------------------
    def observe(self, value):
        v = float(value)
        if v != v:                   # NaN: no bucket is right
            return
        i = self.bucket_index(v)
        with self._lock:
            self._buckets[i] = self._buckets.get(i, 0) + 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def reset(self):
        with self._lock:
            self._buckets = {}
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    # -- readout -----------------------------------------------------------
    @property
    def count(self):
        with self._lock:
            return self._count

    def percentile(self, q):
        """Interpolated q-th percentile (q in [0, 100]); None when
        empty."""
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q):
        if not self._count:
            return None
        target = max(1, int(math.ceil(q / 100.0 * self._count)))
        cum = 0
        for i in sorted(self._buckets):
            n = self._buckets[i]
            if cum + n >= target:
                lo, hi = self.bucket_bounds(i)
                est = lo + (hi - lo) * ((target - cum) / float(n))
                return min(max(est, self._min), self._max)
            cum += n
        return self._max

    def snapshot(self):
        with self._lock:
            if not self._count:
                return {"count": 0, "sum": 0.0, "avg": None, "min": None,
                        "max": None, "p50": None, "p95": None, "p99": None}
            return {"count": self._count,
                    "sum": self._sum,
                    "avg": self._sum / self._count,
                    "min": self._min,
                    "max": self._max,
                    "p50": self._percentile_locked(50),
                    "p95": self._percentile_locked(95),
                    "p99": self._percentile_locked(99)}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_PROM_SAN = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name):
    n = _PROM_SAN.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return n


def _prom_num(v):
    return format(float(v), ".10g")


class MetricsRegistry:
    """Thread-safe name -> metric table with typed accessors.

    ``counter()/gauge()/histogram()`` create on first use and return the
    existing metric afterwards (histogram shape kwargs only apply at
    creation); asking for a name under a different type raises
    ``TypeError`` — one name means one thing process-wide.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get(self, name, cls, kwargs=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **(kwargs or {}))
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    "metric %r already registered as %s, not %s"
                    % (name, type(m).__name__, cls.__name__))
            return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def histogram(self, name, base=1e-3, growth=1.25, max_buckets=120):
        return self._get(name, Histogram,
                         {"base": base, "growth": growth,
                          "max_buckets": max_buckets})

    def find(self, prefix=""):
        """[(name, metric)] whose name starts with ``prefix``."""
        with self._lock:
            return [(n, m) for n, m in sorted(self._metrics.items())
                    if n.startswith(prefix)]

    def snapshot(self):
        """One JSON-ready dict of everything (the JSONL export schema):
        ``{ts_unix, counters: {name: int}, gauges: {name: float},
        histograms: {name: {count,sum,avg,min,max,p50,p95,p99}}}``."""
        counters, gauges, hists = {}, {}, {}
        for name, m in self.find():
            if isinstance(m, Counter):
                counters[name] = m.value
            elif isinstance(m, Gauge):
                gauges[name] = m.value
            elif isinstance(m, Histogram):
                hists[name] = m.snapshot()
        return {"ts_unix": round(time.time(), 3), "counters": counters,
                "gauges": gauges, "histograms": hists}

    def dump_prometheus(self):
        """Prometheus text exposition (0.0.4): counters and gauges as
        themselves, histograms as summaries (quantile-labelled series
        plus ``_sum``/``_count``)."""
        lines = []
        for name, m in self.find():
            pn = _prom_name(name)
            if isinstance(m, Counter):
                lines.append("# TYPE %s counter" % pn)
                lines.append("%s %d" % (pn, m.value))
            elif isinstance(m, Gauge):
                lines.append("# TYPE %s gauge" % pn)
                lines.append("%s %s" % (pn, _prom_num(m.value)))
            elif isinstance(m, Histogram):
                s = m.snapshot()
                lines.append("# TYPE %s summary" % pn)
                if s["count"]:
                    for q, key in ((0.5, "p50"), (0.95, "p95"),
                                   (0.99, "p99")):
                        lines.append('%s{quantile="%g"} %s'
                                     % (pn, q, _prom_num(s[key])))
                lines.append("%s_sum %s" % (pn, _prom_num(s["sum"])))
                lines.append("%s_count %d" % (pn, s["count"]))
        return "\n".join(lines) + "\n"

    def reset(self):
        """Zero every metric in place (tests / measurement windows);
        metric objects and their identities survive."""
        for _, m in self.find():
            if isinstance(m, Counter):
                m.reset()
            elif isinstance(m, Gauge):
                m.set(0.0)
            elif isinstance(m, Histogram):
                m.reset()


_REGISTRY = MetricsRegistry()


def registry():
    """The process-wide registry every framework layer reports into."""
    return _REGISTRY


# ---------------------------------------------------------------------------
# JSONL exporter
# ---------------------------------------------------------------------------
class JsonlExporter:
    """Background thread appending one registry snapshot per interval as
    a JSON line; a final line is flushed at :meth:`stop`.  The snapshot
    happens under the metric locks, the file write after release."""

    def __init__(self, path, interval_s=10.0, reg=None):
        self.path = str(path)
        self.interval_s = max(0.01, float(interval_s))
        self._reg = reg or registry()
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="telemetry-export",
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        """Signal, flush the final snapshot, and join the thread."""
        self._stop_evt.set()
        self._thread.join(timeout=10.0)

    def _loop(self):
        while True:
            stopped = self._stop_evt.wait(self.interval_s)
            line = json.dumps(self._reg.snapshot())
            try:
                with open(self.path, "a") as f:
                    f.write(line + "\n")
            except OSError:
                pass                  # telemetry must never take down the job
            if stopped:
                return


_exporter = None


def start_exporter(path, interval_s=10.0, reg=None):
    """Start (or replace) the module-level JSONL exporter."""
    global _exporter
    stop_exporter()
    _exporter = JsonlExporter(path, interval_s=interval_s, reg=reg).start()
    return _exporter


def stop_exporter():
    global _exporter
    if _exporter is not None:
        _exporter.stop()
        _exporter = None


# ---------------------------------------------------------------------------
# localhost HTTP endpoint (Prometheus scrape target)
# ---------------------------------------------------------------------------
_http = None          # (server, thread)


def serve_http(port=0, reg=None):
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json``
    (snapshot JSON) on ``127.0.0.1:port`` from a daemon thread; returns
    the bound port (useful with ``port=0``).  Localhost-only by design —
    production scraping goes through a sidecar, not an open port."""
    global _http
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    stop_http()
    the_reg = reg or registry()

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):                         # noqa: N802 (stdlib API)
            if self.path.startswith("/metrics.json"):
                body = json.dumps(the_reg.snapshot()).encode("utf-8")
                ctype = "application/json"
            elif self.path.startswith("/metrics") or self.path == "/":
                body = the_reg.dump_prometheus().encode("utf-8")
                ctype = "text/plain; version=0.0.4"
            elif self.path.startswith("/debug/recompiles"):
                from . import dispatch

                body = json.dumps(
                    {"entries": dispatch.recompile_ring(),
                     "text": dispatch.explain_recompiles()},
                    default=str).encode("utf-8")
                ctype = "application/json"
            elif self.path.startswith("/debug/memory"):
                from . import memory

                body = json.dumps(memory.update(reg=the_reg),
                                  default=str).encode("utf-8")
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass                      # scrapes must not spam stderr

    server = ThreadingHTTPServer(("127.0.0.1", int(port)), _Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="telemetry-http", daemon=True)
    thread.start()
    _http = (server, thread)
    return server.server_address[1]


def stop_http():
    global _http
    if _http is not None:
        server, thread = _http
        _http = None
        server.shutdown()
        server.server_close()
        thread.join(timeout=10.0)


# ---------------------------------------------------------------------------
# cost-analysis step accounting
# ---------------------------------------------------------------------------
def _peak_flops():
    from .config import config

    return float(config.telemetry_peak_flops)


def _peak_hbm_gbs():
    from .config import config

    return float(config.telemetry_peak_hbm_gbs)


class StepAccountant:
    """Live MFU / HBM-bandwidth-utilization / throughput gauges with
    zero device syncs.

    Feed it the step's cost dict (``{"flops", "bytes_accessed"}`` per
    execution, counted from the shapes) once, then call
    :meth:`on_step` per step with the item count (images, tokens).  The
    step rate is the EWMA of host wall-clock between successive calls —
    valid because a full device queue backpressures the host, so in
    steady state dispatches complete at exactly the device step rate.
    The first call only arms the clock (it would otherwise fold compile
    time into the rate).

    Gauges published under ``prefix.``: ``steps_per_sec``,
    ``items_per_sec``, and — when the cost dict is known — ``mfu``
    (vs ``MXNET_TELEMETRY_PEAK_FLOPS``), ``hbm_gbs`` and ``hbm_util``
    (vs ``MXNET_TELEMETRY_PEAK_HBM_GBS``).
    """

    def __init__(self, prefix, reg=None, alpha=0.25):
        self.prefix = prefix
        self._reg = reg or registry()
        self._alpha = float(alpha)
        self._cost = None
        self._last_t = None
        self._ewma_dt = None

    def set_cost(self, cost):
        """``{"flops": float, "bytes_accessed": float}`` per execution
        (or None to disable the derived gauges)."""
        self._cost = dict(cost) if cost else None
        return self

    @property
    def cost(self):
        return self._cost

    def on_step(self, items=None):
        """Record one completed step dispatch; ``items`` is the batch's
        item count for the items_per_sec gauge."""
        now = time.perf_counter()
        last, self._last_t = self._last_t, now
        if last is None:
            return None
        dt = now - last
        if dt <= 0:
            return None
        self._ewma_dt = (dt if self._ewma_dt is None else
                         (1 - self._alpha) * self._ewma_dt
                         + self._alpha * dt)
        sps = 1.0 / self._ewma_dt
        g = self._reg.gauge
        g(self.prefix + ".steps_per_sec").set(sps)
        if items:
            g(self.prefix + ".items_per_sec").set(float(items) * sps)
        if self._cost:
            flops = float(self._cost.get("flops") or 0.0)
            nbytes = float(self._cost.get("bytes_accessed") or 0.0)
            if flops > 0:
                g(self.prefix + ".mfu").set(flops * sps / _peak_flops())
            if nbytes > 0:
                gbs = nbytes * sps / 1e9
                g(self.prefix + ".hbm_gbs").set(gbs)
                g(self.prefix + ".hbm_util").set(gbs / _peak_hbm_gbs())
        return sps


# ---------------------------------------------------------------------------
# end-to-end trace IDs (chrome-trace async events via the profiler buffer)
# ---------------------------------------------------------------------------
_TRACE_SEQ = itertools.count(1)


def new_trace_id():
    """Process-unique request trace ID (chrome-trace async-event id)."""
    return "r%x-%x" % (os.getpid(), next(_TRACE_SEQ))


def _record(evt):
    from . import profiler as _prof

    _prof.record_event(evt)


def trace_begin(name, trace_id, cat="serving", args=None):
    """Open an async span (chrome-trace 'b'); pair with
    :func:`trace_end` on the same (cat, id, name)."""
    evt = {"ph": "b", "cat": cat, "name": name, "id": trace_id}
    if args:
        evt["args"] = args
    _record(evt)


def trace_end(name, trace_id, cat="serving", args=None):
    evt = {"ph": "e", "cat": cat, "name": name, "id": trace_id}
    if args:
        evt["args"] = args
    _record(evt)


def trace_instant(name, cat="serving", args=None, scope="t"):
    evt = {"ph": "i", "cat": cat, "name": name, "s": scope}
    if args:
        evt["args"] = args
    _record(evt)
