"""Trace-driven load generation and replay: the counterpart of
``mxnet_tpu/loadgen.py``.

* :class:`TraceSpec` — a seeded description of an arrival process
  (Poisson or bursty two-state MMPP), prompt/output-length
  distributions (log-normal), a shared-prefix mix, weighted deadline
  classes, tenants, and piecewise ramp segments.
* :func:`generate_trace` — spec -> a deterministic list of request
  dicts.  The same spec and seed give the same trace as the JAX
  package's, bit for bit (both draw from one numpy Generator in the same
  order).  Traces round-trip through JSONL (:func:`save_trace` /
  :func:`load_trace`).
* :func:`replay` — push a trace through a target at wall-clock or
  compressed time.  Targets are plain callables built by the adapter
  factories: :func:`server_target` (an in-process server with
  ``submit_async(feed, deadline_ms=)``) or :func:`generation_target` (a
  ``GenerationServer`` stream) or :func:`gateway_target` (the HTTP front
  door of the fleet plane).  Every request produces exactly one
  typed-outcome record — the serving layer's outcome contract, observed
  from the client side.
* :class:`ReplayReport` — per-request records plus aggregate curves
  (offered vs goodput per second, shed rate, TTFT/latency percentiles)
  and :func:`shed_knee`.

Determinism: all sampling flows through one ``numpy`` Generator seeded
from the spec; replay threads write into a preallocated slot per
request, so the *records* are ordered by trace position regardless of
completion order.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time

import numpy as np

from . import clock as _clockmod

__all__ = ["TraceSpec", "generate_trace", "prompt_tokens", "save_trace",
           "load_trace", "replay", "ReplayReport", "server_target",
           "generation_target", "gateway_target", "shed_knee",
           "TYPED_OUTCOMES"]

# env-tunable defaults (the JAX package's names)
_DEF_MAX_INFLIGHT = int(os.environ.get("MXTPU_LOADGEN_MAX_INFLIGHT",
                                       "256"))
_DEF_TIMEOUT_S = float(os.environ.get("MXTPU_LOADGEN_TIMEOUT_S", "60"))

# outcome names the serving stack can terminate a request with; anything
# else surfaces as "UNTYPED:<Name>" so parity tests catch contract leaks
TYPED_OUTCOMES = ("ok", "Overloaded", "DeadlineExceeded", "Draining",
                  "Unavailable", "ReplicaLost", "QuotaExceeded",
                  "UnknownRoute")


# ---------------------------------------------------------------------------
# trace model
# ---------------------------------------------------------------------------
class TraceSpec:
    """Seeded description of a synthetic workload.

    ``segments`` is the diurnal ramp: a list of ``{"duration_s": float,
    "rate_rps": float}`` pieces played in order (one segment = a flat
    Poisson/MMPP window at that offered rate).  ``arrival="mmpp"``
    overlays a two-state Markov-modulated process: dwell times are
    exponential with mean ``burst_dwell_s``, and the burst state
    multiplies the segment rate by ``burst_factor``.

    ``deadline_classes`` is a list of ``{"name", "deadline_ms",
    "weight"}``; each request samples one class by weight.
    ``prefix_groups``/``prefix_hit_rate`` describe the shared-prefix
    mix (a request in a group shares its group's prompt prefix — the
    prefix-cache-friendly fraction of traffic); ``session_count > 0``
    assigns requests round-robin-by-sample to sticky sessions (the
    gateway affinity path).

    ``tenants`` is an optional weighted mix of ``{"name", "weight"}``
    entries; each request samples one tenant by weight and carries it
    end-to-end (``X-MXTPU-Tenant`` on the gateway wire), feeding the
    per-tenant quota/fair-share machinery in :mod:`mxnet_tpu_torch.tenancy`.
    """

    _FIELDS = ("seed", "arrival", "burst_factor", "burst_dwell_s",
               "segments", "prompt_len_mean", "prompt_len_sigma",
               "prompt_len_max", "output_len_mean", "output_len_sigma",
               "output_len_max", "deadline_classes", "prefix_groups",
               "prefix_hit_rate", "prefix_len", "session_count",
               "tenants")

    def __init__(self, seed=0, arrival="poisson", burst_factor=4.0,
                 burst_dwell_s=2.0, segments=None,
                 prompt_len_mean=32, prompt_len_sigma=0.5,
                 prompt_len_max=512,
                 output_len_mean=16, output_len_sigma=0.5,
                 output_len_max=256,
                 deadline_classes=None, prefix_groups=0,
                 prefix_hit_rate=0.0, prefix_len=8, session_count=0,
                 tenants=None):
        if arrival not in ("poisson", "mmpp"):
            raise ValueError("arrival must be 'poisson' or 'mmpp', got %r"
                             % (arrival,))
        self.seed = int(seed)
        self.arrival = arrival
        self.burst_factor = float(burst_factor)
        self.burst_dwell_s = float(burst_dwell_s)
        self.segments = [dict(s) for s in (segments or
                                           [{"duration_s": 10.0,
                                             "rate_rps": 10.0}])]
        for s in self.segments:
            if s.get("duration_s", 0) <= 0 or s.get("rate_rps", 0) < 0:
                raise ValueError("bad segment %r" % (s,))
        self.prompt_len_mean = float(prompt_len_mean)
        self.prompt_len_sigma = float(prompt_len_sigma)
        self.prompt_len_max = int(prompt_len_max)
        self.output_len_mean = float(output_len_mean)
        self.output_len_sigma = float(output_len_sigma)
        self.output_len_max = int(output_len_max)
        self.deadline_classes = [dict(c) for c in (
            deadline_classes or [{"name": "default", "deadline_ms": 1000.0,
                                  "weight": 1.0}])]
        if not self.deadline_classes or any(
                c.get("weight", 0) <= 0 or c.get("deadline_ms", 0) <= 0
                for c in self.deadline_classes):
            raise ValueError("deadline_classes need positive weight and "
                             "deadline_ms")
        self.prefix_groups = int(prefix_groups)
        self.prefix_hit_rate = float(prefix_hit_rate)
        self.prefix_len = int(prefix_len)
        self.session_count = int(session_count)
        self.tenants = None if not tenants else [dict(t) for t in tenants]
        if self.tenants is not None and any(
                not t.get("name") or t.get("weight", 0) <= 0
                for t in self.tenants):
            raise ValueError("tenants need a name and positive weight")

    @property
    def duration_s(self):
        return sum(s["duration_s"] for s in self.segments)

    def as_dict(self):
        return {f: getattr(self, f) for f in self._FIELDS}

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: v for k, v in dict(d).items()
                      if k in cls._FIELDS})

    def __repr__(self):
        return "TraceSpec(seed=%d, %s, %d segment(s), %.1fs)" % (
            self.seed, self.arrival, len(self.segments), self.duration_s)


def _arrival_times(spec, rng):
    """Offsets (seconds from trace start) for every arrival."""
    times = []
    t_seg = 0.0
    # MMPP state machine persists across segments: strict calm <-> burst
    # alternation (every cycle HAS a burst — no coin-flip lottery), with
    # dwell means burst_dwell_s (burst) and burst_dwell_s * burst_factor
    # (calm).  The normalization keeps the long-run offered rate at the
    # segment's nominal rate: burst share s = 1/(1+factor), so dividing
    # both state rates by (1-s) + s*factor preserves the mean.
    in_burst = True                     # first flip below lands on calm
    dwell_until = 0.0
    share = 1.0 / (1.0 + spec.burst_factor)
    norm = (1.0 - share) + share * spec.burst_factor
    for seg in spec.segments:
        end = t_seg + float(seg["duration_s"])
        rate = float(seg["rate_rps"])
        t = t_seg
        while rate > 0:
            r = rate
            if spec.arrival == "mmpp":
                while t >= dwell_until:
                    in_burst = not in_burst
                    dwell_until = t + rng.exponential(
                        spec.burst_dwell_s if in_burst
                        else spec.burst_dwell_s * spec.burst_factor)
                r = rate * (spec.burst_factor if in_burst else 1.0) / norm
            t += rng.exponential(1.0 / r)
            if t >= end:
                break
            times.append(t)
        t_seg = end
    return times


def generate_trace(spec):
    """Materialize ``spec`` into a list of request dicts, each::

        {"i", "t", "prompt_len", "max_new_tokens", "deadline_ms",
         "class", "priority", "session", "prefix_group"}

    ``t`` is the arrival offset in seconds from trace start.  Same spec
    (same seed) -> identical trace.  ``priority`` is the QoS wire form
    ``"name=rank"``: the tighter a class's deadline, the higher its rank
    (loosest class = rank 0), so preemption and brownout admission favor
    exactly the requests with the least slack."""
    rng = np.random.default_rng(spec.seed)
    times = _arrival_times(spec, rng)
    weights = np.asarray([c["weight"] for c in spec.deadline_classes],
                         float)
    weights = weights / weights.sum()
    by_slack = sorted(spec.deadline_classes,
                      key=lambda c: -float(c["deadline_ms"]))
    rank_of = {str(c["name"]): r for r, c in enumerate(by_slack)}
    tnames, tweights = None, None
    if spec.tenants:
        tnames = [str(t["name"]) for t in spec.tenants]
        tweights = np.asarray([t["weight"] for t in spec.tenants], float)
        tweights = tweights / tweights.sum()
    reqs = []
    for i, t in enumerate(times):
        plen = int(min(spec.prompt_len_max, max(1, round(
            rng.lognormal(math.log(spec.prompt_len_mean),
                          spec.prompt_len_sigma)))))
        olen = int(min(spec.output_len_max, max(1, round(
            rng.lognormal(math.log(spec.output_len_mean),
                          spec.output_len_sigma)))))
        cls = spec.deadline_classes[int(rng.choice(len(weights),
                                                   p=weights))]
        group = None
        if spec.prefix_groups > 0 and rng.random() < spec.prefix_hit_rate:
            group = int(rng.integers(spec.prefix_groups))
        session = None
        if spec.session_count > 0:
            session = "s%d" % int(rng.integers(spec.session_count))
        tenant = None
        if tnames:
            tenant = tnames[int(rng.choice(len(tnames), p=tweights))]
        name = str(cls["name"])
        reqs.append({"i": i, "t": round(float(t), 6),
                     "prompt_len": plen, "max_new_tokens": olen,
                     "deadline_ms": float(cls["deadline_ms"]),
                     "class": name,
                     "priority": "%s=%d" % (name, rank_of[name]),
                     "session": session, "prefix_group": group,
                     "tenant": tenant})
    return reqs


def prompt_tokens(req, vocab=1000, seed=0):
    """Deterministic token ids for one trace request (shared-prefix
    groups share their first ``prefix_len``-ish tokens by construction:
    the group id seeds the prefix, the request id seeds the tail)."""
    group = req.get("prefix_group")
    n = int(req["prompt_len"])
    if group is None:
        rng = np.random.default_rng((seed, 7919, int(req["i"])))
        return rng.integers(1, vocab, size=n, dtype=np.int64)
    pfx_rng = np.random.default_rng((seed, 104729, int(group)))
    pfx = pfx_rng.integers(1, vocab, size=min(n, 8), dtype=np.int64)
    tail_rng = np.random.default_rng((seed, 7919, int(req["i"])))
    tail = tail_rng.integers(1, vocab, size=n - len(pfx), dtype=np.int64)
    return np.concatenate([pfx, tail])


# -- JSONL round-trip -------------------------------------------------------
def save_trace(path, trace, spec=None):
    """Write a trace as JSONL: an optional header line carrying the
    spec, then one request object per line."""
    with open(path, "w") as f:
        if spec is not None:
            f.write(json.dumps({"kind": "trace_header",
                                "spec": spec.as_dict()}) + "\n")
        for req in trace:
            f.write(json.dumps(req) + "\n")


def load_trace(path):
    """Read a JSONL trace; returns ``(trace, spec_or_None)``.  Accepts
    both headered files (from :func:`save_trace`) and bare
    one-request-per-line captures."""
    trace, spec = [], None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if obj.get("kind") == "trace_header":
                spec = TraceSpec.from_dict(obj["spec"])
                continue
            if "t" not in obj:
                raise ValueError("trace line missing arrival offset "
                                 "'t': %r" % (obj,))
            trace.append(obj)
    trace.sort(key=lambda r: (r["t"], r.get("i", 0)))
    for i, req in enumerate(trace):
        req.setdefault("i", i)
    return trace, spec


# ---------------------------------------------------------------------------
# outcome records + report
# ---------------------------------------------------------------------------
def _outcome_record(req, outcome, latency_ms=None, ttft_ms=None,
                    tokens=0, migrated=0):
    return {"kind": "outcome", "i": int(req["i"]),
            "t_offered": float(req["t"]), "class": req.get("class"),
            "tenant": req.get("tenant"),
            "outcome": str(outcome),
            "latency_ms": None if latency_ms is None
            else round(float(latency_ms), 3),
            "ttft_ms": None if ttft_ms is None
            else round(float(ttft_ms), 3),
            "tokens": int(tokens),
            # live KV handoffs this stream survived (the gateway's
            # terminal line carries the count; 0 = never migrated)
            "migrated": int(migrated)}


def _pctl(vals, q):
    if not vals:
        return None
    vals = sorted(vals)
    idx = min(len(vals) - 1, max(0, int(math.ceil(q / 100.0 * len(vals)))
                                 - 1))
    return vals[idx]


def shed_knee(curve, ok_floor=0.9):
    """Offered rate (rps) at the first curve bucket where goodput stops
    tracking offered load (``ok/offered < ok_floor``); None when the
    curve never bends — the shed knee of a goodput-vs-offered plot."""
    for b in curve:
        if b["offered"] > 0 and b["ok"] / b["offered"] < ok_floor:
            return b["offered_per_sec"]
    return None


class ReplayReport:
    """Outcome records + aggregate curves for one replay run."""

    def __init__(self, records, wall_s, speed=1.0, name="loadreplay"):
        self.records = [r for r in records if r is not None]
        self.wall_s = float(wall_s)
        self.speed = float(speed)
        self.name = str(name)

    def outcome_counts(self):
        out = {}
        for r in self.records:
            out[r["outcome"]] = out.get(r["outcome"], 0) + 1
        return out

    def curve(self, bucket_s=1.0):
        """Per-trace-time buckets: offered/ok/shed counts and rates plus
        per-bucket latency and TTFT p99 — the goodput-vs-offered-load
        curve (bucket times are *trace* time, so compressed replay and
        simulation produce comparable curves)."""
        if not self.records:
            return []
        bucket_s = float(bucket_s)
        horizon = max(r["t_offered"] for r in self.records)
        n = int(horizon // bucket_s) + 1
        buckets = [{"t": round(i * bucket_s, 6), "offered": 0, "ok": 0,
                    "shed": 0, "_lat": [], "_ttft": []}
                   for i in range(n)]
        for r in self.records:
            b = buckets[int(r["t_offered"] // bucket_s)]
            b["offered"] += 1
            if r["outcome"] == "ok":
                b["ok"] += 1
                if r["latency_ms"] is not None:
                    b["_lat"].append(r["latency_ms"])
                if r["ttft_ms"] is not None:
                    b["_ttft"].append(r["ttft_ms"])
            elif r["outcome"] == "Overloaded":
                b["shed"] += 1
        for b in buckets:
            b["offered_per_sec"] = round(b["offered"] / bucket_s, 3)
            b["goodput_per_sec"] = round(b["ok"] / bucket_s, 3)
            b["latency_p99_ms"] = _pctl(b.pop("_lat"), 99)
            b["ttft_p99_ms"] = _pctl(b.pop("_ttft"), 99)
        return buckets

    def summary(self, prefix=None):
        """Flat aggregate metrics; keys carry the bench tripwire
        suffixes (``_per_sec`` higher-better, ``_ms`` lower-better) so
        a replay regression trips the same >10% check as a bench leg."""
        prefix = self.name if prefix is None else prefix
        span = max((r["t_offered"] for r in self.records), default=0.0)
        span = max(span, 1e-9)
        ok = [r for r in self.records if r["outcome"] == "ok"]
        lats = [r["latency_ms"] for r in ok
                if r["latency_ms"] is not None]
        ttfts = [r["ttft_ms"] for r in ok if r["ttft_ms"] is not None]
        counts = self.outcome_counts()
        out = {
            "%s_requests" % prefix: len(self.records),
            "%s_offered_per_sec" % prefix: round(
                len(self.records) / span, 3),
            "%s_goodput_per_sec" % prefix: round(len(ok) / span, 3),
            "%s_shed_rate" % prefix: round(
                counts.get("Overloaded", 0) / max(1, len(self.records)),
                4),
            "%s_outcomes" % prefix: counts,
            "%s_wall_s" % prefix: round(self.wall_s, 3),
        }
        if lats:
            out["%s_latency_p50_ms" % prefix] = round(_pctl(lats, 50), 3)
            out["%s_latency_p99_ms" % prefix] = round(_pctl(lats, 99), 3)
        if ttfts:
            out["%s_ttft_p99_ms" % prefix] = round(_pctl(ttfts, 99), 3)
        migrated = sum(r.get("migrated", 0) for r in self.records)
        if migrated:
            out["%s_streams_migrated" % prefix] = migrated
        tenants = self.tenant_summary()
        if tenants:
            out["%s_tenants" % prefix] = tenants
        return out

    def tenant_summary(self):
        """Per-tenant isolation view: request/ok/QuotaExceeded counts
        plus latency and TTFT p99, keyed by tenant (records without a
        tenant are skipped).  The noisy-neighbor proof reads exactly
        this: the flooder's ``shed_quota`` climbs while the victims'
        ``ttft_p99_ms`` barely moves."""
        by = {}
        for r in self.records:
            t = r.get("tenant")
            if not t:
                continue
            d = by.setdefault(t, {"requests": 0, "ok": 0,
                                  "shed_quota": 0, "_lat": [],
                                  "_ttft": []})
            d["requests"] += 1
            if r["outcome"] == "ok":
                d["ok"] += 1
                if r["latency_ms"] is not None:
                    d["_lat"].append(r["latency_ms"])
                if r["ttft_ms"] is not None:
                    d["_ttft"].append(r["ttft_ms"])
            elif r["outcome"] == "QuotaExceeded":
                d["shed_quota"] += 1
        for d in by.values():
            d["latency_p99_ms"] = _pctl(d.pop("_lat"), 99)
            d["ttft_p99_ms"] = _pctl(d.pop("_ttft"), 99)
        return by

    def write_jsonl(self, path, bucket_s=1.0):
        """Emit the replay as bench-leg JSONL: one line per outcome
        record, one per curve bucket, and a final leg line in the exact
        ``bench.py`` ``_flush_leg`` shape (``{"leg", "status",
        "elapsed_s", "record"}``) holding the flat summary metrics."""
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")
            for b in self.curve(bucket_s):
                f.write(json.dumps({"kind": "curve", **b}) + "\n")
            f.write(json.dumps({"leg": self.name, "status": "ok",
                                "elapsed_s": round(self.wall_s, 1),
                                "record": self.summary()}) + "\n")
        return path


# ---------------------------------------------------------------------------
# targets: trace request -> one typed outcome dict
# ---------------------------------------------------------------------------
def _typed(exc):
    """Typed-outcome name for an exception raised by the serving
    stack; unexpected types surface loudly as UNTYPED."""
    from . import serving as _serving

    if isinstance(exc, _serving.ServingError):
        return type(exc).__name__
    return "UNTYPED:%s" % type(exc).__name__


def server_target(server, input_fn, timeout_s=None):
    """Adapter over an in-process server with the ``ModelServer``
    interface, ``submit_async(feed, deadline_ms=)`` (``input_fn(req) ->
    feed dict``)."""
    timeout_s = _DEF_TIMEOUT_S if timeout_s is None else float(timeout_s)

    def call(req):
        t0 = time.monotonic()
        try:
            fut = server.submit_async(input_fn(req),
                                      deadline_ms=req["deadline_ms"])
            fut.result(timeout=timeout_s)
        except Exception as e:   # noqa: BLE001 — typed below
            return _outcome_record(
                req, _typed(e), (time.monotonic() - t0) * 1e3)
        return _outcome_record(req, "ok", (time.monotonic() - t0) * 1e3)

    return call


def generation_target(server, vocab=None, seed=0, timeout_s=None):
    """Adapter over an in-process
    :class:`~mxnet_tpu_torch.generation.GenerationServer`: prompts are
    built deterministically from the trace (:func:`prompt_tokens`), tokens
    are drained through the streaming iterator, and TTFT comes from the
    future's own first-token stamp.  ``vocab`` defaults to the served
    model's vocabulary."""
    timeout_s = _DEF_TIMEOUT_S if timeout_s is None else float(timeout_s)
    if vocab is None:
        vocab = int(server.engine.model.cfg.vocab_size)

    def call(req):
        t0 = time.monotonic()
        n_tok = 0
        try:
            fut = server.submit_async(
                prompt_tokens(req, vocab=vocab, seed=seed),
                max_new_tokens=req["max_new_tokens"],
                deadline_ms=req["deadline_ms"],
                priority=req.get("priority") or req.get("class"),
                tenant=req.get("tenant"))
            for _ in fut.tokens(timeout=timeout_s):
                n_tok += 1
        except Exception as e:   # noqa: BLE001 — typed below
            return _outcome_record(
                req, _typed(e), (time.monotonic() - t0) * 1e3,
                tokens=n_tok)
        ttft = None if fut.t_first_token is None else \
            (fut.t_first_token - fut.t_admit) * 1e3
        return _outcome_record(req, "ok", (time.monotonic() - t0) * 1e3,
                               ttft_ms=ttft, tokens=n_tok)

    return call


def gateway_target(addr, kind="predict", input_fn=None, vocab=1000,
                   seed=0, timeout_s=None, route=None):
    """Adapter over the HTTP front door (a
    :class:`~mxnet_tpu_torch.gateway.Gateway` or one fleet worker) at
    ``addr`` (``host:port``).  ``kind='predict'`` POSTs ``input_fn(req)`` (JSON
    arrays) to ``/v1/predict``; ``kind='generate'`` streams
    ``/v1/generate`` NDJSON, mapping the terminal line to the typed
    outcome.  ``route`` targets a named model route
    (``/v1/<route>/<verb>``, e.g. ``gen@v1``) instead of the bare
    default-route alias.  Sticky sessions — and each request's tenant
    (``X-MXTPU-Tenant``) — from the trace ride along."""
    import http.client

    if kind not in ("predict", "generate"):
        raise ValueError("kind must be 'predict' or 'generate'")
    if kind == "predict" and input_fn is None:
        raise ValueError("predict replay needs input_fn(req) -> feed")
    timeout_s = _DEF_TIMEOUT_S if timeout_s is None else float(timeout_s)
    host, _, port = str(addr).rpartition(":")
    prefix = "/v1" if route in (None, "default") else "/v1/%s" % route

    def call(req):
        t0 = time.monotonic()
        conn = http.client.HTTPConnection(host, int(port),
                                          timeout=timeout_s)
        try:
            if kind == "predict":
                body = {"inputs": {k: np.asarray(v).tolist()
                                   for k, v in input_fn(req).items()},
                        "deadline_ms": req["deadline_ms"]}
                headers = {"Content-Type": "application/json"}
                if req.get("tenant"):
                    headers["X-MXTPU-Tenant"] = str(req["tenant"])
                conn.request("POST", prefix + "/predict",
                             body=json.dumps(body).encode(),
                             headers=headers)
                resp = conn.getresponse()
                payload = json.loads(resp.read() or b"{}")
                lat = (time.monotonic() - t0) * 1e3
                if resp.status == 200:
                    return _outcome_record(req, "ok", lat)
                return _outcome_record(
                    req, payload.get("error", "UNTYPED:HTTP%d"
                                     % resp.status), lat)
            body = {"prompt": prompt_tokens(req, vocab=vocab,
                                            seed=seed).tolist(),
                    "max_new_tokens": req["max_new_tokens"],
                    "deadline_ms": req["deadline_ms"]}
            if req.get("session"):
                body["session"] = req["session"]
            headers = {"Content-Type": "application/json"}
            prio = req.get("priority") or req.get("class")
            if prio:
                headers["X-MXTPU-Priority"] = str(prio)
            if req.get("tenant"):
                headers["X-MXTPU-Tenant"] = str(req["tenant"])
            conn.request("POST", prefix + "/generate",
                         body=json.dumps(body).encode(),
                         headers=headers)
            resp = conn.getresponse()
            if resp.status != 200:
                return _outcome_record(
                    req, "UNTYPED:HTTP%d" % resp.status,
                    (time.monotonic() - t0) * 1e3)
            n_tok, ttft, outcome, migrated = 0, None, None, 0
            while True:
                raw = resp.readline()
                if not raw:
                    outcome = "UNTYPED:TruncatedStream"
                    break
                line = json.loads(raw)
                if "error" in line:
                    outcome = line["error"]
                    break
                if "done" in line:
                    outcome = "ok"
                    migrated = int(line.get("migrated", 0))
                    break
                if "token" in line:
                    if ttft is None:
                        ttft = (time.monotonic() - t0) * 1e3
                    n_tok += 1
            return _outcome_record(req, outcome,
                                   (time.monotonic() - t0) * 1e3,
                                   ttft_ms=ttft, tokens=n_tok,
                                   migrated=migrated)
        except OSError as e:
            return _outcome_record(req, "UNTYPED:%s" % type(e).__name__,
                                   (time.monotonic() - t0) * 1e3)
        finally:
            conn.close()

    return call


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------
def replay(trace, target, speed=1.0, max_inflight=None, name="loadreplay",
           clock=None):
    """Replay ``trace`` against ``target`` (a callable from one of the
    adapter factories: ``target(req) -> outcome record``).

    ``speed`` compresses time: 1.0 replays at wall clock, 10.0 plays a
    10-minute trace in one minute, ``float('inf')`` fires every request
    as fast as the inflight cap admits.  Each request runs on its own
    thread (bounded by ``max_inflight``) so slow outcomes never stall
    the arrival process — exactly like independent clients.

    An armed ``tenant_flood@n`` chaos hook fires at trace slot ``n``:
    the triggering request's tenant bursts ``factor``-fold at that
    instant (ghost duplicates appended after the trace's own records) —
    the noisy-neighbor injection the isolation proof replays against.

    Returns a :class:`ReplayReport`; ``records[i]`` is trace order."""
    from . import chaos as _chaos

    clk = _clockmod.resolve(clock)
    speed = float(speed)
    if speed <= 0:
        raise ValueError("speed must be > 0 (use float('inf') for asap)")
    cap = _DEF_MAX_INFLIGHT if max_inflight is None else int(max_inflight)
    sem = threading.BoundedSemaphore(cap)
    records = [None] * len(trace)
    threads = []
    t0 = clk.now()

    def run_one(slot, req):
        try:
            records[slot] = target(req)
        except Exception as e:   # noqa: BLE001 — adapters return, never
            # raise; a raise here is itself a contract violation worth a
            # loud UNTYPED record instead of a lost slot
            records[slot] = _outcome_record(
                req, "UNTYPED:%s" % type(e).__name__)
        finally:
            sem.release()

    for slot, req in enumerate(trace):
        if math.isfinite(speed):
            due = t0 + req["t"] / speed
            while True:
                dt = due - clk.now()
                if dt <= 0:
                    break
                clk.sleep(min(dt, 0.05))
        burst = [(slot, req)]
        factor = _chaos.tenant_flood(slot)
        if factor > 1:
            for _ in range(factor - 1):
                ghost = dict(req)
                ghost["i"] = len(records)
                ghost["session"] = None
                ghost["ghost"] = 1
                records.append(None)
                burst.append((ghost["i"], ghost))
        for gslot, greq in burst:
            sem.acquire()
            th = threading.Thread(target=run_one, args=(gslot, greq),
                                  name="loadgen-%d" % gslot, daemon=True)
            th.start()
            threads.append(th)
    for th in threads:
        th.join()
    return ReplayReport(records, wall_s=clk.now() - t0, speed=speed,
                        name=name)
