"""Per-tenant admission: quotas, fair shares, brownout exemptions — the
counterpart of ``mxnet_tpu/tenancy.py``, with the same parsing, the same
buckets and the same verdicts.

A request's tenant (the ``X-MXTPU-Tenant`` wire header, or the
``tenant=`` argument of ``GenerationServer.submit_async``) is enforced
*inside* the QoS class at the same admission gates that apply brownout
and the queue cap:

* **token-bucket quota** — each tenant spends one token per admission
  from a bucket refilled at its configured ``rate`` requests/second up
  to ``burst``; an empty bucket sheds with typed
  :class:`~mxnet_tpu_torch.serving.QuotaExceeded` (never another
  tenant's ``Overloaded``).
* **weighted-fair queue share** — when the admission queue is
  contended (>= ``MXTPU_TENANT_FAIR_FRAC`` of capacity), a tenant may
  only hold its weight's share of the queue; the overflow sheds
  ``QuotaExceeded`` while lighter tenants keep admitting.
* **brownout exemption** — tenants marked ``exempt`` bypass the
  brownout ladder's qos_only shed and token cap; quota and fair-share
  still apply.

Quotas come from one spec string (``MXTPU_TENANT_QUOTAS``)::

    MXTPU_TENANT_QUOTAS="gold:rate=50,burst=100,weight=4,exempt;free:rate=5,burst=10"

Unlisted tenants get the ``MXTPU_TENANT_DEFAULT_*`` knobs (rate 0 =
unlimited).  Tenant ids are length-capped and charset-checked.  One lock
guards the bucket table; it is never held across anything blocking.
"""
from __future__ import annotations

import math
import os
import string
import threading

__all__ = ["parse_tenant", "parse_route", "TenantSpec", "TenantGovernor",
           "governor",
           "reset_governor"]

# env-tunable defaults (the JAX package's names)
_DEF_QUOTAS = os.environ.get("MXTPU_TENANT_QUOTAS", "")
_DEF_RATE = float(os.environ.get("MXTPU_TENANT_DEFAULT_RATE", "0"))
_DEF_BURST = float(os.environ.get("MXTPU_TENANT_DEFAULT_BURST", "0"))
_DEF_WEIGHT = float(os.environ.get("MXTPU_TENANT_DEFAULT_WEIGHT", "1"))
# queue fill fraction above which the weighted-fair share is enforced
_DEF_FAIR_FRAC = float(os.environ.get("MXTPU_TENANT_FAIR_FRAC", "0.5"))

# wire-name hardening: both tenant ids and route names are bounded,
# printable, and counter-safe (they feed `gen.admitted_by_tenant.<t>`
# style telemetry keys — a hostile header must not mint arbitrary keys)
_NAME_MAX = 64
_TENANT_CHARS = frozenset(string.ascii_letters + string.digits + "._-")
_ROUTE_CHARS = frozenset(string.ascii_letters + string.digits + "._-@")


def _checked_name(value, allowed, what):
    s = str(value).strip()
    if not s:
        raise ValueError("empty %s" % what)
    if len(s) > _NAME_MAX:
        raise ValueError("%s longer than %d chars" % (what, _NAME_MAX))
    if not set(s) <= allowed:
        bad = sorted(set(s) - allowed)[:4]
        raise ValueError("%s contains invalid character(s) %r" % (what, bad))
    return s


def parse_tenant(value):
    """Validate a tenant id from the ``X-MXTPU-Tenant`` header (or the
    body's ``tenant`` field).  ``None``/empty means the anonymous
    tenant.  Raises ``ValueError`` on a hostile value — oversized,
    non-printable, or outside ``[A-Za-z0-9._-]`` (non-UTF-8 header
    bytes arrive latin-1-decoded and fail the charset check) — which
    the HTTP front doors translate into a typed 400 ``BadTenant``,
    never a 500."""
    if value is None:
        return "anon"
    s = str(value).strip()
    if not s:
        return "anon"
    return _checked_name(s, _TENANT_CHARS, "tenant id")


def parse_route(value):
    """Validate a route name (``model@version`` style) from a
    ``/v1/<route>/...`` path.  Same hardening as :func:`parse_tenant`
    plus ``@``; raises ``ValueError`` on anything else."""
    if value is None:
        return "default"
    return _checked_name(value, _ROUTE_CHARS, "route name")


class TenantSpec:
    """One tenant's quota configuration."""

    __slots__ = ("name", "rate", "burst", "weight", "exempt")

    def __init__(self, name, rate=0.0, burst=0.0, weight=1.0,
                 exempt=False):
        self.name = str(name)
        self.rate = max(0.0, float(rate))
        # burst 0 with a finite rate defaults to 2 seconds of rate
        self.burst = float(burst) if float(burst) > 0 \
            else (2.0 * self.rate if self.rate > 0 else 0.0)
        self.weight = max(1e-9, float(weight))
        self.exempt = bool(exempt)

    def as_dict(self):
        return {"name": self.name, "rate": self.rate, "burst": self.burst,
                "weight": self.weight, "exempt": self.exempt}


def _parse_quota_spec(spec):
    """``"gold:rate=50,burst=100,weight=4,exempt;free:rate=5"`` ->
    ``{name: TenantSpec}``.  Raises ``ValueError`` on malformed items
    (config errors should fail loudly at startup, not at admission)."""
    out = {}
    for item in str(spec or "").split(";"):
        item = item.strip()
        if not item:
            continue
        name, _, opts = item.partition(":")
        name = parse_tenant(name)
        kw = {}
        for opt in opts.split(","):
            opt = opt.strip()
            if not opt:
                continue
            if opt == "exempt":
                kw["exempt"] = True
                continue
            k, eq, v = opt.partition("=")
            if not eq or k.strip() not in ("rate", "burst", "weight"):
                raise ValueError("MXTPU_TENANT_QUOTAS: bad option %r "
                                 "for tenant %r" % (opt, name))
            kw[k.strip()] = float(v)
        out[name] = TenantSpec(name, **kw)
    return out


class TenantGovernor:
    """Token buckets + weighted-fair shares over the configured specs.

    :meth:`check` is called at an admission gate with the current clock
    reading and (optionally) the admission queue's composition; it
    either returns the tenant's :class:`TenantSpec` or raises the typed
    :class:`~mxnet_tpu_torch.serving.QuotaExceeded`.  Buckets are keyed by
    tenant and refill lazily on access, so idle tenants cost nothing.
    """

    def __init__(self, quotas=None, default_rate=None, default_burst=None,
                 default_weight=None, fair_frac=None):
        if isinstance(quotas, str) or quotas is None:
            quotas = _parse_quota_spec(_DEF_QUOTAS if quotas is None
                                       else quotas)
        self.specs = dict(quotas)
        self.default_rate = _DEF_RATE if default_rate is None \
            else float(default_rate)
        self.default_burst = _DEF_BURST if default_burst is None \
            else float(default_burst)
        self.default_weight = _DEF_WEIGHT if default_weight is None \
            else float(default_weight)
        self.fair_frac = _DEF_FAIR_FRAC if fair_frac is None \
            else float(fair_frac)
        self._lock = threading.Lock()
        self._buckets = {}        # tenant -> [tokens, last_refill_ts]
        self.admitted = 0
        self.shed_quota = 0
        self.shed_share = 0

    def spec_for(self, tenant):
        spec = self.specs.get(tenant)
        if spec is None:
            spec = TenantSpec(tenant, rate=self.default_rate,
                              burst=self.default_burst,
                              weight=self.default_weight)
        return spec

    def exempt(self, tenant):
        """True when ``tenant`` bypasses brownout degradation (a paying
        tier) — quota and fair-share still apply."""
        spec = self.specs.get(tenant)
        return bool(spec is not None and spec.exempt)

    def fair_cap(self, spec, queue_cap, queue_tenants):
        """Max queue slots ``spec``'s tenant may hold under contention:
        its weight's share of capacity across the tenants currently in
        the queue (plus itself)."""
        total = spec.weight
        for other in queue_tenants:
            if other != spec.name:
                total += self.spec_for(other).weight
        share = spec.weight / total
        return max(1, int(math.ceil(queue_cap * share)))

    def check(self, tenant, now, queue_len=0, queue_cap=0,
              tenant_pending=0, queue_tenants=()):
        """Spend one admission for ``tenant`` at clock reading ``now``.

        Raises :class:`~mxnet_tpu_torch.serving.QuotaExceeded` when the
        tenant's token bucket is empty, or — with the queue contended
        (``queue_len >= fair_frac * queue_cap``) — when the tenant
        already holds its weighted-fair share of the queue
        (``tenant_pending`` of ``queue_cap`` slots, weights computed
        over ``queue_tenants``).  Returns the tenant's spec."""
        from .serving import QuotaExceeded

        spec = self.spec_for(tenant)
        # weighted-fair share first: it does not spend a token, so a
        # tenant parked at its share cap keeps its bucket for later
        if queue_cap > 0 and queue_len >= self.fair_frac * queue_cap:
            cap_n = self.fair_cap(spec, queue_cap, queue_tenants)
            # the cap binds only when it restricts below full capacity:
            # a sole tenant's share IS the whole queue, and shedding it
            # QuotaExceeded would mask the ordinary Overloaded signal
            if tenant_pending >= cap_n and cap_n < queue_cap:
                with self._lock:
                    self.shed_share += 1
                raise QuotaExceeded(
                    "tenant %r holds %d of its %d fair-share queue "
                    "slot(s) (weight %.3g, queue %d/%d)"
                    % (tenant, tenant_pending, cap_n, spec.weight,
                       queue_len, queue_cap))
        if spec.rate > 0:
            with self._lock:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = self._buckets[tenant] = [spec.burst, now]
                tokens, last = bucket
                tokens = min(spec.burst,
                             tokens + spec.rate * max(0.0, now - last))
                if tokens < 1.0:
                    bucket[0], bucket[1] = tokens, now
                    self.shed_quota += 1
                    raise QuotaExceeded(
                        "tenant %r over quota (%.3g of burst %.3g "
                        "token(s) left at %.3g req/s)"
                        % (tenant, tokens, spec.burst, spec.rate))
                bucket[0], bucket[1] = tokens - 1.0, now
        with self._lock:
            self.admitted += 1
        return spec

    def snapshot(self):
        with self._lock:
            buckets = {t: round(b[0], 3) for t, b in self._buckets.items()}
            return {"tenants": sorted(self.specs),
                    "admitted": self.admitted,
                    "shed_quota": self.shed_quota,
                    "shed_share": self.shed_share,
                    "buckets": buckets}


_GOVERNOR = None
_GOVERNOR_LOCK = threading.Lock()


def governor():
    """The process-global :class:`TenantGovernor` (env-configured) —
    shared by every admission gate in the process, exactly like
    :func:`mxnet_tpu_torch.serving.brownout`.  Tests :func:`reset_governor`
    it."""
    global _GOVERNOR
    with _GOVERNOR_LOCK:
        if _GOVERNOR is None:
            _GOVERNOR = TenantGovernor()
        return _GOVERNOR


def reset_governor(gov=None):
    """Replace (or re-derive from the env) the process-global governor;
    returns the new one."""
    global _GOVERNOR
    with _GOVERNOR_LOCK:
        _GOVERNOR = gov if gov is not None else TenantGovernor()
        return _GOVERNOR
