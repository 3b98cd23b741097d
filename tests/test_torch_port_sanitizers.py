"""The port's runtime sanitizers against the JAX package's: the same
lock-order and lockset scenarios through ``mxnet_tpu.lockdep`` /
``mxnet_tpu.racecheck`` and ``mxnet_tpu_torch.lockdep`` /
``mxnet_tpu_torch.racecheck`` give the same counters, field states, race
reports and inversion reports.

Both packages are imported here, so each scenario installs one package's
sanitizer, runs, snapshots and uninstalls it (last in, first out) before
the other package's runs; every test ends with ``threading.Lock``,
``threading.RLock`` and ``time.sleep`` the stdlib's again.  Threads carry
explicit names, and every lock and access happens in this file's helpers,
so the witness strings (thread, caller site) are equal across packages;
creation sites of package locks are package-relative and compared by file.
"""
import contextlib
import gc
import subprocess
import sys
import threading
import time
import types

import pytest

from conftest import subprocess_env

import mxnet_tpu  # noqa: F401  (install_from_env runs at import)
import mxnet_tpu_torch  # noqa: F401
from mxnet_tpu import debug as jdebug
from mxnet_tpu import lockdep as jlockdep
from mxnet_tpu import racecheck as jracecheck
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu_torch import debug as tdebug
from mxnet_tpu_torch import lockdep as tlockdep
from mxnet_tpu_torch import racecheck as tracecheck
from mxnet_tpu_torch import telemetry as ttelemetry

_STD_LOCK = threading.Lock
_STD_RLOCK = threading.RLock
_STD_SLEEP = time.sleep

JAX = types.SimpleNamespace(name="jax", lockdep=jlockdep,
                            racecheck=jracecheck, telemetry=jtelemetry,
                            debug=jdebug)
PORT = types.SimpleNamespace(name="torch", lockdep=tlockdep,
                             racecheck=tracecheck, telemetry=ttelemetry,
                             debug=tdebug)


@pytest.fixture(autouse=True)
def _stdlib_factories_restored():
    assert not (jlockdep.installed() or tlockdep.installed()
                or jracecheck.installed() or tracecheck.installed()), \
        "a sanitizer was armed from the environment"
    yield
    assert threading.Lock is _STD_LOCK
    assert threading.RLock is _STD_RLOCK
    assert time.sleep is _STD_SLEEP


@contextlib.contextmanager
def armed(san, mode="record"):
    """Install one package's sanitizer for a scenario; uninstall and wipe
    on the way out.  The collector is off meanwhile: the JAX package's
    racecheck finalizer takes the detector lock, so a collection that
    lands inside its ``snapshot()`` would deadlock (the port's finalizer
    queues instead; see ``test_port_finalizer_takes_no_lock``)."""
    gc.collect()
    gc.disable()
    san.install(mode)
    san.reset()
    try:
        yield san
    finally:
        san.uninstall()
        san.reset()
        gc.enable()


def both(scenario):
    """``scenario(P)`` through the JAX package, then the port."""
    return scenario(JAX), scenario(PORT)


def run_threads(*targets):
    """Run ``(name, fn)`` pairs one after the other on named threads."""
    for name, fn in targets:
        t = threading.Thread(target=fn, name=name)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()


# ---------------------------------------------------------------------------
# lockdep
# ---------------------------------------------------------------------------
def _wrapped(P, site, kind="Lock"):
    real = threading._allocate_lock() if kind == "Lock" \
        else threading._RLock()
    return P.lockdep._LockWrapper(real, site, kind)


def _inverted_pair(a, b):
    def order_ab():
        with a:
            with b:
                pass

    def order_ba():
        with b:
            with a:
                pass

    run_threads(("order-ab", order_ab), ("order-ba", order_ba))


def _ld_inversion(P):
    with armed(P.lockdep):
        _inverted_pair(_wrapped(P, "store.py:10"),
                       _wrapped(P, "server.py:20"))
        return P.lockdep.snapshot()


def _ld_raise(P):
    with armed(P.lockdep, "raise"):
        a, b = _wrapped(P, "raise_a.py:1"), _wrapped(P, "raise_b.py:2")
        with a:
            with b:
                pass
        with pytest.raises(P.lockdep.LockOrderError,
                           match="lock-order") as err:
            with b:
                with a:
                    pass
        held = (a._inner.locked(), b._inner.locked())
        with a:                       # a clean held stack afterwards
            pass
        return {"snap": P.lockdep.snapshot(), "held": held,
                "msg": str(err.value)}


def _ld_same_site(P):
    with armed(P.lockdep):
        _inverted_pair(_wrapped(P, "cls.py:7"), _wrapped(P, "cls.py:7"))
        return P.lockdep.snapshot()


def _ld_blocking(P):
    with armed(P.lockdep, "raise"):
        lk = _wrapped(P, "transport.py:5")
        with lk:
            time.sleep(0.001)         # instrumented while installed
            P.lockdep.note_blocking("recv_msg")
        time.sleep(0.001)             # nothing held: no event
        P.lockdep.note_blocking("idle")
        snap = P.lockdep.snapshot()
    for e in snap["held_across_blocking"]:
        e["thread"] = "-"
    return snap


def _ld_condition_rlock(P):
    with armed(P.lockdep):
        cv = threading.Condition(_wrapped(P, "cv.py:3", kind="RLock"))
        hits = []

        def waiter():
            with cv:
                cv.wait(timeout=5)
                hits.append(1)

        t = threading.Thread(target=waiter, name="waiter")
        t.start()
        time.sleep(0.05)
        with cv:
            cv.notify_all()
        t.join(timeout=10)
        r = _wrapped(P, "reent.py:4", kind="RLock")
        with r:
            with r:
                pass
        snap = P.lockdep.snapshot()
        snap["counters"].pop("acquires")   # waits re-acquire by timing
        return {"hits": hits, "snap": snap}


def _ld_gauges_and_bundle(P, tmp_path):
    with armed(P.lockdep):
        _inverted_pair(_wrapped(P, "gauge_a.py:1"),
                       _wrapped(P, "gauge_b.py:2"))
        path = P.debug.write_bundle("lockdep_parity_%s" % P.name,
                                    force=True)
        gauges = P.telemetry.registry().snapshot()["gauges"]
        import json

        section = json.loads(open(path).read())["sections"]["lockdep"]
        # the bundle writer's own package locks are each package's own
        for k in ("acquires", "locks_created"):
            section["counters"].pop(k)
        return {"inversions": gauges["lockdep.inversions"],
                "edges": gauges["lockdep.edges"],
                "section": section}


@pytest.mark.parametrize("scenario", [_ld_inversion, _ld_raise,
                                      _ld_same_site, _ld_blocking,
                                      _ld_condition_rlock],
                         ids=lambda f: f.__name__)
def test_lockdep_scenarios_report_alike(scenario):
    jax_out, port_out = both(scenario)
    assert port_out == jax_out


def test_lockdep_reports_are_the_expected_ones():
    """The equal reports are the right ones (parity is not vacuous)."""
    inv = _ld_inversion(PORT)
    assert inv["counters"]["inversions"] == 1
    assert inv["counters"]["edges"] == 1
    (rep,) = inv["inversions"]
    assert {rep["a"], rep["b"]} == {"store.py:10", "server.py:20"}
    assert "order-ba" in rep["path_ab"] and "order-ab" in rep["path_ba"]
    raised = _ld_raise(PORT)
    assert raised["held"] == (False, False)
    assert "raise_a.py:1" in raised["msg"] and "raise_b.py:2" in raised["msg"]
    assert _ld_same_site(PORT)["counters"]["edges"] == 0
    blk = _ld_blocking(PORT)
    assert blk["counters"]["held_across_blocking"] == 2
    assert [e["kind"] for e in blk["held_across_blocking"]][1] == "recv_msg"
    assert all(e["held"] == ["transport.py:5"]
               for e in blk["held_across_blocking"])
    assert "test_torch_port_sanitizers.py" in \
        blk["held_across_blocking"][1]["at"]
    cond = _ld_condition_rlock(PORT)
    assert cond["hits"] == [1] and cond["snap"]["counters"]["edges"] == 0


def test_lockdep_gauges_and_bundle_section_alike(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_DEBUG_BUNDLE_DIR", str(tmp_path))
    jax_out, port_out = both(lambda P: _ld_gauges_and_bundle(P, tmp_path))
    assert port_out == jax_out
    assert port_out["inversions"] == 1.0
    assert port_out["section"]["mode"] == "record"


def _package_lock(P):
    """A lock created by code of package ``P`` (a StormDetector's)."""
    return P.debug.StormDetector(3)._lock


def test_lockdep_scope_is_its_own_package():
    """Each package's lockdep wraps the locks its own package creates,
    with a package-relative site, and leaves the other package's (and
    foreign code's) locks alone: ``_PKG_DIR + os.sep`` keeps
    ``mxnet_tpu/`` and ``mxnet_tpu_torch/`` apart."""
    def scope(P, other):
        with armed(P.lockdep):
            own, theirs = _package_lock(P), _package_lock(other)
            foreign = threading.Lock()
            return (type(own).__name__, own._site.split(":")[0],
                    type(theirs).__name__, type(foreign).__name__)

    jax_out, port_out = scope(JAX, PORT), scope(PORT, JAX)
    assert port_out == jax_out
    assert port_out[0] == "_LockWrapper" and port_out[1] == "debug.py"
    assert port_out[2] != "_LockWrapper" and port_out[3] != "_LockWrapper"


def test_lockdep_uninstall_restores_factories():
    def lifecycle(P):
        P.lockdep.install("record")
        swapped = (threading.Lock is not _STD_LOCK,
                   time.sleep is not _STD_SLEEP)
        P.lockdep.uninstall()
        lk = _wrapped(P, "stale.py:1")    # handed-out wrappers delegate
        with lk:
            pass
        restored = (threading.Lock is _STD_LOCK,
                    threading.RLock is _STD_RLOCK,
                    time.sleep is _STD_SLEEP)
        acquires = P.lockdep.snapshot()["counters"]["acquires"]
        P.lockdep.reset()
        return swapped, restored, acquires

    jax_out, port_out = both(lifecycle)
    assert port_out == jax_out == ((True, True), (True, True, True), 0)


# ---------------------------------------------------------------------------
# racecheck
# ---------------------------------------------------------------------------
def _token(P, site, kind="Lock"):
    real = threading._allocate_lock() if kind == "Lock" \
        else threading._RLock()
    return P.racecheck._LockToken(real, site, kind)


def _boxcls(P):
    @P.racecheck.track("ctr")
    class Box:
        def __init__(self):
            self.ctr = 0

    return Box


def _rc_unguarded(P):
    with armed(P.racecheck):
        box = _boxcls(P)()
        run_threads(("writer", lambda: setattr(box, "ctr", 1)))
        box.ctr = 2                   # a second post-init writer
        return P.racecheck.snapshot()


def _rc_disciplined(P):
    with armed(P.racecheck):
        lk = _token(P, "box.py:1")
        box = _boxcls(P)()

        def bump():
            with lk:
                box.ctr += 1

        run_threads(("bumper", bump))
        with lk:
            box.ctr += 1
        assert box.ctr == 2           # a bare read after join: silent
        return P.racecheck.snapshot()


def _rc_wrong_instance(P):
    with armed(P.racecheck):
        a_lk, b_lk = _token(P, "box.py:1"), _token(P, "box.py:1")
        box = _boxcls(P)()

        def bump():
            with a_lk:
                box.ctr += 1

        run_threads(("holder-a", bump))
        with b_lk:
            box.ctr += 1
        return P.racecheck.snapshot()


def _rc_handoff(P):
    with armed(P.racecheck):
        box = _boxcls(P)()
        box.ctr = 1

        def own():
            for _ in range(50):
                box.ctr += 1

        run_threads(("owner", own))
        return P.racecheck.snapshot()


def _rc_read_sharing(P):
    with armed(P.racecheck):
        box = _boxcls(P)()
        run_threads(("reader", lambda: box.ctr))
        return P.racecheck.snapshot()


def _rc_raise_once(P):
    with armed(P.racecheck, "raise"):
        box = _boxcls(P)()
        run_threads(("w", lambda: setattr(box, "ctr", 1)))
        with pytest.raises(P.racecheck.RaceError,
                           match="unsynchronized writes") as err:
            box.ctr = 2
        box.ctr = 3                   # reported once per field
        return {"snap": P.racecheck.snapshot(), "msg": str(err.value)}


def _rc_condition(P):
    with armed(P.racecheck):
        @P.racecheck.track("items")
        class Q:
            def __init__(self):
                self.items = 0

        cv = threading.Condition(_token(P, "q.py:1", kind="RLock"))
        q = Q()
        done = []

        def producer():
            with cv:
                q.items += 1
                cv.notify_all()

        def consumer():
            with cv:
                while q.items == 0:
                    cv.wait(timeout=5)
                q.items -= 1
                done.append(1)

        t1 = threading.Thread(target=consumer, name="consumer")
        t2 = threading.Thread(target=producer, name="producer")
        t1.start()
        time.sleep(0.05)
        t2.start()
        t1.join(timeout=10)
        t2.join(timeout=10)
        snap = P.racecheck.snapshot()
        snap["counters"].pop("accesses")      # the wait loop's reads
        snap["counters"].pop("refinements")   # depend on timing
        return {"done": done, "snap": snap}


@pytest.mark.parametrize("scenario", [_rc_unguarded, _rc_disciplined,
                                      _rc_wrong_instance, _rc_handoff,
                                      _rc_read_sharing, _rc_raise_once,
                                      _rc_condition],
                         ids=lambda f: f.__name__)
def test_racecheck_scenarios_report_alike(scenario):
    jax_out, port_out = both(scenario)
    assert port_out == jax_out


def test_racecheck_reports_are_the_expected_ones():
    snap = _rc_unguarded(PORT)
    assert snap["counters"]["races"] == 1
    (race,) = snap["races"]
    assert (race["cls"], race["field"]) == ("Box", "ctr")
    assert race["access"]["thread"] == "MainThread"
    assert race["prior"]["thread"] == "writer"
    assert race["access"]["held"] == race["prior"]["held"] == "no locks"
    assert "test_torch_port_sanitizers.py" in race["access"]["at"]
    assert _rc_disciplined(PORT)["counters"]["races"] == 0
    wrong = _rc_wrong_instance(PORT)
    assert wrong["counters"]["races"] == 1
    assert "box.py:1" in wrong["races"][0]["prior"]["held"]
    assert _rc_handoff(PORT)["field_states"] == {"shared-modified": 1}
    assert _rc_read_sharing(PORT)["field_states"] == {"shared": 1}
    assert _rc_raise_once(PORT)["snap"]["counters"]["races"] == 1
    cond = _rc_condition(PORT)
    assert cond["done"] == [1] and cond["snap"]["counters"]["races"] == 0


def test_collected_instance_states_are_dropped_alike():
    def scenario(P):
        with armed(P.racecheck):
            box = _boxcls(P)()
            run_threads(("writer", lambda: setattr(box, "ctr", 1)))
            before = P.racecheck.snapshot()["field_states"]
            del box
            gc.collect()
            return before, P.racecheck.snapshot()["field_states"]

    jax_out, port_out = both(scenario)
    assert port_out == jax_out == ({"shared-modified": 1}, {})


def test_port_finalizer_takes_no_lock():
    """A collection can run a finalizer on a thread that holds the
    detector lock (inside ``snapshot()``): the port's only queues."""
    with tracecheck._state_lock:
        tracecheck._forget(12345, ("ctr",))     # returns: no self-deadlock
    with armed(tracecheck):
        box = _boxcls(PORT)()
        run_threads(("writer", lambda: setattr(box, "ctr", 1)))
        key = (id(box), "ctr")
        with tracecheck._state_lock:
            assert key in tracecheck._field_states
            tracecheck._forget(id(box), ("ctr",))
        assert tracecheck.snapshot()["field_states"] == {}
        del box


def test_racecheck_gauges_and_bundle_section_alike(tmp_path, monkeypatch):
    import json

    monkeypatch.setenv("MXTPU_DEBUG_BUNDLE_DIR", str(tmp_path))

    def scenario(P):
        with armed(P.racecheck):
            box = _boxcls(P)()
            run_threads(("writer", lambda: setattr(box, "ctr", 1)))
            box.ctr = 2
            path = P.debug.write_bundle("racecheck_parity_%s" % P.name,
                                        force=True)
            gauges = P.telemetry.registry().snapshot()["gauges"]
            return {"races": gauges["racecheck.races"],
                    "fields": gauges["racecheck.fields_tracked"],
                    "section": json.loads(open(path).read())[
                        "sections"]["racecheck"]}

    jax_out, port_out = both(scenario)
    assert port_out == jax_out
    assert port_out["races"] == 1.0 and port_out["fields"] == 1.0


def test_racecheck_tracks_the_same_fleet_fields():
    """The gateway's and the fleet worker's lock-disciplined counters are
    declared alike in both packages."""
    from mxnet_tpu import fleet_worker as jfw
    from mxnet_tpu import gateway as jgw
    from mxnet_tpu_torch import fleet_worker as tfw
    from mxnet_tpu_torch import gateway as tgw

    def fields(rc, cls):
        return sorted(f for c, fs in rc._registry if c is cls for f in fs)

    assert fields(tracecheck, tgw.Gateway) == \
        fields(jracecheck, jgw.Gateway) != []
    assert fields(tracecheck, tfw.FleetWorker) == \
        fields(jracecheck, jfw.FleetWorker) != []


def test_racecheck_uninstall_restores_factories_and_hooks():
    def lifecycle(P):
        Box = _boxcls(P)
        P.racecheck.install("record")
        hooked = "__getattribute__" in vars(Box)
        P.racecheck.uninstall()
        P.racecheck.reset()
        box = Box()
        box.ctr += 1                  # de-instrumented: nothing counted
        return (hooked, threading.Lock is _STD_LOCK,
                P.racecheck.snapshot()["counters"]["accesses"])

    jax_out, port_out = both(lifecycle)
    assert port_out == jax_out == (True, True, 0)


def test_both_sanitizers_stack_and_unwind_lifo():
    """lockdep then racecheck, as package import arms them: a package lock
    is a racecheck token over a lockdep wrapper, and unwinding in reverse
    order gives back the stdlib factories."""
    def stacked(P):
        P.lockdep.install("record")
        P.racecheck.install("record")
        try:
            lk = _package_lock(P)
            inner = type(lk._inner).__name__
            outer = type(lk).__name__
        finally:
            P.racecheck.uninstall()
            P.lockdep.uninstall()
            P.racecheck.reset()
            P.lockdep.reset()
        return outer, inner, threading.Lock is _STD_LOCK

    jax_out, port_out = both(stacked)
    assert port_out == jax_out == ("_LockToken", "_LockWrapper", True)


def test_off_mode_leaves_factories_untouched():
    Box = _boxcls(PORT)
    assert "__getattribute__" not in vars(Box)
    assert threading.Lock is tlockdep._real_Lock is tracecheck._real_Lock
    assert time.sleep is tlockdep._real_sleep


def test_env_arms_both_at_port_import():
    """``MXTPU_LOCKDEP`` / ``MXTPU_RACECHECK`` arm at ``import
    mxnet_tpu_torch``, before its first lock and its first tracked class:
    the kernel counters' module lock comes out as a token over a wrapper,
    the gateway is instrumented, a foreign lock is not wrapped."""
    code = (
        "import threading\n"
        "import mxnet_tpu_torch\n"
        "from mxnet_tpu_torch import lockdep, racecheck\n"
        "from mxnet_tpu_torch.gateway import Gateway\n"
        "from mxnet_tpu_torch.ops.kernels import common\n"
        "assert lockdep.mode() == 'record' and racecheck.mode() == 'raise'\n"
        "lk = common._COUNTS_LOCK\n"
        "assert type(lk).__name__ == '_LockToken', type(lk)\n"
        "assert type(lk._inner).__name__ == '_LockWrapper'\n"
        "assert lk._site.startswith('ops/kernels/common.py:'), lk._site\n"
        "assert '__setattr__' in vars(Gateway)\n"
        "assert type(threading.Lock()).__name__ not in ('_LockToken',\n"
        "                                               '_LockWrapper')\n"
        "import sys\n"
        "assert not any(m.split('.')[0] in ('jax', 'mxnet_tpu')\n"
        "               for m in sys.modules)\n"
        "print('ARMED_OK')\n")
    res = subprocess.run(
        [sys.executable, "-c", code],
        env=subprocess_env(MXTPU_LOCKDEP="record", MXTPU_RACECHECK="raise"),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ARMED_OK" in res.stdout
