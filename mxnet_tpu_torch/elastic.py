"""Graceful preemption drain: the SIGTERM/SIGINT half of
``mxnet_tpu/elastic.py``.

* :class:`PreemptionHandler` — converts SIGTERM/SIGINT (an eviction
  notice) into a flag (``requested``), with callbacks that run on the
  first signal (a server's drain flag); a second signal exits with
  :data:`PREEMPTED_EXIT_CODE`.
* :data:`NUMERIC_EXIT_CODE` — the retryable exit code of the
  numerical-health sentinel's last rung (:mod:`~mxnet_tpu_torch.sentinel`).
* :func:`install_preemption_drain` — wires a server's drain flag into the
  handler: the first signal closes admission, and the server completes
  what it admitted.  It sets a flag and nothing else; it never exits the
  process.

The training side (``PreemptionRequested``, the handler's checkpoint-and-
exit ``drain``), ``CheckpointManager``, ``Watchdog``, ``supervise`` and
``FaultInjector`` are not ported yet.
"""
from __future__ import annotations

import os
import signal
import sys
import threading

__all__ = ["PreemptionHandler", "install_preemption_drain",
           "PREEMPTED_EXIT_CODE", "NUMERIC_EXIT_CODE"]

PREEMPTED_EXIT_CODE = 76  # graceful drain: checkpointed, restart for free
NUMERIC_EXIT_CODE = 77    # sentinel escalation exhausted: params poisoned


def _log(msg):
    print("[mxnet_tpu_torch.elastic] %s" % msg, file=sys.stderr, flush=True)


class PreemptionHandler:
    """Graceful SIGTERM/SIGINT drain.

    The first signal only sets a flag (``requested``) and runs the
    registered callbacks; a second signal while draining exits
    immediately with :data:`PREEMPTED_EXIT_CODE` (the eviction deadline
    is near; better to lose the tail than be SIGKILLed).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 exit_code=PREEMPTED_EXIT_CODE):
        self._signals = tuple(signals)
        self.exit_code = exit_code
        self._requested = threading.Event()
        self._signal_count = 0
        self._prev = {}
        self._installed = False
        # registration happens during setup, before install() arms the
        # signal; Python delivers signals on the main thread, so the
        # iteration in _on_signal never overlaps add_callback
        self._callbacks = []

    def install(self):
        """Register the signal handlers (main thread only — CPython
        restriction).  Returns self for chaining."""
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        self._installed = True
        return self

    def uninstall(self):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self._installed = False

    def add_callback(self, fn):
        """Register ``fn`` to run from the signal handler on the FIRST
        drain signal (e.g. a server's ``_drain_flag.set`` so admission
        closes immediately, before the step boundary).  ``fn`` runs in
        signal-handler context: it must be async-signal safe — an atomic
        flag/Event set, never lock acquisition or I/O."""
        self._callbacks.append(fn)
        return self

    def _on_signal(self, signum, frame):
        self._signal_count += 1
        if self._signal_count > 1:
            os._exit(self.exit_code)  # impatient second signal
        self._requested.set()
        for fn in self._callbacks:
            try:
                fn()
            except Exception:
                pass  # a broken callback must not mask the drain
        _log("received signal %d: draining at the next step boundary"
             % signum)

    @property
    def requested(self):
        return self._requested.is_set()


def install_preemption_drain(drain_flag_set, handler=None):
    """Wire a server's drain flag into SIGTERM/SIGINT (the rc-76
    graceful-drain contract).

    The implementation behind ``GenerationServer.install_preemption_drain``:
    installs a fresh :class:`PreemptionHandler` when none is
    given (main thread only — CPython signal restriction) and registers
    ``drain_flag_set`` to run on the FIRST drain signal so admission
    closes immediately, before the step boundary.  ``drain_flag_set``
    runs in signal-handler context: it must be async-signal safe (an
    Event/flag set, never lock acquisition or I/O).  Returns the
    handler.
    """
    if handler is None:
        handler = PreemptionHandler().install()
    handler.add_callback(drain_flag_set)
    return handler
