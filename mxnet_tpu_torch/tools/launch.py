"""Launch a distributed job: the port of ``mxnet_tpu/tools/launch.py``.

Starts N identical worker processes on this host, wired to one
``torch.distributed`` TCP store that rank 0 hosts: every worker runs the
same command (single program, multiple data; no server or scheduler
roles).  Each gets ``MXNET_TPU_COORDINATOR`` / ``_NUM_WORKERS`` /
``_WORKER_ID`` (and ``_PLATFORM`` / ``_BACKEND`` when given), which
``import mxnet_tpu_torch`` reads (:func:`mxnet_tpu_torch._dist.init_from_env`),
so a script that imports the package becomes a rank unchanged.

Usage (the JAX package's CLI)::

    python -m mxnet_tpu_torch.tools.launch -n 4 [--launcher local] \\
        [--platform cpu|gpu] [--backend gloo|nccl] [--timeout S] \\
        -- python train.py ...

``--platform cpu`` runs the ranks on the CPU over gloo.  Without it each
rank drives ``cuda:<rank mod device count>`` over NCCL; ``--backend gloo``
lets several ranks share one card (NCCL refuses two ranks on one device).
``--local-devices`` above 1 is refused: one rank drives one device.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

__all__ = ["launch_local", "main"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local(num_workers, command, platform=None, local_devices=None,
                 env=None, port=None, backend=None, timeout=None):
    """Start ``num_workers`` local worker processes running ``command``
    and wait for them; returns their exit codes.  With ``timeout``
    (seconds) the workers still running then are killed and report -9; a
    worker that fails makes the others be killed too (a collective would
    wait for it forever)."""
    if local_devices is not None and int(local_devices) > 1:
        raise ValueError("--local-devices %s: one rank drives one device; "
                         "launch more ranks instead" % local_devices)
    port = port or _free_port()
    procs = []
    for i in range(num_workers):
        e = dict(os.environ)
        e.update(env or {})
        e["MXNET_TPU_COORDINATOR"] = "localhost:%d" % port
        e["MXNET_TPU_NUM_WORKERS"] = str(num_workers)
        e["MXNET_TPU_WORKER_ID"] = str(i)
        if platform:
            e["MXNET_TPU_PLATFORM"] = platform
        if backend:
            e["MXNET_TPU_BACKEND"] = backend
        procs.append(subprocess.Popen(list(command), env=e))
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or (deadline is not None
                          and time.monotonic() > deadline):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        codes = [p.wait() for p in procs]
    return codes


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mxnet_tpu_torch.tools.launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("--launcher", default="local",
                    choices=["local", "ssh", "mpi", "sge", "yarn"])
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="cpu: the ranks on the CPU over gloo")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="gloo lets several ranks share one card")
    ap.add_argument("--local-devices", type=int, default=None,
                    help="refused above 1 (one rank drives one device)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="kill the workers after this many seconds")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="worker command (prefix with --)")
    args = ap.parse_args(argv)
    if args.launcher != "local":
        raise NotImplementedError(
            "launcher %r: only the local launcher is provided (one host)"
            % args.launcher)
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        ap.error("no worker command given")
    codes = launch_local(args.num_workers, command, platform=args.platform,
                         local_devices=args.local_devices,
                         backend=args.backend, timeout=args.timeout)
    bad = [(i, c) for i, c in enumerate(codes) if c != 0]
    if bad:
        print("workers failed: %s" % bad, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
