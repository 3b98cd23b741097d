"""CPU builders and helpers of the port's fleet-plane tests
(``tests/test_torch_port_{fleet,gateway}.py``).

The port's entry points default to the card, so a worker process spawned
by a CPU test is given a builder that asks for the CPU::

    python -m mxnet_tpu_torch.fleet_worker --builder torch_port_fleet_util:cpu_model

with this directory and the repository on ``PYTHONPATH``
(:func:`worker_env`).  This module imports nothing of the JAX package: a
worker process loads it.
"""
import http.client
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def cpu_model():
    """The demo FC ModelServer on the CPU."""
    from mxnet_tpu_torch.fleet_worker import demo_model

    torch.set_num_threads(1)
    return demo_model(device="cpu")


def cpu_generation():
    """The demo generation server on the CPU."""
    from mxnet_tpu_torch.fleet_worker import demo_generation

    torch.set_num_threads(1)
    return demo_generation(device="cpu")


def worker_env(**extra):
    """Env of a spawned port worker: the repository and this directory on
    ``PYTHONPATH``, one intra-op thread."""
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + HERE,
           "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


def worker_argv(registry_addr, rid, service, builder):
    return [sys.executable, "-m", "mxnet_tpu_torch.fleet_worker",
            "--registry", registry_addr, "--service", service,
            "--rid", rid, "--heartbeat-s", "0.1",
            "--builder", "torch_port_fleet_util:" + builder]


def post(addr, path, obj, timeout=60):
    """POST JSON to host:port: (status, parsed body, headers)."""
    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(obj).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, json.loads(data or b"{}"), dict(resp.headers)
    finally:
        conn.close()


def get(addr, path, timeout=30):
    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def stream(addr, path, obj, timeout=60):
    """POST and read the NDJSON body up to its terminal line."""
    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    lines = []
    try:
        conn.request("POST", path, body=json.dumps(obj).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        while True:
            raw = resp.readline()
            if not raw:
                break
            lines.append(json.loads(raw))
            if "done" in lines[-1] or "error" in lines[-1]:
                break
        return lines
    finally:
        conn.close()


def wait(cond, timeout=30.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise TimeoutError("timed out waiting for %s" % msg)
