"""The port stands alone: no JAX, nothing of ``mxnet_tpu``, no silent CPU.

* An AST scan of every module of ``mxnet_tpu_torch/`` and of the scripts
  that run it on the card (``chip_smoke.py`` and its probes) finds no
  import of ``jax`` or ``mxnet_tpu``.
* A child process in which ``jax`` and ``mxnet_tpu`` cannot be imported
  imports the port and serves two tokens on the CPU; another quantizes a
  small symbolic convnet and runs it in int8; a third trains a small
  network with a user ``Custom`` op through ``Module.fit`` (``rtc``,
  ``operator``, ``module``, ``optimizer``, ``initializer``, ``metric``,
  ``lr_scheduler``, ``callback`` and ``random`` all loaded).
* Without a CUDA device, the entry points refuse to start unless the
  caller asks for the CPU (``device="cpu"``, or ``ctx=cpu()`` on the
  symbolic path).
"""
import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import subprocess_env

import mxnet_tpu_torch
from mxnet_tpu_torch import (GenerationConfig, GenerationEngine,
                             GenerationServer, TransformerConfig,
                             TransformerLM)

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")
TINY = dict(vocab_size=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_len=32, dtype="float32")


def _port_files():
    files = sorted((REPO / "mxnet_tpu_torch").rglob("*.py"))
    return files + [REPO / name for name in (
        "chip_smoke.py", "module_gate_probe.py", "int8_plan_probe.py",
        "rmsnorm_plan_probe.py")]


def _imported_roots(path):
    roots = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.append(str(node.args[0].value).split(".")[0])
    return roots


def test_ast_scan_finds_no_jax_or_mxnet_tpu_import():
    files = _port_files()
    assert len(files) >= 10                    # the scan saw the package
    bad = {str(p.relative_to(REPO)): r for p in files
           for r in _imported_roots(p) if r in FORBIDDEN}
    assert not bad, bad


_CHILD = r"""
import importlib.abc, json, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import numpy as np
import mxnet_tpu_torch as mt
cfg = mt.TransformerConfig(**json.loads(sys.argv[1]))
srv = mt.GenerationServer(mt.TransformerLM(cfg, device="cpu"),
                          mt.GenerationConfig(page_size=8, max_pages=8,
                                              max_slots=2),
                          device="cpu", warm=False)
out = srv.submit(np.array([3, 1, 4, 1, 5]), max_new_tokens=2, timeout=60)
srv.drain(timeout=10)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
print(json.dumps({"tokens": out, "loaded": loaded}))
"""


def test_serves_with_jax_unimportable():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(TINY)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=subprocess_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert len(res["tokens"]) == 2
    assert all(0 <= t < TINY["vocab_size"] for t in res["tokens"])


_CHILD_INT8 = r"""
import importlib.abc, json, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.contrib.quantization import quantize_model
cpu = mx.cpu()
net = mx.sym.Convolution(mx.sym.Variable("data"), kernel=(3, 3),
                         num_filter=4, name="conv")
net = mx.sym.Flatten(mx.sym.Activation(net, act_type="relu"))
net = mx.sym.FullyConnected(net, num_hidden=3, name="fc")
rng = np.random.RandomState(0)
x = rng.rand(4, 2, 6, 6).astype(np.float32)
ex = net.simple_bind(ctx=cpu, grad_req="null", data=x.shape)
args = {k: mx.nd.array(rng.randn(*v.shape) * 0.3, ctx=cpu)
        for k, v in ex.arg_dict.items() if k != "data"}
qsym, qargs, _ = quantize_model(
    net, args, {}, ctx=cpu, calib_mode="naive",
    calib_data=mx.io.NDArrayIter(x, np.zeros(4), 2), fuse_int8=True)
out = qsym.bind(ctx=cpu, args=dict(qargs, data=mx.nd.array(x, ctx=cpu))
                ).forward()[0].asnumpy()
ex.copy_params_from(args)
ref = ex.forward(data=x)[0].asnumpy()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
print(json.dumps({"shape": list(out.shape), "max_err": float(abs(out - ref).max()),
                  "scale": float(abs(ref).max()), "loaded": loaded}))
"""


def test_int8_path_runs_with_jax_unimportable():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_INT8], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=subprocess_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["shape"] == [4, 3]
    assert res["max_err"] <= 0.05 * res["scale"]


_CHILD_TRAIN = r"""
import importlib.abc, json, logging, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import numpy as np
import mxnet_tpu_torch as mx

class Square(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], in_data[0] * in_data[0])

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self.assign(in_grad[0], req[0], out_grad[0] * in_data[0] * 2.0)

@mx.operator.register("square")
class SquareProp(mx.operator.CustomOpProp):
    def create_operator(self, ctx, shapes, dtypes):
        return Square()

mx.random.seed(0)
rng = np.random.RandomState(0)
x = rng.randn(64, 8).astype(np.float32)
y = (x[:, 0] > 0).astype(np.float32)
net = mx.sym.Custom(mx.sym.FullyConnected(mx.sym.Variable("data"),
                                          num_hidden=8, name="fc1"),
                    op_type="square", name="sq")
net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(net, num_hidden=2,
                                                 name="fc2"), name="softmax")
it = mx.io.NDArrayIter(x, y, batch_size=16, shuffle=True)
mod = mx.mod.Module(net, context=mx.cpu())
mod.fit(it, num_epoch=3, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                          "lr_scheduler": mx.lr_scheduler.FactorScheduler(4)},
        initializer=mx.init.Xavier(),
        batch_end_callback=[mx.callback.Speedometer(16, 2),
                            mx.callback.log_train_metric(2)])
acc = dict(mod.score(it, mx.metric.Accuracy()))["accuracy"]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
mods = sorted(m for m in sys.modules if m.startswith("mxnet_tpu_torch."))
print(json.dumps({"acc": acc, "loaded": loaded, "modules": mods}))
"""


def test_trains_with_jax_unimportable():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_TRAIN], capture_output=True,
        text=True, timeout=120, cwd=REPO, env=subprocess_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    for name in ("rtc", "operator", "module.module", "optimizer.optimizer",
                 "initializer", "metric", "lr_scheduler", "callback",
                 "random"):
        assert "mxnet_tpu_torch." + name in res["modules"], name
    assert 0.0 <= res["acc"] <= 1.0


_CHILD_GLUON = r"""
import importlib.abc, json, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon.contrib import FusedTrainStep
from mxnet_tpu_torch.gluon.model_zoo import vision

cpu = mx.cpu()
rng = np.random.RandomState(0)
x = mx.nd.array(rng.rand(8, 3, 16, 16), ctx=cpu)
y = mx.nd.array(rng.randint(0, 4, 8), ctx=cpu)
losses = []
for fused in (False, True):
    net = vision.get_resnet(1, 18, classes=4, thumbnail=True)
    net.initialize(mx.init.Xavier(), ctx=cpu)
    net.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05, "momentum": 0.9})
    step = FusedTrainStep(net, loss_fn, tr)
    for _ in range(3):
        if fused:
            loss = step(x, y)
        else:
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(8)
        losses.append(float(loss.mean().asscalar()))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
mods = sorted(m for m in sys.modules if m.startswith("mxnet_tpu_torch."))
print(json.dumps({"losses": losses, "loaded": loaded, "modules": mods}))
"""


def test_gluon_trains_with_jax_unimportable():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_GLUON], capture_output=True,
        text=True, timeout=120, cwd=REPO, env=subprocess_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    for name in ("autograd", "gluon.block", "gluon.parameter",
                 "gluon.trainer", "gluon.loss", "gluon.nn.conv_layers",
                 "gluon.model_zoo.vision.resnet", "gluon.contrib.fused"):
        assert "mxnet_tpu_torch." + name in res["modules"], name
    assert all(np.isfinite(res["losses"]))


_CHILD_SERVING_PLANE = r"""
import importlib.abc, json, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import time
import numpy as np
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import (chaos, config, debug, dispatch, elastic,
                             leakcheck, loadgen, memory, profiler, telemetry,
                             tenancy)
from mxnet_tpu_torch.serving import StreamMigrated, brownout

leakcheck.install("raise")
cfg = mt.TransformerConfig(**json.loads(sys.argv[1]))
model = mt.TransformerLM(cfg, device="cpu")
gcfg = mt.GenerationConfig(page_size=8, max_pages=16, max_slots=2,
                           max_new_tokens=12)
a = mt.GenerationServer(model, gcfg, device="cpu", warm=False)
b = mt.GenerationServer(model, gcfg, device="cpu", warm=False)
p = np.array([3, 1, 4, 1, 5])
ref = a.submit(p, timeout=60)
fut = a.submit_async(p, on_token=lambda t: time.sleep(0.01))
while len(fut.stream_tokens) < 2:
    time.sleep(0.002)
[h] = a.park_streams(1)
try:
    fut.result(timeout=10)
except StreamMigrated:
    pass
got = fut.stream_tokens
h2 = b.import_stream(a.export_stream(h))
got += list(b.submit_async(p, resume_from=got, migrate_handle=h2).tokens(
    timeout=60))
trace = loadgen.generate_trace(loadgen.TraceSpec(
    seed=1, segments=[{"duration_s": 0.5, "rate_rps": 8.0}],
    prompt_len_mean=4, prompt_len_max=8, output_len_mean=2,
    output_len_max=4))
rep = loadgen.replay(trace, loadgen.generation_target(b), speed=4.0)
drained = a.drain(timeout=10) and b.drain(timeout=10)
leakcheck.assert_quiescent()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
print(json.dumps({"equal": got == ref, "outcomes": rep.outcome_counts(),
                  "drained": drained, "loaded": loaded,
                  "pages": a.engine.allocator.used + b.engine.allocator.used,
                  "tokens": profiler.dispatch_value("gen_tokens")}))
"""


def test_serving_plane_runs_with_jax_unimportable():
    """Migration, loadgen replay, telemetry, chaos, tenancy, memory, leak
    ledger and drain, with ``jax`` and ``mxnet_tpu`` unimportable."""
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_SERVING_PLANE,
         json.dumps(dict(TINY, max_len=64))],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=subprocess_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["equal"] and res["drained"] and res["pages"] == 0
    assert set(res["outcomes"]) <= {"ok", "Overloaded"}
    assert res["tokens"] > 0


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_entry_points_refuse_cpu_fallback(no_cuda, device):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mxnet_tpu_torch.resolve_device(device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(TransformerConfig(**TINY), device=device)
    model = TransformerLM(TransformerConfig(**TINY), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(model, GenerationConfig(max_pages=4),
                         device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationServer(model, GenerationConfig(max_pages=4),
                         device=device, warm=False)


def test_symbolic_entry_points_refuse_cpu_fallback(no_cuda):
    import numpy as np

    from mxnet_tpu_torch import cpu, current_context, gpu, nd, sym
    from mxnet_tpu_torch.contrib.quantization import quantize_model

    with pytest.raises(RuntimeError, match="no CUDA device"):
        nd.array([1.0, 2.0])                  # default context gpu(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nd.zeros((2,), ctx=gpu(0))
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=2, name="fc")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net.simple_bind(data=(1, 3))
    args = {"fc_weight": nd.zeros((2, 3), ctx=cpu()),
            "fc_bias": nd.zeros((2,), ctx=cpu())}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net.bind(args=dict(args, data=nd.zeros((1, 3), ctx=cpu())))
    calib = __import__("mxnet_tpu_torch").io.NDArrayIter(
        np.zeros((2, 3), np.float32), np.zeros(2), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize_model(net, args, {}, calib_mode="naive", calib_data=calib)
    assert net.simple_bind(ctx=cpu(), data=(1, 3)).forward()[0].shape == \
        (1, 2)
    with cpu():                    # a context scope sets the default
        assert current_context() == cpu()
        assert nd.array([1.0]).context == cpu()
    assert current_context() == gpu(0)
    # the training path: a Module binds on gpu(0) unless told otherwise
    from mxnet_tpu_torch import mod
    m = mod.Module(net, label_names=())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.bind(data_shapes=[("data", (1, 3))])


def test_serving_plane_refuses_cpu_fallback(no_cuda):
    """Without a card a server for the serving plane (migration peers,
    loadgen targets) refuses to start unless given ``device="cpu"``, and
    the memory view reports the host, not a card."""
    from mxnet_tpu_torch import memory

    model = TransformerLM(TransformerConfig(**TINY), device="cpu")
    for _ in range(2):                         # a migration's two peers
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GenerationServer(model, GenerationConfig(max_pages=4),
                             warm=False)
    assert list(memory.device_view()) == ["cpu"]


def test_default_device_is_cuda0_when_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mxnet_tpu_torch.default_device() == torch.device("cuda", 0)


def test_other_devices_rejected():
    with pytest.raises(ValueError):
        mxnet_tpu_torch.resolve_device("meta")


def test_gluon_entry_points_refuse_cpu_fallback(no_cuda):
    """Without a card the Gluon entry points refuse to start unless given
    ``ctx=cpu()`` (or a ``with cpu():`` scope)."""
    from mxnet_tpu_torch import autograd, cpu, gluon, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = gluon.nn.Dense(3, in_units=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net.initialize()                       # default context gpu(0)
    p = gluon.Parameter("p_weight", shape=(2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.initialize(ctx=__import__("mxnet_tpu_torch").gpu(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.resnet18_v1(classes=4, thumbnail=True).initialize()
    deferred = gluon.nn.BatchNorm()
    deferred.initialize()                      # deferred: nothing placed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deferred(nd.ones((2, 3), ctx=cpu()))
    net.initialize(ctx=cpu(), force_reinit=True)
    x = nd.ones((4, 2), ctx=cpu())
    with autograd.record():
        loss = net(x).sum()
    loss.backward()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    tr.step(4)
    assert net.weight.data().context == cpu()
    with cpu():
        d = gluon.nn.Dense(2, in_units=2)
        d.initialize()
        assert d.weight.list_ctx() == [cpu()]


def test_predict_and_model_server_refuse_cpu_fallback(no_cuda, tmp_path):
    """Without a card the predict API, the serving front and the loaders
    refuse to start unless given ``ctx=cpu()``."""
    from mxnet_tpu_torch import cpu, nd, predict, serving, sym

    net = sym.FullyConnected(sym.Variable("data"), num_hidden=2, name="fc")
    params = {"arg:fc_weight": nd.zeros((2, 3), ctx=cpu()),
              "arg:fc_bias": nd.zeros((2,), ctx=cpu())}
    shapes = {"data": (1, 3)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.Predictor(net, params, input_shapes=shapes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.ModelServer(net, params, input_shapes=shapes)
    path = str(tmp_path / "m.params")
    nd.save(path, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.MXPredCreate(net.tojson(), open(path, "rb").read(), 2, 0,
                             1, ["data"], [(1, 3)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nd.load(path)
    p = predict.Predictor(net, path, ctx=cpu(), input_shapes=shapes)
    assert p.forward(data=np.ones((1, 3), np.float32))[0].shape == (1, 2)
    srv = serving.ModelServer(predictors=[p], max_wait_ms=1)
    try:
        assert srv.submit({"data": np.ones((1, 3), np.float32)})[0].shape \
            == (1, 2)
    finally:
        assert srv.drain(timeout=30)


_CHILD_NUMERICAL = r"""
import importlib.abc, json, sys, tempfile, os

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import benchmark, chaos, gluon, monitor, sentinel
from mxnet_tpu_torch.gluon.contrib import FusedTrainStep
from mxnet_tpu_torch.predict import Predictor
from mxnet_tpu_torch.serving import ModelServer

cpu = mx.cpu()
rng = np.random.RandomState(0)
net = gluon.nn.HybridSequential()
net.add(gluon.nn.Dense(8, activation="relu"), gluon.nn.BatchNorm(),
        gluon.nn.Dense(4))
net.initialize(mx.init.Xavier(), ctx=cpu)
net.hybridize()
x = mx.nd.array(rng.rand(8, 6), ctx=cpu)
y = mx.nd.array(rng.randint(0, 4, 8), ctx=cpu)
tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr,
                      numeric_guard="skip")
with chaos.inject("nan_grad@1"):
    losses = [float(step(x, y).mean().asscalar()) for _ in range(3)]
step.check_health()
rate = benchmark.compiled_throughput(net, x, steps=2, draws=2)["median"]
d = tempfile.mkdtemp()
data = mx.sym.var("data")
sym = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
mx.nd.save(os.path.join(d, "m.params"),
           {"arg:fc_weight": mx.nd.array(rng.rand(3, 6), ctx=cpu),
            "arg:fc_bias": mx.nd.zeros((3,), ctx=cpu)}, format="mxnet")
pred = Predictor(sym.tojson(), os.path.join(d, "m.params"), ctx=cpu,
                 input_shapes={"data": (1, 6)})
srv = ModelServer(predictors=[pred], max_wait_ms=1)
out = srv.submit({"data": rng.rand(1, 6).astype(np.float32)})[0]
drained = srv.drain(timeout=30)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
mods = sorted(m for m in sys.modules if m.startswith("mxnet_tpu_torch."))
print(json.dumps({"losses": losses, "events": [list(e[:2]) for e in
                  step._sentinel.events], "rate": rate,
                  "out": list(out.shape), "drained": drained,
                  "loaded": loaded, "modules": mods}))
"""


def test_predict_serving_and_sentinel_run_with_jax_unimportable():
    """The predict API over a dmlc params file, the serving front, the
    throughput harness and a guarded fused step with a nan_grad fault,
    with ``jax`` and ``mxnet_tpu`` unimportable."""
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_NUMERICAL], capture_output=True,
        text=True, timeout=120, cwd=REPO, env=subprocess_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    for name in ("predict", "serving", "sentinel", "monitor", "benchmark",
                 "ndarray.utils", "ndarray.dmlc_serde",
                 "optimizer.loss_scaler"):
        assert "mxnet_tpu_torch." + name in res["modules"], name
    assert res["events"] == [[1, "skip"]]
    assert res["losses"][1] == res["losses"][2]       # the step was skipped
    assert res["rate"] > 0 and res["out"] == [1, 3] and res["drained"]
