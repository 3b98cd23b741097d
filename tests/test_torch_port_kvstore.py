"""The port's KVStore (``mxnet_tpu_torch/kvstore.py``) and launcher
(``mxnet_tpu_torch/tools/launch.py``).

``dist_sync`` runs across 3 gloo rank processes on the CPU started by the
port's launcher, as tests/test_dist.py drives tests/dist_worker.py
(``torch_port_dist_worker.py``: each integer round equal to the sum bit
for bit, every rank holding the same bits of a non-integer sum).  The
single-process stores are held to the JAX package's on the same pushes:
exactly for sums, to 1e-6 for optimizer updates.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.tools import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()


def test_dist_sync_kvstore_through_the_ports_launcher(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "3",
         "--platform", "cpu", "--timeout", "120", "--", sys.executable,
         os.path.join(REPO, "tests", "torch_port_dist_worker.py"),
         str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=150,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, "launcher failed:\n%s\n%s" % (
        r.stdout[-3000:], r.stderr[-6000:])
    done = sorted(p.name for p in tmp_path.glob("worker_*.ok"))
    assert done == ["worker_0.ok", "worker_1.ok", "worker_2.ok"]
    sums = [np.load(tmp_path / ("sum_%d.npy" % i)) for i in range(3)]
    for s in sums[1:]:
        np.testing.assert_array_equal(s, sums[0])


def test_launch_cli_errors():
    with pytest.raises(NotImplementedError):
        launch.main(["-n", "2", "--launcher", "ssh", "--", "true"])
    with pytest.raises(SystemExit):
        launch.main(["-n", "2"])                      # no command
    with pytest.raises(ValueError, match="one rank drives one device"):
        launch.main(["-n", "2", "--local-devices", "2", "--", "true"])


def test_launch_kills_the_others_when_a_worker_fails():
    codes = launch.launch_local(
        2, [sys.executable, "-c",
            "import os, sys, time\n"
            "if os.environ['MXNET_TPU_WORKER_ID'] == '1': sys.exit(3)\n"
            "time.sleep(60)"], timeout=50)
    assert codes[1] == 3 and codes[0] != 0


def test_launch_timeout_kills_workers():
    codes = launch.launch_local(
        1, [sys.executable, "-c", "import time; time.sleep(60)"], timeout=1)
    assert codes == [-9]


def _stores(kind="local"):
    return jmx.kv.create(kind), tmx.kv.create(kind)


def _arrays(seed, shape=(3, 4), n=1):
    r = np.random.RandomState(seed)
    return [r.randn(*shape).astype(np.float32) for _ in range(n)]


def _pull(jkv, tkv, key, shape=(3, 4)):
    jo, to = jmx.nd.zeros(shape), tmx.nd.zeros(shape, ctx=CPU)
    jkv.pull(key, out=jo)
    tkv.pull(key, out=to)
    return jo.asnumpy(), to.asnumpy()


@pytest.mark.parametrize("kind", ["local", "device", "dist_sync",
                                  "dist_device_sync"])
@pytest.mark.parametrize("key", [3, "w"])
def test_push_pull_sums_like_jax(kind, key):
    """One rank: every type sums the pushed values (the dist types add
    the ranks' sums, here of one)."""
    jkv, tkv = _stores(kind)
    init, = _arrays(0)
    jkv.init(key, jmx.nd.array(init))
    tkv.init(key, tmx.nd.array(init, ctx=CPU))
    vals = _arrays(1, n=3)
    jkv.push(key, [jmx.nd.array(v) for v in vals])
    tkv.push(key, [tmx.nd.array(v, ctx=CPU) for v in vals])
    j, t = _pull(jkv, tkv, key)
    np.testing.assert_array_equal(t, j)
    assert tkv.rank == 0 and tkv.num_workers == 1 and tkv.type == kind


def test_list_keys_and_pushpull_like_jax():
    jkv, tkv = _stores()
    a, b = _arrays(2, n=2)
    jkv.init(["a", "b"], [jmx.nd.array(a), jmx.nd.array(b)])
    tkv.init(["a", "b"], [tmx.nd.array(a, ctx=CPU), tmx.nd.array(b, ctx=CPU)])
    c, d = _arrays(3, n=2)
    jo, to = jmx.nd.zeros((3, 4)), tmx.nd.zeros((3, 4), ctx=CPU)
    jkv.pushpull("a", jmx.nd.array(c), out=jo)
    tkv.pushpull("a", tmx.nd.array(c, ctx=CPU), out=to)
    np.testing.assert_array_equal(to.asnumpy(), jo.asnumpy())
    jkv.push(["a", "b"], [jmx.nd.array(d), jmx.nd.array(c)])
    tkv.push(["a", "b"], [tmx.nd.array(d, ctx=CPU), tmx.nd.array(c, ctx=CPU)])
    for k in "ab":
        j, t = _pull(jkv, tkv, k)
        np.testing.assert_array_equal(t, j)
    # a pulled array is a copy: later pushes do not change it
    before = to.asnumpy().copy()
    tkv.push("a", tmx.nd.array(c, ctx=CPU))
    np.testing.assert_array_equal(to.asnumpy(), before)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_optimizer_on_the_store_like_jax(momentum):
    jkv, tkv = _stores()
    w, = _arrays(4)
    jkv.init(0, jmx.nd.array(w))
    tkv.init(0, tmx.nd.array(w, ctx=CPU))
    jkv.set_optimizer(jmx.optimizer.SGD(learning_rate=0.1, momentum=momentum,
                                        rescale_grad=1.0))
    tkv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, momentum=momentum,
                                        rescale_grad=1.0))
    for seed in (5, 6, 7):
        g, = _arrays(seed)
        jkv.push(0, jmx.nd.array(g))
        tkv.push(0, tmx.nd.array(g, ctx=CPU))
        j, t = _pull(jkv, tkv, 0)
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_optimizer_states_save_and_load(tmp_path):
    """A store that loads another's saved momentum continues exactly as
    the other does.  (The JAX store cannot be the oracle here: its
    Updater keeps the loaded states as numpy arrays and its next update
    fails; ``Updater.set_states`` there does not sync them back.)"""
    w, g1, g2 = _arrays(8, n=3)
    a, b = tmx.kv.create(), tmx.kv.create()
    for kv in (a, b):
        kv.init(1, tmx.nd.array(w, ctx=CPU))
        kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        kv.push(1, tmx.nd.array(g1, ctx=CPU))
    b.push(1, tmx.nd.array(g2, ctx=CPU))              # b's momentum moves on
    fname = str(tmp_path / "a.states")
    a.save_optimizer_states(fname)
    b.load_optimizer_states(fname)                    # back to a's
    b.init(1, a._data[1])
    for kv in (a, b):
        kv.push(1, tmx.nd.array(g2, ctx=CPU))
    oa, ob = tmx.nd.zeros((3, 4), ctx=CPU), tmx.nd.zeros((3, 4), ctx=CPU)
    a.pull(1, out=oa)
    b.pull(1, out=ob)
    np.testing.assert_array_equal(ob.asnumpy(), oa.asnumpy())


def test_custom_updater_runs_on_the_store():
    jkv, tkv = _stores()
    seen = {"j": [], "t": []}
    jkv.set_updater(lambda k, g, w: seen["j"].append(k))
    tkv.set_updater(lambda k, g, w: seen["t"].append(k))
    a, = _arrays(9)
    for kv, nd, kw in ((jkv, jmx.nd, {}), (tkv, tmx.nd, {"ctx": CPU})):
        kv.init("x", nd.array(a, **kw))
        kv.init(4, nd.array(a, **kw))
        kv.push("x", nd.array(a, **kw))
        kv.push(4, nd.array(a, **kw))
    assert seen["t"] == seen["j"] == [0, 4]


@pytest.mark.parametrize("call", [
    lambda kv: kv.init_host_rows("e", (10, 4)),
    lambda kv: kv.row_sparse_pull("e", row_ids=[1]),
    lambda kv: kv.set_gradient_compression({"type": "2bit"}),
    lambda kv: kv.push("e", tmx.nd.zeros((1, 4), ctx=CPU), row_ids=[1]),
], ids=["init_host_rows", "row_sparse_pull", "compression", "push_rows"])
def test_unported_parts_raise_naming_the_roadmap(call):
    kv = tmx.kv.create("dist_sync")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        call(kv)


def test_create_refuses_like_jax():
    with pytest.raises(NotImplementedError, match="dist_async"):
        tmx.kv.create("dist_async")
    for bad, err in (("nope", ValueError), (3, TypeError)):
        with pytest.raises(err):
            tmx.kv.create(bad)
        with pytest.raises(err):
            jmx.kv.create(bad)
