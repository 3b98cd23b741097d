"""Live KV migration of the port's GenerationServer, against the JAX
package's and across the two packages.

* the ``MXKV`` wire blob: the same header and blocks pack to the same
  bytes in both packages, in f32 and bf16, and each unpacks the other's;
  the port unpacks bf16 with ``ml_dtypes`` unimportable;
* a stream parked on a JAX server continues on a port server, and the
  other way round, equal to the unparked JAX stream — greedy and
  seeded-sampled (the sampler state travels in the blob);
* ``resume_from`` on the port equals the JAX stream's suffix;
* the TTL sweep, ``release_import``, the corrupt-blob fallback and
  ``defrag`` on the port;
* the cases of tests/test_migration.py that need no gateway or fleet,
  under their names, on the port.

Streams are compared exactly: at f32 the packages' logits agree within
1e-5, far inside the gaps between the top logits of these prompts.
"""
import json
import struct
import sys
import threading

import numpy as np
import pytest
import torch

import ml_dtypes

from mxnet_tpu import generation as jgen
from mxnet_tpu import profiler as jprof
from mxnet_tpu.serving import StreamMigrated as JStreamMigrated
from mxnet_tpu_torch import GenerationServer, leakcheck
from mxnet_tpu_torch import chaos
from mxnet_tpu_torch import generation as pgen
from mxnet_tpu_torch import profiler as pprof
from mxnet_tpu_torch.generation import (KV_BLOB_MAGIC, KV_BLOB_VERSION,
                                        pack_kv_blob, unpack_kv_blob)
from mxnet_tpu_torch.serving import StreamMigrated

from torch_port_serving_util import (gcfg, jax_model, port_model, prompts,
                                     wait)


def _mcfg(jax_side=False, **kw):
    # long streams: a 48-token budget keeps a stream alive while the test
    # parks it mid-decode
    kw.setdefault("max_pages", 64)
    kw.setdefault("max_new_tokens", 48)
    return gcfg(jax_side=jax_side, **kw)


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server A, port server B) over the same weights;
    A and B share one port model (two KV pools)."""
    jm, params = jax_model()
    j = jgen.GenerationServer(jm, params, _mcfg(jax_side=True))
    model = port_model()
    a = GenerationServer(model, _mcfg(), device="cpu")
    b = GenerationServer(model, _mcfg(), device="cpu")
    yield j, a, b
    for s in (j, a, b):
        s.drain(timeout=10)
    for s in (a, b):
        assert s.engine.allocator.used == 0


class _Hold:
    """on_token callback that holds the scheduler thread once the stream
    has streamed ``n`` tokens, until :meth:`release`: the test parks the
    stream while it is held, so the park never races the stream's end."""

    def __init__(self, n):
        self.n, self.seen = n, 0
        self.reached, self._go = threading.Event(), threading.Event()

    def __call__(self, t):
        self.seen += 1
        if self.seen == self.n:
            self.reached.set()
            self._go.wait(30)

    def release(self):
        self._go.set()


def _park_handle(src, prompt, n_before, err=StreamMigrated, **samp):
    """Park ``prompt``'s stream on ``src`` after ``n_before`` tokens;
    returns (delivered tokens, handle)."""
    hold = _Hold(n_before)
    fut = src.submit_async(prompt, on_token=hold, **samp)
    try:
        assert hold.reached.wait(30), "%d token(s) before park" % n_before
        handles = src.park_streams(1)
    finally:
        hold.release()
    assert len(handles) == 1
    with pytest.raises(err) as ei:
        fut.result(timeout=10)
    assert ei.value.handle == handles[0]
    return fut.stream_tokens, handles[0]


def _park(src, prompt, n_before, err=StreamMigrated, **samp):
    delivered, h = _park_handle(src, prompt, n_before, err=err, **samp)
    return delivered, src.export_stream(h)


def _attach(dst, prof, prompt, delivered, blob, **samp):
    p0 = prof.dispatch_value("gen_prefills")
    h = dst.import_stream(blob)
    fut = dst.submit_async(prompt, resume_from=delivered, migrate_handle=h,
                           **samp)
    cont = list(fut.tokens(timeout=60))
    assert prof.dispatch_value("gen_prefills") == p0   # no prefill at all
    return cont


# ---------------------------------------------------------------------------
# the MXKV wire blob, byte for byte across the packages
# ---------------------------------------------------------------------------
def _header():
    rng = np.random.default_rng(5)
    rng.random(3)
    return {"length": 12, "last_token": 4, "n_pages": 2, "page_size": 8,
            "rng_state": rng.bit_generator.state, "gen_tokens": [5, 6, 7],
            "prompt": [1, 2, 3], "temperature": 0.5}


def _blocks(dtype):
    rng = np.random.RandomState(0)
    k = rng.randn(2, 2, 8, 4, 16).astype(np.float32)
    v = rng.randn(2, 2, 8, 4, 16).astype(np.float32)
    if dtype == "bfloat16":
        k, v = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
    return k, v


def _torch_block(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blob_bytes_identical_to_jax(dtype):
    header, (k, v) = _header(), _blocks(dtype)
    want = jgen.pack_kv_blob(header, k, v)
    assert pack_kv_blob(header, k, v) == want              # numpy blocks
    assert pack_kv_blob(header, _torch_block(k), _torch_block(v)) == want
    h, k2, v2 = unpack_kv_blob(want)
    assert h == jgen.unpack_kv_blob(want)[0]
    assert h["kv_dtype"] == dtype
    assert k2.tobytes() == k.tobytes() and v2.tobytes() == v.tobytes()
    # the JAX package reads the port's blob
    _, jk, jv = jgen.unpack_kv_blob(pack_kv_blob(header, _torch_block(k),
                                                 _torch_block(v)))
    assert jk.dtype == k.dtype and np.array_equal(
        jk.view(np.uint8), k.view(np.uint8))


def test_bf16_unpacks_without_ml_dtypes(monkeypatch):
    """numpy alone has no bfloat16: with ``ml_dtypes`` unimportable the
    port reads a bf16 blob as its raw 2-byte words, and the tensors it
    installs are the packed ones bit for bit."""
    header, (k, v) = _header(), _blocks("bfloat16")
    blob = jgen.pack_kv_blob(header, k, v)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes as _md  # noqa: F401
    h, k2, v2 = unpack_kv_blob(blob)
    assert h["kv_dtype"] == "bfloat16" and k2.dtype == np.uint16
    kt = pgen._block_tensor(k2, torch.bfloat16, "cpu")
    assert kt.dtype == torch.bfloat16
    assert torch.equal(kt.view(torch.int16), _torch_block(k).view(
        torch.int16))
    # and the port packs the same bytes again
    assert pack_kv_blob(h, kt, pgen._block_tensor(v2, torch.bfloat16,
                                                  "cpu")) == blob


def test_bf16_server_migrates_without_ml_dtypes(monkeypatch):
    """A bf16 stream parked on one port server continues on another with
    ``ml_dtypes`` unimportable, bit for bit."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    from mxnet_tpu_torch import TransformerConfig, TransformerLM
    from torch_port_serving_util import cfg_kw

    model = TransformerLM(TransformerConfig(**cfg_kw(dtype="bfloat16")),
                          device="cpu")
    a = GenerationServer(model, _mcfg(), device="cpu")
    b = GenerationServer(model, _mcfg(), device="cpu")
    try:
        p = prompts([8], seed=4)[0]
        ref = a.submit(p, temperature=0.0, timeout=60)
        delivered, blob = _park(a, p, 3, temperature=0.0)
        assert unpack_kv_blob(blob)[0]["kv_dtype"] == "bfloat16"
        cont = _attach(b, pprof, p, delivered, blob, temperature=0.0)
        assert delivered + cont == ref
    finally:
        a.drain(timeout=10)
        b.drain(timeout=10)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
SAMPLING = {"greedy": dict(temperature=0.0),
            "sampled": dict(temperature=0.9, top_k=12, seed=123)}


@pytest.mark.parametrize("mode", sorted(SAMPLING))
def test_park_on_jax_attach_on_port(servers, mode):
    j, a, _ = servers
    samp = SAMPLING[mode]
    p = prompts([8], seed=21)[0]
    ref = j.submit(p, timeout=60, **samp)
    delivered, blob = _park(j, p, 3, err=JStreamMigrated, **samp)
    cont = _attach(a, pprof, p, delivered, blob, **samp)
    assert len(delivered) >= 3 and cont
    assert delivered + cont == ref


@pytest.mark.parametrize("mode", sorted(SAMPLING))
def test_park_on_port_attach_on_jax(servers, mode):
    j, a, _ = servers
    samp = SAMPLING[mode]
    p = prompts([8], seed=22)[0]
    ref = j.submit(p, timeout=60, **samp)
    delivered, blob = _park(a, p, 3, **samp)
    cont = _attach(j, jprof, p, delivered, blob, **samp)
    assert delivered + cont == ref


@pytest.mark.parametrize("mode", sorted(SAMPLING))
def test_resume_from_matches_jax(servers, mode):
    j, a, _ = servers
    samp = dict(SAMPLING[mode], max_new_tokens=12)
    p = prompts([6], seed=23)[0]
    full = j.submit(p, timeout=60, **samp)
    for cut in (1, 4, 11):
        want = j.submit(p, resume_from=full[:cut], timeout=60, **samp)
        assert want == full[cut:]
        assert a.submit(p, resume_from=full[:cut], timeout=60,
                        **samp) == want


def test_ttl_sweep_matches_jax(servers):
    """A parked stream nobody exports, and an import nobody attaches, free
    their pages when the TTL lapses, in both packages."""
    j, a, b = servers
    for src, dst in ((a, b), (j, a)):
        for srv in (src, dst):
            srv._park_timeout = 0.05
        try:
            e0 = src.stats["migrate_expired"], dst.stats["migrate_expired"]
            used = src.engine.allocator.used, dst.engine.allocator.used
            err = JStreamMigrated if src is j else StreamMigrated
            p = prompts([8], seed=24)[0]
            _, h = _park_handle(src, p, 2, err=err, temperature=0.0)
            wait(lambda: src.snapshot()["parked"] == 0, msg="park sweep")
            with pytest.raises(KeyError):
                src.export_stream(h)
            assert src.stats["migrate_expired"] == e0[0] + 1
            # an import that is never attached
            _, blob = _park(src, p, 2, err=err, temperature=0.0)
            h2 = dst.import_stream(blob)
            wait(lambda: dst.snapshot()["imports"] == 0, msg="import sweep")
            assert dst.release_import(h2) is False
            assert dst.stats["migrate_expired"] == e0[1] + 1
            wait(lambda: (src.engine.allocator.used,
                          dst.engine.allocator.used) == used,
                 msg="pages back")
        finally:
            for srv in (src, dst):
                srv._park_timeout = pgen._DEF_MIGRATE_PARK_S


def test_defrag_bitwise_on_port_like_jax():
    """Defrag moves a stream's pages down after a sibling frees the low
    ones, and the stream continues equal to the JAX server's."""
    jm, params = jax_model()
    j = jgen.GenerationServer(jm, params, _mcfg(jax_side=True))
    srv = GenerationServer(port_model(), _mcfg(), device="cpu")
    try:
        p_long = prompts([8], seed=5)[0]
        ref = j.submit(p_long, temperature=0.0, timeout=60)
        gate = threading.Event()
        fut_s = srv.submit_async(prompts([8], seed=6)[0], max_new_tokens=4,
                                 temperature=0.0)
        fut_l = srv.submit_async(p_long, temperature=0.0,
                                 on_token=lambda t: gate.wait(0.01))
        fut_s.result(timeout=60)         # frees the low pages
        wait(lambda: len(fut_l.stream_tokens) >= 6, msg="6 tokens")
        moved = srv.defrag()
        gate.set()
        assert fut_l.result(timeout=60) == ref
        assert moved == 1 and srv.stats["defrag_moved"] == 1
        wait(lambda: srv.snapshot()["active"] == 0, msg="settled")
        assert srv.engine.allocator.used == 0
    finally:
        j.drain(timeout=10)
        srv.drain(timeout=10)


def test_move_pages_overlapping_sets():
    """Gather-then-scatter: a move whose destinations overlap its sources
    copies the old contents, not half-written ones."""
    srv = GenerationServer(port_model(), _mcfg(), device="cpu", warm=False)
    try:
        eng = srv.engine
        for p in range(1, 6):
            eng.k_pages[:, p] = float(p)
            eng.v_pages[:, p] = -float(p)
        eng.move_pages([3, 4, 5], [2, 3, 4])
        assert [float(eng.k_pages[0, p, 0, 0, 0]) for p in range(1, 6)] \
            == [1.0, 3.0, 4.0, 5.0, 5.0]
        assert [float(eng.v_pages[1, p, 0, 0, 0]) for p in range(1, 6)] \
            == [-1.0, -3.0, -4.0, -5.0, -5.0]
    finally:
        srv.drain(timeout=10)


def test_leakcheck_quiescent_after_cycle(servers):
    """With the leak ledger armed, a park / export / import / attach
    cycle and its settlement leave no live page or future."""
    _, a, b = servers
    leakcheck.install("raise")
    try:
        p = prompts([8], seed=25)[0]
        ref = a.submit(p, temperature=0.0, timeout=60)
        delivered, blob = _park(a, p, 3, temperature=0.0)
        assert delivered + _attach(b, pprof, p, delivered, blob,
                                   temperature=0.0) == ref
        wait(lambda: a.snapshot()["active"] == b.snapshot()["active"] == 0,
             msg="settled")
        assert leakcheck.live_count("kv_pages") == 0
        assert leakcheck.assert_quiescent() == {}
    finally:
        leakcheck.uninstall()
        leakcheck.reset()


# ---------------------------------------------------------------------------
# tests/test_migration.py's cases that need no gateway or fleet, on the port
# ---------------------------------------------------------------------------
class TestKVBlob:
    def _sample(self):
        header = {"length": 12, "last_token": 4, "n_pages": 2,
                  "page_size": 8, "rng_state": {"state": {"key": [1, 2]}},
                  "gen_tokens": [5, 6, 7]}
        rng = np.random.RandomState(0)
        k = rng.randn(2, 2, 8, 4, 16).astype(np.float32)
        v = rng.randn(2, 2, 8, 4, 16).astype(np.float32)
        return header, k, v

    def test_roundtrip_bitwise(self):
        header, k, v = self._sample()
        blob = pack_kv_blob(header, k, v)
        assert blob[:4] == KV_BLOB_MAGIC
        h2, k2, v2 = unpack_kv_blob(blob)
        want = json.loads(json.dumps(header))
        assert {k: h2[k] for k in want} == want
        assert h2["kv_dtype"] == "float32"
        assert h2["kv_shape"] == [2, 2, 8, 4, 16]
        assert k2.dtype == k.dtype and v2.dtype == v.dtype
        assert np.array_equal(k2, k) and np.array_equal(v2, v)

    def test_crc_corruption_rejected(self):
        header, k, v = self._sample()
        blob = bytearray(pack_kv_blob(header, k, v))
        blob[len(blob) // 2] ^= 0xFF
        with pytest.raises(ValueError):
            unpack_kv_blob(bytes(blob))

    def test_bad_magic_rejected(self):
        header, k, v = self._sample()
        blob = pack_kv_blob(header, k, v)
        with pytest.raises(ValueError):
            unpack_kv_blob(b"XXXX" + blob[4:])

    def test_version_mismatch_rejected(self):
        header, k, v = self._sample()
        blob = pack_kv_blob(header, k, v)
        bumped = blob[:4] + struct.pack(">H", KV_BLOB_VERSION + 1) \
            + blob[6:]
        with pytest.raises(ValueError):
            unpack_kv_blob(bumped)

    def test_truncated_rejected(self):
        header, k, v = self._sample()
        blob = pack_kv_blob(header, k, v)
        for cut in (0, 3, 9, len(blob) // 2, len(blob) - 1):
            with pytest.raises(ValueError):
                unpack_kv_blob(blob[:cut])


class TestMigrationChaosKinds:
    def test_migrate_interrupt_gate(self):
        assert chaos.migrate_interrupt(0) is False
        with chaos.inject("migrate_interrupt@1"):
            assert chaos.migrate_interrupt(0) is False
            assert chaos.migrate_interrupt(1) is True
            assert chaos.migrate_interrupt(1) is False
        assert chaos.migrate_interrupt(1) is False

    def test_drain_migrate_requires_live_stream(self):
        assert chaos.drain_migrate(0, 5) is False
        with chaos.inject("drain_migrate@0"):
            assert chaos.drain_migrate(0, 0) is False
            assert chaos.drain_migrate(0, 3) is True
            assert chaos.drain_migrate(0, 3) is False


@pytest.fixture(scope="class")
def pair():
    model = port_model()
    a = GenerationServer(model, _mcfg(), device="cpu")
    b = GenerationServer(model, _mcfg(), device="cpu")
    yield a, b
    a.drain(timeout=10)
    b.drain(timeout=10)


class TestDirectMigration:
    def _migrate(self, a, b, prompt, n_before=3, **samp):
        delivered, blob = _park(a, prompt, n_before, **samp)
        return delivered, _attach(b, pprof, prompt, delivered, blob, **samp)

    def test_forced_migration_bitwise_greedy(self, pair):
        a, b = pair
        prompt = prompts([8])[0]
        ref = a.submit_async(prompt, temperature=0.0).result(timeout=60)
        delivered, cont = self._migrate(a, b, prompt, temperature=0.0)
        assert len(delivered) >= 3 and cont
        assert delivered + cont == ref
        assert a.stats["parked"] >= 1 and a.stats["migrated_out"] >= 1
        assert b.stats["migrated_in"] >= 1
        assert b.stats["migrate_attached"] >= 1

    def test_forced_migration_bitwise_sampled(self, pair):
        a, b = pair
        prompt = prompts([8], seed=21)[0]
        samp = dict(temperature=0.9, top_k=12, seed=123)
        ref = a.submit_async(prompt, **samp).result(timeout=60)
        delivered, cont = self._migrate(a, b, prompt, **samp)
        assert delivered + cont == ref

    def test_unknown_handle_falls_back_to_resume(self, pair):
        a, b = pair
        prompt = prompts([6], seed=11)[0]
        ref = a.submit_async(prompt, temperature=0.0).result(timeout=60)
        delivered = ref[:3]
        resumed = b.stats["resumed"]
        fut = b.submit_async(prompt, resume_from=delivered,
                             migrate_handle="kvm-deadbeef",
                             temperature=0.0)
        cont = list(fut.tokens(timeout=60))
        assert delivered + cont == ref
        assert b.stats["resumed"] == resumed + 1

    def test_corrupt_blob_rejected_then_resume(self, pair):
        a, b = pair
        prompt = prompts([8], seed=13)[0]
        ref = a.submit_async(prompt, temperature=0.0).result(timeout=60)
        delivered, blob = _park(a, prompt, 2, temperature=0.0)
        blob = bytearray(blob)
        blob[len(blob) - 9] ^= 0x01
        used = b.engine.allocator.used
        with pytest.raises(ValueError):
            b.import_stream(bytes(blob))
        assert b.engine.allocator.used == used
        fut2 = b.submit_async(prompt, resume_from=delivered,
                              temperature=0.0)
        assert delivered + list(fut2.tokens(timeout=60)) == ref

    def test_export_unknown_handle(self, pair):
        a, _ = pair
        with pytest.raises(KeyError):
            a.export_stream("kvm-0000000000000000")

    def test_release_import_frees_pages(self, pair):
        a, b = pair
        prompt = prompts([8], seed=3)[0]
        _, blob = _park(a, prompt, 2, temperature=0.0)
        used0 = b.engine.allocator.used
        h2 = b.import_stream(blob)
        assert b.engine.allocator.used > used0
        assert b.release_import(h2) is True
        assert b.engine.allocator.used == used0
        assert b.release_import(h2) is False

    def test_pages_quiescent_after_full_cycle(self, pair):
        a, b = pair
        wait(lambda: a.snapshot()["active"] == 0
             and b.snapshot()["active"] == 0, msg="streams settled")
        assert a.engine.allocator.used == 0
        assert b.engine.allocator.used == 0
        assert a.snapshot()["parked"] == 0
        assert b.snapshot()["imports"] == 0


def test_defrag_relocates_and_continues_bitwise():
    srv = GenerationServer(port_model(), _mcfg(), device="cpu")
    try:
        p_long = prompts([8], seed=5)[0]
        ref = srv.submit_async(p_long, temperature=0.0).result(timeout=60)
        gate = threading.Event()
        fut_s = srv.submit_async(prompts([8], seed=6)[0],
                                 max_new_tokens=4, temperature=0.0)
        fut_l = srv.submit_async(
            p_long, temperature=0.0,
            on_token=lambda t: gate.wait(0.01))
        fut_s.result(timeout=60)
        wait(lambda: len(fut_l.stream_tokens) >= 6, msg="6 tokens")
        moved = srv.defrag()
        gate.set()
        cont = fut_l.result(timeout=60)
        assert cont == ref
        assert moved >= 1
        assert srv.stats["defrag_moved"] >= 1
        wait(lambda: srv.snapshot()["active"] == 0, msg="settled")
        assert srv.engine.allocator.used == 0
    finally:
        srv.drain(timeout=10)
