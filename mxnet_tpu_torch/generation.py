"""Continuous-batching generative inference: paged KV cache + token scheduler.

The port of ``mxnet_tpu/generation.py``, its device half and its host half:

* **Paged KV cache** — K/V live in fixed-size pages ``[L, P, page_size, H,
  D]`` on the device, handed out by a host-side free-list allocator
  (:class:`PageAllocator`).  Page 0 is the reserved garbage page: writes
  from prompt padding and inactive decode slots land there, so the device
  code never branches on validity.  Occupancy is published on the
  ``gen.kv_page_util`` gauge and exhaustion sheds with a typed
  :class:`~mxnet_tpu_torch.serving.Overloaded` — never an OOM.

* **Token-level continuous batching** — :class:`GenerationServer` runs one
  scheduler thread whose unit of work is a single prefill or a single
  decode iteration.  Sequences join (via prefill) and leave (EOS / length /
  deadline) the running batch at iteration boundaries.  Prompt lengths and
  decode slot counts are padded to fixed bucket chains, and
  :meth:`GenerationEngine.warm` runs every bucket once up front; a
  :class:`~mxnet_tpu_torch.dispatch.ShapeTracker` per callable counts a
  shape first seen after warmup as a ``recompile``, as the JAX server's
  jit does.

* **QoS, resume and migration** — a request carries a priority
  (:func:`parse_priority`): under page exhaustion strictly-lower-rank
  streams are preempted (journaled and re-admitted through the resume
  path) before anything is shed.  ``resume_from`` re-prefills prompt +
  delivered tokens.  A stream parked by
  :meth:`GenerationServer.park_streams` moves its K/V pages, host cursor
  and live sampler state to another server in a CRC-checked ``MXKV`` blob
  (:func:`pack_kv_blob`, byte-compatible with the JAX package's) and
  continues there with no prefill; :meth:`GenerationServer.defrag` moves
  streams inside one pool the same way.  The page tensors are written in
  place, so every page movement runs on the scheduler thread, between
  iterations.

* **Tenancy, brownout, chaos, telemetry, drain** — admission spends the
  tenant's quota and fair share (:mod:`~mxnet_tpu_torch.tenancy`), obeys
  the brownout ladder (:func:`~mxnet_tpu_torch.serving.brownout`), reads
  the ``page_pressure`` chaos hook, reports the JAX package's counters,
  histograms and trace events under the same names, and drains on SIGTERM
  (:meth:`GenerationServer.install_preemption_drain`).

Device compute lives in ``models/transformer.py`` (``prefill`` /
``decode_step``) and runs under :func:`torch.inference_mode`; everything
here is host-side orchestration.  Sampling is host-side in f64, so a seeded
stream is the same token for token as the JAX package's given the same
logits.

Not ported yet (each is listed in ROADMAP.md): MoE decode, a CUDA-graph
unit per bucket (the shape tracker counts signatures instead), and the
fleet around the server (gateway, worker, rebalancer).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import struct
import threading
import time
import zlib

import numpy as np
import torch

from . import chaos as _chaos
from . import clock as _clockmod
from . import dispatch as _dispatch
from . import leakcheck as _leakcheck
from . import profiler as _profiler
from . import resolve_device
from . import telemetry as _telemetry
from . import tenancy as _tenancy
from .base import dtype_name as _dtype_name
from .serving import (DRAINING, SERVING, STARTING, STOPPED, DeadlineExceeded,
                      Draining, Overloaded, QuotaExceeded, StreamingFuture,
                      StreamMigrated, brownout)

__all__ = ["GenerationConfig", "PageAllocator", "GenerationEngine",
           "GenerationServer", "parse_priority", "pack_kv_blob",
           "unpack_kv_blob", "KV_BLOB_MAGIC", "KV_BLOB_VERSION"]

_DEF_PAGE_SIZE = int(os.environ.get("MXTPU_GEN_PAGE_SIZE", "16"))
_DEF_MAX_PAGES = int(os.environ.get("MXTPU_GEN_MAX_PAGES", "256"))
_DEF_MAX_SLOTS = int(os.environ.get("MXTPU_GEN_MAX_SLOTS", "8"))
_DEF_MAX_NEW = int(os.environ.get("MXTPU_GEN_MAX_NEW", "128"))
_DEF_MAX_QUEUE = int(os.environ.get("MXTPU_GEN_MAX_QUEUE", "64"))
_DEF_DEADLINE_MS = float(os.environ.get("MXTPU_GEN_DEADLINE_MS", "60000"))
_DEF_SLOT_BUCKETS = os.environ.get("MXTPU_GEN_SLOT_BUCKETS", "")
_DEF_PREFILL_BUCKETS = os.environ.get("MXTPU_GEN_PREFILL_BUCKETS", "")
_DEF_TEMPERATURE = float(os.environ.get("MXTPU_GEN_TEMPERATURE", "0"))
_DEF_TOP_K = int(os.environ.get("MXTPU_GEN_TOP_K", "0"))
_DEF_SEED = int(os.environ.get("MXTPU_GEN_SEED", "0"))
# live KV migration: how long a parked/imported stream may hold its pages
# before the TTL sweep frees them (an abandoned transfer must not leak KV
# pages)
_DEF_MIGRATE_PARK_S = float(os.environ.get(
    "MXTPU_MIGRATE_PARK_TIMEOUT_S", "30"))


def _log(msg):
    print("[mxnet_tpu_torch.generation] %s" % msg, flush=True)


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Knobs for the generative stack (env defaults: ``MXTPU_GEN_*``, the
    same variables as the JAX package's)."""

    page_size: int = _DEF_PAGE_SIZE     # tokens per KV page
    max_pages: int = _DEF_MAX_PAGES     # total pages incl. the garbage page
    max_slots: int = _DEF_MAX_SLOTS     # concurrent decode sequences
    max_new_tokens: int = _DEF_MAX_NEW  # per-request generation cap
    max_seq_len: int = 0                # 0 -> model config max_len
    # bucket chains ('' -> pow2 chain capped at max_slots / max_seq_len)
    slot_buckets: str = _DEF_SLOT_BUCKETS
    prefill_buckets: str = _DEF_PREFILL_BUCKETS
    eos_id: int = -1                    # -1 -> no EOS stopping
    temperature: float = _DEF_TEMPERATURE  # <= 0 -> greedy argmax
    top_k: int = _DEF_TOP_K             # 0 -> full vocabulary
    seed: int = _DEF_SEED               # base seed for per-request rngs


def _resolve_chain(spec, cap):
    """Concrete ascending bucket chain from a comma spec, capped (and
    capped-member-included) so warmup can enumerate every bucket."""
    cap = int(cap)
    if spec:
        vals = {int(t) for t in str(spec).split(",") if str(t).strip()}
        vals = {v for v in vals if 0 < v <= cap}
        vals.add(cap)
        return tuple(sorted(vals))
    return _dispatch.pow2_chain(cap)


def _pick_bucket(chain, n):
    for b in chain:
        if b >= n:
            return b
    return chain[-1]


# hostile-header hardening for parse_priority: the whole value is
# length-capped, ranks are digit-capped (a 4000-digit "rank" must not
# become a bignum that outranks everything), and class names are
# sanitized to the counter-safe charset before they mint
# `gen.admitted_by_class.<name>` telemetry keys
_PRIO_MAX_LEN = 256
_PRIO_RANK_DIGITS = 9
_PRIO_NAME_MAX = 32
_PRIO_NAME_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def _prio_rank_of(tail):
    tail = tail.strip()
    body = tail[1:] if tail[:1] in ("+", "-") else tail
    if not body.isdigit() or len(body) > _PRIO_RANK_DIGITS:
        return None
    return int(tail)


def _prio_name_of(name):
    name = name.strip()
    if (not name or len(name) > _PRIO_NAME_MAX
            or not set(name) <= _PRIO_NAME_CHARS):
        return "default"
    return name


def parse_priority(value):
    """Normalize a request priority into ``(class_name, rank)``.

    Higher rank = more important.  Accepted shapes: ``None`` (the default
    class, rank 0), a bare int rank, a ``"name=rank"`` string (the
    ``X-MXTPU-Priority`` wire form), a bare numeric string, or a bare class
    name (rank 0).  Malformed or hostile values — oversized headers,
    junk/oversized ranks, class names outside ``[A-Za-z0-9._-]`` — degrade
    to the default class/rank 0 rather than failing admission."""
    if value is None:
        return ("default", 0)
    if isinstance(value, (int, np.integer)):
        r = int(value)
        return ("p%d" % r, r)
    s = str(value).strip()
    if not s or len(s) > _PRIO_MAX_LEN:
        return ("default", 0)
    if "=" in s:
        name, _, tail = s.partition("=")
        rank = _prio_rank_of(tail)
        return (_prio_name_of(name), 0 if rank is None else rank)
    r = _prio_rank_of(s)
    if r is not None:
        return ("p%d" % r, r)
    return (_prio_name_of(s), 0)


def _sample_token(logits, temperature, top_k, rng):
    """Pick the next token id from one logits row (np [V], host-side).

    ``temperature <= 0`` is greedy argmax — the default, bit-identical to
    the pre-sampling decode path.  Otherwise softmax(logits / temperature)
    in f64, optionally restricted to the ``top_k`` highest logits, sampled
    with the request's own ``np.random.Generator`` so a fixed seed gives a
    deterministic token stream regardless of batch composition.
    """
    if temperature <= 0.0:
        return int(np.argmax(logits))
    z = np.asarray(logits, np.float64) / float(temperature)
    if top_k and top_k < z.shape[-1]:
        kth = np.partition(z, -top_k)[-top_k]
        z = np.where(z >= kth, z, -np.inf)
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(z.shape[-1], p=p))


# ---------------------------------------------------------------------------
# KV snapshot wire format (live migration)
# ---------------------------------------------------------------------------
# Layout (big-endian), the JAX package's byte for byte:
#   magic[4] | version u16 | header_len u32 | header JSON | payload_len u64
#   | payload (raw K block bytes ++ raw V block bytes) | crc32 u32
# The CRC covers header+payload; any magic/version/CRC/shape mismatch is
# a ValueError so the transfer path can fall back to re-prefill — a
# migration can never be worse than the resume-from-journal path.
#
# numpy has no bfloat16 of its own (``ml_dtypes`` adds one, and need not be
# installed), so a bf16 block travels as its raw 2-byte words: header
# ``"kv_dtype": "bfloat16"`` and the same bytes as the JAX package writes.
KV_BLOB_MAGIC = b"MXKV"
KV_BLOB_VERSION = 1


def _raw(arr):
    """A zero-copy byte view of a C-contiguous array of any dtype."""
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _block_bytes(block):
    """``(dtype name, shape, raw bytes)`` of a K/V block — a numpy array
    (bfloat16 through ``ml_dtypes``, if any) or a torch tensor — with the
    bytes as a view, not a copy."""
    if isinstance(block, torch.Tensor):
        t = block.detach().contiguous().cpu()
        name = _dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, list(t.shape), _raw(t.numpy())
    arr = np.asarray(block)
    return str(arr.dtype), list(arr.shape), _raw(arr)


def _np_block(raw, dtype, shape):
    """The numpy array over a block's raw bytes (no copy); a bfloat16
    block is the ``ml_dtypes`` type where that is installed, else its raw
    words as ``uint16``."""
    if dtype == "bfloat16":
        try:
            import ml_dtypes
        except ImportError:
            return np.frombuffer(raw, dtype=np.uint16).reshape(shape)
        return np.frombuffer(raw, dtype=ml_dtypes.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def _itemsize(dtype):
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


def pack_kv_blob(header, k_block, v_block):
    """Serialize one parked stream: ``header`` (JSON-able dict) plus its
    gathered K/V pages (numpy arrays or tensors ``[L, n_pages, page_size,
    H, D]``).  The blocks' bytes are copied once, into the blob, and the
    CRC runs over them in place."""
    kd, kshape, kraw = _block_bytes(k_block)
    vd, vshape, vraw = _block_bytes(v_block)
    if (kd, kshape) != (vd, vshape):
        raise ValueError("KV blob: K is %s%s, V is %s%s"
                         % (kd, kshape, vd, vshape))
    header = dict(header)
    header["kv_dtype"] = kd
    header["kv_shape"] = kshape
    hbytes = json.dumps(header, sort_keys=True).encode()
    crc = zlib.crc32(vraw, zlib.crc32(kraw, zlib.crc32(hbytes)))
    return b"".join([KV_BLOB_MAGIC,
                     struct.pack(">HI", KV_BLOB_VERSION, len(hbytes)),
                     hbytes,
                     struct.pack(">Q", len(kraw) + len(vraw)),
                     kraw, vraw,
                     struct.pack(">I", crc & 0xFFFFFFFF)])


def unpack_kv_blob(blob):
    """Validate + parse a :func:`pack_kv_blob` blob.  Returns
    ``(header, k_block, v_block)`` as read-only numpy arrays over the
    blob's bytes (a bfloat16 block as ``ml_dtypes.bfloat16`` where
    installed, else its raw ``uint16`` words); raises ``ValueError`` on any
    magic / version / truncation / checksum mismatch."""
    if not isinstance(blob, bytes):
        blob = bytes(blob)             # the arrays must not see later writes
    mv = memoryview(blob)
    if len(mv) < 10 or mv[:4] != KV_BLOB_MAGIC:
        raise ValueError("KV blob: bad magic")
    version, hlen = struct.unpack(">HI", mv[4:10])
    if version != KV_BLOB_VERSION:
        raise ValueError("KV blob: version %d != %d"
                         % (version, KV_BLOB_VERSION))
    off = 10
    if len(mv) < off + hlen + 8:
        raise ValueError("KV blob: truncated header")
    hbytes = bytes(mv[off:off + hlen])
    off += hlen
    (plen,) = struct.unpack(">Q", mv[off:off + 8])
    off += 8
    if len(mv) != off + plen + 4:
        raise ValueError("KV blob: truncated payload")
    payload = mv[off:off + plen]
    (crc,) = struct.unpack(">I", mv[off + plen:off + plen + 4])
    if crc != (zlib.crc32(payload, zlib.crc32(hbytes)) & 0xFFFFFFFF):
        raise ValueError("KV blob: CRC mismatch")
    try:
        header = json.loads(hbytes)
    except ValueError:
        raise ValueError("KV blob: unparseable header")
    shape = tuple(int(d) for d in header["kv_shape"])
    dtype = str(header["kv_dtype"])
    try:
        n = int(np.prod(shape)) * _itemsize(dtype)
    except TypeError:
        raise ValueError("KV blob: unknown dtype %r" % dtype)
    if plen != 2 * n:
        raise ValueError("KV blob: payload is %d byte(s), header says "
                         "2x%d" % (plen, n))
    k_block = _np_block(payload[:n], dtype, shape)
    v_block = _np_block(payload[n:], dtype, shape)
    return header, k_block, v_block


def _block_tensor(block, dtype, device):
    """A tensor on ``device`` of a block :func:`unpack_kv_blob` returned,
    bit for bit (bf16 through its raw words): one host copy (the blob's
    arrays are read-only), then the copy to the device."""
    arr = np.array(block, order="C")
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _restore_rng(state):
    """Rebuild a ``np.random.Generator`` from its journaled
    ``bit_generator.state`` dict — the migrated stream's sampler resumes
    mid-sequence, bitwise (no fast-forward approximation needed)."""
    name = str(state.get("bit_generator", "PCG64"))
    bg = getattr(np.random, name)()
    bg.state = state
    return np.random.Generator(bg)


# ---------------------------------------------------------------------------
# page allocator
# ---------------------------------------------------------------------------
class PageAllocator:
    """Host-side free-list allocator over the KV page pool.

    Page 0 is reserved as the garbage page and is never handed out;
    capacity is therefore ``num_pages - 1``.  Occupancy is published on the
    ``gen.kv_page_util`` gauge after every alloc/free, and the high-water
    mark is kept in ``peak_util``.
    """

    def __init__(self, num_pages):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the garbage page)")
        self.num_pages = int(num_pages)
        self._capacity = self.num_pages - 1
        # pop() from the tail -> lowest page ids are handed out first
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._held = []            # impounded by page_pressure chaos
        self._lock = threading.Lock()
        self.peak_util = 0.0

    @property
    def capacity(self):
        return self._capacity

    @property
    def used(self):
        with self._lock:
            return self._capacity - len(self._free)

    def alloc(self, n):
        """Allocate ``n`` pages; returns their ids, or None when the pool
        cannot satisfy the request (all-or-nothing — no partial grants)."""
        with self._lock:
            if n > len(self._free):
                return None
            got = [self._free.pop() for _ in range(int(n))]
        for p in got:
            # leakcheck ledger: one entry per page until it comes back
            # through free()
            _leakcheck.track("kv_pages", (id(self), p))
        self._publish()
        return got

    def free(self, pages):
        pages = [int(p) for p in pages]
        with self._lock:
            self._free.extend(pages)
        for p in pages:
            _leakcheck.untrack("kv_pages", (id(self), p))
        self._publish()

    def impound(self, frac):
        """Chaos hook (``page_pressure``): move ``frac`` of the current
        free list into a held side-pool so allocation sees artificial
        exhaustion.  Impounded pages count as used on the util gauge.
        Returns how many pages were impounded.  ``frac`` is clamped to
        [0, 1], and repeated impounds accumulate into the same side-pool
        (one ``release()`` returns them all)."""
        with self._lock:
            frac = min(1.0, max(0.0, float(frac)))
            n = min(len(self._free), int(len(self._free) * frac))
            for _ in range(n):
                self._held.append(self._free.pop())
        self._publish()
        return n

    def release(self):
        """Return every impounded page to the free list (end of the
        ``page_pressure`` window).  Returns how many were released.
        Idempotent: a second release finds an empty side-pool and returns
        0 — pages re-enter the free list exactly once."""
        with self._lock:
            n = len(self._held)
            self._free.extend(self._held)
            self._held = []
        self._publish()
        return n

    @property
    def held(self):
        """Pages currently impounded by chaos."""
        with self._lock:
            return len(self._held)

    def min_free(self):
        """Lowest free page id, or None when the pool is exhausted — the
        defrag pass moves a stream only when a lower-numbered page than
        one it occupies is free (free+realloc pops lowest ids first, so
        relocation provably compacts)."""
        with self._lock:
            return min(self._free) if self._free else None

    def _publish(self):
        util = self.used / self._capacity
        if util > self.peak_util:
            self.peak_util = util
        _telemetry.registry().gauge("gen.kv_page_util").set(util)


# ---------------------------------------------------------------------------
# engine: prefill/decode over bucketed shapes
# ---------------------------------------------------------------------------
class _PendingReq:
    """One queued admission (fresh, resumed, or preempted-and-journaled).

    ``tokens`` is the full prefill input: the prompt, plus — for a resumed
    or re-admitted stream — every token already generated, so re-prefill
    reconstructs the KV state the earlier incarnation held.  ``start_new``
    counts those already-generated tail tokens (0 for a fresh request);
    ``patient`` marks an internally-preempted stream, which requeues on
    page exhaustion instead of shedding."""

    __slots__ = ("fut", "tokens", "max_new", "sampling", "prio_name",
                 "prio_rank", "start_new", "patient", "tenant")

    def __init__(self, fut, tokens, max_new, sampling, prio_name,
                 prio_rank, start_new=0, patient=False, tenant="anon"):
        self.fut = fut
        self.tokens = tokens
        self.max_new = max_new
        self.sampling = sampling      # (temperature, top_k, rng)
        self.prio_name = prio_name
        self.prio_rank = prio_rank
        self.start_new = start_new
        self.patient = patient
        self.tenant = tenant


class _Seq:
    """One sequence resident in the decode batch (host-side bookkeeping)."""

    __slots__ = ("fut", "table", "n_pages", "length", "last_token",
                 "n_new", "max_new", "prompt_len", "sampling",
                 "prio_name", "prio_rank", "input_tokens", "gen_tokens",
                 "preempted", "tenant")

    def __init__(self, fut, table, n_pages, length, last_token, max_new,
                 prompt_len, sampling, prio_name="default", prio_rank=0,
                 input_tokens=None, start_new=0, tenant="anon"):
        self.fut = fut
        self.table = table            # np [M] int64, padded with 0
        self.n_pages = n_pages        # leading valid entries of table
        self.length = length          # tokens with K/V in the cache
        self.last_token = last_token  # next token to feed decode_step
        self.n_new = start_new + 1    # generated so far, all incarnations
        #                               (prefill emits one)
        self.max_new = max_new
        self.prompt_len = prompt_len
        self.sampling = sampling      # (temperature, top_k, rng)
        self.prio_name = prio_name
        self.prio_rank = prio_rank
        self.input_tokens = input_tokens  # np array actually prefilled
        self.gen_tokens = [last_token]    # sampled by THIS incarnation
        self.preempted = False
        self.tenant = tenant


class GenerationEngine:
    """Owns the paged KV tensors and runs prefill/decode on the model.

    ``device`` defaults to ``cuda:0`` (raises without one unless
    ``device="cpu"``); the model is moved there.  ``params`` is the flat
    weight dict the prefill/decode calls read (the model's own parameters;
    :meth:`GenerationServer.swap_params` replaces it).  Shapes are padded
    to fixed bucket chains (prompt length for prefill, slot count for
    decode), :meth:`warm` runs every bucket once, and a
    :class:`~mxnet_tpu_torch.dispatch.ShapeTracker` per callable
    (``gen_prefill``, ``gen_decode``) counts signatures under the
    ``recompile`` / ``jit_cache_*`` counters.  The page tensors are
    updated in place on the device.
    """

    def __init__(self, model, config=None, *, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = config or GenerationConfig()
        if model.cfg.use_moe:
            raise NotImplementedError("paged decode does not support MoE yet")
        if self.device.type == "cuda":
            # JAX accumulates bf16 products in f32: keep cuBLAS from
            # reducing in bf16, and keep f32 matmuls out of TF32
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
                = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.params = {k: p.detach() for k, p in model.named_parameters()}
        self.page_size = int(self.cfg.page_size)
        self.max_seq = int(self.cfg.max_seq_len or model.cfg.max_len)
        self.pages_per_seq = -(-self.max_seq // self.page_size)
        self.allocator = PageAllocator(self.cfg.max_pages)
        self.k_pages, self.v_pages = model.init_kv_pages(
            self.cfg.max_pages, self.page_size)
        self.slot_chain = _resolve_chain(self.cfg.slot_buckets,
                                         self.cfg.max_slots)
        self.prefill_chain = _resolve_chain(self.cfg.prefill_buckets,
                                            self.max_seq)
        self._prefill_track = _dispatch.ShapeTracker("gen_prefill")
        self._decode_track = _dispatch.ShapeTracker("gen_decode")
        self.stats = {"prefills": 0, "decode_iters": 0, "tokens": 0}
        # tagged memory accounting: the engine owns the weights and the KV
        # page pool, the two dominant residents of a decode server (weakly
        # held — a collected engine drops out of the mem.* view)
        from . import memory as _memory

        self._mem_handles = (_memory.register("params",
                                              self._mem_params_bytes),
                             _memory.register("kv_pages",
                                              self._mem_kv_bytes))

    def _mem_params_bytes(self):
        return sum(t.numel() * t.element_size()
                   for t in self.params.values())

    def _mem_kv_bytes(self):
        return sum(t.numel() * t.element_size()
                   for t in (self.k_pages, self.v_pages))

    def _tensor(self, a):
        return torch.from_numpy(np.asarray(a)).to(self.device)

    def _run_prefill(self, toks, length, table):
        self._prefill_track.note(self.k_pages, self.v_pages, toks, length,
                                 table)
        with torch.inference_mode():
            logits = self.model.prefill(
                self.k_pages, self.v_pages, self._tensor(toks), length,
                self._tensor(table), params=self.params)
            return logits.cpu().numpy()

    def _run_decode(self, toks, tables, lens, active):
        self._decode_track.note(self.k_pages, self.v_pages, toks, tables,
                                lens, active)
        with torch.inference_mode():
            logits = self.model.decode_step(
                self.k_pages, self.v_pages, self._tensor(toks),
                self._tensor(tables), self._tensor(lens),
                self._tensor(active), params=self.params)
            return logits.cpu().numpy()

    def prefill(self, prompt, table):
        """Run one prompt (1-D int array) against pages ``table`` (np [M]);
        returns the next-token logits as np [V]."""
        T = int(prompt.shape[0])
        if T > self.max_seq:
            raise ValueError("prompt length %d > max_seq_len %d"
                             % (T, self.max_seq))
        tpad = _pick_bucket(self.prefill_chain, T)
        toks = np.zeros((1, tpad), np.int64)
        toks[0, :T] = prompt
        logits = self._run_prefill(toks, T, np.asarray(table, np.int64))
        self.stats["prefills"] += 1
        _profiler.dispatch_count("gen_prefills")
        return logits

    def decode(self, seqs):
        """One decode iteration over ``seqs`` (objects with ``last_token``,
        ``table`` and ``length``), padded up to the enclosing slot bucket;
        returns np logits [len(seqs), V].  Does NOT advance host
        bookkeeping — the caller owns lengths/tokens."""
        n = len(seqs)
        bucket = _pick_bucket(self.slot_chain, n)
        m = self.pages_per_seq
        toks = np.zeros(bucket, np.int64)
        tables = np.zeros((bucket, m), np.int64)
        lens = np.zeros(bucket, np.int64)
        active = np.zeros(bucket, bool)
        for i, s in enumerate(seqs):
            if not 0 <= s.length < self.max_seq:
                raise ValueError("decode at length %d outside [0, %d)"
                                 % (s.length, self.max_seq))
            toks[i] = s.last_token
            tables[i] = s.table
            lens[i] = s.length
            active[i] = True
        logits = self._run_decode(toks, tables, lens, active)
        self.stats["decode_iters"] += 1
        self.stats["tokens"] += n
        _profiler.dispatch_count("gen_decode_iters")
        _profiler.dispatch_count("gen_tokens", n)
        return logits[:n]

    def warm(self):
        """Run every prefill and decode bucket once (builds the kernels and
        warms the libraries).  Every warmup write goes to the garbage page
        (zero page tables, inactive slots): nothing is allocated and no
        cache state is disturbed."""
        m = self.pages_per_seq
        zt = np.zeros(m, np.int64)
        for tpad in self.prefill_chain:
            self._run_prefill(np.zeros((1, tpad), np.int64), 1, zt)
        for s in self.slot_chain:
            self._run_decode(np.zeros(s, np.int64),
                             np.zeros((s, m), np.int64),
                             np.zeros(s, np.int64), np.zeros(s, bool))
        _log("warm: %d prefill bucket(s) %s, %d decode bucket(s) %s"
             % (len(self.prefill_chain), list(self.prefill_chain),
                len(self.slot_chain), list(self.slot_chain)))

    # -- page movement (scheduler thread only: the pages' one writer) ---
    def gather_pages(self, pages):
        """K and V of ``pages`` as host tensors ``[L, n, page_size, H,
        D]``: one gather and one device-to-host copy per tensor."""
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        return (self.k_pages.index_select(1, idx).cpu(),
                self.v_pages.index_select(1, idx).cpu())

    def scatter_pages(self, pages, k_block, v_block):
        """Write ``k_block`` / ``v_block`` (``[L, n, ...]`` tensors) into
        ``pages``, in place."""
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        self.k_pages.index_copy_(1, idx, k_block.to(self.device))
        self.v_pages.index_copy_(1, idx, v_block.to(self.device))

    def move_pages(self, old, new):
        """Copy the K/V of pages ``old`` into pages ``new`` inside the
        pool.  The two may overlap: both blocks are gathered before either
        is written."""
        src = torch.as_tensor(old, dtype=torch.int64, device=self.device)
        dst = torch.as_tensor(new, dtype=torch.int64, device=self.device)
        k_block = self.k_pages.index_select(1, src)
        v_block = self.v_pages.index_select(1, src)
        self.k_pages.index_copy_(1, dst, k_block)
        self.v_pages.index_copy_(1, dst, v_block)


# ---------------------------------------------------------------------------
# token-level scheduler
# ---------------------------------------------------------------------------
class GenerationServer:
    """Continuous-batching front end over one :class:`GenerationEngine`.

    A single scheduler thread owns the device: each loop turn it either
    runs ONE task posted by another thread (a migration's page scatter, a
    defrag pass, a weight swap), prefills ONE waiting request into a free
    slot, or runs ONE decode iteration over the active batch — that
    alternation IS iteration-level scheduling (Orca): joins and leaves
    only ever happen between decode steps.  All outcome settlement
    (resolve/reject) happens under the server lock, so deadline expiry,
    page shedding, preemption and drain races keep the exactly-once
    typed-outcome contract.  Device compute always runs OUTSIDE the lock.
    """

    def __init__(self, model, config=None, *, max_queue=None,
                 deadline_ms=None, warm=True, clock=None, device=None):
        self.clock = _clockmod.resolve(clock)
        self.engine = GenerationEngine(model, config, device=device)
        self.cfg = self.engine.cfg
        self.max_queue = _DEF_MAX_QUEUE if max_queue is None \
            else int(max_queue)
        self.default_deadline = (_DEF_DEADLINE_MS if deadline_ms is None
                                 else float(deadline_ms)) / 1e3
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending = collections.deque()   # [_PendingReq]
        self._active = []                     # [_Seq]
        self._inflight = None                 # fut mid-prefill (not yet in
        #                                       _active; drain must see it)
        self._drain_flag = threading.Event()
        self._stop = False
        self._preemption = None
        self._defer_prefill = False           # force one decode turn so a
        #                                       requeued patient prefill
        #                                       cannot starve the batch
        self._loop_turn = 0                   # page_pressure chaos clock
        self._pressure_until = 0
        # live migration: parked streams awaiting export, imported streams
        # awaiting attach — both hold KV pages under a TTL so an abandoned
        # transfer can never leak them
        self._parked = {}                     # handle -> record
        self._imports = {}                    # handle -> record
        self._park_timeout = _DEF_MIGRATE_PARK_S
        self._tasks = collections.deque()     # (fn, box, evt) run on the
        #                                       scheduler thread (the page
        #                                       tensors have one writer)
        self._limbo = 0                       # seqs mid-defrag-relocation
        self._state = STARTING
        self.stats = {
            "admitted": 0, "shed_queue": 0, "shed_pages": 0, "ok": 0,
            "deadline_exceeded": 0, "rejected_draining": 0,
            "preempted": 0, "resumed": 0, "shed_brownout": 0,
            "shed_quota": 0,
            "parked": 0, "migrated_out": 0, "migrated_in": 0,
            "migrate_attached": 0, "migrate_expired": 0,
            "defrag_moved": 0,
        }
        if warm:
            self.engine.warm()
        self._state = SERVING
        # postmortem bundles embed the scheduler view (weakly held)
        from . import debug as _debug

        _debug.add_section("generation", self.snapshot)
        self._thread = threading.Thread(target=self._loop,
                                        name="gen-scheduler", daemon=True)
        self._thread.start()

    @property
    def state(self):
        with self._lock:
            return self._state

    # -- admission -----------------------------------------------------
    def submit_async(self, prompt, max_new_tokens=None, deadline_ms=None,
                     on_token=None, temperature=None, top_k=None, seed=None,
                     priority=None, resume_from=None, migrate_handle=None,
                     tenant=None):
        """Admit one generation request; returns a
        :class:`~mxnet_tpu_torch.serving.StreamingFuture` or raises the
        typed admission error (:class:`Overloaded` / :class:`Draining` /
        :class:`QuotaExceeded`).

        ``tenant`` is a tenant id (see :mod:`mxnet_tpu_torch.tenancy`):
        admission spends one token from the tenant's bucket and — when the
        queue is contended — holds each tenant to its weighted-fair share
        of queue slots, so a flooding tenant sheds typed
        :class:`QuotaExceeded` while everyone else keeps streaming.
        ``exempt`` tenants bypass the brownout rank gate and token cap,
        but never quota/fair-share.

        ``temperature`` / ``top_k`` / ``seed`` override the config-level
        sampling knobs per request (``temperature <= 0`` = greedy argmax,
        ``top_k == 0`` = full vocabulary).  Sampling state is per-request
        and host-side, so batch composition never perturbs a stream: an
        explicit ``seed`` replays the exact token stream; by default each
        request derives an independent rng from ``(cfg.seed, admission
        index)``, as the JAX server does.

        ``priority`` is any :func:`parse_priority` shape; under page
        exhaustion strictly-lower-rank streams are preempted before
        anything is shed, and brownout level 3 admits only ranks at or
        above the configured floor.

        ``resume_from`` — a list of tokens an earlier incarnation of this
        stream already generated.  The server re-prefills prompt+prefix and
        the returned future streams only the continuation.  With an
        explicit ``seed`` the rng is fast-forwarded by ``len(resume_from)``
        draws, so a sampled resume produces the suffix the first run would
        have.  Greedy resume recomputes the prefix's K/V through prefill:
        on the CPU in f32 it continues bit for bit; in bf16 on the card
        the re-prefill runs other GEMM shapes (and flash past the dense
        gate), so a greedy stream can part from the first run at a
        near-tie.

        ``migrate_handle`` — a handle returned by :meth:`import_stream`:
        attach directly to the installed KV state (length, last token and
        live sampling rng shipped in the snapshot) with **no prefill at
        all**.  An unknown/expired handle, or a snapshot that disagrees
        with the caller's journal, falls back to the ``resume_from``
        re-prefill path — migration is never worse than failover.

        Token ids are checked against the vocabulary here, on the host: an
        out-of-range index would assert on the device (JAX clamps it)."""
        prompt = self._check_tokens(prompt, "prompt")
        if prompt.size == 0:
            raise ValueError("empty prompt")
        prefix = (self._check_tokens(resume_from, "resume_from")
                  if resume_from is not None else None)
        if migrate_handle is not None:
            fut = self._attach_migrated(migrate_handle, prompt, prefix,
                                        max_new_tokens, deadline_ms,
                                        on_token)
            if fut is not None:
                return fut
            # fall through: re-prefill from the journal instead
        start_new = 0 if prefix is None else int(prefix.size)
        tokens = prompt if prefix is None \
            else np.concatenate([prompt, prefix])
        if tokens.size >= self.engine.max_seq:
            raise ValueError("prompt length %d >= max_seq_len %d"
                             % (tokens.size, self.engine.max_seq))
        max_new = int(max_new_tokens or self.cfg.max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if start_new and max_new - start_new < 1:
            raise ValueError("resume_from already carries %d token(s), "
                             ">= max_new_tokens %d" % (start_new, max_new))
        temperature = (self.cfg.temperature if temperature is None
                       else float(temperature))
        top_k = self.cfg.top_k if top_k is None else int(top_k)
        if top_k < 0:
            raise ValueError("top_k must be >= 0")
        prio_name, prio_rank = parse_priority(priority)
        tenant = _tenancy.parse_tenant(tenant)
        gov = _tenancy.governor()
        exempt = gov.exempt(tenant)
        bo = brownout()
        if not exempt:
            max_new = max(bo.cap_max_new(max_new), start_new + 1)
        now = self.clock.now()
        deadline = now + (self.default_deadline if deadline_ms is None
                          else float(deadline_ms) / 1e3)
        with self._cv:
            if (self._drain_flag.is_set()
                    or self._state in (DRAINING, STOPPED)):
                self.stats["rejected_draining"] += 1
                raise Draining("generation server is draining")
            try:
                # fair-share sees the live queue composition: how many
                # slots this tenant already holds, and who else is queued
                gov.check(tenant, now,
                          queue_len=len(self._pending),
                          queue_cap=self.max_queue,
                          tenant_pending=sum(
                              1 for r in self._pending
                              if r.tenant == tenant),
                          queue_tenants={r.tenant
                                         for r in self._pending})
            except QuotaExceeded:
                self.stats["shed_quota"] += 1
                _profiler.dispatch_count("gen_quota_shed")
                _profiler.dispatch_count("gen.shed_by_tenant.%s" % tenant)
                raise
            if not exempt and not bo.admits(prio_rank):
                self.stats["shed_brownout"] += 1
                _profiler.dispatch_count("gen_brownout_shed")
                _profiler.dispatch_count("gen.shed_by_tenant.%s" % tenant)
                raise Overloaded(
                    "brownout level %d admits only priority rank >= %d "
                    "(got %s=%d)" % (bo.level, bo.min_rank, prio_name,
                                     prio_rank))
            if len(self._pending) >= self.max_queue:
                self.stats["shed_queue"] += 1
                _profiler.dispatch_count("requests_shed")
                _profiler.dispatch_count("gen.shed_by_tenant.%s" % tenant)
                raise Overloaded("generation queue full (%d pending)"
                                 % len(self._pending))
            fut = StreamingFuture({"tokens": tokens}, rows=1,
                                  deadline=deadline, t_admit=now,
                                  on_token=on_token, clock=self.clock)
            self.stats["admitted"] += 1
            if start_new:
                self.stats["resumed"] += 1
                _profiler.dispatch_count("gen_resumed")
            _profiler.dispatch_count("requests_admitted")
            _profiler.dispatch_count("gen.admitted_by_class.%s" % prio_name)
            _profiler.dispatch_count("gen.admitted_by_tenant.%s" % tenant)
            _telemetry.trace_begin("request", fut.trace_id, cat="gen",
                                   args={"prompt_len": int(prompt.size),
                                         "max_new": max_new,
                                         "priority": prio_name,
                                         "resumed": start_new})
            rng = np.random.default_rng(
                int(seed) if seed is not None
                else (self.cfg.seed, self.stats["admitted"]))
            if start_new and seed is not None and temperature > 0.0:
                # one uniform draw per sampled token (rng.choice consumes
                # exactly one double) — fast-forward past the prefix so
                # the resumed suffix replays the first stream
                rng.random(start_new)
            self._pending.append(_PendingReq(
                fut, tokens, max_new, (temperature, top_k, rng),
                prio_name, prio_rank, start_new=start_new,
                tenant=tenant))
            self._cv.notify_all()
        return fut

    def _check_tokens(self, tokens, what):
        tokens = np.asarray(tokens).reshape(-1)
        if tokens.size == 0:
            return tokens.astype(np.int64)
        vocab = self.engine.model.cfg.vocab_size
        if (not np.issubdtype(tokens.dtype, np.integer)
                or tokens.min() < 0 or tokens.max() >= vocab):
            raise ValueError("%s token ids must be integers in [0, %d)"
                             % (what, vocab))
        return tokens.astype(np.int64)

    def submit(self, prompt, timeout=None, **kw):
        """Blocking convenience: the generated token-id list."""
        return self.submit_async(prompt, **kw).result(timeout=timeout)

    # -- work on the scheduler thread ----------------------------------
    @staticmethod
    def _new_handle():
        return "kvm-" + os.urandom(8).hex()

    def _run_on_scheduler(self, fn, timeout=30.0):
        """Run ``fn`` on the scheduler thread and return its result.

        The page tensors are written in place by prefill/decode on the
        scheduler thread, so every other read or write of them — the
        export gather, the import scatter, the defrag relocation — runs
        there too, between iterations, never beside a decode queued on the
        same CUDA stream."""
        if threading.current_thread() is self._thread:
            return fn()
        box = {}
        evt = threading.Event()
        with self._cv:
            if self._stop or self._state == STOPPED:
                raise Draining("generation server is stopped")
            self._tasks.append((fn, box, evt))
            self._cv.notify_all()
        if not evt.wait(timeout):
            raise TimeoutError("scheduler did not service the task "
                               "within %.1fs" % timeout)
        if "error" in box:
            raise box["error"]
        return box["result"]

    # -- adapter hot-swap ----------------------------------------------
    def swap_params(self, params):
        """Atomically swap the engine's weights for a same-structure
        adapter.

        ``params`` is a flat dict under the JAX names (``"embed"``,
        ``"blocks.wqkv"``, ...) of numpy arrays or tensors; it must match
        the resident weights name for name, shape for shape and dtype for
        dtype, so every bucket keeps its shape signature — zero
        ``recompile``.  The tensors are copied to the device here and the
        dict is installed on the scheduler thread, between decode steps,
        so every in-flight stream sees one coherent set of weights per
        step (tokens sampled before the swap came wholly from the old
        weights, after it wholly from the new).  The module's own
        parameters are not touched: another server over the same model
        keeps its weights."""
        old = self.engine.params
        if set(params) != set(old):
            raise ValueError(
                "adapter params names differ from the resident model: "
                "missing %s, unexpected %s"
                % (sorted(set(old) - set(params)),
                   sorted(set(params) - set(old))))
        new = {}
        for name in sorted(old):
            leaf, res = params[name], old[name]
            ns, os_ = tuple(leaf.shape), tuple(res.shape)
            nd = _dtype_name(leaf.dtype)
            od = _dtype_name(res.dtype)
            if ns != os_ or nd != od:
                raise ValueError(
                    "adapter params leaf %r is %s%s, resident model has "
                    "%s%s — a swap must be shape/dtype-identical to stay "
                    "recompile-free" % (name, nd, ns, od, os_))
            new[name] = (leaf.detach().to(self.engine.device)
                         if isinstance(leaf, torch.Tensor)
                         else _block_tensor(leaf, res.dtype,
                                            self.engine.device))

        def _install():
            self.engine.params = new
            return True

        self._run_on_scheduler(_install)
        _profiler.dispatch_count("gen_adapter_swaps")
        _telemetry.trace_instant("gen.adapter_swap", cat="gen",
                                 args={"leaves": len(new)})
        return True

    # -- live KV migration ---------------------------------------------
    def _park_seq_locked(self, seq):
        """Evict ``seq`` from the batch but KEEP its pages: record every
        field a receiver needs for bitwise continuation (page table, host
        cursor, live sampling rng, QoS rank) under a fresh handle, and
        settle the old future with :class:`StreamMigrated`.  Caller holds
        the cv.

        Safe against an in-flight decode: the post-decode advance loop
        skips done futures without touching host state, and a re-run of
        the same decode position writes bitwise-identical KV — so the
        snapshot cursor and the page contents can never disagree."""
        self._active.remove(seq)
        handle = self._new_handle()
        start0 = seq.n_new - len(seq.gen_tokens)
        n_prompt = int(seq.input_tokens.size) - start0
        temperature, top_k, rng = seq.sampling
        rec = {
            "prompt": np.asarray(seq.input_tokens[:n_prompt], np.int64),
            "generated": ([int(t) for t in seq.input_tokens[n_prompt:]]
                          + [int(t) for t in seq.gen_tokens]),
            "input_tokens": seq.input_tokens,
            "gen_tokens": [int(t) for t in seq.gen_tokens],
            "length": int(seq.length),
            "last_token": int(seq.last_token),
            "n_new": int(seq.n_new),
            "max_new": int(seq.max_new),
            "prompt_len": int(seq.prompt_len),
            "temperature": float(temperature),
            "top_k": int(top_k),
            "rng": rng,
            "prio_name": seq.prio_name,
            "prio_rank": int(seq.prio_rank),
            "tenant": seq.tenant,
            "table": seq.table,
            "n_pages": int(seq.n_pages),
            "expires": self.clock.now() + self._park_timeout,
        }
        self._parked[handle] = rec
        self.stats["parked"] += 1
        _profiler.dispatch_count("gen_parked")
        _telemetry.trace_instant(
            "gen.park", cat="gen",
            args={"handle": handle, "tokens": seq.n_new,
                  "pages": seq.n_pages})
        seq.fut._reject(StreamMigrated(
            "stream parked for migration after %d token(s)" % seq.n_new,
            handle=handle))
        self._cv.notify_all()
        return handle

    def park_streams(self, n=None):
        """Park up to ``n`` active streams (all of them by default) for
        migration; returns their handles.  Largest KV footprint first —
        the stream whose move frees the most pages / saves the most
        re-prefill.  Each parked stream's old future settles with
        :class:`StreamMigrated`; the state is claimable via
        :meth:`export_stream` until the park TTL expires."""
        with self._cv:
            cands = [s for s in self._active
                     if not s.fut.done and not s.preempted]
            cands.sort(key=lambda s: (-s.n_pages, -s.n_new))
            if n is not None:
                cands = cands[:max(0, int(n))]
            return [self._park_seq_locked(s) for s in cands]

    def export_stream(self, handle):
        """Serialize a parked stream into the versioned, CRC-checksummed
        wire blob and free its pages on this side (the blob is now the
        only copy — the sender forgets the stream).  The page gather runs
        on the scheduler thread, one device-to-host copy per tensor.
        Raises ``KeyError`` for an unknown/expired handle."""
        t0 = time.perf_counter()
        with self._cv:
            rec = self._parked.pop(handle, None)
            if rec is None:
                raise KeyError("unknown or expired migration handle %r"
                               % handle)
        pages = [int(p) for p in rec["table"][:rec["n_pages"]]]
        try:
            k_block, v_block = self._run_on_scheduler(
                lambda: self.engine.gather_pages(pages))
        finally:
            self.engine.allocator.free(pages)
        header = {
            "prompt": [int(t) for t in rec["prompt"]],
            "generated": rec["generated"],
            "input_tokens": [int(t) for t in rec["input_tokens"]],
            "gen_tokens": rec["gen_tokens"],
            "length": rec["length"],
            "last_token": rec["last_token"],
            "n_new": rec["n_new"],
            "max_new": rec["max_new"],
            "prompt_len": rec["prompt_len"],
            "temperature": rec["temperature"],
            "top_k": rec["top_k"],
            "rng_state": rec["rng"].bit_generator.state,
            "prio_name": rec["prio_name"],
            "prio_rank": rec["prio_rank"],
            "n_pages": rec["n_pages"],
            "page_size": int(self.engine.page_size),
        }
        blob = pack_kv_blob(header, k_block, v_block)
        with self._cv:
            self.stats["migrated_out"] += 1
        _profiler.dispatch_count("gen_migrated_out")
        _telemetry.registry().histogram("gen.migrate_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return blob

    def import_stream(self, blob):
        """Validate + install a :meth:`export_stream` blob: allocate pages
        from this server's :class:`PageAllocator` (leak-audited like any
        admission), scatter the KV block into the page tensors on the
        scheduler thread, and stage the stream for
        ``submit_async(migrate_handle=...)`` attach.  Returns the local
        handle.  Raises ``ValueError`` on checksum/version/shape mismatch
        and :class:`Overloaded` when no pages are free — the caller falls
        back to re-prefill either way."""
        t0 = time.perf_counter()
        header, k_block, v_block = unpack_kv_blob(blob)
        eng = self.engine
        n_pages = int(header["n_pages"])
        shape = tuple(k_block.shape)
        want = tuple(eng.k_pages.shape)
        if (int(header["page_size"]) != eng.page_size
                or shape[0] != want[0] or shape[1] != n_pages
                or shape[2:] != want[2:]
                or str(header["kv_dtype"]) != _dtype_name(eng.k_pages.dtype)):
            raise ValueError(
                "KV blob: incompatible geometry %s/%s page_size=%s for "
                "engine %s page_size=%d"
                % (shape, header["kv_dtype"], header["page_size"], want,
                   eng.page_size))
        if n_pages > eng.pages_per_seq \
                or int(header["length"]) >= eng.max_seq:
            raise ValueError("KV blob: %d page(s) / length %d exceed "
                             "this engine's max_seq_len %d"
                             % (n_pages, header["length"], eng.max_seq))
        k_t = _block_tensor(k_block, eng.k_pages.dtype, "cpu")
        v_t = _block_tensor(v_block, eng.v_pages.dtype, "cpu")

        def install():
            pages = eng.allocator.alloc(n_pages)
            if pages is None:
                raise Overloaded(
                    "KV pages exhausted: migration needs %d page(s), "
                    "%d free of %d" % (n_pages, eng.allocator.capacity
                                       - eng.allocator.used,
                                       eng.allocator.capacity))
            try:
                eng.scatter_pages(pages, k_t, v_t)
            except BaseException:
                eng.allocator.free(pages)
                raise
            return pages

        pages = self._run_on_scheduler(install)
        table = np.zeros(eng.pages_per_seq, np.int64)
        table[:n_pages] = pages
        handle = self._new_handle()
        rec = {
            "prompt": np.asarray(header["prompt"], np.int64),
            "generated": [int(t) for t in header["generated"]],
            "input_tokens": np.asarray(header["input_tokens"], np.int64),
            "gen_tokens": [int(t) for t in header["gen_tokens"]],
            "length": int(header["length"]),
            "last_token": int(header["last_token"]),
            "n_new": int(header["n_new"]),
            "max_new": int(header["max_new"]),
            "prompt_len": int(header["prompt_len"]),
            "temperature": float(header["temperature"]),
            "top_k": int(header["top_k"]),
            "rng": _restore_rng(header["rng_state"]),
            "prio_name": str(header["prio_name"]),
            "prio_rank": int(header["prio_rank"]),
            "table": table,
            "n_pages": n_pages,
            "expires": self.clock.now() + self._park_timeout,
        }
        with self._cv:
            self._imports[handle] = rec
            self.stats["migrated_in"] += 1
        _profiler.dispatch_count("gen_migrated_in")
        _telemetry.registry().histogram("gen.migrate_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return handle

    def _attach_migrated(self, handle, prompt, prefix, max_new_tokens,
                         deadline_ms, on_token):
        """Attach a fresh future to an imported stream — the
        ``migrate_handle`` half of :meth:`submit_async`.  Returns the
        future, or None to fall back to the re-prefill path."""
        delivered = [] if prefix is None else [int(t) for t in prefix]
        now = self.clock.now()
        deadline = now + (self.default_deadline if deadline_ms is None
                          else float(deadline_ms) / 1e3)
        with self._cv:
            if (self._drain_flag.is_set()
                    or self._state in (DRAINING, STOPPED)):
                self.stats["rejected_draining"] += 1
                raise Draining("generation server is draining")
            rec = self._imports.get(handle)
            if rec is None:
                return None
            generated = rec["generated"]
            if (not np.array_equal(prompt, rec["prompt"])
                    or len(delivered) > len(generated)
                    or generated[:len(delivered)] != delivered):
                # snapshot and journal disagree: drop the import, free
                # its pages, re-prefill from the journal (never worse)
                del self._imports[handle]
                self.engine.allocator.free(
                    [int(p) for p in rec["table"][:rec["n_pages"]]])
                self.stats["migrate_expired"] += 1
                return None
            del self._imports[handle]
            max_new = int(max_new_tokens or rec["max_new"])
            bo = brownout()
            max_new = max(bo.cap_max_new(max_new), len(generated))
            fut = StreamingFuture({"tokens": rec["input_tokens"]}, rows=1,
                                  deadline=deadline, t_admit=now,
                                  on_token=on_token, clock=self.clock)
            self.stats["admitted"] += 1
            self.stats["migrate_attached"] += 1
            _profiler.dispatch_count("requests_admitted")
            _profiler.dispatch_count("gen_migrate_attached")
            _telemetry.trace_begin("request", fut.trace_id, cat="gen",
                                   args={"migrated": True,
                                         "tokens": len(generated)})
            seq = _Seq(fut, rec["table"], rec["n_pages"], rec["length"],
                       rec["last_token"], max_new, rec["prompt_len"],
                       (rec["temperature"], rec["top_k"], rec["rng"]),
                       prio_name=rec["prio_name"],
                       prio_rank=rec["prio_rank"],
                       input_tokens=rec["input_tokens"],
                       tenant=rec.get("tenant", "anon"))
            seq.gen_tokens = list(rec["gen_tokens"])
            seq.n_new = len(generated)
            gap = generated[len(delivered):]
        # catch-up emission outside the lock (token callbacks are user
        # code) — tokens generated before the park that the client has
        # not seen yet stream first, then decode continues from the KV
        finished = seq.n_new >= seq.max_new
        for t in gap:
            if not fut._emit(int(t)):
                finished = True
                break
        with self._cv:
            if fut.done:                       # deadline/cancel raced
                self.engine.allocator.free(
                    [int(p) for p in seq.table[:seq.n_pages]])
            elif finished:
                self._active.append(seq)
                self._retire_locked(seq)
            else:
                self._active.append(seq)
                self._cv.notify_all()
        return fut

    def release_import(self, handle):
        """Drop a staged (imported, unattached) migration record and free
        its pages — the transfer-abort path.  Returns True if the handle
        was live.  Idempotent."""
        with self._cv:
            rec = self._imports.pop(handle, None)
            if rec is None:
                return False
            pages = [int(p) for p in rec["table"][:rec["n_pages"]]]
            if pages:
                self.engine.allocator.free(pages)
            self.stats["migrate_expired"] += 1
        _profiler.dispatch_count("gen_migrate_expired")
        return True

    def _sweep_migration_locked(self, now):
        """TTL sweep: free the pages of parked/imported streams nobody
        claimed (aborted transfer, dead peer).  Caller holds the cv."""
        for store in (self._parked, self._imports):
            for h in [h for h, r in store.items() if now >= r["expires"]]:
                rec = store.pop(h)
                pages = [int(p) for p in rec["table"][:rec["n_pages"]]]
                if pages:
                    self.engine.allocator.free(pages)
                self.stats["migrate_expired"] += 1
                _profiler.dispatch_count("gen_migrate_expired")
                _log("migration handle %s expired unclaimed — freed %d "
                     "page(s)" % (h, len(pages)))

    # -- defrag (self-migration) ---------------------------------------
    def defrag(self, timeout=30.0):
        """Compact fragmented page tables by migrating streams to this
        server itself: gather a stream's pages, free them, re-allocate
        (the free list hands out lowest ids first) and scatter back.
        Returns how many streams moved.  Runs on the scheduler thread —
        the only writer of the page tensors — between iterations, so the
        decode loop never sees a half-moved table."""
        return self._run_on_scheduler(self._defrag_pass, timeout=timeout)

    def _defrag_pass(self):
        eng = self.engine
        moved = 0
        with self._cv:
            seqs = [s for s in self._active
                    if not s.fut.done and not s.preempted]
        for s in seqs:
            with self._cv:
                if s not in self._active or s.fut.done or s.preempted:
                    continue
                old = [int(p) for p in s.table[:s.n_pages]]
                low = eng.allocator.min_free()
                if not old or low is None or low >= max(old):
                    continue          # already as compact as it can get
                # take the seq out of the batch while its pages move so
                # a racing retire/park cannot free a stale table
                self._active.remove(s)
                self._limbo += 1
            new = None
            try:
                eng.allocator.free(old)
                new = eng.allocator.alloc(len(old))
                if new is None:       # cannot happen (just freed n)
                    raise Overloaded("defrag lost its own pages")
                # gather-then-scatter: the old and new sets may overlap
                eng.move_pages(old, new)
                with self._cv:
                    self._limbo -= 1
                    s.table[:len(new)] = new
                    if s.fut.done:    # settled while relocating: tidy up
                        eng.allocator.free(new)
                    else:
                        self._active.append(s)
                        moved += 1
                        self.stats["defrag_moved"] += 1
                    self._cv.notify_all()
            except BaseException:
                # relocation failed mid-flight: the stream's KV is in an
                # unknown state — give it one typed outcome, return any
                # pages it still holds, and keep the server healthy
                with self._cv:
                    self._limbo -= 1
                    if new:
                        eng.allocator.free(new)
                    self._reject_locked(s.fut, Overloaded(
                        "defrag relocation failed after %d token(s)"
                        % s.n_new))
                continue
        if moved:
            _profiler.dispatch_count("gen_defrag_moved", moved)
            _telemetry.trace_instant("gen.defrag", cat="gen",
                                     args={"moved": moved})
        return moved

    # -- scheduler loop ------------------------------------------------
    def _loop(self):
        while True:
            work = task = None
            with self._cv:
                if self._stop:
                    break
                if self._drain_flag.is_set() and self._state == SERVING:
                    self._state = DRAINING
                self._expire_locked(self.clock.now())
                self._loop_turn += 1
            self._chaos_pressure()                 # allocator IO, no lock
            with self._cv:
                if self._stop:
                    break
                if self._tasks:
                    # page-tensor work posted by another thread (export
                    # gather, import scatter, defrag, weight swap) —
                    # serviced here because this thread is the page
                    # tensors' only writer
                    task = self._tasks.popleft()
                elif (self._pending and not self._defer_prefill
                        and len(self._active) < self.cfg.max_slots):
                    work = self._pending.popleft()
                    self._inflight = work.fut
                elif not self._active:
                    self._defer_prefill = False
                    self._cv.wait(0.02)
                    continue
                else:
                    self._defer_prefill = False
            if task is not None:
                fn, box, evt = task
                try:
                    box["result"] = fn()           # device work, no lock
                except BaseException as e:
                    box["error"] = e
                evt.set()
            elif work is not None:
                self._do_prefill(work)
            else:
                self._decode_iteration()
        # scheduler stopped: unblock every waiter still queued behind it
        with self._cv:
            leftovers = list(self._tasks)
            self._tasks.clear()
        for _fn, box, evt in leftovers:
            box["error"] = Draining("scheduler stopped before the "
                                    "migration task ran")
            evt.set()

    def _chaos_pressure(self):
        """``page_pressure`` chaos: impound most of the KV free list for a
        bounded window of scheduler turns, forcing the preemption path."""
        frac = _chaos.page_pressure(self._loop_turn)
        if frac > 0.0:
            n = self.engine.allocator.impound(frac)
            self._pressure_until = self._loop_turn + 32
            _log("chaos page_pressure: impounded %d page(s) for 32 turns"
                 % n)
        elif self._pressure_until and self._loop_turn >= self._pressure_until:
            self._pressure_until = 0
            n = self.engine.allocator.release()
            _log("chaos page_pressure: released %d page(s)" % n)
            with self._cv:
                self._cv.notify_all()

    def _expire_locked(self, now):
        self._sweep_migration_locked(now)
        for i in range(len(self._pending) - 1, -1, -1):
            fut = self._pending[i].fut
            if now >= fut.deadline:
                del self._pending[i]
                self._reject_locked(fut, DeadlineExceeded(
                    "deadline passed while queued"))
        for s in list(self._active):
            if now >= s.fut.deadline:
                self._retire_locked(s, DeadlineExceeded(
                    "deadline passed after %d token(s)" % s.n_new))

    def _reject_locked(self, fut, err):
        if fut._reject(err):
            key = ("deadline_exceeded"
                   if isinstance(err, DeadlineExceeded) else
                   "shed_pages" if isinstance(err, Overloaded) else
                   "rejected_draining")
            self.stats[key] += 1
        self._cv.notify_all()

    def _retire_locked(self, seq, err=None):
        """Remove ``seq`` from the active batch, free its pages, settle.
        Idempotent: a sequence already retired (deadline expiry or drain
        sweep racing the decode loop) is left alone — pages free once."""
        if seq not in self._active:
            return
        self._active.remove(seq)
        pages = [int(p) for p in seq.table[:seq.n_pages]]
        if err is None:
            if seq.fut._resolve(list(seq.fut.stream_tokens)):
                self.stats["ok"] += 1
        else:
            self._reject_locked(seq.fut, err)
        if pages:
            self.engine.allocator.free(pages)
        self._cv.notify_all()

    # -- QoS preemption ------------------------------------------------
    def _preempt_locked(self, rank, need):
        """Free pages for a rank-``rank`` admission by preempting
        strictly-lower-priority active streams, lowest rank (then largest
        footprint) first.  Each victim is journaled as a patient
        :class:`_PendingReq` — its future stays live and it re-admits
        through the resume path — so nothing is shed unless every victim
        is same-or-higher priority.  Returns True once ``need`` pages are
        free.  Caller holds the cv; the scheduler thread is the only
        decoder, so victims are never mid-device-step."""
        alloc = self.engine.allocator
        while alloc.capacity - alloc.used < need:
            victims = [s for s in self._active
                       if s.prio_rank < rank and not s.preempted
                       and not s.fut.done]
            if not victims:
                return False
            v = min(victims, key=lambda s: (s.prio_rank, -s.n_pages))
            self._preempt_seq_locked(v)
        return True

    def _preempt_seq_locked(self, seq):
        """Evict ``seq`` from the batch, journal its exact state (prompt +
        every generated token + its live sampling rng) and requeue it as a
        patient pending entry.  The future is NOT settled — the stream
        simply pauses until re-prefill."""
        self._active.remove(seq)
        seq.preempted = True
        tokens = np.concatenate(
            [seq.input_tokens, np.asarray(seq.gen_tokens, np.int64)])
        self._pending.append(_PendingReq(
            seq.fut, tokens, seq.max_new, seq.sampling, seq.prio_name,
            seq.prio_rank, start_new=seq.n_new, patient=True,
            tenant=seq.tenant))
        self.stats["preempted"] += 1
        _profiler.dispatch_count("gen_preempted")
        _telemetry.trace_instant(
            "gen.preempt", cat="gen",
            args={"priority": seq.prio_name, "tokens": seq.n_new})
        pages = [int(p) for p in seq.table[:seq.n_pages]]
        if pages:
            self.engine.allocator.free(pages)
        self._cv.notify_all()

    def _do_prefill(self, req):
        eng = self.engine
        fut, max_new, sampling = req.fut, req.max_new, req.sampling
        tokens = req.tokens
        need = -(-int(tokens.size) // eng.page_size)
        pages = eng.allocator.alloc(need)
        if pages is None:
            with self._cv:
                if self._preempt_locked(req.prio_rank, need):
                    pages = eng.allocator.alloc(need)
        if pages is None:
            if req.patient:
                # an internally-preempted stream waits out the pressure
                # instead of shedding; defer one turn to the decode side
                # so the batch keeps draining and freeing pages
                with self._cv:
                    self._inflight = None
                    self._pending.append(req)
                    self._defer_prefill = True
                    self._cv.notify_all()
                return
            _profiler.dispatch_count("gen_pages_shed")
            with self._cv:
                self._inflight = None
                self._reject_locked(fut, Overloaded(
                    "KV pages exhausted: prompt needs %d page(s), "
                    "%d free of %d" % (need, eng.allocator.capacity
                                       - eng.allocator.used,
                                       eng.allocator.capacity)))
            return
        table = np.zeros(eng.pages_per_seq, np.int64)
        table[:need] = pages
        logits = eng.prefill(tokens, table)        # device work, no lock
        tok = _sample_token(logits, *sampling)
        seq = _Seq(fut, table, need, int(tokens.size), tok, max_new,
                   int(tokens.size), sampling, prio_name=req.prio_name,
                   prio_rank=req.prio_rank, input_tokens=tokens,
                   start_new=req.start_new, tenant=req.tenant)
        is_eos = self.cfg.eos_id >= 0 and tok == self.cfg.eos_id
        emitted = False if is_eos else fut._emit(tok)  # EOS never streams
        if (emitted and req.start_new == 0
                and fut.t_first_token is not None):
            _telemetry.registry().histogram("gen.ttft_ms").observe(
                (fut.t_first_token - fut.t_admit) * 1e3)
        with self._cv:
            self._inflight = None
            if fut.done:                           # drain/deadline raced
                eng.allocator.free(pages)
            elif self.clock.now() >= fut.deadline:
                self._reject_locked(fut, DeadlineExceeded(
                    "deadline passed during prefill"))
                eng.allocator.free(pages)
            elif is_eos or seq.n_new >= max_new:
                self._active.append(seq)
                self._retire_locked(seq)
            else:
                self._active.append(seq)
                self._cv.notify_all()

    def _decode_iteration(self):
        eng = self.engine
        with self._cv:
            seqs = list(self._active)
        if not seqs:
            return
        # grow page tables for sequences crossing a page boundary; a pool
        # miss first preempts strictly-lower-priority streams (journaled,
        # not shed) and only sheds THIS sequence with a typed Overloaded
        # when no lower-rank victim exists (its streamed tokens stand;
        # the outcome names the truncation)
        survivors = []
        for s in seqs:
            if s.preempted or s.fut.done:
                continue
            needed = s.length // eng.page_size + 1
            if needed > s.n_pages:
                got = eng.allocator.alloc(1)
                if got is None:
                    with self._cv:
                        if self._preempt_locked(s.prio_rank, 1):
                            got = eng.allocator.alloc(1)
                if got is None:
                    _profiler.dispatch_count("gen_pages_shed")
                    with self._cv:
                        self._retire_locked(s, Overloaded(
                            "KV pages exhausted mid-decode after %d "
                            "token(s)" % s.n_new))
                    continue
                s.table[s.n_pages] = got[0]
                s.n_pages += 1
            survivors.append(s)
        # a grow-phase preemption may have evicted a sequence admitted to
        # survivors earlier in this same pass — its pages are gone, so it
        # must not reach the device; its journal already holds its state
        survivors = [s for s in survivors if not s.preempted]
        if not survivors:
            return
        t0 = time.perf_counter()
        logits = eng.decode(survivors)             # device work, no lock
        dt = time.perf_counter() - t0
        if dt > 0:
            _telemetry.registry().histogram(
                "gen.decode_tokens_per_sec").observe(len(survivors) / dt)
        _telemetry.trace_instant(
            "gen.decode_iter", cat="gen",
            args={"active": len(survivors),
                  "bucket": _pick_bucket(eng.slot_chain, len(survivors)),
                  "ms": round(dt * 1e3, 3)})
        # advance + emit with no lock held (token callbacks are user code);
        # settlement then happens under the lock, and _retire_locked is
        # idempotent against deadline/drain sweeps that raced the step
        finished = []
        for i, s in enumerate(survivors):
            if s.fut.done:                         # settled while decoding
                finished.append(s)
                continue
            s.length += 1
            tok = _sample_token(logits[i], *s.sampling)
            if self.cfg.eos_id >= 0 and tok == self.cfg.eos_id:
                finished.append(s)
                continue
            s.last_token = tok
            s.gen_tokens.append(tok)
            s.n_new += 1
            if not s.fut._emit(tok):
                finished.append(s)
                continue
            if s.n_new >= s.max_new or s.length >= eng.max_seq:
                finished.append(s)
        if finished:
            with self._cv:
                for s in finished:
                    self._retire_locked(s)

    # -- lifecycle -----------------------------------------------------
    def install_preemption_drain(self, handler=None):
        """Wire graceful drain into SIGTERM/SIGINT (the rc-76 contract):
        the first signal sets the drain flag, so new submits raise
        :class:`Draining` while the streams already admitted run to their
        outcome.  It never exits the process.  Installing a fresh handler
        works on the main thread only; returns the handler (its
        ``uninstall()`` restores the previous signal handlers)."""
        from .elastic import install_preemption_drain

        handler = install_preemption_drain(self._drain_flag.set,
                                           handler=handler)
        self._preemption = handler
        return handler

    def drain(self, timeout=None):
        """Stop admission (typed :class:`Draining` rejections), let every
        admitted request reach its terminal outcome, then stop the
        scheduler.  On timeout, unresolved requests are swept with typed
        ``Draining`` so nothing ever hangs.  Parked and imported streams
        nobody claimed die with the server: their pages return to the
        pool.  Returns True when everything in flight completed."""
        self._drain_flag.set()
        deadline = None if timeout is None else self.clock.now() + timeout
        with self._cv:
            if self._state == STOPPED:
                return True
            if self._state != DRAINING:
                self._state = DRAINING
                _log("state -> DRAINING (%d queued, %d active)"
                     % (len(self._pending), len(self._active)))
            self._cv.notify_all()
            while self._pending or self._active or self._limbo \
                    or self._inflight is not None:
                if deadline is not None and self.clock.now() >= deadline:
                    break
                self._cv.wait(0.05)
            drained = not (self._pending or self._active or self._limbo
                           or self._inflight is not None)
            if not drained:
                aborted = 0
                while self._pending:
                    fut = self._pending.popleft().fut
                    self._reject_locked(fut, Draining(
                        "drain timed out with the request still queued"))
                    aborted += 1
                if self._inflight is not None and not self._inflight.done:
                    self._reject_locked(self._inflight, Draining(
                        "drain timed out during prefill"))
                    aborted += 1
                for s in list(self._active):
                    if not s.fut.done:
                        self._retire_locked(s, Draining(
                            "drain timed out after %d token(s)" % s.n_new))
                        aborted += 1
                _log("drain timeout: aborted %d unresolved request(s) "
                     "with typed Draining" % aborted)
            # unexported parked / unclaimed imported streams die with the
            # server: their KV pages return to the pool so the leakcheck
            # ledger is quiescent at stop
            self._sweep_migration_locked(float("inf"))
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
        with self._cv:
            self._state = STOPPED
        return drained

    def close(self, timeout=5.0):
        return self.drain(timeout=timeout)

    def snapshot(self):
        with self._lock:
            alloc = self.engine.allocator
            return {
                "state": self._state,
                "pending": len(self._pending),
                "active": len(self._active),
                "parked": len(self._parked),
                "imports": len(self._imports),
                "pages_used": alloc.used,
                "pages_capacity": alloc.capacity,
                "kv_page_util_peak": round(alloc.peak_util, 4),
                "stats": dict(self.stats),
            }
