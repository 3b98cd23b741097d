"""Int8 matmul, int32 out or with the per-channel dequant fused.

Counterpart of ``mxnet_tpu/ops/pallas/int8_matmul.py``.  ``a`` [M, K] int8
× ``b`` [N, K] int8, contracted over K on both (activations row-major, the
weight in FullyConnected's ``(num_hidden, input_dim)`` layout), accumulates
exactly in int32:

* without scales the int32 accumulator comes back (the TPU's
  ``_mm_i32_kernel``; launch counter ``int8_matmul``);
* with ``scale_a`` (scalar) and/or ``scale_b`` (scalar or per output
  channel [N]) the epilogue writes ``f32(acc) · s[n]`` with ``s = 1 ·
  scale_a · scale_b`` built in f32 as the TPU wrapper builds it, so the
  dequantized f32 result leaves the kernel once (``_mm_dequant_kernel``;
  launch counter ``int8_matmul_dequant``).

Both are bit-exact against the XLA lowering ``int8_matmul_lax``: the int32
sum is exact in any order (below 2^31; past it both wrap), and the epilogue
is one rounding of the int32 to f32 and one f32 product.

On a CUDA tensor :func:`int8_matmul` launches ``csrc/int8_matmul.cu``; on a
CPU tensor it runs :func:`int8_matmul_reference`.  The source has two
variants, and :func:`plan_int8_matmul` picks one by layout alone, with its
tiles and its split of K:

* ``wgmma`` — tensor cores through wgmma, fed by TMA, with split-K for the
  classifier heads' small M: every input TMA can read (K and both row
  strides multiples of 16 bytes, both bases 16-byte aligned:
  :func:`_tma_aligned`);
* ``mma`` — mma.sync tiles: everything else (K odd, an offset view).

Each launch counts as ``kernels.launch.int8_matmul`` (or
``int8_matmul_dequant``) and as ``<that>.wgmma`` / ``<that>.mma``.  Split-K
stays bit-exact: int32 addition with wraparound is associative, so partial
sums over disjoint K ranges added in any order give the one pass's bits.
Each split stores its partial tile into an int32 workspace, and a second
kernel of the same source adds them and writes the result (counted as
``<that>.reduce``), so the dequant form scales only the complete sum.
"""
from __future__ import annotations

import collections
import ctypes
import fractions

import torch

from . import _build
from .common import count_launch, register_impl, select_impl, sm_count

__all__ = ["int8_matmul", "int8_matmul_reference", "plan_int8_matmul"]

_WGMMA_BLOCK_M = 128         # rows of M per CTA: two consumer warpgroups
_WGMMA_BLOCK_K = 128         # K bytes per tile: one 128-byte swizzled row
_MMA_BLOCK_K = 64
_MIN_K_TILES_PER_SPLIT = 2


def _dequant_scale(scale_a, scale_b, n, device):
    """``1 · scale_a · scale_b`` in f32, as an [n] vector, or None."""
    if scale_a is None and scale_b is None:
        return None
    s = torch.ones((), dtype=torch.float32, device=device)
    for v in (scale_a, scale_b):
        if v is not None:
            s = s * torch.as_tensor(v, dtype=torch.float32, device=device)
    if s.numel() not in (1, n):
        raise ValueError("int8_matmul: the scales hold %d values, expected "
                         "1 or N = %d" % (s.numel(), n))
    return s.reshape(-1).expand(n)


def int8_matmul_reference(a, b, scale_a=None, scale_b=None):
    """Plain version: an int32 matmul on the CPU; on the card, where integer
    ``mm`` is not supported, an f64 matmul (exact: |acc| < 127²·K < 2^53)
    cast to int64 and then to int32, which wraps past 2^31 as the int32
    sum does."""
    if a.device.type == "cuda":
        acc = torch.matmul(a.to(torch.float64), b.to(torch.float64).t()).to(
            torch.int64).to(torch.int32)
    else:
        acc = torch.matmul(a.to(torch.int32), b.to(torch.int32).t())
    s = _dequant_scale(scale_a, scale_b, b.shape[0], a.device)
    return acc if s is None else acc.to(torch.float32) * s


class Int8Plan(collections.namedtuple(
        "Int8Plan", "variant block_m block_n splits k_tiles_per_split")):
    """How one int8 matmul runs on the card.  ``variant``: ``"wgmma"`` or
    ``"mma"``; ``block_m`` x ``block_n``: the output tile of one CTA;
    ``splits``: the K splits over a grid axis, each ``k_tiles_per_split``
    tiles of K (128 bytes for wgmma, 64 for mma; the last split may be
    shorter, none is empty)."""


def _cdiv(a, b):
    return -(-a // b)


def plan_int8_matmul(M, N, K, num_sms, aligned=True):
    """The plan for ``[M, K] x [N, K]`` on a card with ``num_sms`` SMs.

    ``aligned`` (what TMA can read: :func:`_tma_aligned`) takes the
    ``wgmma`` variant, anything else the ``mma`` one (128 x 128 tiles when
    they fill the card, 64 x 64 otherwise; no split).  wgmma tiles are 128
    rows of M (two warpgroups) by ``block_n`` columns:

    * when the output holds at least one wave of 128 x 128 tiles, 256 or
      128 columns, whichever fills its waves better (256 on a tie), and no
      split (2048^3: 128 x 256, one wave of 128 CTAs);
    * below that (the classifier heads, M <= 128), 256, 128 or 64 columns
      and K split over a grid axis, at least two K tiles a split, so that
      the CTAs fill as much of one wave as they can.

    Ties go to the fewest splits, then to the fewest column tiles, then to
    the fewest columns computed past N.  Each split writes an int32 [M, N]
    partial that a second kernel reads back, which on an H100 costs more
    than the extra reads of A from the L2: at VGG16's fc6 (M 128, K 25088,
    N 4096) 64 columns x 2 splits beat 256 x 8 by about a fifth
    (``int8_plan_probe.py`` times each plan).
    """
    if not aligned:
        big = _cdiv(M, 128) * _cdiv(N, 128) >= num_sms
        bm = 128 if big else 64
        return Int8Plan("mma", bm, bm, 1, _cdiv(K, _MMA_BLOCK_K))
    k_tiles = _cdiv(K, _WGMMA_BLOCK_K)
    row_tiles = _cdiv(M, _WGMMA_BLOCK_M)
    full = row_tiles * _cdiv(N, 128) >= num_sms
    best = None
    for bn in ((256, 128) if full else (256, 128, 64)):
        tiles = row_tiles * _cdiv(N, bn)
        splits = 1
        if tiles < num_sms:
            splits = max(1, min(num_sms // tiles,
                                k_tiles // _MIN_K_TILES_PER_SPLIT))
        per = _cdiv(k_tiles, splits)
        splits = _cdiv(k_tiles, per)          # no empty split
        ctas = tiles * splits
        fill = fractions.Fraction(ctas, _cdiv(ctas, num_sms) * num_sms)
        # then the fewest splits, then the fewest column tiles, then the
        # fewest padded columns
        key = (fill, -splits, -tiles, -bn * _cdiv(N, bn))
        if best is None or key > best[0]:
            best = (key, Int8Plan("wgmma", _WGMMA_BLOCK_M, bn, splits, per))
    return best[1]


def _tma_aligned(a, b):
    """Whether the wgmma variant's TMA copies can read ``a`` [M, K] and
    ``b`` [N, K] (K-contiguous): K and both row strides multiples of 16
    bytes, both bases 16-byte aligned."""
    K = a.shape[1]
    return (K % 16 == 0 and a.stride(0) % 16 == 0 and b.stride(0) % 16 == 0
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


def _configure(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mxt_int8_mm_mma.argtypes = [vp, vp, vp, i, vp, i, vp, i, i, i, ll,
                                    ll, ll, i, vp]
    lib.mxt_int8_mm_mma.restype = ctypes.c_int
    lib.mxt_int8_mm_wgmma.argtypes = [vp, vp, vp, i, vp, i, vp, vp, i, i, i,
                                      ll, ll, ll, i, i, i, vp]
    lib.mxt_int8_mm_wgmma.restype = ctypes.c_int
    lib.mxt_int8_mm_error_string.argtypes = [ctypes.c_int]
    lib.mxt_int8_mm_error_string.restype = ctypes.c_char_p


def _scale_operands(scale_a, scale_b, n, device):
    """The dequant scales as the kernels read them, or None without any:
    ``(scale_a, a_step, scale_b, b_step)``, each scale a flat f32 tensor on
    ``device`` (or None) with the step 0 where it holds one value for all
    N and 1 where it holds one per output channel.  The kernels form
    ``scale_a[n·a_step] · scale_b[n·b_step]`` in f32, which is the product
    :func:`_dequant_scale` builds (``1 · a · b``; the 1 is exact), so no
    kernel of the wrapper forms it first.  Raises where
    :func:`_dequant_scale` would."""
    if scale_a is None and scale_b is None:
        return None
    out, shapes = [], []
    for v in (scale_a, scale_b):
        if v is None:
            out += [None, 0]
            continue
        t = torch.as_tensor(v, dtype=torch.float32, device=device)
        shapes.append(t.shape)
        out += [t.reshape(-1).contiguous(), int(t.numel() > 1)]
    count = torch.Size(torch.broadcast_shapes(*shapes)).numel()
    if count not in (1, n) or any(t is not None and t.numel() not in (1, n)
                                  for t in out[::2]):
        raise ValueError("int8_matmul: the scales hold %d values, expected "
                         "1 or N = %d" % (count, n))
    return tuple(out)


def _operands(a, b, scale_a, scale_b):
    """Check the operands of a launch; returns ``(a, b, s, out)`` with
    ``a`` and ``b`` K-contiguous, ``s`` the dequant scales as the kernels
    read them (:func:`_scale_operands`, or None) and ``out`` the empty
    [M, N] result (int32, or f32 with a scale)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("int8_matmul: operands must be int8, got %s and %s"
                        % (a.dtype, b.dtype))
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError("int8_matmul: shapes %s x %s, expected [M, K] x "
                         "[N, K]" % (tuple(a.shape), tuple(b.shape)))
    if b.device != a.device:
        raise ValueError("int8_matmul: b on %s, a on %s" % (b.device,
                                                            a.device))
    M, K = a.shape
    N = b.shape[0]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError("int8_matmul: dimensions %s too large" % ((M, N,
                                                                    K),))
    a = a if a.stride(1) == 1 else a.contiguous()
    b = b if b.stride(1) == 1 else b.contiguous()
    s = _scale_operands(scale_a, scale_b, N, a.device)
    out = torch.empty((M, N), dtype=torch.int32 if s is None
                      else torch.float32, device=a.device)
    return a, b, s, out


def _launch(variant, a, b, s, out, plan=None):
    """Launch ``variant`` on operands checked by :func:`_operands` (wgmma
    with ``plan``, by default :func:`plan_int8_matmul`'s); counts the
    launch as ``int8_matmul`` (or ``int8_matmul_dequant``) and as
    ``<that>.<variant>``, and split-K's second kernel as
    ``<that>.reduce``.  Returns ``out``."""
    M, K = a.shape
    N = b.shape[0]
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    if variant == "wgmma" and not _tma_aligned(a, b):
        raise ValueError("int8_matmul (wgmma variant): needs K and both row "
                         "strides multiples of 16 and 16-byte-aligned "
                         "bases; got K %d, strides %d / %d, offsets %d / %d"
                         % (K, a.stride(0), b.stride(0), a.data_ptr() % 16,
                            b.data_ptr() % 16))
    lib = _build.load("int8_matmul", _configure)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    name = "int8_matmul" if s is None else "int8_matmul_dequant"
    sa, a_step, sb, b_step = s or (None, 0, None, 0)
    sp = (None if sa is None else sa.data_ptr(), a_step,
          None if sb is None else sb.data_ptr(), b_step)
    if variant == "mma":
        count_launch(name)
        count_launch(name + ".mma")
        rc = lib.mxt_int8_mm_mma(a.data_ptr(), b.data_ptr(), *sp,
                                 out.data_ptr(), M, N, K, a.stride(0),
                                 b.stride(0), out.stride(0),
                                 sm_count(a.device), stream)
    else:
        plan = plan or plan_int8_matmul(M, N, K, sm_count(a.device))
        ws = None            # split-K: one int32 [M, N] slice per split
        if plan.splits > 1:
            ws = torch.empty(plan.splits * M * N, dtype=torch.int32,
                             device=a.device)
        count_launch(name)
        count_launch(name + ".wgmma")
        if plan.splits > 1:              # and the kernel that adds them
            count_launch(name + ".reduce")
        rc = lib.mxt_int8_mm_wgmma(a.data_ptr(), b.data_ptr(), *sp,
                                   out.data_ptr(),
                                   None if ws is None else ws.data_ptr(), M,
                                   N, K, a.stride(0), b.stride(0),
                                   out.stride(0), plan.block_n, plan.splits,
                                   plan.k_tiles_per_split, stream)
    _build.check(lib, "mxt_int8_mm", rc)
    return out


def _int8_mm_mma_cuda(a, b, scale_a=None, scale_b=None):
    """The ``mma`` variant of ``csrc/int8_matmul.cu`` (mma.sync; any
    layout) on CUDA int8 tensors ``a`` [M, K] and ``b`` [N, K]."""
    return _launch("mma", *_operands(a, b, scale_a, scale_b))


def _int8_mm_wgmma_cuda(a, b, scale_a=None, scale_b=None):
    """The ``wgmma`` variant of ``csrc/int8_matmul.cu`` (wgmma, TMA,
    split-K), with :func:`plan_int8_matmul`'s tiles, on CUDA int8 tensors
    that TMA can read (:func:`_tma_aligned`; raises otherwise)."""
    return _launch("wgmma", *_operands(a, b, scale_a, scale_b))


def _int8_matmul_cuda(a, b, scale_a=None, scale_b=None):
    """The int8 matmul on CUDA tensors: the variant :func:`plan_int8_matmul`
    names for the operands' shapes and layout."""
    a, b, s, out = _operands(a, b, scale_a, scale_b)
    (M, K), N = a.shape, b.shape[0]
    if not (M and N and K):
        return _launch("mma", a, b, s, out)      # empty: nothing to launch
    plan = plan_int8_matmul(M, N, K, sm_count(a.device), _tma_aligned(a, b))
    return _launch(plan.variant, a, b, s, out, plan)


def int8_matmul(a, b, scale_a=None, scale_b=None):
    """``a`` [M, K] int8 × ``b`` [N, K] int8 → [M, N]: the int32
    accumulator without scales, ``f32(acc) · scale_a · scale_b[n]`` with
    them.  The CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    fn, _ = select_impl("int8_matmul", a)
    return fn(a, b, scale_a, scale_b)


register_impl("int8_matmul", cuda=_int8_matmul_cuda,
              reference=int8_matmul_reference)
