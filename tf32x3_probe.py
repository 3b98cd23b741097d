#!/usr/bin/env python3
"""Where the tf32x3 flash kernels' time goes, on one NVIDIA card.

The measurements that the design of the tf32x3 kernels
(``mxnet_tpu_torch/ops/kernels/csrc/flash_attention_tf32x3.cu``, the
forward; ``flash_attention_bwd_tf32x3.cu``, dQ and dK/dV) rests on:

* the rate ``mma.sync`` reaches: m16n8k8 TF32 and m16n8k16 bf16 products
  with f32 accumulation, operands in registers, eight independent
  accumulators a warp, one CTA of 8 or 16 warps an SM; and the TF32 rate
  with the kernels' operand split (``split_tf32``: two ops a value) of 16
  values beside every 24 products, the ratio of the kernels' score loop;
* each phase's share of the forward, the dQ and the dK/dV kernel at [1,
  4096, 16, 256] causal f32, and of the tf32x3_xwide forward, dQ and
  dK/dV (the same kernels in 2-CTA clusters that split D) at the f32
  hd512 training leg's [2, 8192, 2, 512] causal: a copy of each source in
  which thread 0 of every CTA reads ``clock64`` at each phase boundary of
  every streamed tile and adds the cycles to a per-phase sum (its barrier
  waits included: the phases of warp 0, which computes p), beside the
  launch's device time.  One phase is all but empty outside a cluster:
  meeting the peer CTA (the partial scores pushed to the peer, the wait
  for the peer's, their sum), the exchange's share; the waits for the
  streamed tiles are the copies' share; and the ptxas registers and
  spills of the forward's four instantiations (tf32x3 and tf32x3_xwide at
  192 and 256 columns a CTA);

and two design choices, each timed in turns: the forward's at [1, 4096,
16, 256] and [1, 8192, 4, 256] causal f32 with the errors of both against
the plain version: the value tile's and the next key tile's copies issued
a few pieces at each step of the first half of a product loop (the built
kernel, ``copy_step``), against each tile's copies issued at once before
the loop (``copy_rows``, as the backward issues them); and tf32x3_xwide's
exchange of partial scores between the two CTAs of a cluster at [2, 8192,
2, 512] and [1, 4096, 16, 384] causal f32, dQ and dK/dV: each warp
pushing its partials into the peer's exchange tile (st.async, per-warp
mbarriers; the built kernel) against each reading the peer's in place
(ld.shared::cluster) between two cluster barriers a tile, with both
plans' gradients compared bit for bit.  Last, tf32x3_xwide's dK/dV at 256
columns a CTA, the most registers of the eight instantiations, with its
output products' k-steps fully unrolled (as built) and unrolled by two:
the ptxas registers and spills of each, and the two timed in turns at
[2, 8192, 2, 512].  The copies are
built in a temporary directory; the port's own build is untouched.

With ``--narrow`` it measures instead the narrow plans at head_dim 64 and
128: first the forward's (``NarrowFwd``: warps a CTA, keys a tile,
n-blocks a chunk of P.V, q split once into registers or as it loads;
``NARROW_FWD_PLANS``, five sets, the first as built), each one's ptxas
registers and spills and every set timed in turns at the shapes below
with its errors against the plain version at [2, 1024, 8, D], then each
phase's share of the built forward at [1, 8192, 16, 64] and [1, 4096,
16, 128] (``NARROW_FWD_PHASES``); then the backward's (dQ and dK/dV,
``NarrowDq`` / ``NarrowDkv``): five sets of
plan candidates (warps a CTA, 16-row blocks a warp, streamed rows a tile,
n-blocks a chunk of the output products; ``NARROW_PLANS``, the first as
built), each one's ptxas registers and spills, dQ and dK/dV of every set
timed in turns at [2, 1024, 8, D] and at [1, 8192, 16, 64] / [1, 4096,
16, 128] causal f32, with their errors against the plain backward; then
the score products' k-loop unrolled by two (as built) and fully, and dQ's
dP issued before p (as built) and after, the same way; then each phase's
share of the built dQ and dK/dV at [1, 8192, 16, 64] and [1, 4096, 16,
128] (``NARROW_DQ_PHASES``, ``NARROW_DKV_PHASES``).  The timings use
chip_smoke.py's ``_time_ms`` (a CUDA graph over input copies past the L2
cache).

It prints one JSON line per measurement, then the card's name and power
limit.  Run from the root of a checkout, with one card::

    python3 tf32x3_probe.py            # the measurements above
    python3 tf32x3_probe.py --narrow   # the narrow plan's

It exits non-zero without a CUDA device.
"""
import ctypes
import functools
import importlib
import json
import os
import subprocess
import sys
import tempfile

MMA_SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void tf32(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void bf16(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}
// kind 0: TF32, 1: bf16, 2: TF32 with 16 values split a 24 products
template <int KIND>
__global__ void rate(float* out, int iters, float seed) {
  float v[16];
  for (int i = 0; i < 16; ++i) v[i] = seed * (threadIdx.x + i);
  uint32_t a[4], al[4], b[2], bl[2];
  for (int i = 0; i < 4; ++i) split(v[i], a[i], al[i]);
  for (int i = 0; i < 2; ++i) split(v[4 + i], b[i], bl[i]);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
    if (KIND == 2) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        uint32_t h, l;
        v[i] += 1.0f;
        split(v[i], h, l);
        if (i < 4) { a[i] = h; al[i] = l; }
        else if (i < 6) { b[i - 4] = h; bl[i - 4] = l; }
        else { a[i & 3] ^= h; al[i & 3] ^= l; }
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (KIND == 1) bf16(d[j], a, b);
        else tf32(d[j], k == 0 ? al : a, k == 1 ? bl : b);
      }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 4; ++i) s += d[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" float mma_rate_ms(int kind, int warps, int ctas, int iters) {
  float* out;
  cudaMalloc(&out, (size_t)ctas * warps * 32 * sizeof(float));
  void (*k)(float*, int, float) =
      kind == 0 ? rate<0> : kind == 1 ? rate<1> : rate<2>;
  k<<<ctas, warps * 32>>>(out, 16, 1e-3f);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  k<<<ctas, warps * 32>>>(out, iters, 1e-3f);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
'''

# (line of the kernel's tile loop, label of the phase that ends after it);
# the first entry's tick, before the line, ends the previous tile's last
# phase (the forward's output product; the backward's copy issue)
FWD_PHASES = [
    ("    cp_async_wait<0>();\n    __syncthreads();          // the key tile "
     "is in", "p.v with the next key tile's copy issue, acc * alpha (the "
     "tile before)"),
    ("                              // product no longer reads V, X or "
     "alpha\n", "wait for the key tile (barrier)"),
    ("    cp_async_commit();        // the value tile\n",
     "scores (64 keys, half of D) with the value tile's copy issue"),
    ("    __syncthreads();          // partials are in; K is no longer "
     "read\n", "trade halves (barrier)"),
    ("                lane, f);\n", "read the partner's half; meet the peer "
     "CTA (push, wait for its partials; tf32x3_xwide only)"),
    ("    __syncthreads();          // p, alpha and the value tile are in\n",
     "softmax, wait for the value tile (barrier)"),
]
DQ_PHASES = [
    ("    half_ready(wp);\n", "copy issue (the tile before)"),
    ("    half_ready(wp);\n", "wait for the streamed tile"),
    ("    score_half<D>(A, Bt, g, t, s);\n", "scores (S, half of D)"),
    ("    meet_halves(X, wd, g, t, s, f);  // barrier: V is no longer "
     "read\n", "meet the other half (barrier)"),
    ("      meet_peer(X + 16 * wd * XS, full, full + 64, (k0 / BS) & 1, "
     "lane, f);\n", "meet the peer CTA (push, wait for its partials)"),
    ("    if constexpr (CL == 2) __syncwarp();    // every lane has read "
     "Xw\n", "p, dp - delta, V copy issue"),
    ("    __syncthreads();              // p and dp - delta are in\n",
     "put p, dp - delta (barrier)"),
    ("    out_product<D, true>(Xp, Xd, scale, Ks + c0, g, t, acc);\n",
     "dQ += ds.K"),
    ("    __syncthreads();              // K and the exchange are no longer "
     "read\n", "barrier"),
]
DKV_PHASES = [
    ("    half_ready(wp);\n", "copy issue (the tile before)"),
    ("    half_ready(wp);\n", "wait for the streamed tile"),
    ("    score_half<D>(A, Bt, g, t, s);\n", "scores (S^T, half of D)"),
    ("    meet_halves(X, wd, g, t, s, f);\n", "meet the other half (barrier)"),
    ("                lane, f);\n",
     "meet the peer CTA (push, wait for its partials)"),
    ("    if constexpr (CL == 2) __syncwarp();    // every lane has read "
     "Xw\n", "p, dp - delta"),
    ("    __syncthreads();              // p^T and dp^T - delta are in\n",
     "put p, dp - delta (barrier)"),
    ("    out_product<D, false>(Xp, Xd, scale, dOs + c0, g, t, dv_acc);\n",
     "dV += p^T.dO"),
    ("    __syncthreads();              // dO is no longer read\n",
     "barrier, dO copy issue"),
    ("    out_product<D, true>(Xp, Xd, scale, Qs + c0, g, t, dk_acc);\n",
     "dK += ds^T.Q"),
    ("    __syncthreads();              // Q and the exchange are no longer "
     "read\n", "barrier"),
]


def _tick(base, i, who="threadIdx.x == 0"):
    return ("    if (%s) { const unsigned long long _c = "
            "clock64(); if (_t) atomicAdd(&g_prof[%d], _c - _t); _t = _c; }"
            "\n" % (who, base + i))


def _instrument(src, kernel, end_marker, phases, base,
                loop_marker="\n  for (int ", who="threadIdx.x == 0"):
    """``src`` with ticks at ``phases`` inside ``kernel``'s tile loop (the
    first line at ``loop_marker``), summing into ``g_prof[base + i]``, and
    ``g_prof[base + 15]`` counting tiles; ``who``: the thread that ticks."""
    k0 = src.index(kernel + "(")
    k1 = src.index(end_marker, k0)
    body = src[k0:k1]
    first, label = phases[0]
    at = body.index(first)
    body = (body[:at] + _tick(base, 0, who) + "    if (%s) "
            "atomicAdd(&g_prof[%d], 1ull);\n" % (who, base + 15)
            + body[at:])
    pos = 0
    for i, (line, _) in enumerate(phases[1:], 1):
        at = body.index(line, pos) + len(line)
        body = body[:at] + _tick(base, i, who) + body[at:]
        pos = at
    loop = body.index(loop_marker) + 1
    body = body[:loop] + "  unsigned long long _t = 0;\n" + body[loop:]
    return src[:k0] + body + src[k1:]


def _edited_library(fa, build, tmp, name, edit, configure, tag):
    """The source ``name`` as ``edit(src)`` returns it, built into ``tmp``
    (``tag`` names the copy) and loaded."""
    csrc = os.path.join(os.path.dirname(fa.__file__), "csrc")
    src = edit(open(os.path.join(csrc, name + ".cu")).read())
    path = os.path.join(tmp, "%s_%s.cu" % (name, tag))
    open(path, "w").write(src)
    so = path[:-3] + ".so"
    out = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o",
                          so, path], check=True, capture_output=True,
                         text=True)
    lib = ctypes.CDLL(so)
    configure(lib)
    lib.ptxas_log = out.stdout + out.stderr
    return lib


def _profiled_library(fa, build, tmp, name, instrument, configure):
    """The source ``name`` with ``instrument(src)``'s ticks and a
    ``prof_io`` entry point, built into ``tmp`` and loaded."""
    def edit(src):
        src = src.replace("namespace {\n", "namespace {\n__device__ "
                          "unsigned long long g_prof[32];\n", 1)
        return instrument(src) + (
            'extern "C" int prof_io(unsigned long long* h, int zero) {\n'
            '  return (int)(zero ? cudaMemcpyToSymbol(g_prof, h, 256)\n'
            '                    : cudaMemcpyFromSymbol(h, g_prof, 256));\n'
            '}\n')

    lib = _edited_library(fa, build, tmp, name, edit, configure, "prof")
    lib.prof_io.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


# the built forward's copy issue, spread over its product loops, and the
# edits that issue each tile's copies at once before the loop instead
COPY_AT_ONCE = [
    ("    copy_step<D, D / 32>(vc, d / 8);\n", ""),
    ("    if (copy) copy_step<D, BS / 16>(kc, kk / 8);\n", ""),
    ("    score_half<D>(Qw, Kw,",
     "    copy_rows<D>(Vs, vb, st.s[7], k0, BS, Tk, threadIdx.x, NT);\n"
     "    score_half<D>(Qw, Kw,"),
    ("    out_product<D>(X, Vs + c0,",
     "    if (more)\n      copy_rows<D>(Ks, kb, st.s[4], k0 + BS, BS, Tk, "
     "threadIdx.x, NT);\n    out_product<D>(X, Vs + c0,"),
]


# tf32x3_xwide's exchange as first built: each warp puts its CTA's partial
# in its own exchange tile, and after a cluster barrier reads the peer's in
# place; a second barrier phase, waited on before p is put, keeps the
# peer's reads ahead of that write
EXCHANGE_IN_PLACE_MEET = """__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void meet_peer(float* Xw, uint32_t full,
                                          uint32_t vacant, uint32_t parity,
                                          int lane, float (&f)[4][4]) {
  const int g = lane >> 2, t = lane & 3;
  put(Xw, g, t, f);
  cluster_arrive();
  cluster_wait();
  const uint32_t peer = cluster_map(
      static_cast<uint32_t>(__cvta_generic_to_shared(Xw)),
      cluster_ctarank() ^ 1u);
  float2 u[4], w[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const uint32_t x = peer + 4u * (g * XS + 8 * n + 2 * t);
    u[n] = ld_cluster_f2(x);
    w[n] = ld_cluster_f2(x + 4u * 8 * XS);
  }
  cluster_arrive();
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    f[n][0] += u[n].x;
    f[n][1] += u[n].y;
    f[n][2] += w[n].x;
    f[n][3] += w[n].y;
  }
}

"""


def _exchange_in_place(src):
    # an overload of hopper.cuh's meet_peer template: the call's exact
    # match, so the kernels take it
    at = src.index("template <int D>\n__device__ __forceinline__ void zero(")
    src = src[:at] + EXCHANGE_IN_PLACE_MEET + src[at:]
    old = "    if constexpr (CL == 2) __syncwarp();    // every lane has read Xw\n"
    if src.count(old) != 2:
        raise SystemExit("tf32x3_probe: the backward's source no longer "
                         "holds %r twice" % old)
    return src.replace(old, "    if constexpr (CL == 2) cluster_wait();\n")


def _exchange_choice(torch, fa, build, tmp):
    """tf32x3_xwide's dQ and dK/dV as built (the partials pushed) and with
    the partials read in place, in turns: built, in place, in place, built;
    each time the mean of 3 launches between CUDA events after one warm
    launch; the two plans' gradients compared bit for bit."""
    name = "flash_attention_bwd_tf32x3"
    configure = functools.partial(fa._configure_bwd_source, name)
    libs = {"pushed (st.async, per-warp mbarriers)": build.load(
                name, configure),
            "read in place (two cluster barriers a tile)": _edited_library(
                fa, build, tmp, name, _exchange_in_place, configure,
                "inplace")}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for B, T, H, D in ((2, 8192, 2, 512), (1, 4096, 16, 384)):
        q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                       for _ in range(4))
        o, lse = fa._flash_cuda(q, k, v, True)
        delta = fa._delta(o, do, None)
        for kind, fn in (("dq", fa._flash_dq_tf32x3_xwide_cuda),
                         ("dkv", fa._flash_dkv_tf32x3_xwide_cuda)):
            rec = {"backward": kind, "shape": [B, T, H, D], "causal": True,
                   "dtype": "float32", "variant": "tf32x3_xwide"}
            order = list(libs) + list(libs)[::-1]
            outs = {}
            for choice in order:
                build._LIBS[name] = libs[choice]
                call = functools.partial(fn, q, k, v, do, lse, delta, True,
                                         D ** -0.5)
                outs[choice] = call()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(3):
                    call()
                b.record()
                b.synchronize()
                rec.setdefault(choice, {"ms_turns": []})["ms_turns"].append(
                    a.elapsed_time(b) / 3)
            first, second = (outs[c] for c in libs)
            if kind == "dq":
                first, second = (first,), (second,)
            rec["same_bits"] = all(torch.equal(x, y)
                                   for x, y in zip(first, second))
            print(json.dumps(rec), flush=True)
            del outs, first, second
        build._LIBS[name] = libs[list(libs)[0]]


UNROLL_BY_TWO = ("#pragma unroll\n  for (int kk = 0; kk < BS; kk += 8) {",
                 "#pragma unroll 2\n  for (int kk = 0; kk < BS; kk += 8) {")


def _unrolled_by_two(src):
    old, new = UNROLL_BY_TWO
    if src.count(old) != 1:
        raise SystemExit("tf32x3_probe: the backward's source no longer "
                         "holds %r once" % old)
    return src.replace(old, new)


def _dkv_256_cluster_line(log):
    """The ptxas registers and spills of dK/dV<256, 2> in a build log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "flash_dkv_tf32x3_kernelILi256ELi2E" in line and "Compiling" in line:
            return " ".join(ln.split(":", 1)[-1].strip()
                            for ln in lines[i + 2:i + 4])
    return None


def _ptxas_lines(log, kernel):
    """``kernel``'s instantiations in a build log: the mangled name's
    template arguments, registers and spills, one string each."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if kernel in line and "Compiling entry function" in line:
            name = line.split("'")[1]
            args = name[name.index(kernel) + len(kernel):]
            out.append("%s%s: %s" % (kernel, args, " ".join(
                ln.split(":", 1)[-1].strip() for ln in lines[i + 2:i + 4])))
    return out


def _unroll_choice(torch, fa, build, tmp):
    """tf32x3_xwide's dK/dV at 256 columns a CTA with its output k-steps
    fully unrolled (as built) and unrolled by two: each one's ptxas line,
    then both in turns at [2, 8192, 2, 512] (built, by two, by two, built;
    the mean of 3 launches after a warm one each time), their gradients
    bit for bit."""
    name = "flash_attention_bwd_tf32x3"
    configure = functools.partial(fa._configure_bwd_source, name)
    by_two = _edited_library(fa, build, tmp, name, _unrolled_by_two,
                             configure, "unroll2")
    libs = {"fully unrolled (built)": build.load(name, configure),
            "unrolled by two": by_two}
    print(json.dumps({"dkv<256,2> ptxas": {
        "fully unrolled (built)": _dkv_256_cluster_line(
            build.build([name])[name]["log"]),
        "unrolled by two": _dkv_256_cluster_line(by_two.ptxas_log)}}),
        flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    B, T, H, D = 2, 8192, 2, 512
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = fa._flash_cuda(q, k, v, True)
    delta = fa._delta(o, do, None)
    rec = {"backward": "dkv", "shape": [B, T, H, D], "causal": True,
           "dtype": "float32", "variant": "tf32x3_xwide"}
    outs = {}
    for choice in list(libs) + list(libs)[::-1]:
        build._LIBS[name] = libs[choice]
        call = functools.partial(fa._flash_dkv_tf32x3_xwide_cuda, q, k, v,
                                 do, lse, delta, True, D ** -0.5)
        outs[choice] = call()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(3):
            call()
        b.record()
        b.synchronize()
        rec.setdefault(choice, {"ms_turns": []})["ms_turns"].append(
            a.elapsed_time(b) / 3)
    first, second = (outs[c] for c in libs)
    rec["same_bits"] = all(torch.equal(x, y) for x, y in zip(first, second))
    print(json.dumps(rec), flush=True)
    build._LIBS[name] = libs["fully unrolled (built)"]


def _copies_at_once(src):
    for old, new in COPY_AT_ONCE:
        if src.count(old) != 1:
            raise SystemExit("tf32x3_probe: the forward's source no longer "
                             "holds %r once" % old)
        src = src.replace(old, new)
    return src


def _copy_issue_choice(torch, fa, build, tmp):
    """The forward as built (copies spread over the product loops) and with
    each tile's copies issued at once, in turns: built, at once, at once,
    built; each time the mean of 5 launches between CUDA events after one
    warm launch; and each one's largest error against the plain version."""
    name = "flash_attention_tf32x3"
    configure = functools.partial(fa._configure_fwd_source, name)
    libs = {"copies spread over the product loops": build.load(
                name, configure),
            "copies at once before the loops": _edited_library(
                fa, build, tmp, name, _copies_at_once, configure, "atonce")}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for B, T, H, D in ((1, 4096, 16, 256), (1, 8192, 4, 256)):
        q, k, v = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                   for _ in range(3))
        ro, rlse = fa.flash_attention_reference(q, k, v, True,
                                                return_lse=True)
        rec = {"forward": [B, T, H, D], "causal": True, "dtype": "float32"}
        order = list(libs) + list(libs)[::-1]
        for choice in order:
            build._LIBS[name] = libs[choice]
            o, lse = fa._flash_tf32x3_cuda(q, k, v, True)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(5):
                fa._flash_tf32x3_cuda(q, k, v, True)
            b.record()
            b.synchronize()
            rec.setdefault(choice, {"ms_turns": []})["ms_turns"].append(
                a.elapsed_time(b) / 5)
            rec[choice]["o_max_abs_err"] = float((o - ro).abs().max())
            rec[choice]["lse_max_abs_err"] = float((lse - rlse).abs().max())
        build._LIBS[name] = libs[order[0]]
        print(json.dumps(rec), flush=True)


# the narrow plan's candidates (csrc/flash_attention_bwd_tf32x3.cu,
# ``NarrowDq<D>`` and ``NarrowDkv<D>`` at 64 and 128: warps a CTA, 16-row
# blocks a warp, streamed rows a tile, n-blocks a chunk of the output
# products), one library a set of four, the first as built
NARROW_LINES = {(kind, D): "struct Narrow%s<%d> : Plan<%%d, %%d, %%d, %%d> {};"
                % (kind, D) for kind in ("Dq", "Dkv") for D in (64, 128)}
NARROW_PLANS = [
    {("Dq", 64): (4, 1, 64, 8), ("Dkv", 64): (4, 1, 64, 8),
     ("Dq", 128): (8, 1, 32, 8), ("Dkv", 128): (8, 1, 32, 4)},
    {("Dq", 64): (4, 2, 32, 4), ("Dkv", 64): (4, 2, 16, 4),
     ("Dq", 128): (4, 2, 16, 2), ("Dkv", 128): (4, 1, 32, 4)},
    {("Dq", 64): (4, 2, 32, 8), ("Dkv", 64): (4, 2, 32, 2),
     ("Dq", 128): (2, 2, 16, 2), ("Dkv", 128): (8, 1, 16, 4)},
    {("Dq", 64): (8, 1, 32, 8), ("Dkv", 64): (8, 1, 64, 8),
     ("Dq", 128): (8, 1, 32, 16), ("Dkv", 128): (4, 1, 16, 4)},
    {("Dq", 64): (8, 1, 64, 8), ("Dkv", 64): (4, 1, 64, 4),
     ("Dq", 128): (4, 1, 16, 8), ("Dkv", 128): (8, 1, 32, 2)},
]
NARROW_SHAPES = ((2, 1024, 8, 64), (1, 8192, 16, 64), (2, 1024, 8, 128),
                 (1, 4096, 16, 128))


# the narrow kernels' phases, as DQ_PHASES
NARROW_DQ_PHASES = [
    ("    if (k0 + BS < k_end) {            // the next tile into the other "
     "stage\n", "barrier: the stage is no longer read (the tile before)"),
    ("    __syncthreads();                  // this tile is in, every "
     "thread's part\n", "next tile's copy issue, wait for this tile "
     "(barrier)"),
    ("      score_rows<D, BS, M>(Qw, Ks, g, t, p);\n", "S = Q.K^T"),
    ("      score_rows<D, BS, M>(Ow, Vs, g, t, ds);\n", "dP = dO.V^T"),
    ("      out_rows<D, BS, P::NC, M>(ds, Ks, g, t, acc);\n",
     "p, ds, dQ += ds.K"),
]
NARROW_DKV_PHASES = [
    ("    if (q0 + BS < Tq) {               // the next tile into the other "
     "stage\n", "barrier: the stage is no longer read (the tile before)"),
    ("    __syncthreads();                  // this tile is in, every "
     "thread's part\n", "next tile's copy issue, wait for this tile "
     "(barrier)"),
    ("      score_rows<D, BS, M>(Kw, Qs, g, t, p);              // S^T = K "
     ". Q^T\n", "S^T = K.Q^T"),
    ("      out_rows<D, BS, P::NC, M>(p, dOs, g, t, dv_acc);    // dV += "
     "p^T . dO\n", "p^T, dV += p^T.dO"),
    ("      score_rows<D, BS, M>(Vw, dOs, g, t, ds);            // dP^T = V "
     ". dO^T\n", "dP^T = V.dO^T"),
    ("      out_rows<D, BS, P::NC, M>(ds, Qs, g, t, dk_acc);    // dK += "
     "ds^T . Q\n", "ds^T, dK += ds^T.Q"),
]


def _narrow_instrumented(src):
    src = _instrument(src, "flash_dq_tf32x3_narrow_kernel",
                      "// st: q (0-2), k (3-5), v (6-8), dO (9-11), dK",
                      NARROW_DQ_PHASES, 0, loop_marker="\n  int s = 0;\n")
    return _instrument(src, "flash_dkv_tf32x3_narrow_kernel",
                       "Strides copy_strides", NARROW_DKV_PHASES, 16,
                       loop_marker="\n  int s = 0;\n")


def _narrow_phases(torch, fa, build, tmp):
    """Each phase's share of the narrow dQ and dK/dV kernels as built (warp
    0's clock64 at each phase boundary of every streamed tile, summed over
    the CTAs), causal f32 at the f32 long-context leg's [1, 8192, 16, 64]
    and at [1, 4096, 16, 128], beside the instrumented launch's time."""
    name = "flash_attention_bwd_tf32x3"
    lib = _profiled_library(fa, build, tmp, name, _narrow_instrumented,
                            functools.partial(fa._configure_bwd_source,
                                              name))
    built = build._LIBS.get(name)
    build._LIBS[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(5)
    buf = (ctypes.c_ulonglong * 32)()
    for B, T, H, D in ((1, 8192, 16, 64), (1, 4096, 16, 128)):
        q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                       for _ in range(4))
        o, lse = fa._flash_cuda(q, k, v, True)
        delta = fa._delta(o, do, None)
        for kind, fn, phases, base in (
                ("dq", fa._flash_dq_tf32x3_cuda, NARROW_DQ_PHASES, 0),
                ("dkv", fa._flash_dkv_tf32x3_cuda, NARROW_DKV_PHASES, 16)):
            fn(q, k, v, do, lse, delta, True, D ** -0.5)
            torch.cuda.synchronize()
            lib.prof_io(ctypes.cast((ctypes.c_ulonglong * 32)(),
                                    ctypes.c_void_p), 1)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(q, k, v, do, lse, delta, True, D ** -0.5)
            b.record()
            b.synchronize()
            lib.prof_io(ctypes.cast(buf, ctypes.c_void_p), 0)
            cycles = [buf[base + i] for i in range(len(phases))]
            tiles = buf[base + 15]
            print(json.dumps({
                "kernel": kind + " narrow", "shape": [B, T, H, D],
                "causal": True, "dtype": "float32",
                "ms_instrumented": a.elapsed_time(b), "tiles": tiles,
                "phases": [{"phase": label, "share": c / sum(cycles),
                            "cycles_a_tile": c / tiles}
                           for (_, label), c in zip(phases, cycles)]}),
                flush=True)
    if built is not None:
        build._LIBS[name] = built


def _narrow_plan(src, plan):
    for key, line in NARROW_LINES.items():
        built = line % NARROW_PLANS[0][key]
        if src.count(built) != 1:
            raise SystemExit("tf32x3_probe: the backward's source no longer "
                             "holds %r once" % built)
        src = src.replace(built, line % plan[key])
    return src


def _candidate_libraries(fa, build, tmp, name, candidates, configure):
    """The source ``name`` as each of ``candidates`` edits it (``(record,
    edit)``: ``edit(src)`` gives the candidate's source, the first the
    built one's), all built into ``tmp`` at once and loaded: each one's
    ``record`` printed with the ptxas line of each narrow kernel."""
    import chip_smoke

    csrc = os.path.join(os.path.dirname(fa.__file__), "csrc")
    src = open(os.path.join(csrc, name + ".cu")).read()
    procs = []
    for i, (_, edit) in enumerate(candidates):
        path = os.path.join(tmp, "%s_narrow%d.cu" % (name, i))
        open(path, "w").write(edit(src))
        procs.append((path[:-3] + ".so", subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = []
    for (so, proc), (record, _) in zip(procs, candidates):
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit("tf32x3_probe: nvcc failed:\n" + log)
        lib = ctypes.CDLL(so)
        configure(lib)
        libs.append(lib)
        print(json.dumps(dict(record, ptxas=[
            line for kernel, line in chip_smoke._ptxas_summary(log)
            if "narrow" in kernel])), flush=True)
    return libs


def _narrow_choice(torch, fa, build, tmp, candidates):
    """The narrow backward kernels built from each of ``candidates``
    (:func:`_candidate_libraries`), then dQ and dK/dV of every candidate in
    turns at ``NARROW_SHAPES`` causal f32 (each candidate once in order and
    once in reverse; chip_smoke.py's ``_time_ms``: a CUDA graph over input
    copies past the L2 cache), with each one's largest error against the
    plain backward at [2, 1024, 8, D] with an lse cotangent."""
    import chip_smoke

    name = "flash_attention_bwd_tf32x3"
    configure = functools.partial(fa._configure_bwd_source, name)
    libs = _candidate_libraries(fa, build, tmp, name, candidates, configure)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for B, T, H, D in NARROW_SHAPES:
        q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                       for _ in range(4))
        o, lse = fa._flash_cuda(q, k, v, True)
        dlse = (torch.randn(B, H, T, generator=gen, device="cuda")
                if T <= 1024 else None)
        delta = fa._delta(o, do, dlse)
        want = (fa.flash_attention_bwd_reference(q, k, v, o, lse, do, dlse,
                                                 True)
                if dlse is not None else None)
        args = chip_smoke._copies((q, k, v, do, lse, delta))
        rec = {"backward": [B, T, H, D], "causal": True, "dtype": "float32",
               "dlse": dlse is not None}
        order = list(range(len(libs))) + list(range(len(libs)))[::-1]
        for kind, launch in (("dq", fa._flash_dq_tf32x3_cuda),
                             ("dkv", fa._flash_dkv_tf32x3_cuda)):
            turns = [[] for _ in libs]
            for i in order:
                build._LIBS[name] = libs[i]
                turns[i].append(chip_smoke._time_ms(
                    lambda *a: launch(*a, True, D ** -0.5), args))
            rec[kind + "_ms_turns"] = turns
        if want is not None:
            errs = []
            for lib in libs:
                build._LIBS[name] = lib
                got = (fa._flash_dq_tf32x3_cuda(q, k, v, do, lse, delta,
                                                True, D ** -0.5),
                       *fa._flash_dkv_tf32x3_cuda(q, k, v, do, lse, delta,
                                                  True, D ** -0.5))
                errs.append([float((a - b).abs().max())
                             for a, b in zip(got, want)])
            rec["max_abs_err_dq_dk_dv"] = errs
        print(json.dumps(rec), flush=True)
    build._LIBS[name] = libs[0]


# the narrow forward's candidates (csrc/flash_attention_tf32x3.cu,
# ``NarrowFwd<D>`` at 64 and 128: warps a CTA, keys a tile, n-blocks a
# chunk of P.V, q's fragments split once into registers), one library a
# set of two, the first as built
NARROW_FWD_LINE = "struct NarrowFwd<%d> : FwdPlan<%d, %d, %d, %d> {};"
NARROW_FWD_PLANS = [
    {64: (4, 64, 8, 1), 128: (8, 64, 8, 0)},
    {64: (8, 64, 8, 1), 128: (4, 32, 8, 0)},
    {64: (4, 32, 8, 1), 128: (8, 32, 8, 0)},
    {64: (8, 32, 8, 1), 128: (4, 64, 16, 0)},
    {64: (4, 64, 8, 0), 128: (8, 32, 16, 0)},
]
# the narrow forward's phases, as FWD_PHASES
NARROW_FWD_PHASES = [
    ("    if (k0 + BS < k_end) {            // the next tile into the other "
     "stage\n", "barrier: the stage is no longer read (the tile before)"),
    ("    __syncthreads();                  // this tile is in, every "
     "thread's part\n", "next tile's copy issue, wait for this tile "
     "(barrier)"),
    ("      score_rows<D, BS, P::QR>(Qw, Ks, g, t, qh, ql, f);\n",
     "S = Q.K^T (the first tile: q's fragments too)"),
    ("        l_run[j] = l_run[j] * alpha[j] + rs[j];\n      }\n",
     "mask, running max, p, running sum"),
    ("      pv_rows<D, BS, P::NC>(f, Vs, alpha[0], alpha[1], g, t, acc);\n",
     "acc = acc * alpha + P.V"),
]


def _narrow_fwd_plan(src, plan):
    for D in (64, 128):
        built = NARROW_FWD_LINE % ((D,) + NARROW_FWD_PLANS[0][D])
        if src.count(built) != 1:
            raise SystemExit("tf32x3_probe: the forward's source no longer "
                             "holds %r once" % built)
        src = src.replace(built, NARROW_FWD_LINE % ((D,) + plan[D]))
    return src


def _narrow_fwd_choice(torch, fa, build, tmp):
    """The narrow forward built from each of ``NARROW_FWD_PLANS``
    (:func:`_candidate_libraries`), then every candidate in turns at
    ``NARROW_SHAPES`` causal f32 (once in order and once in reverse;
    chip_smoke.py's ``_time_ms``), with each one's largest o and lse errors
    against the plain version at [2, 1024, 8, D]."""
    import chip_smoke

    name = "flash_attention_tf32x3"
    configure = functools.partial(fa._configure_fwd_source, name)
    libs = _candidate_libraries(fa, build, tmp, name, [
        ({"narrow forward plan": {"%d" % D: dict(zip(
            ("warps", "keys_a_tile", "n_blocks_a_chunk", "q_in_registers"),
            plan[D])) for D in plan}}, functools.partial(_narrow_fwd_plan,
                                                         plan=plan))
        for plan in NARROW_FWD_PLANS], configure)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for B, T, H, D in NARROW_SHAPES:
        q, k, v = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                   for _ in range(3))
        args = chip_smoke._copies((q, k, v))
        rec = {"forward": [B, T, H, D], "causal": True, "dtype": "float32"}
        order = list(range(len(libs))) + list(range(len(libs)))[::-1]
        turns = [[] for _ in libs]
        for i in order:
            build._LIBS[name] = libs[i]
            turns[i].append(chip_smoke._time_ms(
                lambda q, k, v: fa._flash_tf32x3_cuda(q, k, v, True), args))
        rec["ms_turns"] = turns
        if T <= 1024:
            ro, rlse = fa.flash_attention_reference(q, k, v, True,
                                                    return_lse=True)
            errs = []
            for lib in libs:
                build._LIBS[name] = lib
                o, lse = fa._flash_tf32x3_cuda(q, k, v, True)
                errs.append([float((o - ro).abs().max()),
                             float((lse - rlse).abs().max())])
            rec["max_abs_err_o_lse"] = errs
        print(json.dumps(rec), flush=True)
    build._LIBS[name] = libs[0]


def _narrow_fwd_phases(torch, fa, build, tmp):
    """Each phase's share of the narrow forward as built (the last warp's
    clock64 at each phase boundary of every key tile, summed over the CTAs:
    under the causal mask it walks the most tiles), causal f32 at the f32
    long-context leg's [1, 8192, 16, 64] and at [1, 4096, 16, 128], beside
    the instrumented launch's time."""
    name = "flash_attention_tf32x3"
    lib = _profiled_library(
        fa, build, tmp, name, lambda src: _instrument(
            src, "flash_fwd_tf32x3_narrow_kernel",
            "template <int D>\nint launch_narrow(", NARROW_FWD_PHASES, 0,
            loop_marker="\n  int s = 0;\n",
            who="threadIdx.x == blockDim.x - 32"),
        functools.partial(fa._configure_fwd_source, name))
    built = build._LIBS.get(name)
    build._LIBS[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(7)
    buf = (ctypes.c_ulonglong * 32)()
    for B, T, H, D in ((1, 8192, 16, 64), (1, 4096, 16, 128)):
        q, k, v = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                   for _ in range(3))
        fa._flash_tf32x3_cuda(q, k, v, True)
        torch.cuda.synchronize()
        lib.prof_io(ctypes.cast((ctypes.c_ulonglong * 32)(),
                                ctypes.c_void_p), 1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fa._flash_tf32x3_cuda(q, k, v, True)
        b.record()
        b.synchronize()
        lib.prof_io(ctypes.cast(buf, ctypes.c_void_p), 0)
        cycles = [buf[i] for i in range(len(NARROW_FWD_PHASES))]
        tiles = buf[15]
        print(json.dumps({
            "kernel": "fwd narrow", "shape": [B, T, H, D], "causal": True,
            "dtype": "float32", "ms_instrumented": a.elapsed_time(b),
            "tiles": tiles,
            "phases": [{"phase": label, "share": c / sum(cycles),
                        "cycles_a_tile": c / tiles}
                       for (_, label), c in zip(NARROW_FWD_PHASES, cycles)]}),
            flush=True)
    if built is not None:
        build._LIBS[name] = built


def _plan_record(plan):
    return {"narrow plan": {"%s<%d>" % key: dict(zip(
        ("warps", "row_blocks", "streamed_rows", "n_blocks_a_chunk"),
        plan[key])) for key in plan}}


# the score products' k-loop as built, and the other of its two forms
# (unrolled by two, fully unrolled); and dQ's dP = dO.V^T issued after p is
# formed, where the built kernel issues it right after S (so that p's
# exponentials can run beside its products)
SCORE_UNROLL = ("#pragma unroll 2\n  for (int d = 0; d < D; d += 8) {\n"
                "    uint32_t ah[M][4], al[M][4];",
                "#pragma unroll\n  for (int d = 0; d < D; d += 8) {\n"
                "    uint32_t ah[M][4], al[M][4];")
DQ_DP = ("      // dP first: p's exponentials then run beside its last "
         "products\n      score_rows<D, BS, M>(Ow, Vs, g, t, ds);\n")
DQ_DS_LOOP = ("#pragma unroll\n      for (int m = 0; m < M; ++m)\n"
              "#pragma unroll\n        for (int n = 0; n < BS / 8; ++n)\n"
              "#pragma unroll\n          for (int i = 0; i < 4; ++i)\n"
              "            ds[m][n][i] =\n")


def _other_unroll(src):
    built = next(form for form in SCORE_UNROLL if src.count(form) == 1)
    return src.replace(built, SCORE_UNROLL[1 - SCORE_UNROLL.index(built)])


def _dq_dp_after_p(src):
    for text in (DQ_DP, DQ_DS_LOOP):
        if src.count(text) != 1:
            raise SystemExit("tf32x3_probe: the backward's source no longer "
                             "holds %r once" % text)
    src = src.replace(DQ_DP, "")
    return src.replace(DQ_DS_LOOP, "      score_rows<D, BS, M>(Ow, Vs, g, t, "
                       "ds);\n" + DQ_DS_LOOP)


def _bwd_instrumented(src):
    src = _instrument(src, "flash_dq_tf32x3_kernel",
                      "// st: q (0-2), k (3-5), v (6-8), dO (9-11), dK",
                      DQ_PHASES, 0)
    return _instrument(src, "flash_dkv_tf32x3_kernel", "Strides copy_strides",
                       DKV_PHASES, 16)


def _fwd_instrumented(src):
    return _instrument(src, "flash_fwd_tf32x3_kernel", "template <int D, "
                       "int CL>\nint launch(", FWD_PHASES, 0,
                       loop_marker="\n  for (int k0 = 0;")


def main():
    import torch

    from mxnet_tpu_torch.ops.kernels import _build
    fa = importlib.import_module(
        "mxnet_tpu_torch.ops.kernels.flash_attention")

    if not torch.cuda.is_available():
        raise SystemExit("tf32x3_probe: no CUDA device is available")
    with tempfile.TemporaryDirectory(prefix="tf32x3_probe_") as tmp:
        if "--narrow" in sys.argv[1:]:
            _narrow_fwd_choice(torch, fa, _build, tmp)
            _narrow_fwd_phases(torch, fa, _build, tmp)
            _narrow_choice(torch, fa, _build, tmp, [
                (_plan_record(plan), functools.partial(_narrow_plan,
                                                       plan=plan))
                for plan in NARROW_PLANS])
            _narrow_choice(torch, fa, _build, tmp, [
                ({"score k-loop": "as built", "dQ": "dP before p (built)"},
                 lambda src: src),
                ({"score k-loop": "the other form",
                  "dQ": "dP before p (built)"}, _other_unroll),
                ({"score k-loop": "the other form", "dQ": "dP after p"},
                 lambda src: _dq_dp_after_p(_other_unroll(src))),
                ({"score k-loop": "as built", "dQ": "dP after p"},
                 _dq_dp_after_p)])
            _narrow_phases(torch, fa, _build, tmp)
        else:
            _run(torch, fa, _build, tmp)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


def _run(torch, fa, build, tmp):
    """The measurements, with the libraries built into ``tmp``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    path = os.path.join(tmp, "mma.cu")
    open(path, "w").write(MMA_SRC)
    so = os.path.join(tmp, "mma.so")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so, path],
                   check=True, capture_output=True)
    mma = ctypes.CDLL(so)
    mma.mma_rate_ms.argtypes = [ctypes.c_int] * 4
    mma.mma_rate_ms.restype = ctypes.c_float
    iters = 2048
    for kind, name, flops in (
            (0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
            (1, "bf16 m16n8k16", 2 * 16 * 8 * 16),
            (2, "tf32 m16n8k8, 16 values split a 24", 2 * 16 * 8 * 8)):
        for warps in (8, 16):
            ms = mma.mma_rate_ms(kind, warps, sms, iters)
            total = flops * 24.0 * iters * warps * sms
            print(json.dumps({"mma_sync": name, "warps_per_sm": warps,
                              "ms": ms, "tflops": total / ms / 1e9}),
                  flush=True)

    _copy_issue_choice(torch, fa, build, tmp)
    _exchange_choice(torch, fa, build, tmp)
    _unroll_choice(torch, fa, build, tmp)
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, T, H, D = 1, 4096, 16, 256
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = fa._flash_cuda(q, k, v, True)
    delta = fa._delta(o, do, None)
    # the forward's registers and spills, tf32x3 and tf32x3_xwide
    for line in _ptxas_lines(build.build(["flash_attention_tf32x3"])[
            "flash_attention_tf32x3"]["log"], "flash_fwd_tf32x3_kernel"):
        print(json.dumps({"ptxas": line}), flush=True)
    fwd_lib = _profiled_library(
        fa, build, tmp, "flash_attention_tf32x3", _fwd_instrumented,
        functools.partial(fa._configure_fwd_source,
                          "flash_attention_tf32x3"))
    bwd_lib = _profiled_library(
        fa, build, tmp, "flash_attention_bwd_tf32x3", _bwd_instrumented,
        functools.partial(fa._configure_bwd_source,
                          "flash_attention_bwd_tf32x3"))
    build._LIBS["flash_attention_tf32x3"] = fwd_lib
    build._LIBS["flash_attention_bwd_tf32x3"] = bwd_lib
    # the tf32x3_xwide backward at the f32 hd512 leg's shape
    xB, xT, xH, xD = 2, 8192, 2, 512
    xq, xk, xv, xdo = (torch.randn(xB, xT, xH, xD, generator=gen,
                                   device="cuda") for _ in range(4))
    xo, xlse = fa._flash_cuda(xq, xk, xv, True)
    xdelta = fa._delta(xo, xdo, None)
    buf = (ctypes.c_ulonglong * 32)()
    for name, lib, fn, phases, base, shape in (
            ("fwd", fwd_lib, lambda: fa._flash_tf32x3_cuda(q, k, v, True),
             FWD_PHASES, 0, [B, T, H, D]),
            ("dq", bwd_lib, lambda: fa._flash_dq_tf32x3_cuda(
                q, k, v, do, lse, delta, True, D ** -0.5), DQ_PHASES, 0,
             [B, T, H, D]),
            ("dkv", bwd_lib, lambda: fa._flash_dkv_tf32x3_cuda(
                q, k, v, do, lse, delta, True, D ** -0.5), DKV_PHASES, 16,
             [B, T, H, D]),
            ("fwd tf32x3_xwide", fwd_lib,
             lambda: fa._flash_tf32x3_xwide_cuda(xq, xk, xv, True),
             FWD_PHASES, 0, [xB, xT, xH, xD]),
            ("dq tf32x3_xwide", bwd_lib, lambda: fa._flash_dq_tf32x3_xwide_cuda(
                xq, xk, xv, xdo, xlse, xdelta, True, xD ** -0.5), DQ_PHASES,
             0, [xB, xT, xH, xD]),
            ("dkv tf32x3_xwide", bwd_lib,
             lambda: fa._flash_dkv_tf32x3_xwide_cuda(
                 xq, xk, xv, xdo, xlse, xdelta, True, xD ** -0.5),
             DKV_PHASES, 16, [xB, xT, xH, xD])):
        fn()
        torch.cuda.synchronize()
        lib.prof_io(ctypes.cast((ctypes.c_ulonglong * 32)(), ctypes.c_void_p),
                    1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        lib.prof_io(ctypes.cast(buf, ctypes.c_void_p), 0)
        cycles = [buf[base + i] for i in range(len(phases))]
        tiles = buf[base + 15]
        print(json.dumps({
            "kernel": name, "shape": shape, "causal": True,
            "dtype": "float32", "ms_instrumented": a.elapsed_time(b),
            "tiles": tiles,
            "phases": [{"phase": label, "share": c / sum(cycles),
                        "cycles_a_tile": c / tiles}
                       for (_, label), c in zip(phases, cycles)]}),
              flush=True)


if __name__ == "__main__":
    main()
