#!/usr/bin/env python3
"""Time variants of the port's strip kernel on one GPU.

    python3 scripts/torch_strip_variants.py

Compiles patched copies of ``src/repro_torch/csrc/strip.cu`` with the
build's own flags into ``build/strip_variants/<name>/``, holds each against
the plain version (max |Δ| and sample 0 alone bitwise against the batch's
slice), and times each call (CUDA events) and its two device kernels
(``torch.profiler``) on random bf16 inputs at the llama3-8b-262k shape of
``chip_smoke.py``'s phase 2 (H = 32, Hkv = 8, D = 128, bs = 128) at
N = 8192 (B = 2 and 1) and N = 2048 (B = 1), for several chunk sizes.
Variants:

  current  the source as it is (pass 2 stages each warp's probabilities in
           shared memory and writes 16-byte streaming stores);
  direct   pass 2 writes 8-byte streaming stores straight from the
           accumulator fragments.

It also times ``fill_`` of a float32 tensor the size of the B = 2 strip:
the write alone.  Needs a CUDA card and ``nvcc``; prints the card's name
and power limit.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# pass 2's epilogue in the current source, and its direct-store replacement
_STAGED_FROM = "      if (mask) tile_probs<true>("
_STAGED_TO = ("      __syncwarp();             "
              "// st is rewritten by the next sub-tile\n")
_DIRECT = """\
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float* o = out + cta.grow(a, cta.rho0 + 32 * warp + 16 * f + gq +
                                           8 * rr) * (size_t)N + k0 + 2 * tq;
#pragma unroll
          for (int nt = 0; nt < NN; ++nt) {
            float p[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              p[e] = exp2f(fmaf(s[f][nt][2 * rr + e], sl2, -M[f][rr])) *
                     inv[f][rr];
              if (mask && k0 + 2 * tq + nt * 8 + e > lim[f][rr]) p[e] = 0.f;
            }
            if (fv[f] && k0 + nt * 8 < N)
              __stcs(reinterpret_cast<float2*>(o + nt * 8),
                     make_float2(p[0], p[1]));
          }
        }
"""


def variant_sources() -> dict:
    src = open(os.path.join(ROOT, "src/repro_torch/csrc/strip.cu")).read()
    a, b = src.index(_STAGED_FROM), src.index(_STAGED_TO)
    return {"current": src,
            "direct": src[:a] + _DIRECT + src[b + len(_STAGED_TO):]}


def build(sources: dict) -> dict:
    """{name: the loaded repro_strip}; all variants compile in parallel."""
    from repro_torch.kernels import _build
    procs = {}
    for name, src in sources.items():
        d = os.path.join(ROOT, "build", "strip_variants", name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "strip.cu"), "w") as f:
            f.write(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", os.path.join(d, "libstrip.so"),
               os.path.join(d, "strip.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(ROOT, "build", "strip_variants",
                                       name, "libstrip.so"))
        fn = lib.repro_strip
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def call(fn, q, k, bs: int, chunk: int):
    import torch
    from repro_torch.kernels import _build
    b, h, nq, d = q.shape
    hkv, n = k.shape[1], k.shape[2]
    out = torch.empty((b, h, bs, n), dtype=torch.float32, device=q.device)
    ml = torch.empty((2, b, h, bs, -(-n // chunk)), dtype=torch.float32,
                     device=q.device)
    _build.check(fn(_build.ptr(q), _build.ptr(k), _build.ptr(out),
                    _build.ptr(ml), _build.dtype_code(q), b, h, hkv, nq, n,
                    d, bs, chunk, _build.stream_of(q)), "strip variant")
    return out


def pass_us(fn, reps: int = 10) -> dict:
    """Device µs per call of each pass (the template's second argument)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"strip_\w*kernel<\w+, (\d)>", e.key)
        if m:
            out[f"pass{m.group(1)}"] = round(cs._device_us(e) / reps, 2)
    return out


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.strip import strip_chunk, strip_scores
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    fns = build(variant_sources())
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *s: (torch.randn(s, generator=gen, device="cuda")
                       * 1.5).bfloat16()
    q, k = rand(2, 32, 8192, 128), rand(2, 8, 8192, 128)
    ref = strip_scores(q, k, 128)
    for name, fn in fns.items():
        out = call(fn, q, k, 128, strip_chunk(8192))
        same = torch.equal(call(fn, q[:1], k[:1], 128, strip_chunk(8192)),
                           out[:1])
        err = cs.max_err(out, ref)
        print(f"{name}: max_abs_err {err:.3e}, sample 0 alone bitwise "
              f"{same}", flush=True)
        if err > 1e-5 or not same:
            raise AssertionError(f"variant {name} is wrong")
    del ref, out
    q2, k2 = q[:1, :, :2048].contiguous(), k[:1, :, :2048].contiguous()
    cases = [(2, q, k, (512, 1024)), (1, q[:1], k[:1], (512, 1024)),
             (1, q2, k2, (128, 256, 512))]
    for rnd in range(2):
        for name, fn in fns.items():
            for b, qq, kk, chunks in cases:
                n = kk.shape[2]
                for chunk in chunks if name == "current" else \
                        (strip_chunk(n),):
                    ms = cs.cuda_ms(lambda: call(fn, qq, kk, 128, chunk), 20)
                    dev = pass_us(lambda: call(fn, qq, kk, 128, chunk))
                    print(f"round {rnd} {name} B={b} N={n} chunk={chunk}: "
                          f"{ms:.4f} ms, device us {dev}", flush=True)
    full = torch.empty((2, 32, 128, 8192), device="cuda")
    print(f"fill_ of the B=2 strip's 268 MB: "
          f"{cs.cuda_ms(lambda: full.fill_(1.0), 20):.4f} ms", flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
