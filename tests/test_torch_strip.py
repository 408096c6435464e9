"""The redesigned strip kernel's algorithm (``csrc/strip.cu``), on the CPU.

The CUDA body runs only on the card; this holds a plain mirror of its
arithmetic against the JAX package's Pallas strip kernel (interpret mode):
the keys cut into fixed chunks of whole 64-key sub-tiles, each row's
partial ``(m, l)`` per chunk in base 2 (online over the sub-tiles, as the
kernel's first pass runs), the partials merged in chunk order under the
−inf-safe rule, and the normalised write of the second pass.  Tolerance
1e-6, the one ``tests/test_torch_kernels.py`` holds the plain strip to
(probabilities ≤ 1 from the same float32 logits summed in another order).
Inputs are bf16-rounded, as the card's main path gives them.  It also pins
the chunk rule the wrapper passes to the kernel.
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.strip import strip_scores_pallas
from repro_torch.kernels.strip import strip_chunk

LOG2E = 1.4426950408889634
KN = 64          # keys per sub-tile of the kernel
INF = float("-inf")


def _finite(x):
    return torch.where(torch.isinf(x), torch.zeros_like(x), x)


def split_strip(q, k, bs: int, chunk: int):
    """Mirror of the kernel: q (B, H, Nq, D), k (B, Hkv, N, D) in float32;
    returns the (B, H, bs, N) strip and the per-chunk partials
    ``[(m, l)]`` (each (B, H, bs))."""
    b, h, nq, d = q.shape
    hkv, n = k.shape[1], k.shape[2]
    g = h // hkv
    sl2 = LOG2E / math.sqrt(d)
    qh = q[:, :, nq - bs:].reshape(b, hkv, g, bs, d)
    s = torch.einsum("bkgqd,bknd->bkgqn", qh, k).reshape(b, h, bs, n)
    ok = (torch.arange(n)[None, :]
          <= (n - bs + torch.arange(bs))[:, None])              # (bs, N)
    s = torch.where(ok, s, INF)
    parts = []
    for c0 in range(0, n, chunk):                 # pass 1: one chunk
        m = torch.full((b, h, bs), INF)
        l = torch.zeros((b, h, bs))
        for k0 in range(c0, min(c0 + chunk, n), KN):
            st = s[..., k0:min(k0 + KN, n)]
            m_new = torch.maximum(m, st.max(-1).values * sl2)
            p = torch.exp2(st * sl2 - _finite(m_new)[..., None])
            alpha = torch.where(torch.isinf(m), 0.0,
                                torch.exp2(m - _finite(m_new)))
            seen = ~torch.isinf(m_new)            # else nothing visible yet
            l = torch.where(seen, l * alpha + p.sum(-1), l)
            m = m_new
        parts.append((m, l))
    big = torch.stack([m for m, _ in parts]).max(0).values    # pass 2
    L = torch.zeros_like(big)
    for m, l in parts:
        L = L + torch.where(torch.isinf(m), 0.0,
                            l * torch.exp2(m - _finite(big)))
    p = torch.exp2(s * sl2 - _finite(big)[..., None])
    return p / torch.clamp(L, min=1e-30)[..., None], parts


@pytest.mark.parametrize("h,hkv,d", [
    pytest.param(4, 4, 64, id="4-4"),
    pytest.param(8, 2, 64, id="8-2"),
    # RecurrentGemma's head dim and group: the tensor-core body at D = 256
    # reloads Q's fragments from shared memory, the same split and merge
    pytest.param(16, 1, 256, id="16-1-256"),
])
@pytest.mark.parametrize("n,bs,chunk,nq", [
    (256, 64, 256, 256),     # one chunk
    (320, 64, 128, 352),     # a ragged last chunk (64 keys), Nq > bs rows
    (384, 128, 64, 416),     # chunk < bs: the first rows' last partial sees
                             # no key
    (208, 16, 128, 224),     # N % 64 != 0: a ragged last sub-tile (16 keys)
])
def test_split_strip_matches_pallas(h, hkv, d, n, bs, chunk, nq):
    rng = np.random.default_rng(21)
    b = 2
    bf = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).bfloat16().float()
    q, k = bf(b, h, nq, d), bf(b, hkv, n, d)
    ref = np.stack([np.asarray(strip_scores_pallas(
        jnp.asarray(q[i].numpy()), jnp.asarray(k[i].numpy()),
        block_size=bs, interpret=True)) for i in range(b)])
    got, parts = split_strip(q, k, bs, chunk)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    assert len(parts) == -(-n // chunk)
    # exact zeros above the causal diagonal
    rows = n - bs + np.arange(bs)
    hidden = np.arange(n)[None, :] > rows[:, None]
    assert (got.numpy()[..., hidden] == 0).all()
    masked = torch.isinf(parts[-1][0])
    if chunk < bs:          # rows r < bs - chunk see no key of the last chunk
        assert masked[..., :bs - chunk].all()
        assert not masked[..., bs - chunk:].any()
        assert (parts[-1][1][masked] == 0).all()
    else:
        assert not masked.any()


@pytest.mark.parametrize("n,chunk,chunks", [
    (2048, 256, 8),          # the scheduler's short bucket
    (8192, 1024, 8),         # the main path
    (8320, 1088, 8),         # the decode cache: a last chunk of 704 keys
])
def test_strip_chunk_rule(n, chunk, chunks):
    """Whole sub-tiles, at most 8 chunks, from N alone (no batch
    argument: the partition, and with it every row's arithmetic, is the
    same at any batch size)."""
    assert strip_chunk(n) == chunk and chunk % KN == 0
    assert -(-n // chunk) == chunks
    assert list(inspect.signature(strip_chunk).parameters) == ["n"]
