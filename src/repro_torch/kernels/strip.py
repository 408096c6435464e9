"""Strip scores for SharePrefill's pattern estimation (paper Algorithm 3).

Each head's block pattern is estimated from its *last query block strip*:
softmax(Q̂ Kᵀ/√d) for Q̂ = Q[-block_size:] against all N keys, causally
masked (strip row r is global query N − block_size + r).

  * :func:`strip_scores` — the plain PyTorch version (float32 logits, the
    full (bs, N) logits in memory), and the path for CPU tensors;
  * :func:`strip_scores_cuda` — the hand-written kernel ``csrc/strip.cu``
    (replaces the TPU kernel ``repro/kernels/strip.py::strip_scores_pallas``),
    one call for the whole batch: two device kernels over a split of the
    keys into :func:`strip_chunk`-sized chunks (partial row statistics per
    chunk, then the merged, normalised write);
  * :func:`compute_strips` — the dispatcher: the kernel for CUDA tensors,
    the plain version for CPU tensors;
  * :func:`compute_strips_paged` — the dispatcher over one slot's paged KV
    (decode-pattern refresh).

All three are batched and GQA-native: q ``(B, H, Nq, D)`` with ``Nq ≥ bs``,
k ``(B, Hkv, N, D)``; query head ``h`` reads kv head ``h // (H // Hkv)``.
N, and with it the causal row offsets, always come from ``k``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import shard
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import gather_pages


def strip_scores(q: torch.Tensor, k: torch.Tensor,
                 block_size: int) -> torch.Tensor:
    """Plain version: (B, H, bs, N) float32 strips."""
    b, h, _, d = q.shape
    hkv, n = k.shape[1], k.shape[2]
    g = h // hkv
    q_hat = q[:, :, q.shape[2] - block_size:, :].float()
    # the GQA grouping, heads replicated first (the step bundles' DTensors
    # cannot split a heads axis sharded finer than the kv heads)
    q_hat = shard(q_hat, "batch")
    q_hat = q_hat.reshape(b, hkv, g, block_size, d)
    logits = torch.einsum("bkgqd,bknd->bkgqn", q_hat, k.float())
    logits = logits / math.sqrt(d)
    rows = torch.arange(block_size, device=q.device) + (n - block_size)
    cols = torch.arange(n, device=q.device)
    logits = logits.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return p.reshape(b, h, block_size, n)


def strip_chunk(n: int) -> int:
    """Keys per chunk of the kernel's key split for N = ``n`` keys: whole
    64-key sub-tiles, at most 8 chunks (on an H100, 8 chunks took 8–9 %
    less device time than 16 at N = 8192 and 28 % less at N = 2048:
    ``scripts/torch_strip_variants.py``).  It depends on N alone (never
    on the batch or the card), so a sample's strip is bitwise the same
    alone or in a batch."""
    return 64 * -(-n // 512)


def _check_tensors(q: torch.Tensor, k: torch.Tensor) -> None:
    """Device, dtype, layout and alignment rules of a launch."""
    if not (q.is_cuda and k.is_cuda and q.device == k.device):
        raise ValueError("strip kernel takes CUDA tensors on one device")
    if q.dtype != k.dtype:
        raise ValueError(f"strip: q {q.dtype} and k {k.dtype} differ")
    if not (q.is_contiguous() and k.is_contiguous()):
        raise ValueError("strip kernel takes contiguous q and k")
    if q.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError("strip kernel streams q and k as 16-byte vectors: "
                         "they must be 16-byte aligned")


def strip_scores_cuda(q: torch.Tensor, k: torch.Tensor,
                      block_size: int) -> torch.Tensor:
    """The strip kernel (``csrc/strip.cu``) on CUDA tensors; raises on
    what it does not take."""
    b, h, nq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"strip: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    hkv, n = k.shape[1], k.shape[2]
    if n % block_size or nq < block_size or block_size % 16:
        raise ValueError(f"strip kernel needs N % bs == 0 and Nq >= bs "
                         f"(N={n}, Nq={nq}, bs={block_size})")
    _check_tensors(q, k)
    chunk = strip_chunk(n)
    out = torch.empty((b, h, block_size, n), dtype=torch.float32,
                      device=q.device)
    # each row's (m, l) over each chunk, written by the first kernel
    ml = torch.empty((2, b, h, block_size, -(-n // chunk)),
                     dtype=torch.float32, device=q.device)
    fn = _build.function("strip", "repro_strip", 4, 9)
    code = fn(_build.ptr(q), _build.ptr(k), _build.ptr(out), _build.ptr(ml),
              _build.dtype_code(q), b, h, hkv, nq, n, d, block_size, chunk,
              _build.stream_of(q))
    _build.check(code, "strip kernel")
    strip_scores_cuda.launches += 1
    return out


strip_scores_cuda.launches = 0


def compute_strips(q: torch.Tensor, k: torch.Tensor, *,
                   block_size: int) -> torch.Tensor:
    """(B, H, bs, N) float32 strips: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.is_cuda:
        return strip_scores_cuda(q, k, block_size)
    return strip_scores(q, k, block_size)


def compute_strips_paged(q_hat: torch.Tensor, pool_k: torch.Tensor,
                         page_table: torch.Tensor, *, block_size: int,
                         num_blocks: int) -> torch.Tensor:
    """:func:`compute_strips` over one slot's paged KV: ``q_hat (H, bs,
    D)`` is the slot's window of its last ``bs`` decode queries
    (positions ``[n − bs, n)`` for ``n = num_blocks · bs``), K the first
    ``num_blocks`` pages of ``page_table (NB,)`` gathered from ``pool_k
    (P, Hkv, ps, D)``.  The gather moves page contents unchanged, so the
    strip is the one of the slot's contiguous cache.  Returns ``(H, bs,
    num_blocks · ps)`` float32: the strip kernel on CUDA tensors (which
    raises on a ragged tail), the plain version on CPU tensors."""
    k = gather_pages(pool_k, page_table[None, :num_blocks])
    return compute_strips(q_hat[None].contiguous(), k,
                          block_size=block_size)[0]
