"""Batched block-sparse prefill attention with fused block stats (Ã).

For every (batch, query head, query-block row) the attention runs over the
kv blocks listed in ``indices[b, h, row, :counts[b, h, row]]`` only, against
un-expanded K/V ``(B, Hkv, Nkv, D)`` (query head ``h`` reads kv head
``h // G``), with the causal mask anchored at ``q_block_offset``: q row ``i``
of block ``row`` is global position ``(q_block_offset + row)·bs + i``.  For
heads with ``stats_gate[b, h]`` set, it also returns Ã: for every visited
block, the mean of the scaled logits over its causally valid entries; −inf
for every block not visited, for gated-off heads, and for blocks with no
valid entry.  Rows with ``counts == 0`` output zeros.

Each row visits ``min(counts, steps)`` blocks, where ``steps`` is the row's
step budget in the reference's ragged schedule (``min(causal bound, W)``),
so the semantics equal the TPU kernel's exactly.

  * :func:`block_sparse_attention_plain` — the plain PyTorch version
    (dense logits per (batch, head), masked to the listed blocks), and the
    path for CPU tensors;
  * :func:`block_sparse_attention_cuda` — the hand-written kernel
    ``csrc/block_sparse_attn.cu`` (replaces the TPU kernel
    ``repro/kernels/block_sparse_attn.py::block_sparse_attention_batched``);
  * :func:`block_sparse_attention_batched` — the dispatcher.

All return ``(out (B, H, N, D) in q's dtype, Ã (B, H, NBq, NBkv) f32)``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.indices import table_block_mask

NEG_INF = float("-inf")


def _visited(indices, counts, *, nbkv: int, causal: bool,
             q_block_offset: int) -> torch.Tensor:
    """Per-row visited step counts: min(counts, ragged-schedule steps)."""
    nbq, w = indices.shape[-2], indices.shape[-1]
    rows = torch.arange(nbq, device=indices.device)
    if causal:
        steps = torch.clamp(q_block_offset + rows + 1, max=w)
    else:
        steps = torch.full_like(rows, w)
    steps = torch.clamp(steps, min=1, max=nbkv)
    return torch.minimum(counts, steps.to(counts.dtype))


def block_sparse_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    indices: torch.Tensor, counts: torch.Tensor, *, block_size: int,
    causal: bool = True, stats_gate: Optional[torch.Tensor] = None,
    q_block_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, one (batch, head) at a time to bound the (N, Nkv)
    float32 logits it holds."""
    b, h, n, d = q.shape
    hkv, nkv = k.shape[1], k.shape[2]
    g = h // hkv
    bs = block_size
    nbq, nbkv = n // bs, nkv // bs
    off = nbkv - nbq if q_block_offset is None else int(q_block_offset)
    scale = 1.0 / (d ** 0.5)
    gate = (torch.ones((b, h), dtype=torch.bool, device=q.device)
            if stats_gate is None else stats_gate.to(torch.bool))
    visit = table_block_mask(
        indices, _visited(indices, counts, nbkv=nbkv, causal=causal,
                          q_block_offset=off), nbkv)      # (B, H, NBq, NBkv)
    qpos = off * bs + torch.arange(n, device=q.device)
    kpos = torch.arange(nkv, device=q.device)
    tok_valid = (kpos[None, :] <= qpos[:, None] if causal
                 else torch.ones((n, nkv), dtype=torch.bool, device=q.device))
    tv_blocks = tok_valid.reshape(nbq, bs, nbkv, bs)
    n_valid = tv_blocks.sum(dim=(1, 3))                   # (NBq, NBkv)

    out = torch.empty((b, h, n, v.shape[-1]), dtype=q.dtype, device=q.device)
    a_tilde = torch.full((b, h, nbq, nbkv), NEG_INF, dtype=torch.float32,
                         device=q.device)
    for bi in range(b):
        for hi in range(h):
            kf = k[bi, hi // g].float()
            vf = v[bi, hi // g].float()
            logits = (q[bi, hi].float() @ kf.T) * scale   # (N, Nkv)
            vis = visit[bi, hi].repeat_interleave(bs, 0) \
                .repeat_interleave(bs, 1)
            ok = vis & tok_valid
            masked = logits.masked_fill(~ok, NEG_INF)
            m = masked.amax(dim=-1, keepdim=True)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            p = torch.where(ok, torch.exp(masked - m), torch.zeros_like(m))
            denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
            out[bi, hi] = ((p / denom) @ vf).to(q.dtype)
            if gate[bi, hi]:
                lg = logits.reshape(nbq, bs, nbkv, bs)
                s = torch.where(tv_blocks, lg, 0.0).sum(dim=(1, 3))
                mean = torch.where(n_valid > 0,
                                   s / torch.clamp(n_valid, min=1), NEG_INF)
                a_tilde[bi, hi] = torch.where(visit[bi, hi], mean, NEG_INF)
    return out, a_tilde


def block_sparse_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    indices: torch.Tensor, counts: torch.Tensor, *, block_size: int,
    causal: bool = True, stats_gate: Optional[torch.Tensor] = None,
    q_block_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel (``csrc/block_sparse_attn.cu``) on CUDA tensors; raises
    on what it does not take."""
    b, h, n, d = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != b \
            or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"block-sparse attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    hkv, nkv = k.shape[1], k.shape[2]
    bs = block_size
    if n % bs or nkv % bs:
        raise ValueError(f"block-sparse kernel needs block-aligned lengths "
                         f"(N={n}, Nkv={nkv}, bs={bs})")
    if bs not in (64, 128) or d not in (64, 128):
        raise ValueError(f"block-sparse kernel takes bs, D in (64, 128); "
                         f"got bs={bs}, D={d}")
    nbq, nbkv = n // bs, nkv // bs
    w = indices.shape[-1]
    if tuple(indices.shape) != (b, h, nbq, w) \
            or tuple(counts.shape) != (b, h, nbq):
        raise ValueError(f"tables {tuple(indices.shape)} / "
                         f"{tuple(counts.shape)} vs grid ({b}, {h}, {nbq})")
    tensors = (q, k, v, indices, counts)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("block-sparse kernel takes CUDA tensors on one "
                         "device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("block-sparse kernel: q, k, v dtypes differ")
    if indices.dtype != torch.int32 or counts.dtype != torch.int32:
        raise ValueError("block-sparse kernel takes int32 tables")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("block-sparse kernel takes contiguous tensors")
    gate = (torch.ones((b, h), dtype=torch.int32, device=q.device)
            if stats_gate is None
            else stats_gate.to(device=q.device, dtype=torch.int32)
            .contiguous())
    if tuple(gate.shape) != (b, h):
        raise ValueError(f"stats_gate {tuple(gate.shape)} vs ({b}, {h})")
    off = nbkv - nbq if q_block_offset is None else int(q_block_offset)
    out = torch.empty_like(q)
    a_tilde = torch.full((b, h, nbq, nbkv), NEG_INF, dtype=torch.float32,
                         device=q.device)
    lib = _build.load("block_sparse_attn")
    fn = lib.repro_block_sparse_attn
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p]
    code = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
              _build.ptr(indices), _build.ptr(counts), _build.ptr(gate),
              _build.ptr(out), _build.ptr(a_tilde), _build.dtype_code(q),
              b, h, hkv, n, nkv, d, bs, w, off, int(causal),
              _build.stream_of(q))
    _build.check(code, "block-sparse attention kernel")
    block_sparse_attention_cuda.launches += 1
    return out, a_tilde


block_sparse_attention_cuda.launches = 0


def block_sparse_attention_batched(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    indices: torch.Tensor, counts: torch.Tensor, *, block_size: int,
    causal: bool = True, stats_gate: Optional[torch.Tensor] = None,
    q_block_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = (block_sparse_attention_cuda if q.is_cuda
          else block_sparse_attention_plain)
    return fn(q, k, v, indices, counts, block_size=block_size,
              causal=causal, stats_gate=stats_gate,
              q_block_offset=q_block_offset)
