"""Block-sparse prefill attention with fused block stats (Ã).

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
    ``repro/kernels/block_sparse_attn.py::block_sparse_attention_batched``):
    bfloat16 runs its products on the tensor cores (at bs = 128 and
    D = 128 in the Hopper body, ``wgmma`` fed by TMA; the C function picks
    it from the shape and dtype), float32 on CUDA cores;
  * :func:`block_sparse_attention_batched` — the dispatcher.

All return ``(out (B, H, N, Dv) in q's dtype, Ã (B, H, NBq, NBkv) f32)``:
q and k have width Dqk, v and the output width Dv.  The kernel takes Dqk
= Dv in {64, 96, 128}, and (Dqk, Dv) = (192, 128) (DeepSeek-V2's MLA
prefill) in the batched and single-sample instances.
Two more instances of the same kernel, each with its plain version and
dispatcher:

  * :func:`block_sparse_attention_batched_paged` — K/V in a page pool
    ``(P, Hkv, bs, D)`` read through ``page_table (B, NBkv)``; tables,
    causal bounds and Ã stay logical, so the result is bitwise the
    contiguous path on :func:`~repro_torch.kernels.decode_attn.gather_pages`
    where both run one kernel body (not against the Hopper body, in bf16
    at bs = 128, D = 128) (replaces ``block_sparse_attention_batched_paged``);
  * :func:`block_sparse_attention_kernel` — the single-sample oracle kernel
    the reference reaches through ``attn_impl="kernel"``: q ``(H, N, D)``,
    uniform ``min(counts, W)`` steps per row (no causal bound), offset 0,
    every head's stats, returned compact as ``(H, NBq, W)`` (slot ``w`` of
    a row is its ``w``-th listed block; −inf for ``w ≥ counts``) — replaces
    ``block_sparse_attention_kernel``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import gather_pages
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


def _attend_visited(q, k, v, visit, *, block_size: int, causal: bool,
                    off: int, stats_heads):
    """The plain versions' core: q ``(B, H, N, D)`` against k/v ``(B, Hkv,
    Nkv, D)`` over the tokens of the ``visit (B, H, NBq, NBkv)`` blocks that
    are causally valid at offset ``off``, one (batch, head) at a time to
    bound the (N, Nkv) float32 logits it holds.  Returns the output and, for
    the heads with ``stats_heads[b, h]``, every block's mean scaled logit
    over its causally valid entries (−inf where it has none, and for the
    other heads)."""
    b, h, n, d = q.shape
    hkv, nkv = k.shape[1], k.shape[2]
    g = h // hkv
    bs = block_size
    nbq, nbkv = n // bs, nkv // bs
    scale = 1.0 / (d ** 0.5)
    qpos = off * bs + torch.arange(n, device=q.device)
    kpos = torch.arange(nkv, device=q.device)
    tok_valid = (kpos[None, :] <= qpos[:, None] if causal
                 else torch.ones((n, nkv), dtype=torch.bool, device=q.device))
    tv_blocks = tok_valid.reshape(nbq, bs, nbkv, bs)
    n_valid = tv_blocks.sum(dim=(1, 3))                   # (NBq, NBkv)

    out = torch.empty((b, h, n, v.shape[-1]), dtype=q.dtype, device=q.device)
    means = torch.full((b, h, nbq, nbkv), NEG_INF, dtype=torch.float32,
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
            if stats_heads[bi, hi]:
                lg = logits.reshape(nbq, bs, nbkv, bs)
                s = torch.where(tv_blocks, lg, 0.0).sum(dim=(1, 3))
                means[bi, hi] = torch.where(
                    n_valid > 0, s / torch.clamp(n_valid, min=1), NEG_INF)
    return out, means


def block_sparse_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    indices: torch.Tensor, counts: torch.Tensor, *, block_size: int,
    causal: bool = True, stats_gate: Optional[torch.Tensor] = None,
    q_block_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the batched kernel."""
    b, h, n, _ = q.shape
    nbq, nbkv = n // block_size, k.shape[2] // block_size
    off = nbkv - nbq if q_block_offset is None else int(q_block_offset)
    gate = (torch.ones((b, h), dtype=torch.bool, device=q.device)
            if stats_gate is None else stats_gate.to(torch.bool))
    visit = table_block_mask(
        indices, _visited(indices, counts, nbkv=nbkv, causal=causal,
                          q_block_offset=off), nbkv)      # (B, H, NBq, NBkv)
    out, means = _attend_visited(q, k, v, visit, block_size=block_size,
                                 causal=causal, off=off, stats_heads=gate)
    return out, torch.where(visit, means, NEG_INF)


# the (Dqk, Dv) pairs beyond the equal widths 64, 96 and 128 that the
# batched and single-sample instances take (not the paged one):
# RecurrentGemma's D = 256 and DeepSeek-V2's MLA prefill
WIDE_WIDTHS = ((256, 256), (192, 128))


def _check_shapes(what: str, q: torch.Tensor, hkv: int, nkv: int, d_kv: int,
                  block_size: int, d_v: Optional[int] = None, *,
                  wide: bool = True) -> None:
    """q ``(B, H, N, D)`` against K of ``Hkv`` heads, ``Nkv`` tokens and
    head dim ``d_kv``, and V of width ``d_v`` (default ``d_kv``): the sizes
    the kernel takes (``WIDE_WIDTHS`` too where ``wide``)."""
    n, d = q.shape[2], q.shape[3]
    d_v = d_kv if d_v is None else d_v
    if d_kv != d or q.shape[1] % hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} against {hkv} kv "
                         f"heads of dim {d_kv}")
    bs = block_size
    if n % bs or nkv % bs:
        raise ValueError(f"{what} kernel needs block-aligned lengths "
                         f"(N={n}, Nkv={nkv}, bs={bs})")
    wide_ok = WIDE_WIDTHS if wide else ()
    if bs not in (64, 128) or not (
            (d == d_v and d in (64, 96, 128)) or (d, d_v) in wide_ok):
        raise ValueError(f"{what} kernel takes bs in (64, 128) and D in "
                         f"(64, 96, 128), or (Dqk, Dv) in {wide_ok}; "
                         f"got bs={bs}, D={d}, Dv={d_v}")


def _check_tables(indices, counts, grid: tuple) -> int:
    """Tables of shape ``grid + (W,)`` and ``grid``; returns W."""
    w = indices.shape[-1]
    if tuple(indices.shape) != (*grid, w) or tuple(counts.shape) != grid:
        raise ValueError(f"tables {tuple(indices.shape)} / "
                         f"{tuple(counts.shape)} vs grid {grid}")
    return w


def _check_tensors(what: str, q, kv, tables) -> None:
    """Device, dtype and contiguity rules every launch shares."""
    tensors = (q, *kv, *tables)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{what} kernel takes CUDA tensors on one device")
    if not all(t.dtype == q.dtype for t in kv):
        raise ValueError(f"{what} kernel: q, k, v dtypes differ")
    if any(t.dtype != torch.int32 for t in tables):
        raise ValueError(f"{what} kernel takes int32 tables")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, *kv)):
        raise ValueError(f"{what} kernel streams q, k and v as 16-byte "
                         "vectors: they must be 16-byte aligned")


def _gate(stats_gate, b: int, h: int, device) -> torch.Tensor:
    gate = (torch.ones((b, h), dtype=torch.int32, device=device)
            if stats_gate is None
            else stats_gate.to(device=device, dtype=torch.int32).contiguous())
    if tuple(gate.shape) != (b, h):
        raise ValueError(f"stats_gate {tuple(gate.shape)} vs ({b}, {h})")
    return gate


def block_sparse_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    indices: torch.Tensor, counts: torch.Tensor, *, block_size: int,
    causal: bool = True, stats_gate: Optional[torch.Tensor] = None,
    q_block_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel (``csrc/block_sparse_attn.cu``) on CUDA tensors; raises
    on what it does not take."""
    b, h, n, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.dim() != 4 or v.dim() != 4 \
            or k.shape[0] != b:
        raise ValueError(f"block-sparse attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    hkv, nkv, dv = k.shape[1], k.shape[2], v.shape[3]
    _check_shapes("block-sparse", q, hkv, nkv, k.shape[3], block_size, dv)
    nbq, nbkv = n // block_size, nkv // block_size
    w = _check_tables(indices, counts, (b, h, nbq))
    _check_tensors("block-sparse", q, (k, v), (indices, counts))
    gate = _gate(stats_gate, b, h, q.device)
    off = nbkv - nbq if q_block_offset is None else int(q_block_offset)
    out = q.new_empty((b, h, n, dv))
    a_tilde = torch.full((b, h, nbq, nbkv), NEG_INF, dtype=torch.float32,
                         device=q.device)
    fn = _build.function("block_sparse_attn", "repro_block_sparse_attn", 8,
                         12)
    code = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
              _build.ptr(indices), _build.ptr(counts), _build.ptr(gate),
              _build.ptr(out), _build.ptr(a_tilde), _build.dtype_code(q),
              b, h, hkv, n, nkv, d, dv, block_size, w, off, int(causal),
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


# ---------------------------------------------------------------------------
# The single-sample instance (uniform W steps, compact stats)
# ---------------------------------------------------------------------------

def block_sparse_attention_single_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    indices: torch.Tensor, counts: torch.Tensor, *, block_size: int,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the single-sample kernel: q ``(H, N, D)``, k ``(Hkv,
    N, D)``, v ``(Hkv, N, Dv)``, tables ``(H, NBq, W)`` / ``(H, NBq)`` →
    ``(out (H, N, Dv), stats (H, NBq, W) f32)``."""
    h, n, _ = q.shape
    w = indices.shape[-1]
    nb = n // block_size
    visited = torch.clamp(counts, max=w)                  # no causal bound
    visit = table_block_mask(indices, visited, nb)
    out, means = _attend_visited(
        q[None], k[None], v[None], visit[None], block_size=block_size,
        causal=causal, off=0,
        stats_heads=torch.ones((1, h), dtype=torch.bool, device=q.device))
    stats = torch.gather(means[0], -1, indices.long())
    live = torch.arange(w, device=q.device) < visited[..., None]
    return out[0], torch.where(live, stats, NEG_INF)


def block_sparse_attention_single_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    indices: torch.Tensor, counts: torch.Tensor, *, block_size: int,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single-sample instance of ``csrc/block_sparse_attn.cu`` on CUDA
    tensors; raises on what it does not take."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 \
            or k.shape[:2] != v.shape[:2] or k.shape[1] != q.shape[1]:
        raise ValueError(f"single-sample block-sparse attention: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    h, n, _ = q.shape
    dv = v.shape[2]
    _check_shapes("single-sample block-sparse", q[None], k.shape[0], n,
                  k.shape[2], block_size, dv)
    nb = n // block_size
    w = _check_tables(indices, counts, (h, nb))
    _check_tensors("single-sample block-sparse", q, (k, v),
                   (indices, counts))
    out = q.new_empty((h, n, dv))
    stats = torch.full((h, nb, w), NEG_INF, dtype=torch.float32,
                       device=q.device)
    fn = _build.function("block_sparse_attn",
                         "repro_block_sparse_attn_single", 7, 9)
    code = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
              _build.ptr(indices), _build.ptr(counts), _build.ptr(out),
              _build.ptr(stats), _build.dtype_code(q), h, k.shape[0], n,
              q.shape[2], dv, block_size, w, int(causal),
              _build.stream_of(q))
    _build.check(code, "single-sample block-sparse attention kernel")
    block_sparse_attention_single_cuda.launches += 1
    return out, stats


block_sparse_attention_single_cuda.launches = 0


def block_sparse_attention_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    indices: torch.Tensor, counts: torch.Tensor, *, block_size: int,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-sample block-sparse attention with compact stats (module
    docstring): the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    fn = (block_sparse_attention_single_cuda if q.is_cuda
          else block_sparse_attention_single_plain)
    return fn(q, k, v, indices, counts, block_size=block_size, causal=causal)


# ---------------------------------------------------------------------------
# The paged instance (K/V through a page table)
# ---------------------------------------------------------------------------

def _check_page_size(pool_v: torch.Tensor, block_size: int) -> None:
    if pool_v.shape[2] != block_size:
        raise ValueError(f"page_size {pool_v.shape[2]} != block_size "
                         f"{block_size}")


def block_sparse_attention_paged_plain(
    q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
    page_table: torch.Tensor, indices: torch.Tensor, counts: torch.Tensor,
    *, block_size: int, causal: bool = True,
    stats_gate: Optional[torch.Tensor] = None,
    q_block_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the paged kernel: the contiguous plain version on
    the gathered pages (bitwise)."""
    _check_page_size(pool_v, block_size)
    return block_sparse_attention_plain(
        q, gather_pages(pool_k, page_table), gather_pages(pool_v, page_table),
        indices, counts, block_size=block_size, causal=causal,
        stats_gate=stats_gate, q_block_offset=q_block_offset)


def block_sparse_attention_paged_cuda(
    q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
    page_table: torch.Tensor, indices: torch.Tensor, counts: torch.Tensor,
    *, block_size: int, causal: bool = True,
    stats_gate: Optional[torch.Tensor] = None,
    q_block_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paged instance of ``csrc/block_sparse_attn.cu`` on CUDA tensors;
    raises on what it does not take (pools of unequal K and V widths among
    it).  Page ids outside ``[0, P)`` are never read (their blocks are
    skipped)."""
    _check_page_size(pool_v, block_size)
    b, h, n, _ = q.shape
    if pool_k.shape[-1] != pool_v.shape[-1]:
        raise ValueError(f"paged block-sparse kernel takes equal K and V "
                         f"widths D in (64, 96, 128); got Dqk="
                         f"{pool_k.shape[-1]}, Dv={pool_v.shape[-1]}")
    if pool_k.shape != pool_v.shape or pool_k.dim() != 4 \
            or page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"paged block-sparse attention: q {tuple(q.shape)}"
                         f", pool {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)}, page table "
                         f"{tuple(page_table.shape)}")
    p, hkv = pool_k.shape[:2]
    nbkv = page_table.shape[1]
    _check_shapes("paged block-sparse", q, hkv, nbkv * block_size,
                  pool_k.shape[3], block_size, wide=False)
    nbq = n // block_size
    w = _check_tables(indices, counts, (b, h, nbq))
    _check_tensors("paged block-sparse", q, (pool_k, pool_v),
                   (indices, counts, page_table))
    gate = _gate(stats_gate, b, h, q.device)
    off = nbkv - nbq if q_block_offset is None else int(q_block_offset)
    out = torch.empty_like(q)
    a_tilde = torch.full((b, h, nbq, nbkv), NEG_INF, dtype=torch.float32,
                         device=q.device)
    fn = _build.function("block_sparse_attn",
                         "repro_block_sparse_attn_paged", 9, 12)
    code = fn(_build.ptr(q), _build.ptr(pool_k), _build.ptr(pool_v),
              _build.ptr(page_table), _build.ptr(indices), _build.ptr(counts),
              _build.ptr(gate), _build.ptr(out), _build.ptr(a_tilde),
              _build.dtype_code(q), b, h, hkv, n, nbkv, q.shape[3],
              block_size, w, off, int(causal), p, _build.stream_of(q))
    _build.check(code, "paged block-sparse attention kernel")
    block_sparse_attention_paged_cuda.launches += 1
    return out, a_tilde


block_sparse_attention_paged_cuda.launches = 0


def block_sparse_attention_batched_paged(
    q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
    page_table: torch.Tensor, indices: torch.Tensor, counts: torch.Tensor,
    *, block_size: int, causal: bool = True,
    stats_gate: Optional[torch.Tensor] = None,
    q_block_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched block-sparse attention against a block-paged KV (module
    docstring); requires ``page_size == block_size``.  The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    fn = (block_sparse_attention_paged_cuda if q.is_cuda
          else block_sparse_attention_paged_plain)
    return fn(q, pool_k, pool_v, page_table, indices, counts,
              block_size=block_size, causal=causal, stats_gate=stats_gate,
              q_block_offset=q_block_offset)
