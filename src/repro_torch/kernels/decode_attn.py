"""Sparse decode over prebuilt :class:`DecodePlan` tables.

One query token per sequence against a contiguous cache ``(B, Hkv, S, D)``
or a block-paged pool ``(P, Hkv, ps, D)`` read through a page table
``(B, NB)``.  The plan (built once per admission or served batch by
:func:`repro_torch.serving.decode_plan.build_decode_plan`) lists, per
(batch, kv head), the kv blocks to read; ``keep_heads`` refines the union
per query head of the GQA group, and ``valid (B, S)`` masks slots that are
past the decode position or right-pad of a shorter prompt.  A (batch, kv
head) with ``counts == 0`` outputs exact zeros (the inert-slot contract).
Under paging the plan, keep bits and validity stay in *logical* block
coordinates; only the K/V address goes through ``page_table[b, j]``.

  * :func:`decode_plan_einsum` — plain, full-cache grouped einsum masked by
    ``keep_heads``; the CPU path for full-width plans (``W == NB``);
  * :func:`decode_plan_einsum_sliced` — plain, gathers only the table's
    blocks and honours ``counts``; it walks the table as the kernel does, so
    it is the kernel's plain version;
  * :func:`flash_decode_sparse_cuda` — the hand-written kernel
    ``csrc/decode_attn.cu`` (replaces the TPU kernel
    ``repro/kernels/decode_attn.py::flash_decode_sparse_batched``), which
    splits each table row across :func:`decode_splits` CTAs and merges
    their partials in a second launch;
  * :func:`flash_decode_sparse_batched` — kernel on CUDA tensors, its plain
    version on CPU tensors;
  * :func:`flash_decode_plan` — the dispatcher the model calls;
  * :func:`gather_pages`, :func:`decode_plan_einsum_paged`,
    :func:`decode_plan_einsum_sliced_paged`,
    :func:`flash_decode_sparse_paged_cuda` (the paged instance of the same
    kernel; replaces ``flash_decode_sparse_batched_paged``),
    :func:`flash_decode_sparse_batched_paged` and
    :func:`flash_decode_plan_paged` — the same five over the paged pool;
  * :func:`flash_decode` and :func:`flash_decode_sparse` — the reference's
    single-sample kernels under a per-(query head, token) mask ``(H, S)``
    (public API; no serving path calls them), each with its plain version
    (:func:`flash_decode_plain`, :func:`flash_decode_sparse_plain`) and its
    kernel (:func:`flash_decode_cuda`, :func:`flash_decode_sparse_single_cuda`;
    replace ``flash_decode`` and ``flash_decode_sparse``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.indices import compact_block_mask

NEG_INF = float("-inf")

DECODE_IMPLS = ("auto", "kernel", "einsum")

# the decode kernel's grid aims at this many CTAs per SM
SPLIT_CTAS_PER_SM = 4

# the largest GQA group the decode kernel takes (``GMAX`` in
# ``csrc/decode_attn.cu``: the group is padded to 1, 2, 4, 8 or 16)
GMAX = 16


def decode_splits(b: int, hkv: int, nb: int, sm_count: int) -> int:
    """Splits of each (batch, kv head) row of a plan over ``nb`` kv blocks
    in the decode kernels: enough CTAs (``splits · b · hkv``) to fill the
    card's ``sm_count`` SMs :data:`SPLIT_CTAS_PER_SM` times over, at most
    one per block and at least one.  Every instance (plan, paged, token
    mask) takes this rule, so the paged kernel splits a row as the
    contiguous one does and stays bitwise equal to it on the gathered
    pages.  The wrappers pass the plan's block count NB, not its table
    width: a refresh that narrows the table (``set_plan_width``) then
    leaves every row's split, and so its rounding, as it was.  ``hkv`` is
    the whole model's kv-head count, also where a launch holds one head
    shard of it (:func:`_decode_scratch`): the shard's rows then split, and
    round, as the single-device launch's."""
    want = -(-SPLIT_CTAS_PER_SM * sm_count // max(b * hkv, 1))
    return max(1, min(nb, want))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The number of SMs of a CUDA device (cached)."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None
                     else index)


def _decode_scratch(q, b: int, h: int, hkv: int, nb: int,
                    num_kv_heads: Optional[int] = None):
    """The split count and the float32 scratch for the splits' partials
    (m and l of ``(B, H, splits)``, acc of ``(B, H, splits, D)``).  The
    split follows ``num_kv_heads``, the model's kv-head count (default: the
    launch's ``hkv``): a launch over one head shard then splits each row
    as the whole model's launch does, and is bitwise its head slice."""
    splits = decode_splits(b, num_kv_heads or hkv, nb, sm_count(q.device))
    part = torch.empty(b * h * splits * (q.shape[-1] + 2),
                       dtype=torch.float32, device=q.device)
    return splits, part


def _check_aligned(what: str, tensors) -> None:
    """The kernel streams K/V as 16-byte vectors (rows of D % 8 == 0
    elements): their base pointers must be 16-byte aligned."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} needs 16-byte aligned K/V")


class DecodePlan(NamedTuple):
    """Block tables for sparse decode (layouts as in the reference).

      indices:    (…, B, Hkv, W) int32 — active block ids per (batch, kv
                  head), ascending, padded by repeating the last kept id;
      counts:     (…, B, Hkv) int32 — kept entries per table row;
      keep_heads: (…, B, Hkv, NB, G) bool — per-query-head block keep bits.

    Leaves carry a leading layer axis ``(L, B, …)`` for the whole model, or
    are one layer's slice ``(B, …)``.
    """

    indices: torch.Tensor
    counts: torch.Tensor
    keep_heads: torch.Tensor

    def layer(self, i: int) -> "DecodePlan":
        return DecodePlan(self.indices[i], self.counts[i],
                          self.keep_heads[i])


def resolve_decode_impl(impl: str, device: torch.device) -> str:
    """``auto`` → the kernel on CUDA, the plain einsum on the CPU."""
    if impl == "auto":
        return "kernel" if device.type == "cuda" else "einsum"
    if impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode impl {impl!r}; "
                         f"expected one of {DECODE_IMPLS}")
    return impl


def decode_plan_einsum(q, cache_k, cache_v, keep_heads, valid):
    """Full-cache grouped einsum under the plan's keep bits; (B, H, Dv).
    K/V may be a head slice of a larger cache (a head shard's view): the
    einsums take them contiguous, so they round as on a whole cache."""
    b, h, d = q.shape
    _, hkv, s, dv = cache_v.shape
    g = h // hkv
    nb = keep_heads.shape[2]
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, g, d).float()
    kf, vf = (t.float().contiguous() for t in (cache_k, cache_v))
    logits = torch.einsum("bkgd,bksd->bkgs", qg, kf) * scale
    km = keep_heads.transpose(-1, -2).repeat_interleave(s // nb, dim=-1)
    ok = km & valid[:, None, None, :]               # (B, Hkv, G, S)
    logits = logits.masked_fill(~ok, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(ok, torch.exp(logits - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    pv = (p / denom).to(cache_v.dtype).float()
    out = torch.einsum("bkgs,bksd->bkgd", pv, vf)
    return out.to(q.dtype).reshape(b, h, dv)


def _plan_einsum_sliced(qg, kg, vg, keep_g, valid_g, counts, out_dtype):
    """Masked-softmax core of the width-sliced plain versions, on the
    gathered table blocks ``kg``/``vg (B, Hkv, W, bs, D)``, their keep bits
    ``keep_g (B, Hkv, W, G)`` and validity ``valid_g (B, Hkv, W, bs)``;
    table ranks ≥ ``counts`` (repeat-last padding) are masked out."""
    b, hkv, g, d = qg.shape
    w, bs, dv = vg.shape[2], vg.shape[3], vg.shape[4]
    live = (torch.arange(w, device=qg.device)[None, None, :]
            < counts[..., None])                       # (B, Hkv, W)
    logits = torch.einsum("bkgd,bkwsd->bkgws", qg.float(), kg.float()) \
        * (1.0 / d ** 0.5)
    ok = (keep_g.permute(0, 1, 3, 2)[..., None]        # (B, Hkv, G, W, 1)
          & valid_g[:, :, None]                        # (B, Hkv, 1, W, bs)
          & live[:, :, None, :, None])
    flat = logits.masked_fill(~ok, NEG_INF).reshape(b, hkv, g, w * bs)
    ok_f = ok.expand(b, hkv, g, w, bs).reshape(b, hkv, g, w * bs)
    m = flat.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(ok_f, torch.exp(flat - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    pv = (p / denom).to(vg.dtype).float().reshape(b, hkv, g, w, bs)
    out = torch.einsum("bkgws,bkwsd->bkgd", pv, vg.float())
    return out.to(out_dtype).reshape(b, hkv * g, dv)


def _gather_plan_bits(plan: DecodePlan, valid, bs: int):
    """The table's keep bits ``(B, Hkv, W, G)`` and slot validity
    ``(B, Hkv, W, bs)``, gathered in logical block coordinates."""
    b, hkv, nb, g = plan.keep_heads.shape
    idx = plan.indices.long()
    w = idx.shape[-1]
    keep_g = torch.gather(plan.keep_heads, 2,
                          idx[..., None].expand(b, hkv, w, g))
    valid_b = valid.reshape(b, 1, nb, bs).expand(b, hkv, nb, bs)
    valid_g = torch.gather(valid_b, 2, idx[..., None].expand(b, hkv, w, bs))
    return keep_g, valid_g


def decode_plan_einsum_sliced(q, cache_k, cache_v, plan: DecodePlan, valid):
    """Gather only the plan's W table blocks (ranks ≥ counts masked) and
    contract those; (B, H, Dv).  The kernel's plain version."""
    b, h, d = q.shape
    _, hkv, s, dv = cache_v.shape
    nb = plan.keep_heads.shape[2]
    bs = s // nb
    idx = plan.indices.long()                          # (B, Hkv, W)
    w = idx.shape[-1]
    gidx = idx[..., None, None]
    kg = torch.gather(cache_k.reshape(b, hkv, nb, bs, d), 2,
                      gidx.expand(b, hkv, w, bs, d))
    vg = torch.gather(cache_v.reshape(b, hkv, nb, bs, dv), 2,
                      gidx.expand(b, hkv, w, bs, dv))
    keep_g, valid_g = _gather_plan_bits(plan, valid, bs)
    return _plan_einsum_sliced(q.reshape(b, hkv, h // hkv, d), kg, vg,
                               keep_g, valid_g, plan.counts, q.dtype)


def _check_launch(what: str, q, tensors) -> None:
    """Device, dtype and contiguity rules every plan decode launch shares
    (``tensors`` = K and V, then indices, counts, keep bits, validity and
    any further int32 tables; K/V's layout is :func:`_kv_head_stride`'s)."""
    if not all(t.is_cuda and t.device == q.device for t in (q, *tensors)):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    kv, (indices, counts, keep, valid, *tables) = tensors[:2], tensors[2:]
    if not all(t.dtype == q.dtype for t in kv):
        raise ValueError(f"{what}: q and cache dtypes differ")
    if any(t.dtype != torch.int32 for t in (indices, counts, *tables)) \
            or keep.dtype != torch.bool or valid.dtype != torch.bool:
        raise ValueError(f"{what} takes int32 tables and bool keep / valid "
                         "masks")
    if not all(t.is_contiguous() for t in (q, *tensors[2:])):
        raise ValueError(f"{what} takes contiguous tensors")


def _kv_head_stride(what: str, ck, cv) -> int:
    """Hc, the heads that K/V's leading dimension steps over: their own
    Hkv when contiguous, more when they are a head slice ``x[:, h0:h0 +
    Hkv]`` of a contiguous ``(…, Hc, rows, D)`` cache or pool, which the
    kernel then reads in place (one head shard of a heads-sharded
    serve)."""
    hkv = ck.shape[1]
    if ck.is_contiguous() and cv.is_contiguous():
        return hkv
    inner = ck.shape[2] * ck.shape[3]
    if ck.stride() != cv.stride() \
            or ck.stride()[1:] != (inner, ck.shape[3], 1) \
            or ck.stride(0) % inner or ck.stride(0) // inner < hkv:
        raise ValueError(f"{what} takes contiguous K/V or a head slice of "
                         "them")
    return ck.stride(0) // inner


def _check_plan(what, b, hkv, g, s, indices, counts, keep_heads, valid):
    nb, w = keep_heads.shape[2], indices.shape[-1]
    if tuple(indices.shape) != (b, hkv, w) \
            or tuple(counts.shape) != (b, hkv) \
            or tuple(keep_heads.shape) != (b, hkv, nb, g) \
            or tuple(valid.shape) != (b, s):
        raise ValueError(f"{what}: plan / valid shapes do not match the "
                         "cache")
    return nb, w


def flash_decode_sparse_cuda(q, cache_k, cache_v, indices, counts,
                             keep_heads, valid,
                             num_kv_heads: Optional[int] = None
                             ) -> torch.Tensor:
    """The kernel (``csrc/decode_attn.cu``) on CUDA tensors; raises on what
    it does not take.  ``num_kv_heads`` is the model's kv-head count when
    the cache holds one head shard of it (the split rule's, see
    :func:`_decode_scratch`).  Returns (B, H, D)."""
    b, h, d = q.shape
    if cache_k.shape != cache_v.shape or cache_k.dim() != 4 \
            or cache_k.shape[0] != b or cache_k.shape[3] != d \
            or h % cache_k.shape[1]:
        raise ValueError(f"sparse decode: q {tuple(q.shape)}, cache "
                         f"{tuple(cache_k.shape)} / {tuple(cache_v.shape)}")
    hkv, s = cache_k.shape[1], cache_k.shape[2]
    g = h // hkv
    nb, w = _check_plan("sparse decode", b, hkv, g, s, indices, counts,
                        keep_heads, valid)
    if s % nb or (s // nb) % 32 or g > GMAX or d > 256 or d % 8:
        raise ValueError(f"sparse decode kernel needs a block size that is "
                         f"a multiple of 32, G <= {GMAX} and D <= 256 a "
                         f"multiple of 8 (S={s}, NB={nb}, G={g}, D={d})")
    _check_launch("sparse decode kernel", q,
                  (cache_k, cache_v, indices, counts, keep_heads, valid))
    hc = _kv_head_stride("sparse decode kernel", cache_k, cache_v)
    _check_aligned("sparse decode kernel", (cache_k, cache_v))
    out = torch.empty_like(q)
    splits, part = _decode_scratch(q, b, h, hkv, nb, num_kv_heads)
    fn = _build.function("decode_attn", "repro_decode_attn", 9, 10)
    code = fn(_build.ptr(q), _build.ptr(cache_k), _build.ptr(cache_v),
              _build.ptr(indices), _build.ptr(counts),
              _build.ptr(keep_heads), _build.ptr(valid), _build.ptr(part),
              _build.ptr(out), _build.dtype_code(q), b, h, hkv, hc, s, d, nb,
              w, splits, _build.stream_of(q))
    _build.check(code, "sparse decode kernel")
    flash_decode_sparse_cuda.launches += 1
    return out


flash_decode_sparse_cuda.launches = 0


def flash_decode_sparse_batched(q, cache_k, cache_v, indices, counts,
                                keep_heads, valid,
                                num_kv_heads: Optional[int] = None
                                ) -> torch.Tensor:
    """The kernel for CUDA tensors, its plain version for CPU tensors (which
    does not split, and so takes no ``num_kv_heads``)."""
    if q.is_cuda:
        return flash_decode_sparse_cuda(q, cache_k, cache_v, indices,
                                        counts, keep_heads, valid,
                                        num_kv_heads)
    return decode_plan_einsum_sliced(
        q, cache_k, cache_v, DecodePlan(indices, counts, keep_heads), valid)


def flash_decode_plan(q, cache_k, cache_v, plan: DecodePlan, valid, *,
                      impl: str = "auto",
                      num_kv_heads: Optional[int] = None) -> torch.Tensor:
    """Sparse decode over one layer's plan slice; (B, H, Dv).

    ``kernel`` runs :func:`flash_decode_sparse_batched` (``num_kv_heads``:
    the model's kv-head count under a head shard); ``einsum`` runs the
    plain path the reference's einsum fallback runs (full-cache for a
    full-width plan, the sliced gather for ``W < NB``)."""
    impl = resolve_decode_impl(impl, q.device)
    if impl == "kernel":
        return flash_decode_sparse_batched(
            q, cache_k, cache_v, plan.indices, plan.counts, plan.keep_heads,
            valid, num_kv_heads)
    if plan.indices.shape[-1] < plan.keep_heads.shape[-2]:
        return decode_plan_einsum_sliced(q, cache_k, cache_v, plan, valid)
    return decode_plan_einsum(q, cache_k, cache_v, plan.keep_heads, valid)


# ---------------------------------------------------------------------------
# Block-paged variants: K/V live in a shared page pool, one page per block
# ---------------------------------------------------------------------------

def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Contiguous per-slot view of a page pool: pool ``(P, Hkv, ps, D)``,
    page_table ``(B, NB)`` → ``(B, Hkv, NB·ps, D)``.  A pure gather, so any
    contiguous attention path on the view reads exactly the page
    contents."""
    b, nb = page_table.shape
    _, hkv, ps, d = pool.shape
    g = pool[page_table.reshape(-1).long()].reshape(b, nb, hkv, ps, d)
    return g.transpose(1, 2).reshape(b, hkv, nb * ps, d)


def decode_plan_einsum_paged(q, pool_k, pool_v, page_table, keep_heads,
                             valid):
    """:func:`decode_plan_einsum` on the gathered pages (bitwise the
    contiguous plain path on the same cache)."""
    return decode_plan_einsum(q, gather_pages(pool_k, page_table),
                              gather_pages(pool_v, page_table), keep_heads,
                              valid)


def decode_plan_einsum_sliced_paged(q, pool_k, pool_v, page_table,
                                    plan: DecodePlan, valid):
    """:func:`decode_plan_einsum_sliced` over the pool: the logical table is
    translated through the page table (``page = page_table[b, indices[b,
    h, w]]``) and only those W pages are gathered.  The paged kernel's
    plain version; bitwise the contiguous one on gathered pages."""
    b, h, d = q.shape
    _, hkv, ps, dv = pool_v.shape
    nb = page_table.shape[1]
    idx = plan.indices.long()                          # (B, Hkv, W)
    pages = torch.gather(page_table.long()[:, None, :].expand(b, hkv, nb),
                         2, idx)                       # (B, Hkv, W)
    heads = torch.arange(hkv, device=q.device)[None, :, None]
    kg = pool_k[pages, heads]                          # (B, Hkv, W, ps, D)
    vg = pool_v[pages, heads]
    keep_g, valid_g = _gather_plan_bits(plan, valid, ps)
    return _plan_einsum_sliced(q.reshape(b, hkv, h // hkv, d), kg, vg,
                               keep_g, valid_g, plan.counts, q.dtype)


def flash_decode_sparse_paged_cuda(q, pool_k, pool_v, page_table, indices,
                                   counts, keep_heads, valid,
                                   num_kv_heads: Optional[int] = None
                                   ) -> torch.Tensor:
    """The paged instance of the kernel (``csrc/decode_attn.cu``) on CUDA
    tensors; raises on what it does not take.  Page ids outside ``[0, P)``
    are never read (their blocks are skipped).  ``num_kv_heads`` as in
    :func:`flash_decode_sparse_cuda`.  Returns (B, H, D)."""
    b, h, d = q.shape
    if pool_k.shape != pool_v.shape or pool_k.dim() != 4 \
            or pool_k.shape[3] != d or h % pool_k.shape[1] \
            or page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"paged sparse decode: q {tuple(q.shape)}, pool "
                         f"{tuple(pool_k.shape)} / {tuple(pool_v.shape)}, "
                         f"page table {tuple(page_table.shape)}")
    p, hkv, ps = pool_k.shape[:3]
    g = h // hkv
    nb = page_table.shape[1]
    _, w = _check_plan("paged sparse decode", b, hkv, g, nb * ps, indices,
                       counts, keep_heads, valid)
    if keep_heads.shape[2] != nb or ps % 32 or g > GMAX or d > 256 \
            or d % 8:
        raise ValueError(f"paged sparse decode kernel needs NB table "
                         f"blocks, a page size that is a multiple of 32, "
                         f"G <= {GMAX} and D <= 256 a multiple of 8 "
                         f"(NB={nb}, plan NB={keep_heads.shape[2]}, "
                         f"ps={ps}, G={g}, D={d})")
    _check_launch("paged sparse decode kernel", q,
                  (pool_k, pool_v, indices, counts, keep_heads, valid,
                   page_table))
    hc = _kv_head_stride("paged sparse decode kernel", pool_k, pool_v)
    _check_aligned("paged sparse decode kernel", (pool_k, pool_v))
    out = torch.empty_like(q)
    splits, part = _decode_scratch(q, b, h, hkv, nb, num_kv_heads)
    fn = _build.function("decode_attn", "repro_decode_attn_paged", 10, 11)
    code = fn(_build.ptr(q), _build.ptr(pool_k), _build.ptr(pool_v),
              _build.ptr(page_table), _build.ptr(indices),
              _build.ptr(counts), _build.ptr(keep_heads), _build.ptr(valid),
              _build.ptr(part), _build.ptr(out), _build.dtype_code(q), b, h,
              hkv, hc, ps, d, nb, w, p, splits, _build.stream_of(q))
    _build.check(code, "paged sparse decode kernel")
    flash_decode_sparse_paged_cuda.launches += 1
    return out


flash_decode_sparse_paged_cuda.launches = 0


def flash_decode_sparse_batched_paged(q, pool_k, pool_v, page_table,
                                      indices, counts, keep_heads, valid,
                                      num_kv_heads: Optional[int] = None
                                      ) -> torch.Tensor:
    """The paged kernel for CUDA tensors, its plain version for CPU
    tensors."""
    if q.is_cuda:
        return flash_decode_sparse_paged_cuda(q, pool_k, pool_v, page_table,
                                              indices, counts, keep_heads,
                                              valid, num_kv_heads)
    return decode_plan_einsum_sliced_paged(
        q, pool_k, pool_v, page_table,
        DecodePlan(indices, counts, keep_heads), valid)


def flash_decode_plan_paged(q, pool_k, pool_v, page_table, plan: DecodePlan,
                            valid, *, impl: str = "auto",
                            num_kv_heads: Optional[int] = None
                            ) -> torch.Tensor:
    """Sparse decode over one layer's pool slice; (B, H, Dv).  Same
    dispatch as :func:`flash_decode_plan`: ``kernel`` runs
    :func:`flash_decode_sparse_batched_paged`; ``einsum`` gathers the
    table's pages for ``W < NB`` and the whole page-table row otherwise."""
    impl = resolve_decode_impl(impl, q.device)
    if impl == "kernel":
        return flash_decode_sparse_batched_paged(
            q, pool_k, pool_v, page_table, plan.indices, plan.counts,
            plan.keep_heads, valid, num_kv_heads)
    if plan.indices.shape[-1] < plan.keep_heads.shape[-2]:
        return decode_plan_einsum_sliced_paged(q, pool_k, pool_v,
                                               page_table, plan, valid)
    return decode_plan_einsum_paged(q, pool_k, pool_v, page_table,
                                    plan.keep_heads, valid)


# ---------------------------------------------------------------------------
# Single-sample decode under a per-(query head, token) mask
# ---------------------------------------------------------------------------

def _masked_decode(qg, k, v, ok, out_dtype):
    """Masked-softmax decode of ``qg (Hkv, G, D)`` against ``k``/``v (Hkv,
    S, D)`` under ``ok (Hkv, G, S)``; ``(Hkv·G, Dv)``.  A head with nothing
    visible gets zeros (max guarded, denominator ``max(l, 1e-30)``)."""
    hkv, g, d = qg.shape
    logits = torch.einsum("kgd,ksd->kgs", qg.float(), k.float()) \
        * (1.0 / d ** 0.5)
    logits = logits.masked_fill(~ok, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(ok, torch.exp(logits - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("kgs,ksd->kgd", p / denom, v.float())
    return out.to(out_dtype).reshape(hkv * g, v.shape[-1])


def flash_decode_plain(q, cache_k, cache_v, mask, *, block_kv: int = 128
                       ) -> torch.Tensor:
    """Plain version of :func:`flash_decode`: q ``(H, D)`` against the
    cache ``(Hkv, S, D)`` under ``mask (H, S)``; ``(H, Dv)``.  Like the
    reference it reads ``S // block_kv`` whole blocks (a ragged tail is
    dropped)."""
    h, d = q.shape
    hkv = cache_k.shape[0]
    s = (cache_k.shape[1] // block_kv) * block_kv
    return _masked_decode(q.reshape(hkv, h // hkv, d), cache_k[:, :s],
                          cache_v[:, :s], mask[:, :s].reshape(hkv, -1, s),
                          q.dtype)


def decode_block_table(mask: torch.Tensor, num_kv_heads: int,
                       block_kv: int):
    """The union block table :func:`flash_decode_sparse` walks: per kv
    head, the blocks where any head of its group keeps a token, ascending,
    padded with the last id (the reference's argsort, staged in torch on
    the mask's device); ``(indices (Hkv, NB), counts (Hkv,))`` int32."""
    h, s = mask.shape
    if s % block_kv:
        raise ValueError(f"sparse decode: S={s} is not a multiple of "
                         f"block_kv={block_kv}")
    blk_any = mask.reshape(num_kv_heads, h // num_kv_heads, s // block_kv,
                           block_kv).any(dim=3).any(dim=1)
    return compact_block_mask(blk_any)


def flash_decode_sparse_plain(q, cache_k, cache_v, mask, *,
                              block_kv: int = 128) -> torch.Tensor:
    """Plain version of :func:`flash_decode_sparse`: stages the union table
    and attends over its blocks only (ranks ≥ counts masked), as the kernel
    walks it; ``(H, Dv)``."""
    h, d = q.shape
    hkv, s, _ = cache_k.shape
    g, nb = h // hkv, s // block_kv
    idx, cnt = decode_block_table(mask, hkv, block_kv)
    live = torch.arange(nb, device=q.device)[None, :] < cnt[:, None]
    heads = torch.arange(hkv, device=q.device)[:, None]
    blocks = lambda x: x.reshape(hkv, nb, block_kv, -1)[heads, idx.long()]
    kg, vg = blocks(cache_k), blocks(cache_v)      # (Hkv, NB, bs, D)
    ok = mask.reshape(hkv, g, nb, block_kv)[heads, :, idx.long()]
    ok = ok.permute(0, 2, 1, 3) & live[:, None, :, None]   # (Hkv, G, NB, bs)
    return _masked_decode(q.reshape(hkv, g, d),
                          kg.reshape(hkv, nb * block_kv, d),
                          vg.reshape(hkv, nb * block_kv, -1),
                          ok.reshape(hkv, g, nb * block_kv), q.dtype)


def _check_masked(what, q, cache_k, cache_v, mask, block_kv):
    """Shape, device, dtype and contiguity rules of the token-mask
    kernels; returns ``(H, Hkv, S, D)``."""
    if q.dim() != 2 or cache_k.dim() != 3 or cache_k.shape != cache_v.shape \
            or cache_k.shape[2] != q.shape[1] \
            or q.shape[0] % cache_k.shape[0] \
            or tuple(mask.shape) != (q.shape[0], cache_k.shape[1]):
        raise ValueError(f"{what}: q {tuple(q.shape)}, cache "
                         f"{tuple(cache_k.shape)} / {tuple(cache_v.shape)}, "
                         f"mask {tuple(mask.shape)}")
    h, d = q.shape
    hkv, s = cache_k.shape[:2]
    if s % block_kv or block_kv % 32 or h // hkv > GMAX or d > 256 \
            or d % 8:
        raise ValueError(f"{what} kernel needs S % block_kv == 0, block_kv a "
                         f"multiple of 32, G <= {GMAX} and D <= 256 a "
                         f"multiple of 8 (S={s}, block_kv={block_kv}, "
                         f"G={h // hkv}, D={d})")
    if not all(t.is_cuda and t.device == q.device
               for t in (q, cache_k, cache_v, mask)):
        raise ValueError(f"{what} kernel takes CUDA tensors on one device")
    if not (q.dtype == cache_k.dtype == cache_v.dtype) \
            or mask.dtype != torch.bool:
        raise ValueError(f"{what} kernel takes q and cache of one dtype and "
                         "a bool mask")
    if not all(t.is_contiguous() for t in (q, cache_k, cache_v, mask)):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    _check_aligned(f"{what} kernel", (cache_k, cache_v))
    return h, hkv, s, d


def _launch_masked(q, cache_k, cache_v, mask, indices, counts, *, h, hkv,
                   s, d, nb, what):
    out = torch.empty_like(q)
    splits, part = _decode_scratch(q, 1, h, hkv, nb)
    fn = _build.function("decode_attn", "repro_decode_attn_mask", 8, 9)
    table = indices is not None
    code = fn(_build.ptr(q), _build.ptr(cache_k), _build.ptr(cache_v),
              _build.ptr(indices) if table else None,
              _build.ptr(counts) if table else None, _build.ptr(mask),
              _build.ptr(part), _build.ptr(out), _build.dtype_code(q), 1, h,
              hkv, s, d, nb, int(table), splits, _build.stream_of(q))
    _build.check(code, what)
    return out


def flash_decode_cuda(q, cache_k, cache_v, mask, *, block_kv: int = 128
                      ) -> torch.Tensor:
    """The dense-walk token-mask instance of ``csrc/decode_attn.cu`` on
    CUDA tensors (replaces the TPU kernel ``flash_decode``); raises on what
    it does not take, a ragged ``S % block_kv`` included.  ``(H, D)``."""
    h, hkv, s, d = _check_masked("flash decode", q, cache_k, cache_v, mask,
                                 block_kv)
    out = _launch_masked(q, cache_k, cache_v, mask, None, None, h=h,
                         hkv=hkv, s=s, d=d, nb=s // block_kv,
                         what="flash decode kernel")
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0


def flash_decode_sparse_single_cuda(q, cache_k, cache_v, mask, *,
                                    block_kv: int = 128) -> torch.Tensor:
    """The table-walk token-mask instance of ``csrc/decode_attn.cu`` on CUDA
    tensors (replaces the TPU kernel ``flash_decode_sparse``): stages the
    union table on the device, then launches.  ``(H, D)``."""
    h, hkv, s, d = _check_masked("sparse flash decode", q, cache_k, cache_v,
                                 mask, block_kv)
    idx, cnt = decode_block_table(mask, hkv, block_kv)
    out = _launch_masked(q, cache_k, cache_v, mask, idx.contiguous(),
                         cnt.contiguous(), h=h, hkv=hkv, s=s, d=d,
                         nb=s // block_kv, what="sparse flash decode kernel")
    flash_decode_sparse_single_cuda.launches += 1
    return out


flash_decode_sparse_single_cuda.launches = 0


def flash_decode(q, cache_k, cache_v, mask, *, block_kv: int = 128
                 ) -> torch.Tensor:
    """Single-sample decode, q ``(H, D)`` against ``(Hkv, S, D)`` under the
    token mask ``(H, S)``, every block streamed; ``(H, Dv)`` in q's dtype.
    The kernel for CUDA tensors, its plain version for CPU tensors."""
    fn = flash_decode_cuda if q.is_cuda else flash_decode_plain
    return fn(q, cache_k, cache_v, mask, block_kv=block_kv)


def flash_decode_sparse(q, cache_k, cache_v, mask, *, block_kv: int = 128
                        ) -> torch.Tensor:
    """:func:`flash_decode` skipping the kv blocks where no head of the
    group keeps a token (a per-call block table).  The kernel for CUDA
    tensors, its plain version for CPU tensors."""
    fn = (flash_decode_sparse_single_cuda if q.is_cuda
          else flash_decode_sparse_plain)
    return fn(q, cache_k, cache_v, mask, block_kv=block_kv)
