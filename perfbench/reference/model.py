"""The plain reference forward pass: the published decoder (RMSNorm, GQA
attention with half-split RoPE, SwiGLU MLP or a softmax top-k mixture of
SwiGLU experts with renormalised gates and no dropped token), computed in
float32 with TF32 off, layer by layer and in blocks of rows so that it
fits beside the weights.  It imports nothing of the port.

It follows the serving system's semantics, as a request goes through it:

* a prompt is right-padded with token 0 to its bucket, and the whole
  padded row is prefilled under SharePrefill's block masks
  (:mod:`perfbench.reference.patterns`, worked out again here from this
  pass's own queries and keys; the masks of a row that the pattern
  sharing does not apply to are causal);
* the first served token is read at the prompt's last token; each later
  token is decoded at position ``bucket + j`` and attends the prompt's
  tokens and the tokens decoded before it (the pad slots never).

``precision="fp8"`` computes every product from operands rounded to
float8 e4m3 (per row and per column scales), the control of
``perfbench/check.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import patterns as pat

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the product's reduction axis)."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Arith:
    """The products of one precision: ``float32`` or ``fp8``."""

    def __init__(self, precision: str):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "fp8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(…, n, k) @ (k, m), or batched (…, n, k) @ (…, k, m)."""
        if self.low:
            a, b = fp8(a, -1), fp8(b, -2)
        return a @ b


@dataclasses.dataclass
class Seq:
    """One request as the reference replays it."""
    prompt: np.ndarray           # (prompt_len,) token ids
    bucket: int                  # the padded prefill length
    served: List[int]            # the tokens the system served

    @property
    def rows(self) -> int:
        return self.bucket + max(len(self.served) - 1, 0)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = pos.float()[:, None] * inv
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def causal_rows(a0: int, cb: int, nbk: int, device) -> torch.Tensor:
    """(cb, nbk): key block j is causal for query block a0 + i."""
    i = torch.arange(cb, device=device)[:, None] + a0
    return torch.arange(nbk, device=device)[None, :] <= i


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


class Reference:
    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], *,
                 precision: str = "float32", row_budget: float = 4e9):
        self.cfg, self.w = cfg, weights
        self.ar = Arith(precision)
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.hkv = cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or self.d // self.h
        self.eps = cfg["rms_norm_eps"]
        self.theta = float(cfg["rope_theta"])
        self.experts = cfg.get("num_local_experts", 0)
        self.top_k = cfg.get("num_experts_per_tok", 0)
        self.sp = cfg["port"]
        self.row_budget = row_budget      # bytes of one logits block

    # -- attention ------------------------------------------------------
    def _prompt_attention(self, q, k, v, masks, dense):
        """q (H, N, D), k/v (Hkv, N, D); masks (H, NB, NB) or None (causal);
        → out (H, N, D) and Ã of the ``dense`` heads.  Blocks of query
        rows against the keys up to the block's end, masked by broadcasting
        the block mask over each tile and the causal triangle over the
        diagonal tiles."""
        h, n, d = q.shape
        g = h // self.hkv
        bs = self.sp["block_size"]
        nb = n // bs
        out = torch.empty_like(q)
        at = {}
        rows = max(bs, int(self.row_budget / (4 * g * n)) // bs * bs)
        tri = torch.ones(bs, bs, dtype=torch.bool, device=q.device).tril()
        for kv in range(self.hkv):
            hs = slice(kv * g, (kv + 1) * g)
            want = [i for i in range(g) if dense is not None
                    and bool(dense[kv * g + i])]
            for i in want:
                at[kv * g + i] = torch.full((nb, nb), float("-inf"),
                                            device=q.device)
            for a in range(0, n, rows):
                b = min(n, a + rows)
                cb, nbk, a0 = (b - a) // bs, b // bs, a // bs
                lg = self.ar.mm(q[hs, a:b], k[kv, :b].T).mul_(d ** -0.5)
                t = lg.view(g, cb, bs, nbk, bs)
                keep = causal_rows(a0, cb, nbk, q.device)
                if masks is not None:
                    keep = keep & masks[hs, a0:a0 + cb, :nbk]
                else:
                    keep = keep.expand(g, cb, nbk)
                t.masked_fill_(~keep[:, :, None, :, None], float("-inf"))
                diag = t[:, torch.arange(cb), :, a0 + torch.arange(cb)]
                t[:, torch.arange(cb), :, a0 + torch.arange(cb)] = \
                    diag.masked_fill(~tri, float("-inf"))
                for i in want:
                    fin = torch.isfinite(t[i])
                    s = torch.where(fin, t[i], 0.0).sum((1, 3))
                    c = fin.sum((1, 3))
                    at[kv * g + i][a0:a0 + cb, :nbk] = torch.where(
                        c > 0, s / c.clamp_min(1), float("-inf"))
                lg.sub_(lg.amax(-1, keepdim=True)).exp_()
                den = lg.sum(-1, keepdim=True)
                out[hs, a:b] = self.ar.mm(lg, v[kv, :b]) / den
                del lg, t
        return out, at

    def _decode_attention(self, q, k, v, plen: int, bucket: int):
        """q (H, T, D) of the decoded tokens against the prompt's keys and
        the decoded ones."""
        t = q.shape[1]
        g = self.h // self.hkv
        keys = torch.cat([k[:, :plen], k[:, bucket:]], 1)
        vals = torch.cat([v[:, :plen], v[:, bucket:]], 1)
        keys = keys.repeat_interleave(g, 0)
        vals = vals.repeat_interleave(g, 0)
        lg = self.ar.mm(q, keys.transpose(1, 2)) / self.hd ** 0.5
        ci = torch.arange(plen + t, device=q.device)
        ok = ci[None, :] < plen + 1 + torch.arange(t, device=q.device)[:, None]
        p = torch.softmax(lg.masked_fill(~ok, float("-inf")), -1)
        return self.ar.mm(p, vals)

    def _attention(self, li: int, x, seq: Seq, ids, book, density: list):
        w = self.w
        hn = rmsnorm(x, w["stack::ln1::scale"][li], self.eps)
        proj = lambda name, heads: self.ar.mm(
            hn, w[f"stack::attn::{name}"][li].float().reshape(self.d, -1)
        ).view(-1, heads, self.hd).transpose(0, 1)
        q, k, v = proj("wq", self.h), proj("wk", self.hkv), \
            proj("wv", self.hkv)
        del hn
        n, bucket = x.shape[0], seq.bucket
        pos = torch.arange(n, device=x.device)
        q, k = rope(q, pos, self.theta), rope(k, pos, self.theta)
        bs = self.sp["block_size"]
        qp, kp, vp = q[:, :bucket], k[:, :bucket], v[:, :bucket]
        sharing = (bucket % bs == 0
                   and bucket // bs >= self.sp["min_seq_blocks"])
        if sharing:
            dec = pat.decide(qp, kp, ids, book, self.sp)
            out, at = self._prompt_attention(qp, kp, vp, dec.masks,
                                             dec.dense)
            pat.update(book, ids, dec, at, self.sp["gamma"])
            density.append(float(
                (dec.masks.float().sum((1, 2))
                 / (bucket // bs * (bucket // bs + 1) / 2)).mean()))
        else:
            out, _ = self._prompt_attention(qp, kp, vp, None, None)
        if n > bucket:
            out = torch.cat([out, self._decode_attention(
                q[:, bucket:], k, v, len(seq.prompt), bucket)], 1)
        o = out.transpose(0, 1).reshape(n, self.h * self.hd)
        return self.ar.mm(o, w["stack::attn::wo"][li].float().reshape(
            self.h * self.hd, self.d))

    # -- feed-forward ---------------------------------------------------
    def _swiglu(self, x, wg, wu, wd):
        out = torch.empty_like(x)
        step = max(1, int(self.row_budget / (8 * wg.shape[1])))
        for a in range(0, x.shape[0], step):
            xa = x[a:a + step]
            hid = F.silu(self.ar.mm(xa, wg)) * self.ar.mm(xa, wu)
            out[a:a + step] = self.ar.mm(hid, wd)
        return out

    def _ffn(self, i: int, hn, wts):
        if not self.experts:
            return self._swiglu(hn, *wts)
        probs = torch.softmax(self.ar.mm(hn, wts[0]), -1)
        gate, idx = torch.topk(probs, self.top_k, -1)
        if self.top_k < self.experts:
            # how near each row's routing is to a tie: the k-th choice's
            # probability over the next one's (the smallest over layers)
            nxt = torch.topk(probs, self.top_k + 1, -1).values[:, -1]
            m = gate[:, -1] - nxt
            self.margins[i] = (m if self.margins[i] is None
                               else torch.minimum(self.margins[i], m))
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        y = torch.zeros_like(hn)
        for e in range(self.experts):
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel():
                y.index_add_(0, rows, gate[rows, slot, None] * self._swiglu(
                    hn[rows], *wts[1][e]))
        return y

    def _ffn_weights(self, li: int):
        w, f = self.w, lambda n: w[f"stack::ffn::{n}"][li]
        if not self.experts:
            return [f(n).float() for n in ("w_gate", "w_up", "w_down")]
        experts = [[f(n)[e].float() for n in ("w_gate", "w_up", "w_down")]
                   for e in range(self.experts)]
        return [f("router").float(), experts]

    # -- the pass -------------------------------------------------------
    @torch.no_grad()
    def logits(self, seqs: List[Seq], clusters: np.ndarray,
               num_clusters: int) -> List[torch.Tensor]:
        """Each sequence's logits ``(T, V)`` float32: at its prompt's last
        token, then at each decoded token.  ``self.density[i]`` then holds
        sequence ``i``'s kept share of causal blocks, layer by layer (empty
        where the pattern sharing does not apply), and for a mixture of
        experts ``self.margins[i]`` each of its rows' smallest routing
        margin over the layers."""
        w = self.w
        dev = w["embed"].device
        self.density = [[] for _ in seqs]
        self.margins = [None] * len(seqs)
        with no_tf32():
            xs, books = [], []
            for s in seqs:
                toks = np.zeros(s.rows, np.int64)
                toks[:len(s.prompt)] = s.prompt
                toks[s.bucket:] = s.served[:-1]
                xs.append(w["embed"][torch.as_tensor(toks, device=dev)]
                          .float())
                books.append(pat.Dictionary.empty(
                    num_clusters, s.bucket // self.sp["block_size"], dev))
            ids = torch.as_tensor(np.asarray(clusters), device=dev)
            for li in range(self.cfg["num_hidden_layers"]):
                for i, s in enumerate(seqs):
                    xs[i] = xs[i] + self._attention(
                        li, xs[i], s, ids[li], books[i], self.density[i])
                wts = self._ffn_weights(li)
                for i in range(len(seqs)):
                    hn = rmsnorm(xs[i], w["stack::ln2::scale"][li], self.eps)
                    xs[i] = xs[i] + self._ffn(i, hn, wts)
                del wts
            head = (w["lm_head"] if "lm_head" in w else w["embed"].T).float()
            out = []
            for i, (s, x) in enumerate(zip(seqs, xs)):
                rows = [len(s.prompt) - 1] + list(
                    range(s.bucket, s.bucket + len(s.served) - 1))
                hn = rmsnorm(x[rows], w["final_norm::scale"], self.eps)
                out.append(self.ar.mm(hn, head))
                if self.margins[i] is not None:
                    self.margins[i] = self.margins[i][rows]
            return out
