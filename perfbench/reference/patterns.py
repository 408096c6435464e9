"""SharePrefill's block patterns, worked out again in plain PyTorch from a
layer's query and key (the paper's Algorithms 2–5, as the port computes
them; nothing here imports the port).

For one sequence and one layer, with block size ``bs`` and ``NB`` blocks:

1. the strip: softmax of the last query block's scaled logits against all
   keys, causally masked, ``(H, bs, N)``;
2. â: the strip summed within key blocks, averaged over its rows and
   normalised, ``(H, NB)``;
3. per head, d_sparse = √JSD(â ‖ uniform) and d_sim = √JSD(â ‖ the
   cluster's pivotal representative): a head shares its cluster's pivotal
   mask where d_sparse < δ, d_sim < τ and a pivot exists; the first head of
   a cluster with no pivot yet runs dense (and builds the pivot); every
   other head, and every noise head (cluster −1), takes the
   vertical-slash mask that covers mass γ of the strip;
4. after attention, each dense head's block-averaged logits Ã give the
   cluster's pivot: the block softmax's last row is the representative, and
   the fewest blocks holding mass γ (with the diagonal) its mask.

The dictionary of pivots is carried from layer to layer.
"""
from __future__ import annotations

import dataclasses

import torch

EPS = 1e-12
LN2 = 0.6931471805599453


def causal(nb: int, device) -> torch.Tensor:
    i = torch.arange(nb, device=device)
    return i[None, :] <= i[:, None]


def strip(q: torch.Tensor, k: torch.Tensor, bs: int) -> torch.Tensor:
    """q (H, N, D), k (Hkv, N, D) → (H, bs, N) float32."""
    h, n, d = q.shape
    g = h // k.shape[0]
    qh = q[:, n - bs:].float().reshape(k.shape[0], g, bs, d)
    logits = torch.einsum("kgqd,knd->kgqn", qh, k.float()) / d ** 0.5
    rows = torch.arange(bs, device=q.device) + (n - bs)
    cols = torch.arange(n, device=q.device)
    logits = logits.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
    return torch.softmax(logits, dim=-1).reshape(h, bs, n)


def pooled(s: torch.Tensor, bs: int) -> torch.Tensor:
    h, b, n = s.shape
    a = s.reshape(h, b, n // bs, bs).sum(-1).mean(-2)
    return a / a.sum(-1, keepdim=True).clamp_min(EPS)


def _kl(p, q):
    p, q = p.clamp(EPS, 1.0), q.clamp(EPS, 1.0)
    return (p * (p.log() - q.log())).sum(-1) / LN2


def js_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    m = 0.5 * (p + q)
    return (0.5 * _kl(p, m) + 0.5 * _kl(q, m)).clamp_min(0.0).sqrt()


def top_mass(scores: torch.Tensor, gamma: float) -> torch.Tensor:
    """The fewest entries (ties in index order) whose mass reaches γ."""
    s = scores / scores.sum(-1, keepdim=True).clamp_min(EPS)
    order = torch.argsort(-s, dim=-1, stable=True)
    srt = torch.gather(s, -1, order)
    keep = (torch.cumsum(srt, -1) - srt) < gamma
    return torch.zeros_like(keep).scatter(-1, order, keep)


def vertical_slash(s: torch.Tensor, gamma: float, bs: int) -> torch.Tensor:
    """(H, bs, N) strip → (H, NB, NB) causal mask of the key columns and
    diagonals that cover mass γ (block column 0 and the block diagonal
    always)."""
    h, b, n = s.shape
    nb = n // bs
    col_mass = s.sum(-2)
    offs = torch.arange(n, device=s.device)
    rows = torch.arange(b, device=s.device)
    key = (n - b) + rows[:, None] - offs[None, :]         # key of offset o
    valid = (key >= 0) & (key < n)
    diag_mass = torch.where(valid, torch.gather(
        s, -1, key.clamp(0, n - 1).expand(s.shape)), 0.0).sum(-2)
    cols = top_mass(col_mass, gamma).reshape(h, nb, bs).any(-1)
    lo = top_mass(diag_mass, gamma).reshape(h, nb, bs).any(-1)
    diags = lo | torch.cat([lo[:, 1:], torch.zeros_like(lo[:, :1])], -1)
    cols[:, 0] = True
    diags[:, 0] = True
    i = torch.arange(nb, device=s.device)
    off = i[:, None] - i[None, :]
    cmask = causal(nb, s.device)
    return ((cols[:, None, :] & cmask)
            | (diags[:, off.clamp(0, nb - 1)] & (off >= 0)))


def pivot(a_tilde: torch.Tensor, gamma: float):
    """Ã (NB, NB) of one dense head → (mask (NB, NB), representative
    (NB,))."""
    fin = torch.isfinite(a_tilde)
    mx = a_tilde.amax(-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    e = torch.where(fin, torch.exp(a_tilde - mx), 0.0)
    sc = e / e.sum(-1, keepdim=True).clamp_min(EPS)
    nb = sc.shape[-1]
    mask = top_mass(sc.reshape(nb * nb), gamma).reshape(nb, nb)
    return mask | torch.eye(nb, dtype=torch.bool, device=sc.device), sc[-1]


@dataclasses.dataclass
class Dictionary:
    """One sequence's pivots, cluster by cluster."""
    masks: torch.Tensor      # (C, NB, NB) bool
    reps: torch.Tensor       # (C, NB)
    valid: torch.Tensor      # (C,) bool

    @staticmethod
    def empty(clusters: int, nb: int, device) -> "Dictionary":
        return Dictionary(
            torch.zeros((clusters, nb, nb), dtype=torch.bool, device=device),
            torch.full((clusters, nb), 1.0 / nb, device=device),
            torch.zeros((clusters,), dtype=torch.bool, device=device))


@dataclasses.dataclass
class Decision:
    masks: torch.Tensor      # (H, NB, NB) bool, causal
    dense: torch.Tensor      # (H,) bool: the heads that build pivots


def decide(q: torch.Tensor, k: torch.Tensor, ids: torch.Tensor,
           book: Dictionary, sp: dict) -> Decision:
    """Steps 1–3 for one layer; ``ids`` (H,) the layer's clusters."""
    bs = sp["block_size"]
    nb = q.shape[1] // bs
    s = strip(q, k, bs)
    a = pooled(s, bs)
    safe = ids.clamp(0, book.valid.shape[0] - 1).long()
    has = book.valid[safe] & (ids >= 0)
    d_sparse = js_distance(a, torch.full_like(a, 1.0 / nb))
    d_sim = js_distance(a, book.reps[safe])
    first = torch.argmax((ids[:, None] == ids[None, :]).int(), 1) == \
        torch.arange(ids.shape[0], device=ids.device)
    flat = d_sparse < sp["delta"]
    shared = flat & (d_sim < sp["tau"]) & has & (ids >= 0)
    dense = flat & ~has & first & (ids >= 0)
    cm = causal(nb, q.device)
    masks = torch.where(shared[:, None, None], book.masks[safe],
                        vertical_slash(s, sp["gamma"], bs))
    masks = torch.where(dense[:, None, None], cm, masks) & cm
    return Decision(masks, dense)


def update(book: Dictionary, ids: torch.Tensor, dec: Decision,
           a_tilde: dict, gamma: float) -> None:
    """Step 4: each dense head's pivot replaces its cluster's."""
    for h in torch.nonzero(dec.dense).flatten().tolist():
        c = int(ids[h])
        m, r = pivot(a_tilde[h], gamma)
        book.masks[c], book.reps[c], book.valid[c] = m, r, True
