"""How ``correct`` is decided: the plain reference
(:mod:`perfbench.reference.model`) replays a sample of the requests the
window finished, drawn from the seed with the longest among them, over
each prompt and the tokens the system served, working SharePrefill's
patterns out again from its own queries and keys.  The numbers a cell
may hold to limits (:func:`numbers`):

* the first token's logits as the timed path produced them, against the
  reference's at the prompt's last token: the RMS of the difference over
  the RMS of the reference's logits about their mean, of the worst
  request (``logit_rel_err``) or the median one
  (``logit_rel_err_median``);
* how far each served token's logit lies below the reference's best at
  its position (greedy decoding): the widest gap (``token_gap``), the
  widest over positions whose expert routing is clear of a tie
  (``token_gap_clear``), or the share of tokens more than ``MISMATCH``
  below (``token_mismatch_share``);
* how far each request's kept share of causal blocks (the port's
  ``pattern_stats["block_density"]``) lies from the one the reference's
  patterns keep (``block_density_err``).

Each cell's workload file names the numbers it holds to limits and the
limits (PERF.md gives the readings they were set from: where the top-2
routing of a mixture of experts lies within rounding of a tie, bf16 picks
another expert now and then and that token's output changes wholesale,
so there the widest readings and the first-token logits swing, and the
served cell compares the share and the positions clear of a tie; a
request's kept share of blocks moves by a whole head's mask where one
head's pattern decision lies within rounding of its threshold, so no cell
holds ``block_density_err`` yet).

The control puts the reference computed in float8 e4m3
(``precision="fp8"``, one step below the configuration's bfloat16) in the
system's place: its first-token logits, the tokens it puts first and the
blocks its own patterns keep.  Besides the numbers, a run is not correct
where a request of the window failed or never answered, or where a served
first token is not the argmax of the logits the timed path sampled it
from.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference.model import Reference, Seq
from perfbench.traffic.generator import rng

# a position whose every layer's top-k routing in the reference is at
# least this far from a tie (the k-th choice's probability over the next
# one's) is one that bf16 rounding cannot re-route
CLEAR = 0.02
# a served token whose reference logit lies more than this below the
# reference's best counts as a mismatch (logits; bf16 rounding moves the
# logits of these models by ≈ 0.02 of their spread)
MISMATCH = 0.05


def sample(records: List[dict], k: int, seed: int) -> List[dict]:
    """The longest finished request (prompt and output) and ``k − 1``
    others drawn from the seed."""
    done = [r for r in records if r["ok"]]
    if not done:
        return []
    longest = max(done, key=lambda r: (r["prompt_len"] + len(r["tokens"]),
                                       -r["uid"]))
    rest = [r for r in done if r is not longest]
    pick = rng(seed, 7).permutation(len(rest))[:max(k - 1, 0)]
    return [longest] + [rest[i] for i in sorted(pick)]


def seqs(chosen: List[dict]) -> List[Seq]:
    return [Seq(r["prompt"], r["bucket"], [int(t) for t in r["tokens"]])
            for r in chosen]


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    spread = (ref - ref.mean()).pow(2).mean().sqrt().clamp_min(1e-30)
    return float((got.float().to(ref.device) - ref).pow(2).mean().sqrt()
                 / spread)


def gaps(ref: torch.Tensor, tokens) -> List[float]:
    """``max(row) − row[token]`` for each row of ``ref (T, V)``."""
    t = torch.as_tensor(np.asarray(tokens, np.int64), device=ref.device)
    best = ref.max(-1).values
    return (best - ref.gather(-1, t[:, None])[:, 0]).tolist()


def rows(rep: "Replay", first, tokens, density) -> List[dict]:
    """Each replayed request's readings: the first-token logits' error,
    each served position's gap and routing margin in the reference (None
    without experts), and how far the kept share of causal blocks
    (``density``, one a request) lies from the reference's (None where
    the pattern sharing does not apply)."""
    out = []
    for i, (f, t, d) in enumerate(zip(first, tokens, density)):
        lg, m, want = rep.logits[i], rep.margins[i], rep.density[i]
        out.append({"first_err": rel_err(f, lg[0]), "gaps": gaps(lg, t),
                    "margins": None if m is None else m.tolist(),
                    "density_err": (None if want is None or d is None
                                    else abs(float(d) - want))})
    return out


def numbers(readings: List[dict]) -> Dict[str, float]:
    """Every number a cell may compare (its workload file's ``limits``
    name the ones it does): ``logit_rel_err`` (the worst replayed
    request's first-token logits), ``logit_rel_err_median`` (the median
    request's), ``token_gap`` (the widest gap over every served token),
    ``token_gap_clear`` (the widest over the positions whose routing
    margin in the reference is at least ``CLEAR``, every position without
    experts), ``token_mismatch_share`` (the share of served tokens more
    than ``MISMATCH`` below the reference's best) and
    ``block_density_err`` (the widest gap of a request's kept share of
    causal blocks from the reference's).  A number with nothing to read
    is None."""
    first = [r["first_err"] for r in readings]
    gap = [g for r in readings for g in r["gaps"]]
    clear = [g for r in readings
             for g, m in zip(r["gaps"], r["margins"] or
                             [math.inf] * len(r["gaps"])) if m >= CLEAR]
    dens = [r["density_err"] for r in readings
            if r["density_err"] is not None]
    return {"logit_rel_err": max(first),
            "logit_rel_err_median": float(np.median(first)),
            "token_gap": max(gap),
            "token_gap_clear": max(clear) if clear else None,
            "token_mismatch_share": float(np.mean([g > MISMATCH
                                                   for g in gap])),
            "block_density_err": max(dens) if dens else None}


def system_rows(rep: "Replay", chosen: List[dict]) -> List[dict]:
    return rows(rep, [r["first_logits"] for r in chosen],
                [r["tokens"] for r in chosen],
                [r["density"] for r in chosen])


def control_rows(rep: "Replay", low: "Replay") -> List[dict]:
    """The control's readings: the lower precision's first logits, the
    tokens it puts first at the same positions, and its own patterns'
    kept share."""
    return rows(rep, [lg[0] for lg in low.logits],
                [lg.argmax(-1).tolist() for lg in low.logits], low.density)


@dataclasses.dataclass
class Replay:
    """The reference over the chosen requests: each one's logits
    ``(T, V)``, routing margins ``(T,)`` or None, and kept share of causal
    blocks averaged over the layers or None."""
    logits: List[torch.Tensor]
    margins: list
    density: List[Optional[float]]


def replay(cfg: dict, weights, chosen: List[dict], clusters, num_clusters,
           precision: str = "float32") -> Replay:
    ref = Reference(cfg, weights, precision=precision)
    out = ref.logits(seqs(chosen), clusters, num_clusters)
    return Replay(out, ref.margins,
                  [float(np.mean(d)) if d else None for d in ref.density])


def hard_faults(records: List[dict]) -> List[str]:
    """What fails a run before any number: a request that failed or never
    answered, a first token that is not its logits' argmax."""
    out = []
    for r in records:
        if not r["ok"]:
            out.append(f"request {r['uid']} finished {r['finish']!r}")
        elif r["first_logits"] is None:
            out.append(f"request {r['uid']}: no first-token logits seen")
        elif int(r["first_logits"].argmax()) != int(r["tokens"][0]):
            out.append(f"request {r['uid']}: served first token "
                       f"{int(r['tokens'][0])} is not the argmax "
                       f"{int(r['first_logits'].argmax())} of its logits")
    return out
