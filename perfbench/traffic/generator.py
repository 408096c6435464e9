"""The one traffic generator: a traffic file's parameters and the seed →
the requests a run sends.

Every seed gets the same set of sizes: fixed quantiles of the stated
distributions.  In a closed loop the seed orders each cycle's requests
(the window counts whole cycles, so the order moves nothing) and draws
the token ids.  In an open loop the schedule (the sizes, the gaps between
arrivals and their order) is the same for every seed, and the seed draws
the token ids alone: under load the order of long and short prompts sets
the queue, and orders drawn from the seed moved the median time to first
token by a third from seed to seed where two runs of one seed agreed
within a few percent.

* ``"loop": "closed"``: one client sends cycles of requests, one request
  of each length band (``bands``, log-uniform within a band) a cycle, in an
  order drawn from the seed; cycle ``c`` takes the quantile of stratum
  ``c`` of ``strata`` (in bit-reversed order, so that any run of cycles
  spreads over the band).  The client sends the next request when the
  last one completes.
* ``"loop": "open"``: ``rate_per_s × seconds`` requests due at fixed
  times: log-uniform prompt lengths, uniform output lengths and
  exponential gaps (a Poisson process's), each a set of quantiles, each
  shuffled on its own by a fixed stream (``SCHEDULE``).

Every request is decoded greedily, from its own prompt (no shared
prefixes).  A traffic file holds exactly the keys of its loop
(``KEYS``): the generator refuses any other, so that a mix never asks
for what it would not get.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List

import numpy as np


@dataclasses.dataclass
class Spec:
    uid: int
    prompt: np.ndarray          # (prompt_len,) int32 token ids
    max_new_tokens: int
    arrival_s: float = 0.0      # due time from the window's start


SCHEDULE = 0        # the open loop's one order of sizes and gaps

KEYS = {"closed": {"loop": None, "bands": None, "strata": None,
                   "output_tokens": None},
        "open": {"loop": None, "rate_per_s": None,
                 "prompt_tokens": {"lo", "hi"},
                 "output_tokens": {"lo", "hi"}}}


def validate(params: dict) -> dict:
    """``params`` if it holds exactly the keys its loop reads; else
    ``ValueError``."""
    want = KEYS.get(params.get("loop"))
    if want is None:
        raise ValueError(f"traffic loop {params.get('loop')!r}: not "
                         f"one of {sorted(KEYS)}")
    if set(params) != set(want):
        raise ValueError(f"{params['loop']} traffic takes the keys "
                         f"{sorted(want)}, not {sorted(params)}")
    for k, sub in want.items():
        if sub is not None and (not isinstance(params[k], dict)
                                or set(params[k]) != sub):
            raise ValueError(f"traffic key {k!r} takes {sorted(sub)}, "
                             f"not {params[k]!r}")
    return params


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of the seed (any whole number)."""
    return np.random.default_rng([abs(int(seed)), stream])


def _loguniform(lo: int, hi: int, u: np.ndarray) -> np.ndarray:
    n = np.floor(lo * (hi / lo) ** u).astype(np.int64)
    return np.clip(n, lo + 1, hi)


def _bitrev(c: int, strata: int) -> int:
    bits = max(int(math.ceil(math.log2(strata))), 1)
    while True:
        r = int(f"{c % (1 << bits):0{bits}b}"[::-1], 2)
        if r < strata:
            return r
        c += 1


def closed_cycles(params: dict, seed: int, vocab: int
                  ) -> Iterator[List[Spec]]:
    """The closed loop's cycles, without end."""
    validate(params)
    order_rng, tok_rng = rng(seed, 1), rng(seed, 2)
    bands, strata = params["bands"], params["strata"]
    uid, c = 0, 0
    while True:
        u = (_bitrev(c, strata) + 0.5) / strata
        cycle = []
        for b in order_rng.permutation(len(bands)):
            lo, hi = bands[b]
            n = int(_loguniform(lo, hi, np.array([u]))[0])
            cycle.append(Spec(uid, tok_rng.integers(0, vocab, n,
                                                    dtype=np.int32),
                              int(params["output_tokens"])))
            uid += 1
        yield cycle
        c += 1


def open_schedule(params: dict, seed: int, seconds: float, vocab: int
                  ) -> List[Spec]:
    """The open loop's requests due in ``[0, seconds)``, in arrival
    order."""
    validate(params)
    n = max(int(round(params["rate_per_s"] * seconds)), 1)
    u = (np.arange(n) + 0.5) / n
    p, o = params["prompt_tokens"], params["output_tokens"]
    lens = _loguniform(p["lo"], p["hi"], u)
    outs = (o["lo"] + np.floor(u * (o["hi"] - o["lo"] + 1))).astype(np.int64)
    gaps = -np.log1p(-u) / params["rate_per_s"]
    gaps *= seconds / gaps.sum()            # the last request due in time
    lens = lens[rng(SCHEDULE, 1).permutation(n)]
    outs = outs[rng(SCHEDULE, 2).permutation(n)]
    gaps = gaps[rng(SCHEDULE, 3).permutation(n)]
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    tok_rng = rng(seed, 4)
    return [Spec(i, tok_rng.integers(0, vocab, int(lens[i]), dtype=np.int32),
                 int(outs[i]), float(arrivals[i])) for i in range(n)]


def profile_prompt(seed: int, n: int, vocab: int) -> np.ndarray:
    """The clustering's profiling prompt (the paper's offline step)."""
    return rng(seed, 5).integers(0, vocab, n, dtype=np.int32)
