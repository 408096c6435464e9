"""Synthetic long-context data pipelines (port of
``repro/data/pipeline.py``; numpy only, so the streams equal the
reference's batch for batch).

No datasets can be fetched, so the pipelines generate *structured*
synthetic corpora whose attention signatures emulate the paper's task
families:

  lm          Zipf-distributed token soup with Markov bigram structure
              (PG-19-style language modeling)
  retrieval   needle-in-haystack key/value retrieval (Retr.KV /
              Retr.PassKey: the clustering profile sample, paper §5.2)
  copy        random-span copy task (Code.Debug-style irregular attention)
  dialogue    repeated speaker-turn structure (En.Dia staircase patterns)

Every generator is deterministic in (seed, index, task), so hosts can
shard by index without coordination.  The task enters the seed as
``hash(cfg.task) % 2**31``, as in the reference: Python's string hash is
salted per process, so a stream is reproducible only within one process
or under a fixed ``PYTHONHASHSEED`` (the test suite pins it through
``pyproject.toml``'s plugin).  No check on the card depends on a stream's
exact tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

TASKS = ("lm", "retrieval", "copy", "dialogue")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    task: str = "lm"
    seed: int = 0
    zipf_a: float = 1.2
    needle_len: int = 8
    span_len: int = 64
    turn_len: int = 32


def _rng(cfg: DataConfig, index: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, index, hash(cfg.task) % (2**31)]))


def _zipf_tokens(rng, n, vocab, a):
    z = rng.zipf(a, size=n)
    return np.minimum(z - 1, vocab - 1).astype(np.int32)


def _sample_lm(cfg: DataConfig, rng) -> np.ndarray:
    toks = _zipf_tokens(rng, cfg.seq_len + 1, cfg.vocab_size, cfg.zipf_a)
    # inject bigram structure: every even position partially determines next
    det = (toks[:-1] * 7 + 3) % cfg.vocab_size
    mask = rng.random(cfg.seq_len) < 0.5
    toks[1:][mask] = det[mask]
    return toks


def _sample_retrieval(cfg: DataConfig, rng) -> np.ndarray:
    """key tokens hidden early, query at the end must retrieve them.

    Positions are in *token* coordinates (``tokens = toks[:-1]``) so the
    needle appears verbatim at ``key_pos`` and at the tail of the prompt;
    the final label continues the needle (the retrieval target)."""
    seq = cfg.seq_len
    toks = _zipf_tokens(rng, seq + 1, cfg.vocab_size, cfg.zipf_a)
    nl = cfg.needle_len
    key_pos = rng.integers(nl, max(seq // 2, nl + 1))
    needle = rng.integers(2, cfg.vocab_size, size=nl).astype(np.int32)
    toks[key_pos: key_pos + nl] = needle
    toks[seq - nl: seq] = needle                # prompt tail echoes the key
    toks[seq] = needle[0]                       # label: continue the needle
    return toks


def _sample_copy(cfg: DataConfig, rng) -> np.ndarray:
    toks = _zipf_tokens(rng, cfg.seq_len + 1, cfg.vocab_size, cfg.zipf_a)
    sl = min(cfg.span_len, cfg.seq_len // 4)
    n_spans = max(1, cfg.seq_len // (8 * sl))
    for _ in range(n_spans):
        src = rng.integers(0, cfg.seq_len - 2 * sl)
        dst = rng.integers(src + sl, cfg.seq_len - sl + 1)
        toks[dst: dst + sl] = toks[src: src + sl]
    return toks


def _sample_dialogue(cfg: DataConfig, rng) -> np.ndarray:
    toks = _zipf_tokens(rng, cfg.seq_len + 1, cfg.vocab_size, cfg.zipf_a)
    tl = cfg.turn_len
    speakers = [rng.integers(2, cfg.vocab_size, size=4).astype(np.int32)
                for _ in range(2)]
    for t in range(0, cfg.seq_len - tl, tl):
        toks[t: t + 4] = speakers[(t // tl) % 2]
    return toks


_SAMPLERS = {
    "lm": _sample_lm,
    "retrieval": _sample_retrieval,
    "copy": _sample_copy,
    "dialogue": _sample_dialogue,
}


def sample(cfg: DataConfig, index: int) -> Dict[str, np.ndarray]:
    rng = _rng(cfg, index)
    toks = _SAMPLERS[cfg.task](cfg, rng)
    return {"tokens": toks[:-1], "labels": toks[1:]}


def batches(cfg: DataConfig, *, start_index: int = 0,
            num_hosts: int = 1, host_id: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite batch iterator, host-sharded by index."""
    per_host = cfg.global_batch // num_hosts
    step = 0
    while True:
        base = start_index + step * cfg.global_batch + host_id * per_host
        rows = [sample(cfg, base + i) for i in range(per_host)]
        yield {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        step += 1


def eval_batches(cfg: DataConfig, num_batches: int, *, offset: int = 10**6):
    it = batches(dataclasses.replace(cfg, seed=cfg.seed + 1),
                 start_index=offset)
    for _ in range(num_batches):
        yield next(it)
