"""Shared set-up of the port's lifecycle and refresh tests
(``test_torch_lifecycle.py``, ``test_torch_refresh.py``).

Both packages serve granite-3-2b's smoke config (2 layers, 4 heads, block
64) from the same parameters (the reference's, through
``checkpoint.params_from_numpy``), with the reference tests' prompts
(``repro.data.sample`` of the retrieval task).  The reference runs on the
CPU as its own tests run it; the port runs its kernels' plain versions on
CPU tensors.

Greedy tokens are compared near-tie aware: a stream may leave the
reference's only at a token where the reference's top-2 logit margin is
below ``TIE_TOL``.  The margins come from the reference's own serve: a
:class:`MarginRecorder` (a fault injector with no faults of its own, or
with the serve's) reads every decode row the scheduler hands to
``corrupt_logits``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.data import DataConfig, sample
from repro.models.api import build_model as j_build
from repro.serving import EngineConfig as JConfig
from repro.serving import FaultInjector as JFaults
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.serving import (EngineConfig, Request, ServingEngine,
                                 SlotScheduler)

ARCH = "granite-3-2b"
TIE_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while a test file runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def page_leak_audit(monkeypatch):
    """Every paged serve a test runs ends with zero pages in use and a
    consistent allocator."""
    seen = []
    summary = SlotScheduler._pool_summary

    def audited(self):
        summary(self)
        if self.paged:
            seen.append((self.alloc, dict(self.eng.page_pool_stats)))

    monkeypatch.setattr(SlotScheduler, "_pool_summary", audited)
    yield seen
    for alloc, stats in seen:
        alloc.check_consistency()
        assert stats["pages_in_use_at_end"] == 0, stats


def make_pair(arch=ARCH, **cfg_kw):
    """The reference model and parameters, the port's model on the CPU
    and the same parameters crossed over (``arch``'s smoke config)."""
    jcfg = dataclasses.replace(j_smoke(arch), **cfg_kw)
    tcfg = dataclasses.replace(get_smoke_config(arch), **cfg_kw)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = checkpoint.params_from_numpy(_flatten(jp), tcfg, device="cpu")
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, cfg=tcfg, engines={})


def prompts(max_new, seq, base, vocab):
    dcfg = DataConfig(vocab_size=vocab, seq_len=seq, global_batch=1,
                      task="retrieval")
    return [np.asarray(sample(dcfg, base + i)["tokens"])
            for i in range(len(max_new))]


def requests(cls, vocab, max_new, seq=64, base=0, **kw):
    """One request per ``max_new`` entry, uids from ``base``."""
    return [cls(uid=base + i, prompt=p, max_new_tokens=m, **kw)
            for i, (p, m) in enumerate(
                zip(prompts(max_new, seq, base, vocab), max_new))]


class MarginRecorder(JFaults):
    """The reference's fault injector, also recording the top-2 margin of
    every decode row it sees, by (uid, generated-token index)."""

    def __init__(self, *specs):
        super().__init__(*specs)
        self.margins = {}

    def corrupt_logits(self, uid, token_index, row):
        top2 = np.sort(np.asarray(row, np.float32))[-2:]
        self.margins[(uid, token_index)] = float(top2[1] - top2[0])
        return super().corrupt_logits(uid, token_index, row)


def ref_engine(pair, **kw):
    """The reference engine of one configuration (cached per pair, so its
    compiled programs are shared between tests)."""
    key = tuple(sorted(kw.items()))
    if key not in pair["engines"]:
        jm = pair["jm"]
        pair["engines"][key] = JEngine(jm, pair["jp"],
                                       jm.default_share_prefill(),
                                       JConfig(method="share", **kw))
    return pair["engines"][key]


def port_engine(pair, **kw):
    tm = pair["tm"]
    return ServingEngine(tm, pair["tp"], tm.default_share_prefill(),
                         EngineConfig(method="share", **kw))


def ref_batch_margins(p, reqs, seq, **prefill_kw):
    """The reference's batch path of a plain family (no prompt lengths, no
    plan) replayed on its own tokens: every row's top-2 logit margin by
    (uid, generated-token index); ``prefill_kw`` go to its prefill."""
    import jax.numpy as jnp
    jm = p["jm"]
    toks = np.zeros((len(reqs), seq), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = r.prompt
    res = jm.prefill(p["jp"], jnp.asarray(toks), jm.default_share_prefill(),
                     **prefill_kw)
    cache = JEngine.grow_cache(res.cache, seq, 64)
    logits, margins = res.last_logits, {}
    for t in range(max(len(r.output_tokens) for r in reqs)):
        rows = np.asarray(logits, np.float32)
        tok = np.zeros((len(reqs), 1), np.int32)
        for i, r in enumerate(reqs):
            top2 = np.sort(rows[i])[-2:]
            margins[(r.uid, t)] = float(top2[1] - top2[0])
            if t < len(r.output_tokens):
                tok[i, 0] = r.output_tokens[t]
        logits, cache = jm.decode(p["jp"], jnp.asarray(tok), cache,
                                  jnp.int32(seq + t))
    return margins


def assert_greedy_agree(ref, got, margins):
    """Equal streams and finish reasons, or a first flip where the
    reference's margin is below ``TIE_TOL``; returns whether every stream
    was identical."""
    identical = True
    for r, g in zip(ref, got):
        a, b = r.output_tokens.tolist(), g.output_tokens.tolist()
        flip = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        if flip is None:
            assert len(a) == len(b), (r.uid, a, b)
            assert r.finish_reason == g.finish_reason, r.uid
            continue
        identical = False
        m = margins.get((r.uid, flip))
        print(f"request {r.uid}: flip at token {flip}, margin {m}")
        assert m is not None and m < TIE_TOL, (r.uid, flip, m)
    return identical


__all__ = ["ARCH", "JRequest", "MarginRecorder", "Request", "TIE_TOL",
           "assert_greedy_agree", "make_pair", "one_torch_thread",
           "page_leak_audit", "port_engine", "prompts", "ref_batch_margins",
           "ref_engine", "requests"]
