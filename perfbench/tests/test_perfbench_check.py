"""The check: a sound run is correct; the control (the reference in
float8) fails a cell's limits; and the run comes out not correct with
the timed path broken underneath: a token altered where it is produced,
one request's decoded tokens altered, a first token altered, the
first-token logits off (the prefill cell), every SharePrefill mask built
dense, half of the requests left unanswered; and first tokens stay paired
with their requests through chunked, packed and prefix-hit admissions.  The harness's look for a card is skipped (the runs are
on the CPU at a tiny size); ``test_control_on_the_card`` runs the
control at the cell's own size on the chip."""
import types

import numpy
import pytest
import torch

from conftest import CELLS, run_tiny, tiny_cell
from perfbench import check, files
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import scheduler as scheduler_mod


def _sparse(wl, cfg, traffic):
    """Sparse SharePrefill masks at the tiny size (random weights keep
    nearly every block otherwise)."""
    cfg["port"].update(gamma=0.1, delta=0.6, tau=0.5)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_control_is_not(cell):
    detail = {"control": True}
    res = run_tiny(cell, detail=detail, edit=_sparse)
    assert res["correct"], res
    limits = files.workload(cell)["check"]["limits"]
    ctrl = check.numbers(detail["control"])
    assert any(ctrl[k] > v for k, v in limits.items()), ctrl
    assert list(res)[-1] == "checked"
    assert set(res["checked"]) == set(limits) | {"requests_faulted"}


def test_decoded_token_altered():
    class Argmax:                       # numpy, with a wrong argmax
        def __getattr__(self, name):
            return getattr(numpy, name)

        @staticmethod
        def argmax(a, *args, **kw):
            return (int(numpy.argmax(a)) + 1) % a.shape[-1]
    mp = pytest.MonkeyPatch()
    mp.setattr(scheduler_mod, "np", Argmax())
    try:
        res = run_tiny("mixtral-8x22b.serve-docqa")
    finally:
        mp.undo()
    assert not res["correct"]
    assert res["checked"]["token_mismatch_share"]["value"] > \
        res["checked"]["token_mismatch_share"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_first_token_altered(cell, monkeypatch):
    orig = engine_mod.sample_token
    monkeypatch.setattr(engine_mod, "sample_token",
                        lambda lg, cfg, gen: (orig(lg, cfg, gen) + 1)
                        % lg.shape[-1])
    monkeypatch.setattr(scheduler_mod, "sample_token",
                        engine_mod.sample_token)
    res = run_tiny(cell)
    assert not res["correct"]
    assert res["checked"]["requests_faulted"]["value"] > 0


@pytest.mark.parametrize("cell", ["qwen2.5-7b.prefill-long"])
def test_first_logits_off(cell, monkeypatch):
    """The prefill cell holds the first-token logits; the served cell
    holds the greedy tokens it serves, which halved logits leave as they
    are."""
    from repro_torch.models.api import Model
    orig = Model.prefill

    def prefill(self, *args, **kw):
        out = orig(self, *args, **kw)
        return out._replace(last_logits=out.last_logits * 0.5)
    monkeypatch.setattr(Model, "prefill", prefill)
    res = run_tiny(cell)
    assert not res["correct"]
    first = [k for k in res["checked"] if k.startswith("logit_rel_err")][0]
    assert res["checked"][first]["value"] > res["checked"][first]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_requests_unanswered(cell, monkeypatch):
    orig = engine_mod.ServingEngine.serve

    def serve(self, requests, **kw):
        return orig(self, [r for r in requests if r.uid % 2 == 0
                           or r.uid >= 10 ** 9], **kw)
    monkeypatch.setattr(engine_mod.ServingEngine, "serve", serve)
    res = run_tiny(cell, seconds=0.5)
    assert not res["correct"]
    assert res["failed"] >= res["attempted"] // 2


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell, card):
    """At the cell's own size and load: the system passes and the control
    fails (three seeds; ``calibrate.py`` reads a dozen)."""
    import argparse
    import time
    bench = files.benchmark()
    wl = files.workload(cell)
    cfg, traffic = files.config(wl["config"]), files.traffic(wl["traffic"])
    from perfbench import harness
    for seed in (11, 12, 13):
        detail = {"control": True}
        args = argparse.Namespace(workload=cell, seed=seed, seconds=20.0,
                                  trace=0)
        res = harness.run_cell(args, time.time(),
                               files.cell_entry(bench, cell), wl, cfg,
                               traffic, [], [], {}, card, detail=detail)
        assert res["correct"], res
        ctrl = check.numbers(detail["control"])
        assert any(ctrl[k] > v for k, v in wl["check"]["limits"].items())


def _count_calls(monkeypatch, cls, name):
    """Wrap ``cls.name`` to count its calls."""
    calls = []
    orig = getattr(cls, name)

    def wrapped(self, *args, **kw):
        calls.append(1)
        return orig(self, *args, **kw)
    monkeypatch.setattr(cls, name, wrapped)
    return calls


@pytest.mark.parametrize("pack", [1, 2])
def test_chunked_admission_stays_correct(pack, monkeypatch):
    """First tokens are paired with their requests however the port
    admits them: chunked prefill, packed or not."""
    runs = _count_calls(monkeypatch, scheduler_mod.SlotScheduler,
                        "_complete_run")

    def edit(wl, cfg, traffic):
        wl["engine"].update(prefill_chunk=128, prefill_pack=pack)
    res = run_tiny("mixtral-8x22b.serve-docqa", edit=edit)
    assert runs, "no chunked admission ran"
    assert res["correct"], res
    assert res["checked"]["requests_faulted"]["value"] == 0


def test_prefix_hits_stay_correct(monkeypatch):
    """With ``prefix_sharing`` on and every document asked twice, the
    requests that skip their prefill get their own first tokens."""
    from perfbench.traffic import generator
    hits = _count_calls(monkeypatch, scheduler_mod.SlotScheduler,
                        "_start_from_prefix")
    orig = generator.open_schedule

    def twice(params, seed, seconds, vocab):
        specs = orig(params, seed, seconds, vocab)
        for a, b in zip(specs[0::2], specs[1::2]):
            b.prompt = a.prompt.copy()
        return specs
    monkeypatch.setattr(generator, "open_schedule", twice)

    def edit(wl, cfg, traffic):
        wl["engine"].update(prefix_sharing=True)
    res = run_tiny("mixtral-8x22b.serve-docqa", seconds=2.0, edit=edit)
    assert hits, "no prefix hit"
    assert res["correct"], res
    assert res["checked"]["requests_faulted"]["value"] == 0


def test_dense_patterns_fail_the_prefill_cell(monkeypatch):
    """A fault in the pattern layer: SharePrefill's masks built causal
    (every block kept) in the port.  Where the masks are sparse, the
    first-token logits leave the reference's, and so does the kept share
    of blocks."""
    from repro_torch.core import share_attention
    from repro_torch.core.patterns import causal_block_mask
    built = []

    def dense(q, k, state, cluster_ids, cfg, extra_mask=None):
        masks, decision = orig(q, k, state, cluster_ids, cfg, extra_mask)
        built.append(1)
        causal = causal_block_mask(masks.shape[-1], device=masks.device)
        return causal.expand_as(masks).clone(), decision
    orig = share_attention.build_share_masks
    monkeypatch.setattr(share_attention, "build_share_masks", dense)

    def edit(wl, cfg, traffic):
        _sparse(wl, cfg, traffic)
        wl["check"]["sample"] = 100     # every request, the sparse ones too
    detail = {}
    res = run_tiny("qwen2.5-7b.prefill-long", edit=edit, detail=detail)
    assert built
    assert not res["correct"]
    got = res["checked"]["logit_rel_err"]
    assert got["value"] > got["limit"]
    assert check.numbers(detail["system"])["block_density_err"] > 0.01


def test_one_request_decoded_wrong(monkeypatch):
    """One request of ten checked has every decoded token altered where
    it is produced: the widest gap where the routing is clear of a tie
    catches it, whatever the median and the share read."""
    from perfbench.traffic import generator
    seconds, seed = 3.0, 3
    wl, cfg, traffic = tiny_cell("mixtral-8x22b.serve-docqa")
    specs = generator.open_schedule(traffic, seed, seconds,
                                    cfg["vocab_size"])
    longest = max(specs, key=lambda s: (len(s.prompt) + s.max_new_tokens,
                                        -s.uid)).uid
    vocab = cfg["vocab_size"]

    class Altered(list):
        def append(self, tok):
            super().append((tok + 1) % vocab)
    orig = scheduler_mod.SlotScheduler._first_token

    def first_token(self, r, logits):
        s = orig(self, r, logits)
        if r.uid == longest:
            s.outs = Altered(s.outs)
        return s
    monkeypatch.setattr(scheduler_mod.SlotScheduler, "_first_token",
                        first_token)

    def edit(wl, cfg, traffic):
        wl["check"]["sample"] = 10
    res = run_tiny("mixtral-8x22b.serve-docqa", seed=seed, seconds=seconds,
                   edit=edit)
    assert not res["correct"]
    got = res["checked"]["token_gap_clear"]
    assert got["value"] > got["limit"], res["checked"]
