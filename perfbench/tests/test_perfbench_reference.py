"""The plain reference against the port at a tiny size on the CPU, both
in float32: SharePrefill's patterns worked out again (sparse ones, at a
low γ) give the port's block density, and the logits of a prefill and of
a paged serve's decoded tokens agree."""
import numpy as np
import pytest
import torch

from conftest import tiny_cell
from perfbench import system, weights
from perfbench.reference.model import Reference, Seq
from perfbench.traffic.generator import Spec, profile_prompt
from repro_torch.serving.engine import ServingEngine

CELLS = ("qwen2.5-7b.prefill-long", "mixtral-8x22b.serve-docqa")


def _setup(cell, seed=5):
    torch.set_num_threads(2)
    wl, cfg, _ = tiny_cell(cell)
    cfg["port"].update(gamma=0.1, delta=0.6, tau=0.5)   # sparse masks
    flat = weights.make(cfg, seed, device="cpu", dtype=torch.float32)
    flat["stack::attn::wq"].mul_(6.0)          # peaked attention
    model, params = system.build(cfg, flat, torch.device("cpu"))
    sp, ids, n, _ = system.clusters(
        model, params, cfg, profile_prompt(seed, 256, cfg["vocab_size"]),
        seed)
    return wl, cfg, flat, model, params, sp, ids, n


@pytest.mark.parametrize("cell", CELLS)
def test_prefill_logits_and_density(cell):
    wl, cfg, flat, model, params, sp, ids, n = _setup(cell)
    rng = np.random.default_rng(0)
    for plen in (1024, 1000):
        prompt = rng.integers(0, cfg["vocab_size"], plen)
        toks = np.zeros((1, 1024), np.int64)
        toks[0, :plen] = prompt
        res = model.prefill(params, torch.as_tensor(toks), sp,
                            prompt_lens=torch.tensor([plen]))
        ref = Reference(cfg, flat)
        got = ref.logits([Seq(prompt, 1024, [0])], ids, n)[0][0]
        assert float(res.stats.block_density) < 0.99       # sparse
        assert np.mean(ref.density[0]) == pytest.approx(
            float(res.stats.block_density), abs=1e-6)
        err = (res.last_logits[0] - got).abs().max() / got.std()
        assert err < 1e-4, err


@pytest.mark.parametrize("cell", CELLS)
def test_served_tokens_follow_the_reference(cell):
    wl, cfg, flat, model, params, sp, ids, n = _setup(cell, seed=6)
    settings = dict(wl["engine"], seq_buckets=[256, 512], paged=True,
                    scheduler=True, max_batch=2)
    eng = ServingEngine(model, params, sp, system.engine_config(settings))
    rng = np.random.default_rng(1)
    specs = [Spec(i, rng.integers(0, cfg["vocab_size"], plen), 5)
             for i, plen in enumerate((500, 300, 200))]
    reqs = [system.request(s) for s in specs]
    eng.serve(reqs)
    seqs = [Seq(s.prompt, 512 if len(s.prompt) > 256 else 256,
                [int(t) for t in r.output_tokens])
            for s, r in zip(specs, reqs)]
    ref = Reference(cfg, flat).logits(seqs, ids, n)
    for s, lg in zip(seqs, ref):
        best = lg.max(-1).values
        served = lg.gather(-1, torch.tensor(s.served)[:, None])[:, 0]
        assert float((best - served).max()) < 1e-3
