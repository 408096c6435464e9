"""The system under test, ``repro_torch``, as the benchmark drives it: a
``ModelConfig`` made from the configuration file (never the port's
registry), the model on the benchmark's weights, SharePrefill's clusters
from the port's offline clustering on a seeded profiling prompt, and the
serving engine whose ``serve`` the window drives.

The benchmark's own instruments sit around the calls into the port:
:class:`ModelProxy` wraps the model's ``prefill`` and ``decode`` (a span
each, and the point where a traced run starts its profiler), and
:func:`instrument` the two places where the port samples a request's
first token, to keep the logits the check reads.  Time to first token is
the port's own span, ``Request.ttft_s``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig, MoEConfig, SharePrefillConfig
from repro_torch.core.api import SharePrefill
from repro_torch.core.clustering import cluster_heads
from repro_torch.core.profile import capture_block_attention_maps
from repro_torch.models.api import build_model
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
from repro_torch.serving.sampling import SamplingConfig
from repro_torch.serving.scheduler import SlotScheduler


def model_config(raw: dict) -> ModelConfig:
    """The port's config from a configuration file's published keys and its
    ``port`` settings."""
    port = raw["port"]
    d, h = raw["hidden_size"], raw["num_attention_heads"]
    window = raw.get("sliding_window") or 0
    if not raw.get("use_sliding_window", True):
        window = 0
    experts = raw.get("num_local_experts", 0)
    moe = (MoEConfig(num_experts=experts, top_k=raw["num_experts_per_tok"],
                     expert_d_ff=raw["intermediate_size"],
                     capacity_factor=port["capacity_factor"])
           if experts else MoEConfig())
    sp = SharePrefillConfig(block_size=port["block_size"],
                            gamma=port["gamma"], tau=port["tau"],
                            delta=port["delta"],
                            min_seq_blocks=port["min_seq_blocks"],
                            min_cluster_size=port["min_cluster_size"])
    return ModelConfig(
        name=raw["model_type"], family="moe" if experts else "dense",
        citation=raw["source"], num_layers=raw["num_hidden_layers"],
        d_model=d, num_heads=h, num_kv_heads=raw["num_key_value_heads"],
        head_dim=raw.get("head_dim") or d // h,
        d_ff=raw["intermediate_size"], vocab_size=raw["vocab_size"],
        max_seq_len=raw["max_position_embeddings"],
        rope_theta=float(raw["rope_theta"]),
        rms_norm_eps=raw["rms_norm_eps"],
        tie_embeddings=raw.get("tie_word_embeddings", False),
        sliding_window=window, dtype="bfloat16", param_dtype="bfloat16",
        moe=moe, share_prefill=sp)


def build(raw: dict, flat: Dict[str, torch.Tensor], device):
    """The port's model and parameters: views of the benchmark's
    weights, no copy."""
    cfg = model_config(raw)
    dtype = next(iter(flat.values())).dtype
    model = build_model(cfg, dtype=dtype, device=device)
    params = checkpoint.params_from_tree(tree_util.unflatten(flat), cfg)
    return model, params


def clusters(model, params, raw: dict, prompt: np.ndarray, seed: int):
    """The port's offline clustering (the paper's profiling step) on one
    prompt: ``(SharePrefill, cluster ids (L, H), clusters, seconds)``."""
    port = raw["port"]
    t0 = time.perf_counter()
    toks = torch.as_tensor(prompt[None].astype(np.int64),
                           device=model.device)
    maps = capture_block_attention_maps(params, model.cfg, toks,
                                        block_size=port["cluster_block"])
    res = cluster_heads(torch.as_tensor(maps, device=model.device),
                        distance_threshold=None,
                        min_cluster_size=port["min_cluster_size"],
                        ae_epochs=port["cluster_epochs"],
                        seed=int(seed) % 2 ** 31)
    sp = SharePrefill.from_clustering(model.cfg.share_prefill,
                                      res.cluster_ids, res.num_clusters)
    return sp, res.cluster_ids, int(res.num_clusters), \
        time.perf_counter() - t0


def engine_config(settings: dict) -> EngineConfig:
    kw = dict(settings)
    kw["seq_buckets"] = tuple(kw["seq_buckets"])
    return EngineConfig(**kw)


def request(spec) -> Request:
    return Request(uid=spec.uid, prompt=spec.prompt,
                   max_new_tokens=spec.max_new_tokens,
                   sampling=SamplingConfig(), arrival_s=spec.arrival_s)


class Recorder:
    """The benchmark's instruments around the port (module docstring).

    ``first`` maps a request's uid to the logits its first token was
    sampled from (a copy on the device), taken where the port samples a
    first token with the request in hand: ``SlotScheduler._first_token``
    (one-shot, chunked, packed and prefix-shared admissions) and
    ``ServingEngine._sample_batch`` (the batch path, whose first call for
    a request is its first token).  ``trace_from`` (seconds on the host
    clock) starts ``tracer`` at the first model call past it."""

    def __init__(self, tracer=None):
        self.tracer = tracer
        self.trace_from: Optional[float] = None
        self.first: Dict[int, torch.Tensor] = {}

    def tick(self) -> None:
        tr = self.tracer
        if (tr is not None and not tr.running and not tr.done
                and self.trace_from is not None
                and time.perf_counter() >= self.trace_from):
            tr.start()

    def on_first_token(self, r: Request, row: torch.Tensor) -> None:
        if r.uid not in self.first and not r.resume_tokens:
            self.first[r.uid] = row.detach().clone()


class ModelProxy:
    """The port's model with the recorder's tick and a profiler span on
    prefill and decode; every other attribute is the model's."""

    def __init__(self, model, rec: Recorder):
        self._model, self._rec = model, rec

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, *args, **kw):
        self._rec.tick()
        with torch.profiler.record_function("bench.prefill"):
            return self._model.prefill(*args, **kw)

    def decode(self, *args, **kw):
        self._rec.tick()
        with torch.profiler.record_function("bench.decode"):
            return self._model.decode(*args, **kw)


def instrument(rec: Recorder):
    """Hand every first token's logits to ``rec`` with its request;
    returns the undo."""
    first_token = SlotScheduler._first_token
    sample_batch = ServingEngine._sample_batch

    def _first_token(self, r, logits):
        rec.on_first_token(r, logits[0])
        return first_token(self, r, logits)

    def _sample_batch(self, gen, logits, grp):
        for i, r in enumerate(grp):
            rec.on_first_token(r, logits[i])
        return sample_batch(self, gen, logits, grp)
    SlotScheduler._first_token = _first_token
    ServingEngine._sample_batch = _sample_batch

    def undo():
        SlotScheduler._first_token = first_token
        ServingEngine._sample_batch = sample_batch
    return undo


def make_engine(model, params, sp, settings: dict, rec: Recorder
                ) -> ServingEngine:
    return ServingEngine(ModelProxy(model, rec), params, sp,
                         engine_config(settings))
