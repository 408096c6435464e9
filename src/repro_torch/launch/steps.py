"""Step builders of the dry-run and the card's launch checks (port of
``repro/launch/steps.py``).

For each (arch, input shape) this module produces:
  * the step function (train_step / prefill_step / decode_step), run inside
    a :class:`~repro_torch.distributed.sharding.ShardingRules` context on
    the mesh (so the models' ``shard()`` activation constraints place each
    ``DTensor`` as the reference's do) and under ``implicit_replication``
    (the tensors a model builds itself, rope tables, masks, ``arange``,
    join the mesh replicated);
  * its arguments, the twin of the reference's ``ShapeDtypeStruct``s:
    ``DTensor``s over ``mesh.device_mesh`` whose local shards are ``meta``
    tensors (shapes and dtypes, no data, nothing allocated), placed by
    :func:`~repro_torch.distributed.param_specs.param_shardings`,
    :func:`~repro_torch.distributed.param_specs.cache_shardings` and
    :func:`~repro_torch.distributed.param_specs.batch_pspec`;
  * those placements (``in_shardings``).

The same ``fn`` runs on plain tensors with values (:func:`plain_args`),
where every ``shard()`` is the identity: on the card it launches the
port's kernels.

Decode shapes run ``decode`` — ONE token against a ``seq_len`` KV cache,
written at its last slot; ``long_500k`` uses the sub-quadratic variant per
family (SSM/RG-LRU state, native SWA for Mixtral, SWA-decode for dense GQA —
DESIGN.md §6).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import checkpoint
from repro_torch import tree as tu
from repro_torch.configs import ModelConfig, get_config, get_shape
from repro_torch.core.api import SharePrefill
from repro_torch.distributed.param_specs import (
    batch_pspec,
    cache_shardings,
    param_shardings,
    placements,
)
from repro_torch.distributed.sharding import P, ShardingRules, use_rules
from repro_torch.models import build_model
from repro_torch.models.api import Model
from repro_torch.optim import AdamWState, init_adamw
from repro_torch.training import TrainConfig, make_train_step

LONG_DECODE_WINDOW = 8192       # SWA-decode window for dense archs


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Callable
    args: Tuple[Any, ...]           # DTensors over meta shards
    in_shardings: Any               # their placements
    model: Model
    cfg: ModelConfig


def _with_rules(fn: Callable, mesh) -> Callable:
    """Run the step inside a ShardingRules context, so the models'
    ``shard()`` activation constraints bind to the mesh, and under
    ``implicit_replication``."""
    rules = ShardingRules(mesh)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with use_rules(rules), implicit_replication():
            return fn(*args, **kwargs)
    return wrapped


def _has_values(x: torch.Tensor) -> bool:
    """Whether ``x`` holds data: not a ``meta`` tensor, nor a ``DTensor``
    over meta shards (the dry-run's arguments)."""
    if type(x) is not torch.Tensor and hasattr(x, "to_local"):
        x = x.to_local()
    return x.device.type != "meta"


def step_attn_impl(requested: str, values: bool) -> str:
    """The prefill attention a step runs: ``requested``, except that
    ``auto`` on tensors without values is the dense chunked path (the
    sparse path's tables are sized by values), as the reference's ``auto``
    lowers to chunked off the TPU."""
    return "chunked" if requested == "auto" and not values else requested


def _placed(leaf: torch.Tensor, mesh, place) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(leaf, mesh.device_mesh, place,
                             src_data_rank=None)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _extra_inputs(cfg: ModelConfig, batch: int, seq: int, mesh,
                  dtype) -> Dict[str, Any]:
    """Modality-stub inputs (DESIGN.md §5): VLM M-RoPE ids, audio frames."""
    bspec = batch_pspec(mesh, batch)
    extras: Dict[str, Any] = {}
    if cfg.vlm.enabled:
        extras["positions"] = _placed(
            _meta((3, batch, seq), torch.int32), mesh,
            placements(P(None, *bspec), mesh))
    if cfg.encdec.enabled:
        extras["embeds"] = _placed(
            _meta((batch, cfg.encdec.encoder_seq_len, cfg.d_model), dtype),
            mesh, placements(bspec, mesh))
    return extras


def _sp_for(cfg: ModelConfig) -> SharePrefill:
    if not cfg.share_prefill.enabled or not cfg.num_heads:
        return SharePrefill.disabled()
    return SharePrefill.trivial(cfg.share_prefill, cfg.num_layers,
                                cfg.num_heads)


def _placements_of(tree):
    return tu.tree_map(lambda x: tuple(x.placements), tree)


def build_step(arch: str, shape_name: str, mesh, *,
               method: str = "share",
               dtype=torch.bfloat16,
               fsdp=None,
               microbatches: int = 1) -> StepBundle:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if shape.kind == "train" and cfg.remat_policy == "none":
        cfg = dataclasses.replace(cfg, remat_policy="dots")
    model = build_model(cfg, dtype=dtype, device="meta")
    b, s = shape.global_batch, shape.seq_len

    params_meta = checkpoint.params_to_tree(
        model.init(torch.Generator()), cfg)
    use_fsdp = fsdp if fsdp is not None else (shape.kind == "train")
    p_shard = param_shardings(params_meta, mesh, fsdp=use_fsdp)
    params = tu.tree_map(lambda x, pl: _placed(x, mesh, pl), params_meta,
                         p_shard)
    bspec = placements(batch_pspec(mesh, b), mesh)
    rep = placements(P(), mesh)
    extras = _extra_inputs(cfg, b, s, mesh, dtype)

    if shape.kind == "train":
        tcfg = TrainConfig(microbatches=microbatches)
        extra_fn = (lambda batch: {k: batch[k] for k in extras}) \
            if extras else None
        step = make_train_step(model, tcfg, extra_fn)
        opt = init_adamw(params)
        opt_shard = AdamWState(step=rep, mu=p_shard, nu=p_shard)
        opt = opt._replace(step=_placed(opt.step, mesh, rep))
        batch = {
            "tokens": _placed(_meta((b, s), torch.int32), mesh, bspec),
            "labels": _placed(_meta((b, s), torch.int32), mesh, bspec),
            **extras,
        }
        args = (params, opt, batch)
        in_sh = (p_shard, opt_shard, _placements_of(batch))
        return StepBundle(f"{arch}/{shape_name}/train",
                          _with_rules(step, mesh), args, in_sh, model, cfg)

    if shape.kind == "prefill":
        sp = _sp_for(cfg)

        def prefill_step(params, tokens, extras):
            return model.prefill(
                checkpoint.params_from_tree(params, cfg), tokens, sp,
                method=method,
                attn_impl=step_attn_impl("auto", _has_values(tokens)),
                **extras)

        tokens = _placed(_meta((b, s), torch.int32), mesh, bspec)
        args = (params, tokens, extras)
        in_sh = (p_shard, bspec, _placements_of(extras))
        return StepBundle(f"{arch}/{shape_name}/prefill",
                          _with_rules(prefill_step, mesh), args, in_sh,
                          model, cfg)

    # decode
    window = 0
    if shape_name == "long_500k" and cfg.family in ("dense", "vlm", "moe"):
        window = cfg.sliding_window or LONG_DECODE_WINDOW

    cache_meta = model.init_cache(b, s, dtype=dtype)
    c_shard = cache_shardings(cache_meta, mesh, batch=b)
    cache = tu.tree_map(lambda x, pl: _placed(x, mesh, pl), cache_meta,
                        c_shard)
    token = _placed(_meta((b, 1), torch.int32), mesh, bspec)
    # the write slot: the cache's last, so every slot is attended
    pos = torch.tensor(s - 1, dtype=torch.int32)
    dec_extras = {}
    if cfg.vlm.enabled:
        dec_extras["positions"] = _placed(
            _meta((3, b, 1), torch.int32), mesh,
            placements(P(None, *batch_pspec(mesh, b)), mesh))

    def decode_fn(params, token, cache, pos, extras):
        return model.decode(checkpoint.params_from_tree(params, cfg), token,
                            cache, int(pos), window=window, **extras)

    args = (params, token, cache, pos, dec_extras)
    in_sh = (p_shard, bspec, c_shard, rep, _placements_of(dec_extras))
    return StepBundle(f"{arch}/{shape_name}/decode",
                      _with_rules(decode_fn, mesh), args, in_sh, model, cfg)


def plain_args(bundle: StepBundle, make: Callable) -> Tuple[Any, ...]:
    """The bundle's arguments as plain tensors with values: ``make(key,
    shape, dtype)`` gives each ``DTensor`` leaf's (``key`` its path in the
    arguments, e.g. ``0::stack::attn::wq``); a plain leaf (the decode
    position) is kept."""
    def leaf(key, x):
        if type(x) is torch.Tensor:
            return x
        return make(key, tuple(x.shape), x.dtype)
    return tuple(tu.tree_map_with_path(leaf, a, prefix=str(i))
                 for i, a in enumerate(bundle.args))
