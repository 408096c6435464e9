"""Whisper-style encoder-decoder backbone (port of
``repro/models/whisper.py``; arXiv:2212.04356).

The mel-spectrogram and conv frontend is a stub, as in the reference:
prefill takes precomputed frame embeddings ``embeds (B, T_enc, d)`` (zeros
when none are given, in the parameters' dtype).  A bidirectional encoder
over the frames and a causal decoder with cross-attention; positions are
fixed sinusoidal (``rope_theta = 0``: RoPE is the identity).  SharePrefill
applies to the decoder self-attention (B.1 and B.2, or B.6 per sample);
the encoder and the cross-attention are dense plain PyTorch: the encoder
through :func:`~repro_torch.kernels.chunked.chunked_attention` in blocks
of 64 frames, or one block of all T when T is no multiple of 64 (1500 at
full size); the cross-attention chunked when both lengths are multiples
of 64, else sample by sample through
:func:`~repro_torch.kernels.ref.decode_attention_ref` (the path at 1500
frames).  Decode attends every self-attention slot ≤ pos, right-pad
included, with no plan, as in the reference.

Parameters (:mod:`repro_torch.checkpoint`): ``embed``, ``enc_stack`` (a
list of ``{attn, mlp, ln1, ln2}``), ``enc_norm``, ``dec_stack`` (a list of
``{self_attn, cross_attn, mlp, ln1, ln_x, ln2}``), ``final_norm`` and
``lm_head``.  The cache is ``{"stack": ((k, v), (enc_k, enc_v)), "prefix":
[]}``: the self-attention K/V ``(L, B, Hkv, S, hd)`` and each decoder
layer's projection of the encoder states ``(L, B, Hkv, T, hd)``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import SharePrefill
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.kernels.ops import expand_kv
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models.attention import AttnStats
from repro_torch.models.transformer import (PrefillResult, embed_tokens,
                                            logits_from_hidden,
                                            window_valid_mask, zero_aux)


def _mlp_block(layer, x, cfg: ModelConfig) -> torch.Tensor:
    h = common.rmsnorm(layer["ln2"], x, cfg.rms_norm_eps)
    return x + common.mlp(layer["mlp"], h)


def _add_positions(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    pe = common.sinusoidal_positions(x.shape[1], cfg.d_model,
                                     device=x.device)
    return x + pe[None].to(x.dtype)


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, d) stub frontend output → encoder states."""
    t = frames.shape[1]
    x = _add_positions(frames, cfg)
    for layer in params["enc_stack"]:
        h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
        q, k, v = common.gqa_qkv(layer["attn"], h)
        kx, vx = expand_kv(k, v, q.shape[1])
        bs = 64 if t % 64 == 0 else t
        o = chunked_attention(q, kx, vx, block_size=bs, causal=False)
        x = _mlp_block(layer, x + common.gqa_out(layer["attn"], o), cfg)
    return common.rmsnorm(params["enc_norm"], x, cfg.rms_norm_eps)


def _cross_attend(layer, x, enc_kv, cfg: ModelConfig) -> torch.Tensor:
    q = common.gqa_proj(x, layer["cross_attn"]["wq"])
    kx, vx = expand_kv(*enc_kv, q.shape[1])
    t = kx.shape[2]
    if x.shape[1] % 64 == 0 and t % 64 == 0:
        o = chunked_attention(q, kx, vx, block_size=64, causal=False)
    else:
        o = torch.stack([decode_attention_ref(qq, kk, vv)
                         for qq, kk, vv in zip(q, kx, vx)])
    return common.gqa_out(layer["cross_attn"], o)


def _enc_kv(layer, enc: torch.Tensor):
    return (common.gqa_proj(enc, layer["cross_attn"]["wk"]),
            common.gqa_proj(enc, layer["cross_attn"]["wv"]))


def _cross_block(layer, x, enc_kv, cfg: ModelConfig) -> torch.Tensor:
    h = common.rmsnorm(layer["ln_x"], x, cfg.rms_norm_eps)
    x = x + _cross_attend(layer, h, enc_kv, cfg)
    return _mlp_block(layer, x, cfg)


def forward_train(params, cfg: ModelConfig, tokens, positions=None,
                  embeds=None):
    """Teacher-forced decoder over ``tokens (B, S)`` → (logits (B, S, V),
    zero aux losses): the encoder on ``embeds`` (the frames; zeros of
    ``(B, encoder_seq_len, d)`` when none are given), then each decoder
    layer's self-attention (:func:`~repro_torch.models.attention.
    attention_train`), cross-attention and MLP under the config's
    ``remat_policy``."""
    b, s = tokens.shape
    if embeds is None:
        embeds = params["embed"].new_zeros(
            (b, cfg.encdec.encoder_seq_len, cfg.d_model))
    enc = encode(params, cfg, embeds)
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _add_positions(embed_tokens(params, cfg, tokens), cfg)

    def body(layer, x):
        h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
        x = x + attn_mod.attention_train(layer["self_attn"], h, cfg,
                                         positions)
        return _cross_block(layer, x, _enc_kv(layer, enc), cfg)

    body = common.maybe_remat(body, cfg.remat_policy)
    for layer in params["dec_stack"]:
        x = body(layer, x)
    return logits_from_hidden(params, cfg, x), zero_aux(x.device)


def prefill(params, cfg: ModelConfig, tokens, sp: SharePrefill, *,
            method: str = "share", attn_impl: str = "auto", positions=None,
            embeds=None) -> PrefillResult:
    """Encode ``embeds`` (the frames), then prefill the decoder on the
    padded batch ``tokens (B, S)``; each row's last logits are at the
    padded final position, as in the reference."""
    b, s = tokens.shape
    dev = tokens.device
    if embeds is None:
        embeds = params["embed"].new_zeros(
            (b, cfg.encdec.encoder_seq_len, cfg.d_model))
    enc = encode(params, cfg, embeds)
    if positions is None:
        positions = torch.arange(s, device=dev)[None].expand(b, s)
    x = _add_positions(embed_tokens(params, cfg, tokens), cfg)

    use_sp = sp.cfg.enabled and sp.applicable(s)
    sp_state = sp.init_state(b, s, device=dev) if use_sp else None
    ids = sp.layer_cluster_ids(device=dev) if use_sp else None

    kvs, enc_kvs, stats = [], [], []
    for li, layer in enumerate(params["dec_stack"]):
        h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
        y, kv, sp_state, st = attn_mod.attention_prefill(
            layer["self_attn"], h, cfg, positions, method=method, sp=sp,
            sp_state=sp_state, cluster_ids=None if ids is None else ids[li],
            attn_impl=attn_impl)
        enc_kv = _enc_kv(layer, enc)
        x = _cross_block(layer, x + y, enc_kv, cfg)
        kvs.append(kv)
        enc_kvs.append(enc_kv)
        stats.append(st)
    stack = lambda pairs: tuple(torch.stack(list(c)) for c in zip(*pairs))
    logits = logits_from_hidden(params, cfg, x[:, -1, :])
    return PrefillResult(logits, {"stack": (stack(kvs), stack(enc_kvs)),
                                  "prefix": []},
                         AttnStats.reduce_layers(stats), sp_state)


def decode_step(params, cfg: ModelConfig, token, cache, pos, positions=None,
                *, window: int = 0, embeds=None):
    """One decoder token at the lockstep position ``pos`` (an int or a 0-d
    tensor): the sinusoidal embedding of row ``pos`` (of a table of cache
    length + 1 rows, as the reference builds it), then every layer's self-
    attention over the slots ≤ pos (within ``window`` when it is > 0) and
    its cross-attention over the cached encoder projections.  The self-
    attention cache is written in place and returned.  ``embeds`` is
    unused: the frames were encoded at prefill."""
    x = embed_tokens(params, cfg, token)
    b, dev = x.shape[0], x.device
    if isinstance(pos, torch.Tensor) and pos.dim():
        raise ValueError("the encdec family decodes at one lockstep pos")
    pos = int(pos)
    (ks, vs), (eks, evs) = cache["stack"]
    s = ks.shape[3]
    pe = common.sinusoidal_positions(s + 1, cfg.d_model, device=dev)
    x = x + pe[pos][None, None].to(x.dtype)
    if positions is None:
        positions = attn_mod.row_positions(pos, b, dev)
    valid = (window_valid_mask(None, s, pos, window, b, dev) if window > 0
             else None)
    for li, layer in enumerate(params["dec_stack"]):
        h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
        y = attn_mod.attention_decode(layer["self_attn"], h, cfg, ks[li],
                                      vs[li], pos, positions,
                                      valid_mask=valid)
        x = _cross_block(layer, x + y, (eks[li], evs[li]), cfg)
    return logits_from_hidden(params, cfg, x[:, -1, :]), cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               dtype=torch.float32, device=None):
    """Zeroed self-attention K/V of ``cache_len`` slots and encoder K/V of
    ``encoder_seq_len``."""
    shape = lambda n: (cfg.num_layers, batch, cfg.num_kv_heads, n,
                       cfg.resolved_head_dim)
    zeros = lambda n: torch.zeros(shape(n), dtype=dtype, device=device)
    t = cfg.encdec.encoder_seq_len
    return {"stack": ((zeros(cache_len), zeros(cache_len)),
                      (zeros(t), zeros(t))), "prefix": []}
