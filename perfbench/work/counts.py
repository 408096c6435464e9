"""What a request needs, counted from the configuration file's published
shapes and the request's own sizes.

* Model FLOPs count each multiply-add as 2, at the prompt's real tokens
  (padding is not work), the experts at the routed top-k tokens (not at
  the port's capacity slots), and attention over the share of causal
  blocks SharePrefill kept (``density``), plus B.1's strip.
* The kernels' counts (:func:`strip_work`, :func:`bsa_work`) are of the
  inputs the kernel is given: the padded prefill row, each input byte read
  once and each output byte written once.
"""
from __future__ import annotations


def dims(cfg: dict) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "h": h, "hkv": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or d // h,
            "f": cfg["intermediate_size"], "v": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"],
            "e": cfg.get("num_local_experts", 0),
            "k": cfg.get("num_experts_per_tok", 0),
            "bs": cfg["port"]["block_size"]}


def token_linear_flops(cfg: dict) -> float:
    """The projections and the feed-forward of one token, all layers."""
    m = dims(cfg)
    attn = m["d"] * (m["h"] + 2 * m["hkv"]) * m["hd"] + m["h"] * m["hd"] * m["d"]
    if m["e"]:
        ffn = m["d"] * m["e"] + m["k"] * 3 * m["d"] * m["f"]
    else:
        ffn = 3 * m["d"] * m["f"]
    return 2.0 * m["L"] * (attn + ffn)


def head_flops(cfg: dict) -> float:
    m = dims(cfg)
    return 2.0 * m["d"] * m["v"]


def prefill_flops(cfg: dict, prompt_len: int, density: float) -> float:
    """A prompt's prefill: linear work at its tokens, causal attention over
    the kept share of blocks, the strip of its last block, one row of
    logits."""
    m = dims(cfg)
    n = prompt_len
    attn = 4.0 * m["hd"] * m["h"] * density * n * (n + 1) / 2
    strip = 2.0 * m["h"] * min(m["bs"], n) * n * m["hd"]
    return n * token_linear_flops(cfg) + m["L"] * (attn + strip) \
        + head_flops(cfg)


def decode_flops(cfg: dict, context: int) -> float:
    """One decoded token attending ``context`` tokens (itself included)."""
    m = dims(cfg)
    return (token_linear_flops(cfg) + m["L"] * 4.0 * m["hd"] * m["h"]
            * context + head_flops(cfg))


def strip_work(cfg: dict, n: int) -> tuple:
    """(FLOPs, bytes) of B.1 on a padded row of ``n`` for all layers: the
    last block's queries against every key (bf16 in), the float32 strip
    out."""
    m = dims(cfg)
    bs = m["bs"]
    flops = 2.0 * m["h"] * bs * n * m["hd"]
    nbytes = 2.0 * (m["h"] * bs * m["hd"] + m["hkv"] * n * m["hd"]) \
        + 4.0 * m["h"] * bs * n
    return m["L"] * flops, m["L"] * nbytes


def bsa_work(cfg: dict, n: int, density: float, dense_heads: float
             ) -> tuple:
    """(FLOPs, bytes) of B.2 on a padded row of ``n`` for all layers:
    ``density`` of the causal blocks kept (the block diagonal always), QKᵀ
    and PV on each kept entry; q, k, v read and the output written in
    bf16, and Ã written in float32 for the ``dense_heads`` (a mean per
    layer) that build pivots."""
    m = dims(cfg)
    bs, nb = m["bs"], n // m["bs"]
    kept = density * nb * (nb + 1) / 2
    entries = (kept - nb) * bs * bs + nb * bs * (bs + 1) / 2
    flops = 4.0 * m["hd"] * m["h"] * entries
    nbytes = 2.0 * (2 * m["h"] + 2 * m["hkv"]) * n * m["hd"] \
        + 4.0 * dense_heads * nb * nb
    return m["L"] * flops, m["L"] * nbytes
