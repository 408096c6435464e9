"""Quickstart: SharePrefill in 60 lines (twin of ``examples/quickstart.py``).

Builds a small GQA model, runs a sparse prefill with pattern sharing, and
prints the per-layer pattern statistics — the paper's mechanism visible
end to end.  On CUDA the prefill runs the strip (B.1) and block-sparse
(B.2) kernels.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine

ARCH = "granite-3-2b"       # any of the 10 assigned ids works (--arch style)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    # a long prompt (synthetic tokens); block-aligned for sparse prefill
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))

    # 1. the paper's technique: sparse prefill with pattern sharing
    sp = model.default_share_prefill()
    result = model.prefill(params, tokens, sp, method="share")
    print(f"[share]  last-token logits: {tuple(result.last_logits.shape)}")
    print(f"         computed block fraction: "
          f"{float(result.stats.block_density):.2%}")
    print(f"         heads/layer — shared: {float(result.stats.num_shared):.1f}"
          f"  dense: {float(result.stats.num_dense):.1f}"
          f"  vertical-slash: {float(result.stats.num_vs):.1f}")

    # 2. baseline for comparison: exact dense prefill (FlashAttention-2
    #    semantics)
    dense = model.prefill(params, tokens, sp, method="dense")
    agree = bool(torch.equal(result.last_logits.argmax(-1),
                             dense.last_logits.argmax(-1)))
    print(f"[dense]  greedy next-token agreement with share: {agree}")

    # 3. decode a few tokens from the sparse-prefill cache
    cache = ServingEngine.grow_cache(result.cache, 512, 8)
    tok = result.last_logits.argmax(-1)[:, None]
    out = [int(tok[0, 0])]
    for t in range(4):
        logits, cache = model.decode(params, tok, cache, 512 + t)
        tok = logits.argmax(-1)[:, None]
        out.append(int(tok[0, 0]))
    print(f"[decode] continuation tokens: {out}")


if __name__ == "__main__":
    main()
