"""Training launcher (the single-device twin of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --smoke --steps 50 --task lm --device cpu

It runs on CUDA unless ``--device cpu`` is given (without a GPU and
without it, it raises).  ``--smoke`` takes the reduced config; a full
config trains at its published widths, in float32 as the reference
trains (``ModelConfig.remat_policy`` sets the activation checkpointing).
A ``vlm`` config trains on text with 3-D positions of equal streams, an
``encdec`` one under zero encoder frames, as the reference's launcher.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, batches
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import TrainConfig, train


def extra_kwargs_fn(cfg):
    """The model inputs beyond the tokens, by family: M-RoPE positions
    ``(3, B, S)`` for a ``vlm``, zero frames for an ``encdec``."""
    if cfg.family == "vlm":
        def extra(batch):
            b, s = batch["tokens"].shape
            pos = torch.arange(s, device=batch["tokens"].device)
            return {"positions": pos[None, None].expand(3, b, s)}
        return extra
    if cfg.family == "encdec":
        def extra(batch):
            b = batch["tokens"].shape[0]
            return {"embeds": torch.zeros(
                (b, cfg.encdec.encoder_seq_len, cfg.d_model),
                device=batch["tokens"].device)}
        return extra
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--task", default="lm")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--metrics-out")
    ap.add_argument("--device", default=None,
                    help="cpu to train on the CPU (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, task=args.task)
    tcfg = TrainConfig(num_steps=args.steps, microbatches=args.microbatches,
                       warmup_steps=max(args.steps // 10, 1),
                       optimizer=AdamWConfig(learning_rate=args.lr))

    def log(step, m):
        print(f"step {step:5d} loss={m['total_loss']:.4f} "
              f"ppl={m['perplexity']:.2f} acc={m['accuracy']:.3f} "
              f"gnorm={m['grad_norm']:.2f} wall={m['wall_s']:.1f}s")

    t0 = time.time()
    params, opt_state, history = train(
        model, tcfg, batches(dcfg), ckpt_dir=args.ckpt_dir,
        extra_kwargs_fn=extra_kwargs_fn(cfg), log_fn=log)
    print(f"done in {time.time() - t0:.1f}s on {model.device}; "
          f"final loss {history['total_loss'][-1]:.4f}")
    if args.metrics_out:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
