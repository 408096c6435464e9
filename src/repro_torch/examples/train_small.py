"""Train a small model for a few hundred steps on the synthetic long-context
corpus (twin of ``examples/train_small.py``).

Default is the smoke scale (~3M params, 200 steps); ``--full-100m`` selects
a ~100M-parameter config (same code path).

    PYTHONPATH=src python -m repro_torch.examples.train_small --steps 200 \\
        [--device cpu]
"""
import argparse
import dataclasses

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, batches
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import TrainConfig, train


def hundred_m_config() -> ModelConfig:
    base = get_smoke_config("internlm2-1.8b")
    return dataclasses.replace(
        base, num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
        head_dim=64, d_ff=3072, vocab_size=32768)       # ≈ 0.1B params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = hundred_m_config() if args.full_100m \
        else get_smoke_config("internlm2-1.8b")
    model = build_model(cfg, device=args.device)
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"layers={cfg.num_layers} d_model={cfg.d_model}")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, task="lm")
    tcfg = TrainConfig(num_steps=args.steps, warmup_steps=args.steps // 10,
                       microbatches=args.microbatches, log_every=20,
                       optimizer=AdamWConfig(learning_rate=6e-4))

    def log(step, m):
        print(f"step {step:5d}  loss={m['total_loss']:.4f}  "
              f"ppl={m['perplexity']:.2f}  acc={m['accuracy']:.3f}  "
              f"wall={m['wall_s']:.1f}s")

    params, _, history = train(model, tcfg, batches(dcfg), log_fn=log)
    print(f"final loss: {history['total_loss'][-1]:.4f} "
          f"(started {history['total_loss'][0]:.4f})")


if __name__ == "__main__":
    main()
