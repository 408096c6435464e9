"""End-to-end driver: serve a small model with batched long-context requests
through ``ServingEngine`` (twin of ``examples/serve_longcontext.py``): sparse
prefill (on CUDA the strip, B.1, and block-sparse, B.2, kernels) and dense
decode, as in the paper's §6.1.

    PYTHONPATH=src python -m repro_torch.examples.serve_longcontext \\
        [--method share] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, sample
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="share",
                    choices=["share", "dense", "vertical_slash", "flex"])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--num-requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    sp = model.default_share_prefill()

    # a mixed batch of retrieval and copy-task prompts
    reqs = []
    for i in range(args.num_requests):
        task = "retrieval" if i % 2 == 0 else "copy"
        dcfg = DataConfig(vocab_size=cfg.vocab_size,
                          seq_len=args.prompt_len, global_batch=1, task=task)
        reqs.append(Request(uid=i, prompt=sample(dcfg, i)["tokens"],
                            max_new_tokens=8))

    engine = ServingEngine(
        model, params, sp,
        EngineConfig(method=args.method, max_batch=3,
                     seq_buckets=(args.prompt_len,)))
    t0 = time.time()
    engine.serve(reqs)
    wall = time.time() - t0

    print(f"method={args.method}  {len(reqs)} requests  wall={wall:.2f}s")
    for r in reqs:
        print(f"  req {r.uid}: prefill={r.prefill_s:.3f}s "
              f"decode={r.decode_s:.3f}s "
              f"density={r.pattern_stats['block_density']:.2%} "
              f"out={r.output_tokens.tolist()}")


if __name__ == "__main__":
    main()
