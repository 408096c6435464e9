#!/usr/bin/env python3
"""Compare checkouts of the port on one GPU, in one machine's run.

    python3 scripts/torch_compare_serves.py PARENT CHANGE CHANGE PARENT

Runs each checkout given, in the order given, in a process of its own that
imports that checkout's ``chip_smoke.py`` and ``src/``: it builds that
checkout's kernels, times its strip at the phase-2 shape (layer 0's q and
k of the two phase-4 prompts, B = 2 and B = 1, CUDA events), serves phase
4's two full-width llama3-8b-262k requests twice (the first serve warms
cuBLAS and the allocator; the second is the one to read), then phase 6's
six requests through the paged and the contiguous scheduler, and, where
the checkout has them, phase 9's chunked and packed serves.  Every line
the serves print is kept, prefixed by the checkout's path.  Alternate the
order (parent, change, change, parent) so that drift on the machine does
not favour one side.  Needs a CUDA card; prints its name and power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys


def one(tree: str) -> int:
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, strip_scores_cuda
    from repro_torch.models import build_model

    print(cs.nvidia_smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = get_config(cs.ARCH)
    model = build_model(cfg, dtype=torch.bfloat16)
    params = model.init(torch.Generator(device="cuda").manual_seed(cs.SEED))
    rng = np.random.default_rng(cs.SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in cs.PROMPT_LENS]
    toks = np.zeros((len(prompts), cs.SEQ), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    q, k, _ = cs.layer0_qkv(model, params, torch.as_tensor(toks,
                                                           device="cuda"))
    bs = cfg.share_prefill.block_size
    two = cs.cuda_ms(lambda: strip_scores_cuda(q, k, bs), 20)
    one = cs.cuda_ms(lambda: strip_scores_cuda(q[:1], k[:1], bs), 20)
    print(f"strip ms B=2 {two} B=1 {one}", flush=True)
    del q, k
    layers = cfg.num_layers
    for label in ("warm-up", "measured"):
        print(f"phase 4 serve ({label})", flush=True)
        cs.serve_full(model, params, prompts, {"strip": layers})
    torch.cuda.empty_cache()
    rng = np.random.default_rng(cs.SEED + 2)
    paged = [rng.integers(0, cfg.vocab_size, n) for n, _ in cs.PAGED_REQUESTS]
    run = cs.serve_paged(model, params, paged, layers)
    if hasattr(cs, "serve_chunked"):
        cs.serve_chunked(model, params, paged, layers, run)
    return 0


def main(trees) -> int:
    for tree in trees:
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree], capture_output=True,
                              text=True)
        for line in proc.stdout.splitlines():
            print(f"[{tree}] {line}", flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.exit(one(sys.argv[2]))
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
