"""Visualize the paper's two observations in the terminal: inter-head
pattern similarity and the pattern-type distribution SharePrefill induces
(twin of ``examples/pattern_visualization.py``).

    PYTHONPATH=src python -m repro_torch.examples.pattern_visualization \\
        [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.api import SharePrefill
from repro_torch.core.clustering import cluster_heads, \
    jaccard_similarity_matrix
from repro_torch.core.profile import capture_block_attention_maps, \
    run_prefill_traced
from repro_torch.data import DataConfig, sample
from repro_torch.models import build_model

ARCH = "internlm2-1.8b"
BLOCK = 64


def ascii_heat(m: np.ndarray, chars=" .:-=+*#%@") -> str:
    mm = (m - m.min()) / max(m.max() - m.min(), 1e-9)
    idx = (mm * (len(chars) - 1)).astype(int)
    return "\n".join("".join(chars[i] for i in row) for row in idx)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=512,
                      global_batch=1, task="retrieval")
    toks = torch.as_tensor(sample(dcfg, 0)["tokens"][None], device=dev)

    print("=== capturing attention maps (dense profiling pass) ===")
    maps = capture_block_attention_maps(params, cfg, toks, block_size=BLOCK)
    l, h = maps.shape[:2]
    print(f"{l} layers × {h} heads, {maps.shape[2]}×{maps.shape[3]} blocks")

    print("\n=== head (0,0) attention map ===")
    print(ascii_heat(maps[0, 0]))

    print("\n=== offline clustering (autoencoder + agglomerative) ===")
    res = cluster_heads(torch.as_tensor(maps, device=dev),
                        distance_threshold=0.7, min_cluster_size=2,
                        ae_epochs=100)
    print(f"clusters: {res.num_clusters}; head_dict:\n{res.cluster_ids}")

    masks = maps.reshape(l * h, *maps.shape[2:]) > (1.0 / maps.shape[-1])
    jac = jaccard_similarity_matrix(masks)
    print("\n=== Jaccard similarity between heads (obs 1) ===")
    print(ascii_heat(jac))
    off = jac[~np.eye(len(jac), dtype=bool)]
    print(f"pairs with similarity > 0.5: {(off > 0.5).mean():.1%}")

    print("\n=== SharePrefill pattern distribution (Figure 6) ===")
    sp = SharePrefill.from_clustering(cfg.share_prefill, res.cluster_ids,
                                      res.num_clusters)
    tr = run_prefill_traced(params, cfg, toks, sp, method="share")
    for i, r in enumerate(tr.per_layer):
        bar = ("D" * int(r["num_dense"]) + "S" * int(r["num_shared"])
               + "v" * int(r["num_vs"]))
        print(f"layer {i}: {bar}  (density {r['block_density']:.2%})")


if __name__ == "__main__":
    main()
