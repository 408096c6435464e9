"""Shared pieces of the benchmark's own tests (run them with
``python -m pytest perfbench/tests``; the tests marked ``card`` run only
where a CUDA card is, and skip elsewhere)."""
import argparse
import copy
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("qwen2.5-7b.prefill-long", "mixtral-8x22b.serve-docqa")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (decided inside the test's "
        "fixture); skips elsewhere")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda:0")


def tiny_cell(cell: str):
    """A cell's workload, configuration and traffic cut to a size the CPU
    runs in seconds (the same files, smaller numbers)."""
    from perfbench import files
    wl = copy.deepcopy(files.workload(cell))
    cfg = copy.deepcopy(files.config(wl["config"]))
    traffic = copy.deepcopy(files.traffic(wl["traffic"]))
    cfg.update(hidden_size=128, num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=256, vocab_size=512, num_hidden_layers=2)
    cfg["port"].update(block_size=64, min_seq_blocks=2,
                       cluster_profile_tokens=256, cluster_epochs=5)
    if cfg.get("num_local_experts"):
        cfg["num_local_experts"] = 4
        cfg["port"]["capacity_factor"] = 2.0        # E / k: dropless
    if traffic["loop"] == "closed":
        traffic["bands"] = [[128, 256], [256, 512]]
        wl["engine"]["seq_buckets"] = [256, 512]
    else:
        traffic.update(prompt_tokens={"lo": 128, "hi": 512},
                       output_tokens={"lo": 2, "hi": 6}, rate_per_s=4.0)
        wl["engine"]["seq_buckets"] = [128, 256, 512]
        wl["check"]["sample"] = 3
    return wl, cfg, traffic


def run_tiny(cell: str, seed: int = 3, seconds: float = 1.0, detail=None,
             edit=None):
    """One run of ``cell`` at the tiny size on the CPU, through the
    harness's whole path after its look for a card."""
    import torch
    from perfbench import files, harness
    torch.set_num_threads(2)
    wl, cfg, traffic = tiny_cell(cell)
    if edit is not None:
        edit(wl, cfg, traffic)
    bench = files.benchmark()
    e2e = files.metrics_for(bench, cell, "end_to_end")
    readers = {m["name"]: files.reader("end_to_end", m["name"])
               for m in e2e}
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=0)
    # pytest itself loads the JAX package (the repository's hash-seed
    # plugin): the run's own look for it is the benchmark's, not the test's
    guard, harness.forbidden_modules = harness.forbidden_modules, list
    try:
        return harness.run_cell(args, time.time(),
                                files.cell_entry(bench, cell), wl, cfg,
                                traffic, e2e, [], readers,
                                torch.device("cpu"), detail=detail)
    finally:
        harness.forbidden_modules = guard
