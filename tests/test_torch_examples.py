"""The port's examples (``repro_torch.examples``), twins of the reference's
``examples/*.py``: each ``main`` with ``--device cpu`` runs to its end and
prints the reference's lines (their heads: the numbers are the run's), and
without a GPU and without that flag it raises."""
import importlib

import pytest
import torch

from torch_serving_helpers import one_torch_thread  # noqa: F401

EXAMPLES = {
    "quickstart": ([], ["[share]  last-token logits: (1, 512)",
                        "         computed block fraction: ",
                        "         heads/layer — shared: ",
                        "[dense]  greedy next-token agreement with share: ",
                        "[decode] continuation tokens: ["]),
    "serve_longcontext": (["--num-requests", "3"],
                          ["method=share  3 requests  wall=",
                           "  req 0: prefill=", "  req 1: prefill=",
                           "  req 2: prefill="]),
    "train_small": (["--steps", "3"],
                    ["arch=internlm2-1.8b params≈", "step     0  loss=",
                     "step     2  loss=", "final loss: "]),
    "pattern_visualization": ([], [
        "=== capturing attention maps (dense profiling pass) ===",
        "2 layers × 4 heads, 8×8 blocks", "=== head (0,0) attention map ===",
        "=== offline clustering (autoencoder + agglomerative) ===",
        "clusters: ", "=== Jaccard similarity between heads (obs 1) ===",
        "pairs with similarity > 0.5: ",
        "=== SharePrefill pattern distribution (Figure 6) ===",
        "layer 0: ", "layer 1: "]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu_and_prints_the_reference_lines(
        name, capsys, one_torch_thread):
    argv, heads = EXAMPLES[name]
    importlib.import_module(f"repro_torch.examples.{name}").main(
        argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    for head in heads:
        assert any(line.startswith(head) for line in lines), (head, lines)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_a_gpu_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"repro_torch.examples.{name}").main(
            EXAMPLES[name][0])
