"""The configuration files hold their sources' published numbers."""
import json
import os

import pytest

from perfbench import files

# the published config.json numbers (Qwen/Qwen2.5-7B and
# mistralai/Mixtral-8x22B-Instruct-v0.1)
PUBLISHED = {
    "qwen2.5-7b": {
        "hidden_size": 3584, "intermediate_size": 18944,
        "num_attention_heads": 28, "num_key_value_heads": 4,
        "num_hidden_layers": 28, "vocab_size": 152064,
        "max_position_embeddings": 131072, "rope_theta": 1000000.0,
        "rms_norm_eps": 1e-06, "use_sliding_window": False,
        "sliding_window": 131072, "max_window_layers": 28,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "hidden_act": "silu", "bos_token_id": 151643,
        "eos_token_id": 151643},
    "mixtral-8x22b": {
        "hidden_size": 6144, "intermediate_size": 16384,
        "num_attention_heads": 48, "num_key_value_heads": 8,
        "num_hidden_layers": 56, "vocab_size": 32768,
        "num_local_experts": 8, "num_experts_per_tok": 2,
        "max_position_embeddings": 65536, "rope_theta": 1000000,
        "rms_norm_eps": 1e-05, "sliding_window": None,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "hidden_act": "silu", "router_aux_loss_coef": 0.001},
}
WIDTHS = ("hidden_size", "intermediate_size", "num_attention_heads",
          "num_key_value_heads", "num_local_experts", "num_experts_per_tok",
          "head_dim")


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_config_holds_published_numbers(name):
    cfg = files.config(name)
    for key in ("source", "reduced", "assumed", "deployment", "departures",
                "port"):
        assert key in cfg, key
    for key, value in PUBLISHED[name].items():
        if key in cfg["reduced"]:
            assert cfg["reduced"][key]["published"] == value, key
            assert cfg[key] != value, key
        else:
            assert cfg[key] == value, key
    assert not set(cfg["reduced"]) & set(WIDTHS)


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_benchmark_entry_matches_file(name):
    entry = next(c for c in files.benchmark()["configs"]
                 if c["name"] == name)
    cfg = files.config(name)
    assert entry["file"] == f"perfbench/configs/{name}.json"
    assert entry["source"] == cfg["source"]
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])


def test_mixtral_full_attention_and_dropless():
    cfg = files.config("mixtral-8x22b")
    assert cfg["sliding_window"] is None
    assert cfg["reduced"]["num_hidden_layers"]["published"] == 56
    port = cfg["port"]
    assert port["capacity_factor"] == \
        cfg["num_local_experts"] / cfg["num_experts_per_tok"]
    from perfbench import system
    from repro_torch.models.moe import _capacity, _group_size
    mc = system.model_config(cfg)
    assert mc.sliding_window == 0
    for s in (1, 1024, 8192):
        assert _capacity(_group_size(s), mc) >= _group_size(s)


def test_qwen_builds_the_port_config():
    from perfbench import system
    mc = system.model_config(files.config("qwen2.5-7b"))
    assert (mc.num_layers, mc.d_model, mc.num_heads, mc.num_kv_heads,
            mc.d_ff, mc.vocab_size, mc.sliding_window, mc.family) == \
        (28, 3584, 28, 4, 18944, 152064, 0, "dense")


def test_no_deepseek_file():
    names = os.listdir(os.path.join(files.HERE, "configs"))
    assert not [n for n in names if "deepseek" in n.lower()]
    for c in files.benchmark()["configs"]:
        assert "deepseek" not in c["name"].lower()


def test_every_cell_finds_its_files():
    bench = files.benchmark()
    assert json.dumps(bench)        # well-formed
    for w in bench["workloads"]:
        wl = files.workload(w["name"])
        assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == \
            (w["config"], w["traffic"], w["chips"], w["why"])
        files.config(w["config"])
        files.traffic(w["traffic"])
        for section in ("end_to_end", "per_layer"):
            kind = "end_to_end" if section == "end_to_end" else "metrics"
            for m in files.metrics_for(bench, w["name"], section):
                assert callable(files.reader(kind, m["name"]))
