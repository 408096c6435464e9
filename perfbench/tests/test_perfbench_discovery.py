"""A configuration, a cell and a per-layer metric are added as new files
plus new entries, and the harness finds each by name with no edit to a
file that is there."""
import json
import os
import shutil

from conftest import run_tiny
from perfbench import files


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "perfbench"
    shutil.copytree(files.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = files.config("qwen2.5-7b")
    cfg["num_hidden_layers"] = 2
    (base / "configs" / "new-model.json").write_text(json.dumps(cfg))
    (base / "traffic" / "new-mix.json").write_text(
        json.dumps(dict(files.traffic("prefill-long"), strata=4)))
    cell = dict(files.workload("qwen2.5-7b.prefill-long"),
                config="new-model", traffic="new-mix")
    (base / "workloads" / "new-model.new-mix.json").write_text(
        json.dumps(cell))
    (base / "metrics" / "new_metric.x.py").write_text(
        "def read(ctx):\n    return len(ctx.records)\n")
    bench = files.benchmark()
    bench["workloads"].append({"name": "new-model.new-mix",
                               "config": "new-model", "traffic": "new-mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new_metric.x", "unit": "1",
                               "better": "higher", "source": "program_counter",
                               "layer": "Engine", "moves": "setup_s",
                               "workloads": ["new-model.new-mix"]})
    b = str(base)
    assert files.config("new-model", b)["num_hidden_layers"] == 2
    assert files.traffic("new-mix", b)["strata"] == 4
    assert files.workload("new-model.new-mix", b)["config"] == "new-model"
    names = [m["name"] for m in
             files.metrics_for(bench, "new-model.new-mix", "per_layer")]
    assert names == ["new_metric.x"]
    read = files.reader("metrics", "new_metric.x", b)
    assert read(type("Ctx", (), {"records": [1, 2, 3]})) == 3
    # a metric that lists no cells reaches every cell, those added too
    ends = [m["name"] for m in
            files.metrics_for(bench, "new-model.new-mix", "end_to_end")]
    assert ends == ["setup_s"]
    # the files the repository had are untouched
    for sub in ("configs", "traffic", "workloads", "metrics"):
        for n in os.listdir(os.path.join(files.HERE, sub)):
            assert (base / sub / n).read_bytes() == open(
                os.path.join(files.HERE, sub, n), "rb").read()


def test_a_new_config_runs_through_the_same_path():
    def edit(wl, cfg, traffic):
        cfg.update(num_attention_heads=8, num_key_value_heads=8)
    res = run_tiny("qwen2.5-7b.prefill-long", edit=edit)
    assert res["correct"], res
