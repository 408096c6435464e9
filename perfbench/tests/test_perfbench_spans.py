"""``perfbench/spans.py`` (device, idle and host time by the port's spans)
and the six readers over it: attribution on synthetic events, and on the
card a traced serve whose B.1 and B.2 kernels fall under their spans."""
import types

import numpy as np
import pytest

from perfbench import files, spans
from perfbench.trace import group

# host ranges (µs): a prefill whose masks and rows are spans of their own,
# then a decode step holding a model call and the sampling
RANGES = [(0, 100, "model.prefill"), (10, 30, "share.masks"),
          (30, 80, "attn.rows"), (200, 300, "sched.decode_step"),
          (205, 260, "model.decode"), (260, 300, "sample")]
# device operations: start, end, name, correlation id.  B.1 is launched
# at 15 with no aten op above it and runs at 40; B.2 launched at 35 runs
# at 50; a copy launched at 150 lies under no span; id 9 has no launch
OPS = [(40, 50, "strip_tc_kernel<128, 1>", 1),
       (50, 90, "bsa_tc_kernel<128, 128, 128, 0>", 2),
       (150, 160, "Memcpy HtoD", 3),
       (210, 230, "nvjet_tst_gemm", 4),
       (265, 270, "void elementwise_kernel", 5),
       (320, 330, "void reduce_kernel", 9)]
LAUNCHES = {1: 15.0, 2: 35.0, 3: 150.0, 4: 207.0, 5: 262.0}


def _times():
    return spans.attribute(OPS, LAUNCHES, RANGES, group, lo=0, hi=330)


def test_kernels_go_to_the_span_that_launched_them():
    t = _times()
    assert t.kernel_s == pytest.approx(95e-6)
    assert t.self_device_s == pytest.approx({
        "share.masks": 10e-6, "attn.rows": 40e-6, spans.NO_SPAN: 20e-6,
        "model.decode": 20e-6, "sample": 5e-6})
    assert t.device_s == pytest.approx({
        "model.prefill": 50e-6, "share.masks": 10e-6, "attn.rows": 40e-6,
        "sched.decode_step": 25e-6, "model.decode": 20e-6, "sample": 5e-6,
        spans.NO_SPAN: 20e-6})
    assert t.by_group[("strip", "share.masks")] == pytest.approx(10e-6)
    assert t.by_group[("bsa", "attn.rows")] == pytest.approx(40e-6)
    assert ("strip", "attn.rows") not in t.by_group


def test_idle_goes_to_the_innermost_span_over_it():
    # busy: 40–90, 150–160, 210–230, 265–270, 320–330 of 0–330
    t = _times()
    assert t.idle_s == pytest.approx({
        "model.prefill": 50e-6, "share.masks": 20e-6, "attn.rows": 10e-6,
        "sched.decode_step": 75e-6, "model.decode": 35e-6,
        "sample": 35e-6})
    assert t.self_idle_s == pytest.approx({
        "model.prefill": 20e-6, "share.masks": 20e-6, "attn.rows": 10e-6,
        spans.NO_SPAN: 110e-6, "sched.decode_step": 5e-6,
        "model.decode": 35e-6, "sample": 35e-6})
    assert sum(t.self_idle_s.values()) == pytest.approx(235e-6)
    assert t.host_s["sched.decode_step"] == pytest.approx([100e-6])


def test_a_span_inside_one_of_its_own_name_counts_once():
    t = spans.attribute([(5, 10, "k", 1)], {1: 6.0},
                        [(0, 20, "ffn"), (4, 12, "ffn")], lo=0, hi=20)
    assert t.device_s == pytest.approx({"ffn": 5e-6})
    assert t.idle_s == pytest.approx({"ffn": 15e-6})
    assert t.host_s["ffn"] == pytest.approx([20e-6, 8e-6])


def _event(name, start, end, dev, kind, id_=0, kinds=True):
    from torch.autograd import DeviceType
    e = types.SimpleNamespace(
        name=name, id=id_,
        time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if dev else DeviceType.CPU)
    if kinds:
        e.activity_type = kind
    return e


@pytest.mark.parametrize("kinds", [True, False],
                         ids=["activity kinds", "names only"])
def test_from_events_leaves_out_the_ranges_device_twins(kinds):
    """With the events' activity kinds (torch 2.13), and without them
    (torch 2.11: launches known by their runtime call's name)."""
    _ev = lambda *a: _event(*a, kinds=kinds)
    evs = [_ev("repro_torch." + n, s, e, False, "user_annotation")
           for s, e, n in RANGES]
    evs += [_ev("repro_torch." + n, s + 30, e + 30, True,
                "gpu_user_annotation") for s, e, n in RANGES]
    evs += [_ev("bench.prefill", 0, 100, True, "gpu_user_annotation")]
    evs += [_ev(n, s, e, True, "kernel", c) for s, e, n, c in OPS]
    evs += [_ev("cudaLaunchKernel" if c != 2 else "cuLaunchKernel",
                t, t + 2, False,
                "cuda_runtime" if c != 2 else "cuda_driver", c)
            for c, t in LAUNCHES.items()]
    # an aten op whose own id equals a kernel's correlation id is no launch
    evs += [_ev("aten::mm", 300, 301, False, "cpu_op", 1)]
    got = spans.from_events(evs, group, lo=0, hi=330)
    assert got == _times()


def _ctx(t=None, records=()):
    trace = types.SimpleNamespace() if t is None else \
        types.SimpleNamespace(spans=t)
    return types.SimpleNamespace(trace=trace, records=list(records),
                                 after=[])


def _reader(name):
    return files.reader("metrics", name)


def test_readers():
    t = spans.SpanTimes(
        kernel_s=10.0,
        device_s={"share.masks": 0.5, "moe.dispatch": 0.3,
                  "moe.combine": 0.2, "moe.experts": 6.0},
        self_device_s={}, idle_s={"sched.decode_step": 0.02},
        self_idle_s={}, by_group={},
        host_s={"sched.decode_step": [0.01, 0.03, 0.02, 0.05]})
    ctx = _ctx(t)
    assert _reader("mask_build_share")(ctx) == pytest.approx(5.0)
    assert _reader("moe_dispatch_share")(ctx) == pytest.approx(5.0)
    assert _reader("moe_expert_share")(ctx) == pytest.approx(60.0)
    assert _reader("decode_step_s")(ctx) == pytest.approx(0.025)
    assert _reader("decode_idle_share")(ctx) == pytest.approx(
        100 * 0.02 / 0.11)
    recs = [dict(ok=True, prompt_len=12000, prefill_positions=16384),
            dict(ok=True, prompt_len=20000, prefill_positions=32768),
            dict(ok=False, prompt_len=9000, prefill_positions=16384)]
    assert _reader("prefill_pad_share")(_ctx(records=recs)) == \
        pytest.approx(100 * (1 - 32000 / 49152))


SPAN_READERS = ("mask_build_share", "moe_dispatch_share",
                "moe_expert_share", "decode_step_s", "decode_idle_share")


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_without_spans(name):
    assert _reader(name)(_ctx()) is None
    assert _reader(name)(types.SimpleNamespace(trace=None)) is None
    empty = spans.attribute([], {}, [])
    assert _reader(name)(_ctx(empty)) is None


def test_pad_share_without_the_counter():
    recs = [dict(ok=True, prompt_len=12000, bucket=16384)]
    assert _reader("prefill_pad_share")(_ctx(records=recs)) is None


@pytest.mark.card
@pytest.mark.parametrize("cell", ["qwen2.5-7b.prefill-long",
                                  "mixtral-8x22b.serve-docqa"])
def test_kernels_fall_under_their_spans_on_the_card(cell, card):
    """Qwen2.5-7B at 2 of its layers, served by each cell's engine (the
    batch path, the paged scheduler) at a 4096 bucket with the port's spans
    on: every ``strip_*kernel`` lies under ``share.masks``, every
    ``bsa_*kernel`` under ``attn.rows``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import system, weights
    from repro_torch import tracing
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = dict(files.config("qwen2.5-7b"), num_hidden_layers=2)
    settings = dict(files.workload(cell)["engine"], seq_buckets=(4096,))
    model, params = system.build(
        cfg, weights.make(cfg, 5, device=card), card)
    eng = ServingEngine(model, params, model.default_share_prefill(),
                        EngineConfig(**settings))
    g = np.random.default_rng(5)

    def serve():
        eng.serve([Request(uid=i, prompt=g.integers(0, 1000, n),
                           max_new_tokens=m)
                   for i, (n, m) in enumerate(((4096, 3), (3000, 2)))])
    serve()                                         # warm up
    tracing.enable()
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve()
            torch.cuda.synchronize()
    finally:
        tracing.enable(False)
    ops, launches, ranges = spans.tuples(prof.events())
    t = spans.attribute(ops, launches, ranges, group)
    print(spans.table(t))
    for kind, under in (("strip", "share.masks"), ("bsa", "attn.rows")):
        total = sum((e - s) / 1e6 for s, e, n, _ in ops if group(n) == kind)
        assert total > 0, kind
        assert t.by_group[(kind, under)] == pytest.approx(total), kind
