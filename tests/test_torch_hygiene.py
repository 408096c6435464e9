"""Rules of the port that hold whatever the numbers: what it imports, where
it runs by default, how ``auto`` resolves, that kernels build lazily, and
that its configs are field-for-field copies of the reference's."""
import ast
import dataclasses
import pathlib

import pytest
import torch

import repro.configs as jconfigs
from repro_torch import configs
from repro_torch.kernels import (
    KERNELS, batched_sparse_attention_fn, launch_counts,
    reset_launch_counts, resolve_decode_impl)
from repro_torch.models import build_model
from repro_torch.models.api import resolve_device
from repro_torch.models.attention import resolve_attention_fn

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"{path.name} imports {bad}"


def test_port_has_no_top_level_init():
    """A namespace package, like ``src/repro``."""
    assert not (ROOT / "src" / "repro_torch" / "__init__.py").exists()


@pytest.mark.parametrize("arch", ["llama3-8b-262k", "mamba2-370m"])
def test_build_model_without_device_raises_without_gpu(monkeypatch, arch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke_config(arch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert build_model(cfg, device="cpu").device == torch.device("cpu")


def _port_config(ref):
    """A port ModelConfig with every field of the reference's ``ref``."""
    base = configs.base
    nested = {f.name: getattr(base, type(getattr(ref, f.name)).__name__)
              for f in dataclasses.fields(ref)
              if dataclasses.is_dataclass(getattr(ref, f.name))}
    return base.ModelConfig(**{
        f.name: (nested[f.name](**dataclasses.asdict(getattr(ref, f.name)))
                 if f.name in nested else getattr(ref, f.name))
        for f in dataclasses.fields(ref)})


# every family builds: the VLM backbone (M-RoPE), MLA (deepseek-v2's smoke
# config, with its dense prefix layer), the SSM family (mamba2), the RG-LRU
# hybrid (recurrentgemma) and the encoder-decoder (whisper), as do the moe
# family and sliding windows; an unknown family is refused
@pytest.mark.parametrize("arch", ["mamba2-370m", "qwen2-vl-72b",
                                  "deepseek-v2-236b", "recurrentgemma-9b",
                                  "whisper-base"])
def test_build_model_builds_every_family(arch):
    cfg = _port_config(jconfigs.get_smoke_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfigs.get_smoke_config(arch))
    model = build_model(cfg, device="cpu")
    assert model.cfg == cfg
    assert model.prefill_chunk == (arch in ("qwen2-vl-72b",))
    assert model.transformer_family == (
        arch in ("qwen2-vl-72b", "deepseek-v2-236b"))
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="rnn"), device="cpu")
    for change in ({"family": "moe"}, {"sliding_window": 4096}):
        build_model(dataclasses.replace(
            configs.get_smoke_config("granite-3-2b"), **change),
            device="cpu")


def test_auto_resolves_to_the_sparse_path_on_both_devices():
    fn = resolve_attention_fn("auto", 64)
    assert fn.batched
    assert resolve_attention_fn("sparse", 64).batched
    for impl in ("kernel", "ref"):            # the per-sample path
        assert not getattr(resolve_attention_fn(impl, 64), "batched", False)
    # the dense per-sample path under block masks (chunked prefill's
    # attn_impl="chunked"), as in the reference
    assert not getattr(resolve_attention_fn("chunked", 64), "batched", False)
    with pytest.raises(ValueError, match="unknown attn_impl"):
        resolve_attention_fn("splash", 64)
    assert resolve_decode_impl("auto", torch.device("cpu")) == "einsum"
    assert resolve_decode_impl("auto", torch.device("cuda")) == "kernel"
    assert resolve_decode_impl("einsum", torch.device("cuda")) == "einsum"


def test_launch_counters():
    assert set(KERNELS) == {"strip", "block_sparse_attn", "decode_attn",
                            "decode_attn_paged", "block_sparse_attn_single",
                            "block_sparse_attn_paged", "decode_attn_dense",
                            "decode_attn_sparse"}
    for fn in KERNELS.values():
        fn.launches = 7
    reset_launch_counts()
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert batched_sparse_attention_fn(block_size=64).batched


def test_kernels_are_not_built_at_import():
    from repro_torch.kernels import _build
    assert not _build._LIBS
    assert not any(_build.BUILD_ROOT.glob("*/*.tmp"))


@pytest.mark.parametrize("name", sorted(configs.REGISTRY))
def test_configs_copy_the_reference(name):
    mine, ref = configs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(configs.get_smoke_config(name)) == \
        dataclasses.asdict(jconfigs.get_smoke_config(name))


def test_input_shapes_copy_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.INPUT_SHAPES.items()
            } == {k: dataclasses.asdict(v)
                  for k, v in jconfigs.INPUT_SHAPES.items()}


def test_registry_holds_the_dense_family():
    """All twelve of the reference's configs: the dense family, Mixtral
    (moe, sliding window 4096), Qwen2-VL (vlm, M-RoPE), DeepSeek-V2 (moe
    with MLA), Mamba-2 (ssm), RecurrentGemma (hybrid) and Whisper (encdec),
    pinned field for field against the reference's; an unknown arch is
    refused."""
    assert set(configs.REGISTRY) == set(jconfigs.REGISTRY) == {
        "granite-3-2b", "internlm2-1.8b", "mistral-large-123b",
        "phi3-mini-3.8b", "llama3-8b-262k", "qwen2.5-7b", "mixtral-8x22b",
        "qwen2-vl-72b", "deepseek-v2-236b", "mamba2-370m",
        "recurrentgemma-9b", "whisper-base"}
    assert {n: c.family for n, c in configs.REGISTRY.items()
            if c.family != "dense"} == {"mixtral-8x22b": "moe",
                                        "qwen2-vl-72b": "vlm",
                                        "deepseek-v2-236b": "moe",
                                        "mamba2-370m": "ssm",
                                        "recurrentgemma-9b": "hybrid",
                                        "whisper-base": "encdec"}
    for name in configs.REGISTRY:
        assert dataclasses.asdict(configs.get_config(name)) == \
            dataclasses.asdict(jconfigs.get_config(name))
    mix = configs.get_config("mixtral-8x22b")
    assert (mix.family, mix.num_layers, mix.d_model, mix.num_heads,
            mix.num_kv_heads, mix.d_ff, mix.vocab_size, mix.rope_theta,
            mix.sliding_window) == ("moe", 56, 6144, 48, 8, 16384, 32768,
                                    1e6, 4096)
    assert (mix.moe.num_experts, mix.moe.top_k, mix.moe.expert_d_ff,
            mix.moe.capacity_factor) == (8, 2, 16384, 1.25)
    vl = configs.get_config("qwen2-vl-72b")
    assert (vl.family, vl.num_layers, vl.d_model, vl.num_heads,
            vl.num_kv_heads, vl.resolved_head_dim, vl.d_ff, vl.vocab_size,
            vl.rope_theta, vl.tie_embeddings) == (
        "vlm", 80, 8192, 64, 8, 128, 29568, 152064, 1e6, False)
    assert (vl.vlm.mrope_sections, vl.vlm.num_visual_tokens,
            vl.vlm.visual_embed_dim) == ((16, 24, 24), 1024, 1280)
    ds = configs.get_config("deepseek-v2-236b")
    assert (ds.family, ds.num_layers, ds.d_model, ds.num_heads,
            ds.num_kv_heads, ds.d_ff, ds.vocab_size, ds.rope_theta) == (
        "moe", 60, 5120, 128, 128, 12288, 102400, 1e4)
    assert (ds.moe.num_experts, ds.moe.top_k, ds.moe.num_shared_experts,
            ds.moe.expert_d_ff) == (160, 6, 2, 1536)
    assert (ds.mla.kv_lora_rank, ds.mla.q_lora_rank,
            ds.mla.qk_nope_head_dim, ds.mla.qk_rope_head_dim,
            ds.mla.v_head_dim) == (512, 1536, 128, 64, 128)
    mb = configs.get_config("mamba2-370m")
    assert (mb.family, mb.num_layers, mb.d_model, mb.num_heads,
            mb.vocab_size, mb.share_prefill.enabled) == (
        "ssm", 48, 1024, 0, 50280, False)
    assert (mb.ssm.state_dim, mb.ssm.head_dim, mb.ssm.expand,
            mb.ssm.chunk_size, mb.ssm.conv_width) == (128, 64, 2, 256, 4)
    rg = configs.get_config("recurrentgemma-9b")
    assert (rg.family, rg.num_layers, rg.d_model, rg.num_heads,
            rg.num_kv_heads, rg.resolved_head_dim, rg.d_ff, rg.vocab_size,
            rg.rope_theta) == ("hybrid", 38, 4096, 16, 1, 256, 12288,
                               256000, 1e4)
    assert (rg.rglru.lru_width, rg.rglru.conv_width,
            rg.rglru.local_attn_window, rg.share_prefill.block_size) == (
        4096, 4, 2048, 128)
    wh = configs.get_config("whisper-base")
    assert (wh.family, wh.num_layers, wh.d_model, wh.num_heads,
            wh.num_kv_heads, wh.d_ff, wh.vocab_size, wh.rope_theta) == (
        "encdec", 6, 512, 8, 8, 2048, 51865, 0.0)
    assert (wh.encdec.num_encoder_layers, wh.encdec.encoder_seq_len,
            wh.share_prefill.block_size,
            wh.share_prefill.min_seq_blocks) == (6, 1500, 64, 4)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-2")
