"""Architecture registry of the port, all twelve of the reference's
configs: the dense-family configs, Mixtral (MoE with sliding-window
attention), Qwen2-VL (the VLM backbone, M-RoPE), DeepSeek-V2 (MLA with a
dense prefix layer ahead of the MoE stack), Mamba-2 (the attention-free SSM
family), RecurrentGemma (the RG-LRU hybrid with ring-buffer local
attention) and Whisper (the encoder-decoder), with the reference's
assigned and paper models, input shapes and dry-run pairs.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      reduced_config)
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek_v2
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.internlm2_1_8b import CONFIG as _internlm2
from repro_torch.configs.llama3_8b_262k import CONFIG as _llama3_262k
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.mistral_large_123b import CONFIG as _mistral_large
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3
from repro_torch.configs.qwen2_5_7b import CONFIG as _qwen2_5
from repro_torch.configs.qwen2_vl_72b import CONFIG as _qwen2_vl
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma
from repro_torch.configs.whisper_base import CONFIG as _whisper

# The ten assigned architectures, in the reference's order.
ASSIGNED: Dict[str, ModelConfig] = {
    "granite-3-2b": _granite,
    "mamba2-370m": _mamba2,
    "internlm2-1.8b": _internlm2,
    "qwen2-vl-72b": _qwen2_vl,
    "mistral-large-123b": _mistral_large,
    "mixtral-8x22b": _mixtral,
    "whisper-base": _whisper,
    "deepseek-v2-236b": _deepseek_v2,
    "recurrentgemma-9b": _recurrentgemma,
    "phi3-mini-3.8b": _phi3,
}

# The paper's own evaluation models (extra, not in the assigned pool).
PAPER_MODELS: Dict[str, ModelConfig] = {
    "llama3-8b-262k": _llama3_262k,
    "qwen2.5-7b": _qwen2_5,
}

REGISTRY: Dict[str, ModelConfig] = {**ASSIGNED, **PAPER_MODELS}

# (arch, shape) pairs the dry-run skips, with the reason.
SKIP_PAIRS = {
    ("whisper-base", "long_500k"):
        "enc-dec audio model; a 500k-token self-attention decode cache is "
        "meaningless for this family (DESIGN.md §6)",
}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    return reduced_config(get_config(name))


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(
            f"unknown shape {name!r}; available: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def list_archs(include_paper_models: bool = False) -> List[str]:
    names = list(ASSIGNED)
    if include_paper_models:
        names += list(PAPER_MODELS)
    return names


def dryrun_pairs(include_paper_models: bool = False):
    """Every (arch, shape) pair the dry-run runs, minus the skips."""
    for arch in list_archs(include_paper_models):
        for shape in INPUT_SHAPES:
            if (arch, shape) in SKIP_PAIRS:
                continue
            yield arch, shape
