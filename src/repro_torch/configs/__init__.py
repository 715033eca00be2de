"""Config registry: --arch <id> -> ModelCfg (full) / reduced (smoke tests)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelCfg, ShapeCfg  # noqa: F401

ARCHS: dict[str, str] = {
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
}


def get_config(name: str) -> ModelCfg:
    return importlib.import_module(ARCHS[name]).CONFIG


def get_reduced(name: str) -> ModelCfg:
    return importlib.import_module(ARCHS[name]).reduced()


def cells(include_skipped: bool = False):
    """All assigned (arch, shape) dry-run cells."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name in cfg.skip_shapes and not include_skipped:
                continue
            yield arch, shape.name
