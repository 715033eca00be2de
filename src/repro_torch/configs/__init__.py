"""Config registry: --arch <id> -> ModelCfg (full) / reduced (smoke tests).

Holds only the archs the port serves (llama3.2-1b, h2o-danube-1.8b,
gemma3-4b, gemma3-12b, falcon-mamba-7b, whisper-medium, qwen2-vl-72b); the
other three join with their families."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelCfg, ShapeCfg  # noqa: F401

ARCHS: dict[str, str] = {
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
}


def get_config(name: str) -> ModelCfg:
    return importlib.import_module(ARCHS[name]).CONFIG


def get_reduced(name: str) -> ModelCfg:
    return importlib.import_module(ARCHS[name]).reduced()
