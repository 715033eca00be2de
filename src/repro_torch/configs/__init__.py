"""Config registry: --arch <id> -> ModelCfg (full) / reduced (smoke tests).

Holds only the archs the port serves (llama3.2-1b, falcon-mamba-7b,
whisper-medium); the other seven join with their families."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelCfg, ShapeCfg  # noqa: F401

ARCHS: dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
}


def get_config(name: str) -> ModelCfg:
    return importlib.import_module(ARCHS[name]).CONFIG


def get_reduced(name: str) -> ModelCfg:
    return importlib.import_module(ARCHS[name]).reduced()
