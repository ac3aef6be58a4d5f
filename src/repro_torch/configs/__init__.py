"""Architecture configs and input shapes (counterpart: ``src/repro/configs/``).

Each config module exports ``FULL`` (the published configuration) and
``SMOKE`` (a reduced same-family variant for CPU tests).  The port
registers only the configurations whose every block kind it runs:
``qwen2-1.5b``, ``mamba2-2.7b``, ``gemma3-1b`` (its sliding-window
layers' attention through kernel 6), the dense ``granite-3-8b`` and
``qwen1.5-32b``, the hybrid ``recurrentgemma-9b`` (RG-LRU blocks
beside local attention), the encoder-decoder ``whisper-small``, the
vision-prefixed ``llava-next-34b`` and the two MoE models,
``mixtral-8x22b`` (top-2 of 8 experts, sliding-window attention) and
``llama4-scout-17b-16e`` (top-1 of 16 experts and a shared expert, chunked
and NoPE attention).  That is every configuration of the reference, so
``PENDING_IDS`` is empty; the name stays for the launcher's choices.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ArchConfig

__all__ = ["ARCH_IDS", "PENDING_IDS", "SHAPES", "InputShape", "get_config",
           "get_smoke", "shape_for"]

#: configurations the port runs
ARCH_IDS = ("qwen2-1.5b", "mamba2-2.7b", "gemma3-1b", "granite-3-8b", "qwen1.5-32b",
            "recurrentgemma-9b", "whisper-small", "llava-next-34b", "mixtral-8x22b",
            "llama4-scout-17b-16e")
#: the reference's configurations still waiting for their block kinds: none
PENDING_IDS: tuple = ()

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCH_IDS}
_ALIASES = {"llama4-scout-17b-a16e": "llama4-scout-17b-16e"}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


def _module(name: str):
    name = _ALIASES.get(name, name)
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE


def shape_for(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {tuple(SHAPES)}")
    return SHAPES[name]
