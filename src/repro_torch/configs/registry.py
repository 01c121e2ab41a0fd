"""The port's architecture registry: the reference's ten archs, each with
its exact published config and its structurally identical SMOKE config.
The code is the JAX package's registry; an unknown arch raises KeyError
naming ROADMAP.md.

Sources ([verified-tier] per assignment):
  smollm-135m            hf:HuggingFaceTB/SmolLM-135M
  granite-34b            arXiv:2405.04324
  deepseek-7b            arXiv:2401.02954
  chatglm3-6b            arXiv:2406.12793
  zamba2-1.2b            arXiv:2411.15242
  seamless-m4t-large-v2  arXiv:2308.11596
  qwen2-vl-72b           arXiv:2409.12191
  mixtral-8x22b          arXiv:2401.04088
  deepseek-v2-236b       arXiv:2405.04434
  mamba2-1.3b            arXiv:2405.21060
"""

from __future__ import annotations

import importlib

ARCHS = [
    "smollm-135m",
    "granite-34b",
    "deepseek-7b",
    "chatglm3-6b",
    "zamba2-1.2b",
    "seamless-m4t-large-v2",
    "qwen2-vl-72b",
    "mixtral-8x22b",
    "deepseek-v2-236b",
    "mamba2-1.3b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _module(arch):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r} (see ROADMAP.md); "
                       f"known: {ARCHS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch):
    return _module(arch).CONFIG


def get_smoke_config(arch):
    return _module(arch).SMOKE


def list_archs():
    return list(ARCHS)
