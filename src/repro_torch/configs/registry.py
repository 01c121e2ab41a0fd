"""The port's architecture registry: the archs the port can run, each with
its exact published config and its structurally identical SMOKE config.
The code is the JAX package's registry with ``ARCHS`` narrowed to the
ported archs; every other arch raises KeyError naming ROADMAP.md, where the
families still to port are listed.

Sources ([verified-tier] per assignment):
  smollm-135m            hf:HuggingFaceTB/SmolLM-135M
  granite-34b            arXiv:2405.04324
  deepseek-7b            arXiv:2401.02954
  chatglm3-6b            arXiv:2406.12793
  zamba2-1.2b            arXiv:2411.15242
  mixtral-8x22b          arXiv:2401.04088
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
    "mixtral-8x22b",
    "mamba2-1.3b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _module(arch):
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported (see ROADMAP.md); "
                       f"ported: {ARCHS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch):
    return _module(arch).CONFIG


def get_smoke_config(arch):
    return _module(arch).SMOKE


def list_archs():
    return list(ARCHS)
