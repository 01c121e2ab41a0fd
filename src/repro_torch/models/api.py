"""Uniform model API (port of ``repro.models.api``): ``get_model(cfg)``
returns a ``Model`` whose methods are plain functions of (params,
batch/cache). The port runs every family of the reference: dense, moe
and vlm (the decoder), ssm, hybrid and encdec; an unknown family raises
NotImplementedError naming ROADMAP.md.

Model methods
  init(seed, *, device=None) -> params (an nn.Module)
  loss_fn(params, batch) -> (loss, {"ce", "z_loss", "aux"})
  init_cache(batch_size, max_len, *, device=None) -> cache
  prefill(params, batch, cache) -> (logits, cache)
  decode_step(params, cache, tokens) -> (logits, cache)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

from repro_torch.models.config import ModelConfig
from repro_torch.models import decoder, encdec, hybrid, ssm

_FAMILY_MODULES = {
    "dense": decoder,
    "moe": decoder,
    "vlm": decoder,
    "ssm": ssm,
    "hybrid": hybrid,
    "encdec": encdec,
}
# the nn.Module that holds each family's parameters
MODULES = {"dense": decoder.DecoderLM, "moe": decoder.DecoderLM,
           "vlm": decoder.DecoderLM, "ssm": ssm.SSMLM,
           "hybrid": hybrid.HybridLM, "encdec": encdec.EncDecLM}


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss_fn: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]


def get_model(cfg: ModelConfig) -> Model:
    mod = _FAMILY_MODULES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(f"unknown family {cfg.family!r} (see "
                                  f"ROADMAP.md)")
    return Model(
        cfg=cfg,
        init=partial(mod.init, cfg),
        loss_fn=partial(mod.loss_fn, cfg),
        init_cache=partial(mod.init_cache, cfg),
        prefill=partial(mod.prefill, cfg),
        decode_step=partial(mod.decode_step, cfg),
    )
