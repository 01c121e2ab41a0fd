"""The input-shape grid and the inputs of each (arch, shape) cell (port of
``repro.configs.shapes``).

``train_*`` cells feed a train step, ``prefill_*`` a serving prefill,
``decode_*`` and ``long_*`` a decode step (one token against a cache of
``seq``). long_500k needs a sub-quadratic decode path: it runs for the
SSM, hybrid and sliding-window archs and is refused for the others.

``input_specs`` gives tensors on the meta device (shape and dtype, no
storage) where the reference gives ``ShapeDtypeStruct``s;
``concrete_inputs`` draws real ones with NumPy exactly as the reference
does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def shape_supported(cfg, shape_id):
    """(supported, reason)."""
    if shape_id == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid") or cfg.window > 0
        if not sub_quadratic:
            return False, ("full quadratic attention; long_500k runs only for "
                           "SSM/hybrid/linear-attn per assignment")
    return True, ""


def _sd(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape_id, *, scale=1):
    """Meta tensors for every model input of this (arch, shape) cell, in the
    reference's order. ``scale`` divides batch and seq for reduced runs."""
    spec = SHAPES[shape_id]
    B = max(spec["batch"] // scale, 1)
    S = max(spec["seq"] // scale, 8)
    i32 = torch.int32
    if spec["kind"] == "decode":
        # one new token; the cache is built by the model's init_cache
        return {"tokens": _sd((B, 1), i32)}
    batch = {"tokens": _sd((B, S), i32)}
    if spec["kind"] == "train":
        batch["labels"] = _sd((B, S), i32)
    if cfg.family == "encdec":
        batch["frames"] = _sd((B, max(S // cfg.src_ratio, 8), cfg.d_model),
                              torch.bfloat16)
    if cfg.family == "vlm":
        V = min(cfg.n_vision_tokens, S // 2)
        batch["vision_embeds"] = _sd((B, V, cfg.d_model), torch.bfloat16)
        batch["positions_thw"] = _sd((3, B, S), i32)
    return batch


def concrete_inputs(cfg, shape_id, *, scale=1, seed=0, device=None):
    """Real tensors matching ``input_specs``, on ``device`` (None: the CUDA
    device): token ids uniform over the vocab, bf16 inputs standard normal
    (drawn in float64, rounded to bf16), M-RoPE positions the text ids on
    all three sections; one ``np.random.default_rng(seed)`` drawn in the
    specs' order, as the reference draws it."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in input_specs(cfg, shape_id, scale=scale).items():
        if name == "positions_thw":
            _, b, t = s.shape
            arr = np.broadcast_to(np.arange(t, dtype=np.int32), (3, b, t))
            out[name] = torch.from_numpy(arr.copy())
        elif s.dtype == torch.int32:
            out[name] = torch.from_numpy(
                rng.integers(0, cfg.vocab, size=s.shape, dtype=np.int32))
        else:
            out[name] = torch.from_numpy(rng.normal(0, 1, s.shape)).to(
                s.dtype)
    return {n: t.to(device) for n, t in out.items()}
