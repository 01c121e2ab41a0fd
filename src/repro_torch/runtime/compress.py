"""Gradient compression (port of ``repro.runtime.compress``): int8
quantize -> dequantize with one symmetric scale per reference leaf, over
the train state's ``{name: tensor}`` gradient dicts.

Applied to the gradients before the optimizer (``make_train_step(
compress_fn=)``), it models the wire format of a compressed all-reduce:
an int8 payload and a float32 scale per leaf. A leaf is a parameter of the
reference's tree, where a stack of layers is one array: the port's layers
of a stack (``layers.0.attn.wq.w``, ``layers.1.attn.wq.w``, ...) share one
scale, that of the reference's stacked ``layers.attn.wq.w``
(``convert.reference_name``). Each tensor is quantized in float32 and
returned in its own dtype; rounding is half to even, as ``jnp.round``
rounds.

``make_int8_compressor(error_feedback=True)`` returns a stateful wrapper
that carries the quantization residual into the next call (EF-SGD); the
residual keeps the gradients' dtype.
"""

from __future__ import annotations

import torch

from repro_torch.convert import reference_name


def _scales(grads):
    """{name: the float32 scale of its reference leaf}: the largest |g|
    over the leaf's tensors, floored at 1e-12, over 127."""
    amax = {}
    for n, g in grads.items():
        a = g.to(torch.float32).abs().amax()
        leaf = reference_name(n)
        amax[leaf] = torch.maximum(amax[leaf], a) if leaf in amax else a
    # divided by a tensor, not by the number 127: on a CUDA tensor
    # PyTorch turns division by a Python scalar into a product with its
    # reciprocal, which can land one ulp off the reference's quotient
    return {n: torch.clamp_min(amax[reference_name(n)], 1e-12)
            / amax[reference_name(n)].new_tensor(127.0) for n in grads}


def int8_codes(grads):
    """({name: int8 codes}, {name: float32 scale}): what
    ``quantize_dequantize_int8`` sends."""
    scales = _scales(grads)
    codes = {n: torch.clamp(torch.round(g.to(torch.float32) / scales[n]),
                            -127, 127).to(torch.int8)
             for n, g in grads.items()}
    return codes, scales


def quantize_dequantize_int8(grads):
    """{name: tensor} -> the same names, each through the int8 round trip,
    in its own dtype."""
    codes, scales = int8_codes(grads)
    return {n: (codes[n].to(torch.float32) * scales[n]).to(g.dtype)
            for n, g in grads.items()}


def int8_roundtrip_error(grads):
    """Relative L2 error of the int8 round trip over all the tensors of a
    non-empty dict, a float32 0-d tensor (diagnostics and tests)."""
    out = quantize_dequantize_int8(grads)
    num = den = 0.0
    for n, g in grads.items():
        gf = g.to(torch.float32)
        num = num + ((gf - out[n].to(torch.float32)) ** 2).sum()
        den = den + (gf ** 2).sum()
    return torch.sqrt(num / torch.clamp_min(den, 1e-30))


def make_int8_compressor(*, error_feedback=False):
    """Returns compress_fn(grads) -> grads. With ``error_feedback``, a
    residual carried across calls is added to the gradients before they
    are quantized, and what the round trip dropped becomes the next
    residual."""
    if not error_feedback:
        return quantize_dequantize_int8

    state = {"residual": None}

    def compress(grads):
        if state["residual"] is not None:
            grads = {n: g + state["residual"][n] for n, g in grads.items()}
        out = quantize_dequantize_int8(grads)
        state["residual"] = {n: g - out[n] for n, g in grads.items()}
        return out

    return compress
