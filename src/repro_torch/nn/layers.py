"""The layers the port's networks and language models use (port of
``repro.nn.layers``: ``linear``, ``layernorm``, ``rmsnorm``,
``embedding``, ``embedding_logits``, ``swiglu`` and ``gelu_mlp``).

Weights keep the JAX package's layout — ``w`` is (d_in, d_out) and a layer
computes ``x @ w + b`` — so a parameter's name and shape are those of the
reference tree (``embed.w``, ``b0.ln1.scale``, ...), and converting between
the two is a rename (``repro_torch.convert``). Norms accumulate in float32
and return the input's dtype, as the reference's do.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def truncated_normal(shape, stddev, generator=None):
    """stddev * a standard normal truncated to [-2, 2], float32, on the CPU
    (initialization draws from a CPU generator so a seed gives the same
    weights on every device)."""
    w = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                          generator=generator)
    return w * stddev


def linear(w, b, x):
    """x @ w + b; mixed types compute in their promoted type, as JAX's
    (a bf16 input against float32 weights: float32)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if b is not None:
        y = y + b
    return y


def layernorm(scale, bias, x, *, eps=1e-5):
    """LayerNorm over the last axis with the POPULATION variance
    (``jnp.var``), accumulated in float32 (float64 for float64 inputs)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(acc) + bias.to(acc)).to(x.dtype)


def rmsnorm(scale, x, *, eps=1e-6):
    """RMSNorm over the last axis, accumulated in float32."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def embedding(embed, tokens):
    """``embed[tokens]`` as ``F.embedding``, whose forward and backward
    DTensor can split over a vocab-sharded table."""
    return torch.nn.functional.embedding(tokens, embed)


def embedding_logits(embed, x):
    """The tied read-out x @ embed.T with float32 logits: the operands are
    taken to float32 first, so the logits are never rounded to bf16 (the
    reference's ``preferred_element_type=float32``)."""
    return x.to(torch.float32) @ embed.to(torch.float32).T


def swiglu(gate_w, up_w, down_w, x):
    """down(silu(x @ gate) * (x @ up)), in the input's dtype."""
    g = torch.nn.functional.silu(x @ gate_w)
    return (g * (x @ up_w)) @ down_w


def gelu_mlp(up_w, up_b, down_w, down_b, x):
    """down(gelu(up(x))), the two-matrix (GPT-BigCode) MLP, in the input's
    dtype; ``up_b``/``down_b`` may be None. The gelu is the tanh
    approximation, ``jax.nn.gelu``'s default."""
    h = torch.nn.functional.gelu(linear(up_w, up_b, x), approximate="tanh")
    return linear(down_w, down_b, h)


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` (d_in, d_out) drawn from a truncated normal
    (stddev 1/sqrt(d_in) by default) and cast to ``dtype``."""

    def __init__(self, d_in, d_out, *, use_bias=True, stddev=None,
                 generator=None, dtype=torch.float32):
        super().__init__()
        stddev = stddev if stddev is not None else 1.0 / math.sqrt(d_in)
        self.w = nn.Parameter(truncated_normal((d_in, d_out), stddev,
                                               generator).to(dtype))
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype)) if use_bias
                  else None)

    def forward(self, x):
        return linear(self.w, self.b, x)


class LayerNorm(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return layernorm(self.scale, self.bias, x)


class RMSNorm(nn.Module):
    def __init__(self, d, *, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype))

    def forward(self, x, *, eps=1e-6):
        return rmsnorm(self.scale, x, eps=eps)


class SwiGLU(nn.Module):
    """The llama MLP; parameters ``gate.w``, ``up.w``, ``down.w``."""

    def __init__(self, d_model, d_ff, *, generator=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(use_bias=False, generator=generator, dtype=dtype)
        self.gate = Linear(d_model, d_ff, **kw)
        self.up = Linear(d_model, d_ff, **kw)
        self.down = Linear(d_ff, d_model, **kw)

    def forward(self, x):
        return swiglu(self.gate.w, self.up.w, self.down.w, x)


class GeluMLP(nn.Module):
    """The two-matrix MLP; parameters ``up.{w,b}``, ``down.{w,b}`` (the
    biases when ``use_bias``, as the reference's ``gelu_mlp_init``)."""

    def __init__(self, d_model, d_ff, *, use_bias=True, generator=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(use_bias=use_bias, generator=generator, dtype=dtype)
        self.up = Linear(d_model, d_ff, **kw)
        self.down = Linear(d_ff, d_model, **kw)

    def forward(self, x):
        return gelu_mlp(self.up.w, self.up.b, self.down.w, self.down.b, x)
