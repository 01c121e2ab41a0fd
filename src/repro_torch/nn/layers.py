"""The layers the port's networks use (port of ``repro.nn.layers``'s
``linear`` and ``layernorm``).

Weights keep the JAX package's layout — ``w`` is (d_in, d_out) and a layer
computes ``x @ w + b`` — so a parameter's name and shape are those of the
reference tree (``embed.w``, ``b0.ln1.scale``, ...), and converting between
the two is a rename (``repro_torch.convert``).
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
    y = x @ w
    if b is not None:
        y = y + b
    return y


def layernorm(scale, bias, x, *, eps=1e-5):
    """LayerNorm over the last axis with the POPULATION variance
    (``jnp.var``), accumulated in float32."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


class Linear(nn.Module):
    def __init__(self, d_in, d_out, *, use_bias=True, stddev=None,
                 generator=None):
        super().__init__()
        stddev = stddev if stddev is not None else 1.0 / math.sqrt(d_in)
        self.w = nn.Parameter(truncated_normal((d_in, d_out), stddev,
                                               generator))
        self.b = (nn.Parameter(torch.zeros(d_out)) if use_bias else None)

    def forward(self, x):
        return linear(self.w, self.b, x)


class LayerNorm(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return layernorm(self.scale, self.bias, x)
