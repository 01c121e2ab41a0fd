"""Policy and value networks of §IV-D and the recurrent (GRU)
actor-critic, as ``nn.Module``s (port of ``repro.core.networks``).

Policy: input -> Linear(256) -> tanh -> 3 residual blocks (two linears
interleaved with LayerNorm + ReLU, plus skip) -> tanh -> Linear(mean), with
a trainable log-std clamped to [-2, 3] and exponentiated. The mean head is
scaled by a trainable ``action_scale`` (a parameter in the reference's tree
too, so AdamW updates it).

Value: input -> Linear(256) -> tanh -> 2 residual blocks (Tanh) -> Linear
-> scalar.

Recurrent variant: input -> Linear(256) -> tanh -> GRU cell -> tanh ->
heads; the carry starts at zeros every episode (``rnn_carry``).

Parameter names and shapes are the reference tree's (``embed.w``,
``b0.ln1.scale``, ``gru.wz.b``, ...), so ``repro_torch.convert`` moves
parameters between the packages by name.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.nn.layers import Linear, LayerNorm

HIDDEN = 256
RNN_HIDDEN = 64
LOG_STD_MIN, LOG_STD_MAX = -2.0, 3.0
# 0.5*log(2*pi) and 0.5*log(2*pi*e) in float32, as jnp evaluates them
_HALF_LOG_2PI = float(np.float32(0.5) * np.log(np.float32(2 * math.pi)))
_HALF_LOG_2PI_E = float(np.float32(0.5)
                        * np.log(np.float32(2 * math.pi * math.e)))


class _Block(nn.Module):
    def __init__(self, d, generator):
        super().__init__()
        self.l1 = Linear(d, d, generator=generator)
        self.ln1 = LayerNorm(d)
        self.l2 = Linear(d, d, generator=generator)
        self.ln2 = LayerNorm(d)

    def forward(self, x, act):
        h = act(self.ln1(self.l1(x)))
        h = act(self.ln2(self.l2(h)))
        return x + h


class _GaussianHead(nn.Module):
    """Mean head, mean bias in action units, log-std and action scale."""

    def _init_head(self, d_in, act_dim, action_scale, init_log_std,
                   generator):
        self.mean = Linear(d_in, act_dim, stddev=0.01, generator=generator)
        self.mean_bias_units = nn.Parameter(torch.ones(act_dim))
        self.log_std = nn.Parameter(torch.full((act_dim,), init_log_std))
        self.action_scale = nn.Parameter(torch.tensor(float(action_scale)))

    def _head(self, h):
        raw = self.mean(h) + self.mean_bias_units
        mean = raw * self.action_scale
        log_std = torch.clamp(self.log_std, LOG_STD_MIN, LOG_STD_MAX)
        std = torch.exp(log_std) * torch.ones_like(mean)
        return mean, std


class PolicyNet(_GaussianHead):
    def __init__(self, *, obs_dim=8, act_dim=3, hidden=HIDDEN,
                 action_scale=25.0, init_log_std=1.5, generator=None):
        super().__init__()
        self.embed = Linear(obs_dim, hidden, generator=generator)
        self.b0 = _Block(hidden, generator)
        self.b1 = _Block(hidden, generator)
        self.b2 = _Block(hidden, generator)
        self._init_head(hidden, act_dim, action_scale, init_log_std,
                        generator)

    def forward(self, obs):
        """obs: (..., obs_dim) -> (mean, std): thread-count units."""
        h = torch.tanh(self.embed(obs))
        for b in (self.b0, self.b1, self.b2):
            h = b(h, torch.relu)
        return self._head(torch.tanh(h))


class ValueNet(nn.Module):
    def __init__(self, *, obs_dim=8, hidden=HIDDEN, generator=None):
        super().__init__()
        self.embed = Linear(obs_dim, hidden, generator=generator)
        self.b0 = _Block(hidden, generator)
        self.b1 = _Block(hidden, generator)
        self.out = Linear(hidden, 1, generator=generator)

    def forward(self, obs):
        h = torch.tanh(self.embed(obs))
        for b in (self.b0, self.b1):
            h = b(h, torch.tanh)
        return self.out(h)[..., 0]


class GRUCell(nn.Module):
    def __init__(self, d_in, d_hidden, generator=None):
        super().__init__()
        self.wz = Linear(d_in + d_hidden, d_hidden, generator=generator)
        self.wr = Linear(d_in + d_hidden, d_hidden, generator=generator)
        self.wh = Linear(d_in + d_hidden, d_hidden, generator=generator)

    def forward(self, h, x):
        return gru_cell(self, h, x)


def gru_cell(p: GRUCell, h, x):
    """Standard GRU cell: (..., d_hidden), (..., d_in) -> (..., d_hidden)."""
    hx = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(p.wz(hx))
    r = torch.sigmoid(p.wr(hx))
    cand = torch.tanh(p.wh(torch.cat([x, r * h], dim=-1)))
    return (1.0 - z) * h + z * cand


class RNNPolicyNet(_GaussianHead):
    def __init__(self, *, obs_dim=8, act_dim=3, hidden=HIDDEN,
                 rnn_hidden=RNN_HIDDEN, action_scale=25.0, init_log_std=1.5,
                 generator=None):
        super().__init__()
        self.embed = Linear(obs_dim, hidden, generator=generator)
        self.gru = GRUCell(hidden, rnn_hidden, generator)
        self._init_head(rnn_hidden, act_dim, action_scale, init_log_std,
                        generator)

    def forward(self, carry, obs):
        """(carry, obs) -> (carry', mean, std): thread-count units."""
        x = torch.tanh(self.embed(obs))
        h = self.gru(carry, x)
        mean, std = self._head(torch.tanh(h))
        return h, mean, std


class RNNValueNet(nn.Module):
    def __init__(self, *, obs_dim=8, hidden=HIDDEN, rnn_hidden=RNN_HIDDEN,
                 generator=None):
        super().__init__()
        self.embed = Linear(obs_dim, hidden, generator=generator)
        self.gru = GRUCell(hidden, rnn_hidden, generator)
        self.out = Linear(rnn_hidden, 1, generator=generator)

    def forward(self, carry, obs):
        x = torch.tanh(self.embed(obs))
        h = self.gru(carry, x)
        return h, self.out(torch.tanh(h))[..., 0]


def rnn_carry(net, batch_shape=()):
    """Zero carry for a recurrent policy/value net (episode-start
    contract), on the net's device."""
    w = net.gru.wz.w
    return w.new_zeros(tuple(batch_shape) + (w.shape[1],))


def gaussian_logp(mean, std, action):
    var = std ** 2
    return torch.sum(-0.5 * ((action - mean) ** 2 / var)
                     - torch.log(std) - _HALF_LOG_2PI, dim=-1)


def gaussian_entropy(std):
    return torch.sum(_HALF_LOG_2PI_E + torch.log(std), dim=-1)
