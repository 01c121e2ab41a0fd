"""Capacity-based top-k Mixture-of-Experts with scatter dispatch (port of
``repro.nn.moe``).

The expert products run over (E, C, d) buffers with
C = ceil(N·k/E · capacity_factor), so their operations scale with the
active parameters (times the capacity factor), as a real MoE's do. Tokens
past an expert's capacity are dropped (Switch/GShard semantics): a garbage
slot C catches them, and they add nothing to the output. A
``capacity_factor`` of at least E/k drops nothing. The expert products are
batched matrix products (``torch.bmm``); the reference leaves them to
``jnp.einsum`` outside any Pallas kernel.

Returns the layer output and the Switch-style load-balancing loss
E · sum_e f_e · P_e.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.nn.layers import Linear, SwiGLU, swiglu, truncated_normal


class Experts(nn.Module):
    """``gate`` and ``up`` (E, d_model, d_ff), ``down`` (E, d_ff, d_model)."""

    def __init__(self, d_model, d_ff, n_experts, *, generator=None,
                 dtype=torch.bfloat16):
        super().__init__()
        std_in, std_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
        draw = lambda shape, std: nn.Parameter(
            truncated_normal(shape, std, generator).to(dtype))
        self.gate = draw((n_experts, d_model, d_ff), std_in)
        self.up = draw((n_experts, d_model, d_ff), std_in)
        self.down = draw((n_experts, d_ff, d_model), std_out)


class MoE(nn.Module):
    """The reference's ``moe_init`` tree: ``router.w`` (d_model, E) in
    float32 (routing logits are precision-sensitive), ``experts.*`` in
    ``dtype``, and ``shared.*`` (a SwiGLU of width d_ff_shared · n_shared)
    when there are shared experts."""

    def __init__(self, d_model, d_ff, n_experts, *, n_shared=0,
                 d_ff_shared=None, generator=None, dtype=torch.bfloat16):
        super().__init__()
        self.router = Linear(d_model, n_experts, use_bias=False,
                             generator=generator, dtype=torch.float32)
        self.experts = Experts(d_model, d_ff, n_experts, generator=generator,
                               dtype=dtype)
        if n_shared:
            self.shared = SwiGLU(d_model, (d_ff_shared or d_ff) * n_shared,
                                 generator=generator, dtype=dtype)


def _expert_ffn(experts, buf):
    """buf (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    h = F.silu(torch.bmm(buf, experts.gate)) * torch.bmm(buf, experts.up)
    return torch.bmm(h, experts.down)


def router_noise_draw(shape, generator, device):
    """The router's standard normal noise (float32), drawn from
    ``generator`` (the reference draws ``jax.random.normal(rng, shape)``)."""
    return torch.randn(shape, generator=generator, device=device)


def _route(params, xf, top_k, normalize_weights, router_noise=0.0,
           generator=None):
    """float32 router probabilities (N, E) and the top_k choices' weights
    and experts (N, k), highest first. With ``router_noise`` and a
    ``generator``, the logits get ``router_noise`` times standard normal
    noise first, as the reference's ``router_noise`` and ``rng`` do."""
    logits = xf.to(torch.float32) @ params.router.w
    if router_noise and generator is not None:
        logits = logits + router_noise * router_noise_draw(
            logits.shape, generator, logits.device)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, top_k, dim=-1)
    if normalize_weights:
        top_vals = top_vals / torch.clamp_min(
            top_vals.sum(-1, keepdim=True), 1e-9)
    return probs, top_vals, top_idx


def _shared(params, xf):
    return swiglu(params.shared.gate.w, params.shared.up.w,
                  params.shared.down.w, xf).to(torch.float32)


def moe_apply(params, x, *, top_k, capacity_factor=1.25,
              normalize_weights=True, router_noise=0.0, generator=None):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux loss float32 scalar).
    ``router_noise`` with a ``torch.Generator`` adds noise to the router
    logits (the reference's ``router_noise`` and ``rng``); without a
    generator none is added, as in the reference.

    Choice j of token n goes to slot (rank of n among the tokens whose
    choice j is the same expert) + (that expert's tokens from choices
    before j); a slot at or past C is the garbage slot C."""
    B, S, d = x.shape
    E = params.router.w.shape[1]
    N = B * S
    xf = x.reshape(N, d)
    probs, top_vals, top_idx = _route(params, xf, top_k, normalize_weights,
                                      router_noise, generator)

    C = int(math.ceil(N * top_k / E * capacity_factor))
    buf = xf.new_zeros((E, C + 1, d))
    counts = torch.zeros((E,), dtype=torch.int64, device=x.device)
    slot_of = []
    for j in range(top_k):
        e = top_idx[:, j]
        onehot = F.one_hot(e, E)
        csum = torch.cumsum(onehot, dim=0)
        within = csum - onehot  # rank among choice j
        pos = within.gather(1, e[:, None])[:, 0] + counts.gather(0, e)
        counts = counts + csum[-1]   # choice j's tokens per expert
        slot = pos.clamp_max(C)   # the reference's where(pos < C, pos, C)
        buf.index_put_((e, slot), xf, accumulate=True)
        slot_of.append((e, slot))

    out_buf = torch.cat([_expert_ffn(params.experts, buf[:, :C]),
                         buf.new_zeros((E, 1, d))], dim=1)
    y = torch.zeros((N, d), dtype=torch.float32, device=x.device)
    for j, (e, slot) in enumerate(slot_of):
        kept = (slot < C).to(torch.float32)
        y = y + ((top_vals[:, j] * kept)[:, None]
                 * out_buf[e, slot].to(torch.float32))
    if hasattr(params, "shared"):
        y = y + _shared(params, xf)

    # every choice's tokens per expert: the reference's sum of bincounts
    frac_tokens = counts.to(torch.float32) / (N * top_k)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return y.reshape(B, S, d).to(x.dtype), aux


def moe_apply_dense_reference(params, x, *, top_k, normalize_weights=True):
    """Every expert on every token, masked by the router's choice: the
    oracle of ``moe_apply`` where nothing drops. E/k times the operations;
    tests only."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    _, top_vals, top_idx = _route(params, xf, top_k, normalize_weights)
    ex = params.experts
    g = torch.einsum("nd,edf->enf", xf, ex.gate)
    u = torch.einsum("nd,edf->enf", xf, ex.up)
    all_out = torch.einsum("enf,efd->end", F.silu(g) * u, ex.down)
    rows = torch.arange(xf.shape[0], device=x.device)
    y = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for j in range(top_k):
        sel = all_out[top_idx[:, j], rows]                     # (N, d)
        y = y + top_vals[:, j][:, None] * sel.to(torch.float32)
    if hasattr(params, "shared"):
        y = y + _shared(params, xf)
    return y.reshape(B, S, d).to(x.dtype)
