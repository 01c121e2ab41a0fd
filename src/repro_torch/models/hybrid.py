"""Zamba2-style hybrid (port of ``repro.models.hybrid``): groups of Mamba2
layers, each group followed by one invocation of a SHARED (weight-tied)
attention block (arXiv:2411.15242), then a tail of Mamba2 layers. The
shared block's input is concat(hidden, embedding of the call's tokens),
projected back to d_model.

Structure: G = n_layers // attn_every groups of [attn_every Mamba2 layers
+ the shared block], then n_layers - G·attn_every tail layers. The
block's weights exist once (``shared.*``), read by all G invocations; each
invocation has its own KV cache. The prefill runs every Mamba2 layer's
scan through the SSD kernel (K5) and every invocation's attention through
the flash-attention kernel (K4) with ``attn_backend="pallas"``; decode is
the plain recurrence and the plain cache read.

Parameter names are the reference's key paths with the stacked axes as
indices: ``groups.<g>.<i>.*`` is the reference's ``groups.*[g, i]`` and
``tail.<i>.*`` its ``tail.*[i]`` (``repro_torch.convert``).

``forward`` and ``loss_fn`` are the training path: the Mamba2 layers
through the plain chunked scan and the shared block through
``attention_apply`` (the config's 'full' or 'chunked' backend; K4 and K5
are forward-only, so a loss under ``attn_backend="pallas"`` raises), then
the decoder's cross entropy; ``cfg.remat`` checkpoints each Mamba2 block
and each shared-block invocation.

``cfg.ssd_bf16`` reaches the hybrid only through the ssm model's blocks,
as in the reference: the loss's Mamba2 layers take the bf16 intra-chunk
scan, and the prefill runs K5 whatever the flag says (``models.ssm``), so
its output equals the output with the flag off bit for bit. With
``rope="none"`` the shared block's attention runs without rope.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import ssm
from repro_torch.models.decoder import (Embedding, PARAM_DTYPE, _positions,
                                        _readout, _rope_fn, _rope_fn_decode,
                                        _unported, check_trainable,
                                        cross_entropy, maybe_remat)
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as nnl
from repro_torch.nn import ssd


def _check_supported(cfg):
    if cfg.family != "hybrid":
        raise _unported(f"the {cfg.family!r} family in the hybrid model")
    if cfg.rope not in ("standard", "partial", "none"):
        raise _unported(f"rope {cfg.rope!r}")


def _group_shape(cfg):
    G = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    return G, cfg.n_layers - G * cfg.attn_every


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class SharedAttention(nn.Module):
    """The weight-tied block: ``in_proj`` (2 d_model -> d_model, no bias),
    ``attn_norm``, ``attn``, ``ffn_norm`` and a SwiGLU ``ffn``."""

    def __init__(self, cfg, *, generator=None):
        super().__init__()
        kw = dict(generator=generator, dtype=PARAM_DTYPE)
        self.in_proj = nnl.Linear(2 * cfg.d_model, cfg.d_model,
                                  use_bias=False, **kw)
        self.attn_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        self.attn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, qkv_bias=cfg.qkv_bias, **kw)
        self.ffn_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        self.ffn = nnl.SwiGLU(cfg.d_model, cfg.d_ff, **kw)


class HybridLM(nn.Module):
    """The hybrid's parameters: ``embed.embed``, ``final_norm.scale``,
    ``shared.*``, ``groups.<g>.<i>.{norm.scale, mixer.*}`` (when G > 0),
    ``tail.<i>.*`` (when there is a tail) and ``lm_head.w`` when the
    embeddings are not tied."""

    def __init__(self, cfg, *, generator=None):
        super().__init__()
        _check_supported(cfg)
        G, tail = _group_shape(cfg)
        block = lambda: ssm.Block(cfg, generator=generator)
        self.embed = Embedding(cfg.vocab_padded, cfg.d_model,
                               generator=generator)
        self.final_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        self.shared = SharedAttention(cfg, generator=generator)
        if G:
            self.groups = nn.ModuleList(
                nn.ModuleList(block() for _ in range(cfg.attn_every))
                for _ in range(G))
        if tail:
            self.tail = nn.ModuleList(block() for _ in range(tail))
        if not cfg.tie_embeddings:
            self.lm_head = nnl.Linear(cfg.d_model, cfg.vocab_padded,
                                      use_bias=False, generator=generator,
                                      dtype=PARAM_DTYPE)


def init(cfg, seed=0, *, device=None):
    """Parameters drawn from a ``torch.Generator`` seeded with ``seed``, in
    float32 on the CPU with the reference's stddevs and constants, cast to
    bf16 where the reference keeps bf16, then moved to ``device`` (None:
    the CUDA device). The same seed gives the same weights on every
    device."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return HybridLM(cfg, generator=gen).to(device)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _attn_kw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, mode="causal", window=None,
                backend=cfg.attn_backend, chunk=cfg.attn_chunk)


def _shared_out(p, x, h, a):
    """The block's residual tail, added in the reference's order: with
    h' = h + a, x + (h' + ffn(norm(h')))."""
    h = h + a
    h = h + p.ffn(p.ffn_norm(h))
    return x + h


def _shared_apply(cfg, p, x, x0, positions, mask_pos):
    """One invocation of the shared block over the whole sequence."""
    h = p.in_proj(torch.cat([x, x0], dim=-1))
    a = attn.attention_apply(p.attn, p.attn_norm(h), mask_pos,
                             rope_fn=_rope_fn(cfg, positions),
                             **_attn_kw(cfg))
    return _shared_out(p, x, h, a)


def forward(cfg, params, batch):
    """Token embeddings -> final hidden states. Returns (x, aux loss 0)."""
    _check_supported(cfg)
    G, tail = _group_shape(cfg)
    x = nnl.embedding(params.embed.embed, batch["tokens"])
    x0 = x
    positions, mask_pos = _positions(cfg, batch)
    mamba_fn = maybe_remat(cfg, partial(ssm._block_apply, cfg))
    shared_fn = maybe_remat(cfg, partial(_shared_apply, cfg))
    for g in range(G):
        for p_l in params.groups[g]:
            x = mamba_fn(p_l, x)
        x = shared_fn(params.shared, x, x0, positions, mask_pos)
    if tail:
        for p_l in params.tail:
            x = mamba_fn(p_l, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg, params, batch):
    """The decoder's objective (``models.decoder.cross_entropy``) on the
    hybrid's hidden states."""
    check_trainable(cfg)
    x, aux = forward(cfg, params, batch)
    return cross_entropy(cfg, params, batch, x, aux)


def init_cache(cfg, batch, max_len, *, device=None):
    """Per Mamba2 layer a bf16 conv state and a float32 SSM state (the
    groups' as G lists of attn_every, the tail's as one list), and per
    shared-block invocation a bf16 KV cache of ``max_len`` slots, on
    ``device`` (None: the CUDA device)."""
    _check_supported(cfg)
    device = resolve_device(device)
    G, tail = _group_shape(cfg)
    ssm_one = lambda: ssd.init_ssm_cache(batch, cfg.d_model,
                                         d_inner=cfg.d_inner, device=device,
                                         **ssm._ssm_kw(cfg))
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if G:
        cache["mamba_groups"] = [[ssm_one() for _ in range(cfg.attn_every)]
                                 for _ in range(G)]
        cache["attn"] = [attn.init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                            cfg.head_dim, device=device)
                         for _ in range(G)]
    if tail:
        cache["tail"] = [ssm_one() for _ in range(tail)]
    return cache


def prefill(cfg, params, batch, cache, *, ssd_fn=None):
    """batch["tokens"] (B, S) -> (last-position logits (B, Vp) float32, the
    cache after S tokens). Every Mamba2 layer starts from zero state, as in
    the reference; the KV caches are written in place. ``ssd_fn`` replaces
    the SSD kernel (the plain ``nn.ssd.ssd_chunked`` takes the same
    arguments)."""
    _check_supported(cfg)
    G, tail = _group_shape(cfg)
    x = nnl.embedding(params.embed.embed, batch["tokens"])
    x0 = x
    positions, mask_pos = _positions(cfg, batch)
    new_cache = {"len": cache["len"] + batch["tokens"].shape[1]}
    p = params.shared
    groups = []
    for g in range(G):
        states = []
        for p_l in params.groups[g]:
            x, c_l = ssm._block_prefill(cfg, p_l, x, ssd_fn)
            states.append(c_l)
        groups.append(states)
        h = p.in_proj(torch.cat([x, x0], dim=-1))
        a, _ = attn.attention_prefill(p.attn, p.attn_norm(h), mask_pos,
                                      cache["attn"][g],
                                      rope_fn=_rope_fn(cfg, positions),
                                      **_attn_kw(cfg))
        x = _shared_out(p, x, h, a)
    if G:
        new_cache.update(mamba_groups=groups, attn=cache["attn"])
    if tail:
        new_cache["tail"] = []
        for p_l in params.tail:
            x, c_l = ssm._block_prefill(cfg, p_l, x, ssd_fn)
            new_cache["tail"].append(c_l)
    logits = _readout(cfg, params, x[:, -1:, :])
    return logits[:, 0], new_cache


def decode_step(cfg, params, cache, tokens):
    """tokens: (B, 1) -> (logits (B, Vp), the cache one token on). The
    shared block's second input is the embedding of ``tokens``, the new
    token's, as in the reference."""
    G, tail = _group_shape(cfg)
    x = nnl.embedding(params.embed.embed, tokens)
    x0 = x
    new_cache = {"len": cache["len"] + 1}
    p = params.shared
    groups = []
    for g in range(G):
        states = []
        for p_l, c_l in zip(params.groups[g], cache["mamba_groups"][g]):
            x, c_l = ssm._block_decode(cfg, p_l, x, c_l)
            states.append(c_l)
        groups.append(states)
        h = p.in_proj(torch.cat([x, x0], dim=-1))
        a, _ = attn.attention_decode(
            p.attn, p.attn_norm(h), cache["attn"][g], n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_fn=_rope_fn_decode(cfg))
        x = _shared_out(p, x, h, a)
    if G:
        new_cache.update(mamba_groups=groups, attn=cache["attn"])
    if tail:
        new_cache["tail"] = []
        for p_l, c_l in zip(params.tail, cache["tail"]):
            x, c_l = ssm._block_decode(cfg, p_l, x, c_l)
            new_cache["tail"].append(c_l)
    logits = _readout(cfg, params, x)
    return logits[:, 0], new_cache
