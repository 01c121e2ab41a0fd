"""Encoder-decoder backbone (port of ``repro.models.encdec``;
seamless-m4t-large-v2). The speech frontend is a stub, as in the
reference: the batch carries precomputed frame embeddings ``frames``
(B, S_src, d_model). A bidirectional encoder (rope, GELU MLP with biases)
and a causal decoder with cross-attention: rope on self-attention, none on
cross.

The decoder's causal self-attention runs the config's backend (K4 under
'pallas'); the encoder's bidirectional attention and the cross-attention
are 'full'-mode attention, which 'pallas' runs as the materialized
``sdpa_full``, as in the reference.

The serving cache holds per decoder layer a KV cache (``self``) and the
encoder output's cross K/V (``cross_k``, ``cross_v``, bf16, written by the
prefill), and ``len``. Parameter names are the reference's with the
layer index in place of the stacked axis (``dec_layers.3.cross_attn.wq.w``).

``forward`` and ``loss_fn`` are the training path, as in the reference:
the encoder and the teacher-forced decoder over the whole sequence, each
block under ``maybe_remat`` when ``cfg.remat`` (the reference's
``scan_layers(remat=)``), and the decoder's cross entropy. K4 is
forward-only, so a loss under 'pallas' raises.
"""

from __future__ import annotations

import math
from functools import partial

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.decoder import (Embedding, PARAM_DTYPE, _readout,
                                        _rope_fn, _rope_fn_decode, _unported,
                                        check_trainable, cross_entropy,
                                        maybe_remat)
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as nnl

# the type the reference fixes for the frames entering the encoder and for
# the cached cross K/V, whatever the parameters' type
ACT_DTYPE = torch.bfloat16


def _check_supported(cfg):
    if cfg.family != "encdec":
        raise _unported(f"the {cfg.family!r} family in the enc-dec model")
    if cfg.rope not in ("standard", "partial"):
        raise _unported(f"rope {cfg.rope!r}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _attention(cfg, generator):
    return attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, generator=generator,
                          dtype=PARAM_DTYPE)


def _mlp(cfg, generator):
    return nnl.GeluMLP(cfg.d_model, cfg.d_ff, use_bias=True,
                       generator=generator, dtype=PARAM_DTYPE)


class EncBlock(nn.Module):
    def __init__(self, cfg, *, generator=None):
        super().__init__()
        self.attn_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        self.attn = _attention(cfg, generator)
        self.ffn_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        self.ffn = _mlp(cfg, generator)


class DecBlock(nn.Module):
    def __init__(self, cfg, *, generator=None):
        super().__init__()
        self.self_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        self.self_attn = _attention(cfg, generator)
        self.cross_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        self.cross_attn = _attention(cfg, generator)
        self.ffn_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        self.ffn = _mlp(cfg, generator)


class EncDecLM(nn.Module):
    """``embed.embed``, ``enc_layers.<i>.*``, ``dec_layers.<i>.*``,
    ``enc_norm.scale``, ``final_norm.scale`` and ``lm_head.w`` when the
    embeddings are not tied."""

    def __init__(self, cfg, *, generator=None):
        super().__init__()
        _check_supported(cfg)
        self.embed = Embedding(cfg.vocab_padded, cfg.d_model,
                               generator=generator)
        self.enc_layers = nn.ModuleList(
            EncBlock(cfg, generator=generator)
            for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(
            DecBlock(cfg, generator=generator)
            for _ in range(cfg.n_dec_layers))
        self.enc_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        self.final_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        if not cfg.tie_embeddings:
            self.lm_head = nnl.Linear(cfg.d_model, cfg.vocab_padded,
                                      use_bias=False, generator=generator,
                                      dtype=PARAM_DTYPE)


def init(cfg, seed=0, *, device=None):
    """Parameters drawn as ``decoder.init`` draws them (truncated normals
    with the reference's stddevs from a CPU generator seeded with ``seed``,
    cast to bf16), on ``device`` (None: the CUDA device)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return EncDecLM(cfg, generator=gen).to(device)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _attn_kw(cfg, mode):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, mode=mode, window=None,
                backend=cfg.attn_backend, chunk=cfg.attn_chunk)


def _text_positions(B, S, device):
    mask_pos = torch.arange(S, dtype=torch.int32, device=device)
    return mask_pos[None].expand(B, S), mask_pos


def _enc_block_apply(cfg, p, x, extra):
    positions, mask_pos = extra["positions"], extra["mask_positions"]
    h = p.attn_norm(x, eps=cfg.norm_eps)
    x = x + attn.attention_apply(p.attn, h, mask_pos,
                                 rope_fn=_rope_fn(cfg, positions),
                                 **_attn_kw(cfg, "full"))
    return x + p.ffn(p.ffn_norm(x, eps=cfg.norm_eps))


def encode(cfg, params, frames, *, remat=False):
    """frames: (B, S_src, d_model) precomputed embeddings (the frontend
    stub), taken to ``ACT_DTYPE`` as the reference does -> the encoder
    output. ``remat``: each block under ``maybe_remat`` (training)."""
    B, S = frames.shape[:2]
    positions, mask_pos = _text_positions(B, S, frames.device)
    extra = {"positions": positions, "mask_positions": mask_pos}
    fn = partial(_enc_block_apply, cfg)
    if remat:
        fn = maybe_remat(cfg, fn)
    x = frames.to(ACT_DTYPE)
    for p in params.enc_layers:
        x = fn(p, x, extra)
    return params.enc_norm(x, eps=cfg.norm_eps)


def _dec_block_apply(cfg, p, x, extra):
    """One decoder block over the whole (teacher-forced) sequence."""
    h = p.self_norm(x, eps=cfg.norm_eps)
    x = x + attn.attention_apply(p.self_attn, h, extra["mask_positions"],
                                 rope_fn=_rope_fn(cfg, extra["positions"]),
                                 **_attn_kw(cfg, "causal"))
    h = p.cross_norm(x, eps=cfg.norm_eps)
    x = x + attn.attention_apply(p.cross_attn, h, extra["mask_positions"],
                                 rope_fn=None, x_kv=extra["enc_out"],
                                 kv_positions=extra["enc_pos"],
                                 **_attn_kw(cfg, "full"))
    return x + p.ffn(p.ffn_norm(x, eps=cfg.norm_eps))


def forward(cfg, params, batch):
    """batch {"tokens" (B, S), "frames" (B, S_src, d_model)} -> (the
    decoder's final hidden states, aux loss 0)."""
    _check_supported(cfg)
    enc_out = encode(cfg, params, batch["frames"], remat=True)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions, mask_pos = _text_positions(B, S, tokens.device)
    extra = {"positions": positions, "mask_positions": mask_pos,
             "enc_out": enc_out,
             "enc_pos": torch.arange(enc_out.shape[1], dtype=torch.int32,
                                     device=tokens.device)}
    x = nnl.embedding(params.embed.embed, tokens)
    fn = maybe_remat(cfg, partial(_dec_block_apply, cfg))
    for p in params.dec_layers:
        x = fn(p, x, extra)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg, params, batch):
    """batch {"tokens", "labels" (B, S) int, "frames", optional
    "loss_mask"} -> (scalar loss, metrics): the decoder's objective
    (``models.decoder.cross_entropy``, the reference's ``_shared_loss``) on
    the decoder's hidden states."""
    check_trainable(cfg)
    x, aux = forward(cfg, params, batch)
    return cross_entropy(cfg, params, batch, x, aux)


def init_cache(cfg, batch, max_len, *, device=None):
    """Per decoder layer a bf16 KV cache of ``max_len`` slots and zero bf16
    cross K/V of the reference's source length (the prefill replaces them
    with the encoder output's), on ``device`` (None: the CUDA device)."""
    _check_supported(cfg)
    device = resolve_device(device)
    L = cfg.n_dec_layers
    src = cfg.src_ratio and max(max_len // cfg.src_ratio, 8)
    cross = lambda: torch.zeros((batch, src, cfg.n_kv_heads, cfg.head_dim),
                                dtype=ACT_DTYPE, device=device)
    return {"self": [attn.init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                        cfg.head_dim, device=device)
                     for _ in range(L)],
            "cross_k": [cross() for _ in range(L)],
            "cross_v": [cross() for _ in range(L)],
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(cfg, params, batch, cache):
    """batch {"tokens" (B, S), "frames" (B, S_src, d_model)} -> (last-
    position logits (B, Vp) float32, cache)."""
    enc_out = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions, mask_pos = _text_positions(B, S, tokens.device)
    enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32,
                           device=tokens.device)
    x = nnl.embedding(params.embed.embed, tokens)
    cross_k, cross_v = [], []
    for p, c_self in zip(params.dec_layers, cache["self"]):
        h = p.self_norm(x, eps=cfg.norm_eps)
        a, _ = attn.attention_prefill(p.self_attn, h, mask_pos, c_self,
                                      rope_fn=_rope_fn(cfg, positions),
                                      **_attn_kw(cfg, "causal"))
        x = x + a
        h = p.cross_norm(x, eps=cfg.norm_eps)
        x = x + attn.attention_apply(p.cross_attn, h, mask_pos, rope_fn=None,
                                     x_kv=enc_out, kv_positions=enc_pos,
                                     **_attn_kw(cfg, "full"))
        x = x + p.ffn(p.ffn_norm(x, eps=cfg.norm_eps))
        # the cross K/V for decode
        shape = (B, -1, cfg.n_kv_heads, cfg.head_dim)
        cross_k.append(p.cross_attn.wk(enc_out).reshape(shape).to(ACT_DTYPE))
        cross_v.append(p.cross_attn.wv(enc_out).reshape(shape).to(ACT_DTYPE))
    cache["cross_k"], cache["cross_v"] = cross_k, cross_v
    cache["len"] += S
    logits = _readout(cfg, params, x[:, -1:, :])
    return logits[:, 0], cache


def _cross_decode(cfg, p, x_t, ck, cv):
    """x_t: (B, 1, d); ck/cv: (B, S_src, Hkv, D)."""
    B = x_t.shape[0]
    q = p.wq(x_t).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    kc = attn._repeat_kv(ck, cfg.n_heads)
    vc = attn._repeat_kv(cv, cfg.n_heads)
    s = attn._f32_scores(q, kc) / math.sqrt(cfg.head_dim)
    pr = torch.softmax(s, dim=-1).to(x_t.dtype)
    dt = torch.promote_types(pr.dtype, vc.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", pr.to(dt), vc.to(dt))
    return p.wo(out.reshape(B, 1, cfg.n_heads * cfg.head_dim))


def decode_step(cfg, params, cache, tokens):
    """tokens: (B, 1) -> (logits (B, Vp), cache)."""
    x = nnl.embedding(params.embed.embed, tokens)
    for p, c_self, ck, cv in zip(params.dec_layers, cache["self"],
                                 cache["cross_k"], cache["cross_v"]):
        h = p.self_norm(x, eps=cfg.norm_eps)
        a, _ = attn.attention_decode(p.self_attn, h, c_self,
                                     n_heads=cfg.n_heads,
                                     n_kv_heads=cfg.n_kv_heads,
                                     head_dim=cfg.head_dim,
                                     rope_fn=_rope_fn_decode(cfg))
        x = x + a
        h = p.cross_norm(x, eps=cfg.norm_eps)
        x = x + _cross_decode(cfg, p.cross_attn, h, ck, cv)
        x = x + p.ffn(p.ffn_norm(x, eps=cfg.norm_eps))
    cache["len"] += 1
    logits = _readout(cfg, params, x)
    return logits[:, 0], cache
