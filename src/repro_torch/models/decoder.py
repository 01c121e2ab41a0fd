"""Transformer decoder (port of ``repro.models.decoder``), the dense
(llama-style), MoE (mixtral, deepseek-v2) and VLM-backbone (qwen2-vl)
families: pre-norm blocks of grouped-query attention (causal or
sliding-window) with the standard, partial or M-RoPE rope, or of
multi-head latent attention (``models.mla``), a SwiGLU, GELU or MoE
feed-forward, RMSNorm, tied or separate read-out. An MoE model may lead
with a few dense-FFN layers. A VLM batch may carry ``vision_embeds``
(B, V, d_model), which replace the first V token embeddings, and
``positions_thw`` (3, B, S), M-RoPE's temporal, height and width ids
(text positions on all three when absent).

The reference scans each stack of layers (``dense_layers``, ``layers``)
whose parameters carry a leading L axis; here a stack is a ``ModuleList``
run in a Python loop, and the serving cache holds a list of per-layer KV
caches per stack. Parameter names are the reference's key paths with the
layer index in place of the stacked axis (``layers.3.attn.wq.w`` is
``layers.attn.wq.w[3]``), so converting is a rename and an unstack
(``repro_torch.convert``).

``forward`` and ``loss_fn`` are the training path: every block through
``attention_apply`` (the config's 'full' or 'chunked' backend) and, with
``cfg.remat``, ``torch.utils.checkpoint`` in place of ``jax.checkpoint``.
K4 (``attn_backend="pallas"``) is forward-only, so a loss under it raises.
MLA has no K4 route (``models.mla``): under 'pallas' it raises. Every
family of the decoder trains: the VLM's loss takes ``vision_embeds`` and
``positions_thw`` as its forward does, and the MLA's runs ``mla.mla_apply``
(q and k of head dim nope + rope, v of ``v_head_dim``) under 'full' or
'chunked'.
"""

from __future__ import annotations

import math
from functools import partial

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.models import mla
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as nnl
from repro_torch.nn import moe as nnmoe
from repro_torch.nn.rotary import (apply_mrope, apply_partial_rope,
                                   apply_rope, text_mrope_positions)

NEG_INF = -1e30
PARAM_DTYPE = torch.bfloat16   # the reference's parameter dtype


def _unported(what):
    return NotImplementedError(f"{what} is not ported yet (see ROADMAP.md)")


def _check_supported(cfg):
    if cfg.family not in ("dense", "moe", "vlm"):
        raise _unported(f"the {cfg.family!r} family")
    if cfg.use_mla:
        mla.check_backend(cfg, cfg.attn_backend)
    if cfg.rope not in ("standard", "partial", "mrope", "none"):
        raise _unported(f"rope {cfg.rope!r}")
    if cfg.mlp not in ("swiglu", "gelu"):
        raise _unported(f"the {cfg.mlp!r} MLP")


# ---------------------------------------------------------------------------
# Rope plumbing
# ---------------------------------------------------------------------------

def _rope_fn_decode(cfg):
    """Rope closure for decode: (q, k, pos (B, 1)) -> (q, k), or None for
    ``rope="none"``. M-RoPE gives the cache position to all three sections,
    as the reference does."""
    if cfg.rope == "none":
        return None
    if cfg.rope == "partial":
        return lambda q, k, pos: apply_partial_rope(
            q, k, pos, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    if cfg.rope == "mrope":
        return lambda q, k, pos: apply_mrope(
            q, k, pos[None].expand(3, *pos.shape),
            sections=cfg.mrope_sections, theta=cfg.rope_theta)
    return lambda q, k, pos: apply_rope(q, k, pos, theta=cfg.rope_theta)


def _rope_fn(cfg, positions):
    """Rope closure for full-sequence attention, or None for
    ``rope="none"``. positions: (B, S), or (3, B, S) for M-RoPE."""
    if cfg.rope == "none":
        return None
    if cfg.rope == "mrope":
        return lambda q, k: apply_mrope(q, k, positions,
                                        sections=cfg.mrope_sections,
                                        theta=cfg.rope_theta)
    rope = _rope_fn_decode(cfg)
    return lambda q, k: rope(q, k, positions)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """The (vocab_padded, d_model) table, named ``embed`` as in the
    reference, drawn with stddev 1/sqrt(d_model)."""

    def __init__(self, vocab, d_model, *, generator=None):
        super().__init__()
        self.embed = nn.Parameter(nnl.truncated_normal(
            (vocab, d_model), 1.0 / math.sqrt(d_model),
            generator).to(PARAM_DTYPE))


class Block(nn.Module):
    """Attention (``mla.MLA`` where ``cfg.use_mla``) and a feed-forward: an
    ``nnmoe.MoE`` where ``moe_ffn``, else the config's dense MLP (the GELU
    one without biases, as the reference's ``_block_init``)."""

    def __init__(self, cfg, *, moe_ffn=False, generator=None):
        super().__init__()
        self.attn_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        self.ffn_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        if cfg.use_mla:
            self.attn = mla.MLA(cfg, generator=generator, dtype=PARAM_DTYPE)
        else:
            self.attn = attn.Attention(cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.head_dim,
                                       qkv_bias=cfg.qkv_bias,
                                       generator=generator,
                                       dtype=PARAM_DTYPE)
        kw = dict(generator=generator, dtype=PARAM_DTYPE)
        if moe_ffn:
            self.ffn = nnmoe.MoE(cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                                 n_shared=cfg.n_shared_experts,
                                 d_ff_shared=cfg.d_ff_expert, **kw)
        elif cfg.mlp == "gelu":
            self.ffn = nnl.GeluMLP(cfg.d_model, cfg.d_ff_dense or cfg.d_ff,
                                   use_bias=False, **kw)
        else:
            self.ffn = nnl.SwiGLU(cfg.d_model, cfg.d_ff_dense or cfg.d_ff,
                                  **kw)


def _stacks(cfg):
    """[(stack name, n_layers, moe_ffn)] in execution order: an MoE model's
    leading dense-FFN layers, then its MoE layers."""
    if cfg.n_experts:
        out = []
        if cfg.n_dense_layers:
            out.append(("dense_layers", cfg.n_dense_layers, False))
        out.append(("layers", cfg.n_layers - cfg.n_dense_layers, True))
        return out
    return [("layers", cfg.n_layers, False)]


class DecoderLM(nn.Module):
    """The decoder's parameters: ``embed.embed``, ``final_norm.scale``,
    ``lm_head.w`` when the embeddings are not tied, and per stack of
    ``_stacks`` (``dense_layers``, ``layers``) ``<stack>.<i>.*``."""

    def __init__(self, cfg, *, generator=None):
        super().__init__()
        _check_supported(cfg)
        self.embed = Embedding(cfg.vocab_padded, cfg.d_model,
                               generator=generator)
        self.final_norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        if not cfg.tie_embeddings:
            self.lm_head = nnl.Linear(cfg.d_model, cfg.vocab_padded,
                                      use_bias=False, generator=generator,
                                      dtype=PARAM_DTYPE)
        for name, n, moe_ffn in _stacks(cfg):
            setattr(self, name, nn.ModuleList(
                Block(cfg, moe_ffn=moe_ffn, generator=generator)
                for _ in range(n)))


def init(cfg, seed=0, *, device=None):
    """Parameters drawn from a ``torch.Generator`` seeded with ``seed``:
    truncated normals with the reference's stddevs (1/sqrt(d_in) for every
    matrix, 1/sqrt(d_model) for the embedding), unit norm scales, drawn in
    float32 on the CPU and cast to bf16 (the reference's parameter dtype),
    then moved to ``device`` (None: the CUDA device). The same seed gives
    the same weights on every device."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return DecoderLM(cfg, generator=gen).to(device)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _attn_kw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim,
                mode="sliding" if cfg.window else "causal",
                window=cfg.window or None, backend=cfg.attn_backend,
                chunk=cfg.attn_chunk)


def _ffn(cfg, p, h):
    """(the feed-forward's output, its MoE aux loss or None when dense)."""
    if isinstance(p.ffn, nnmoe.MoE):
        return nnmoe.moe_apply(p.ffn, h, top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               normalize_weights=cfg.moe_normalize)
    return p.ffn(h), None


def _block_apply(cfg, p, x, extra):
    """One block over the whole sequence (training): (x out, the block's
    MoE aux loss or None)."""
    positions, mask_pos = extra["positions"], extra["mask_positions"]
    h = p.attn_norm(x, eps=cfg.norm_eps)
    if cfg.use_mla:
        a = mla.mla_apply(cfg, p.attn, h, positions,
                          backend=cfg.attn_backend, chunk=cfg.attn_chunk)
    else:
        a = attn.attention_apply(p.attn, h, mask_pos,
                                 rope_fn=_rope_fn(cfg, positions),
                                 **_attn_kw(cfg))
    x = x + a
    f, aux = _ffn(cfg, p, p.ffn_norm(x, eps=cfg.norm_eps))
    return x + f, aux


def _save_matmuls(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of matmuls without batch dims, recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(cfg, fn):
    """``fn`` under ``torch.utils.checkpoint`` as the config asks (the
    reference's ``jax.checkpoint`` policies 'full' and 'dots'); the
    recomputation gives the same values, so only memory changes."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = partial(ckpt.create_selective_checkpoint_contexts,
                                   _save_matmuls)
    return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False,
                                         **kw)


def check_trainable(cfg):
    """A loss takes gradients through attention, and K4 has none: a loss
    under 'pallas' raises, whatever the family (the VLM and MLA losses
    included; MLA has no 'pallas' route at all)."""
    if cfg.attn_backend == "pallas":
        raise NotImplementedError(
            "attn_backend='pallas' is forward-only (K4 has no backward in "
            "either package); train with 'full' or 'chunked' (see "
            "ROADMAP.md)")


def _block_prefill(cfg, p, x, cache_l, extra):
    positions, mask_pos = extra["positions"], extra["mask_positions"]
    h = p.attn_norm(x, eps=cfg.norm_eps)
    if cfg.use_mla:
        a, cache_l = mla.mla_prefill(cfg, p.attn, h, positions, cache_l,
                                     backend=cfg.attn_backend,
                                     chunk=cfg.attn_chunk)
    else:
        a, cache_l = attn.attention_prefill(p.attn, h, mask_pos, cache_l,
                                            rope_fn=_rope_fn(cfg, positions),
                                            **_attn_kw(cfg))
    x = x + a
    h = p.ffn_norm(x, eps=cfg.norm_eps)
    return x + _ffn(cfg, p, h)[0], cache_l


def _block_decode(cfg, p, x, cache_l):
    h = p.attn_norm(x, eps=cfg.norm_eps)
    if cfg.use_mla:
        a, cache_l = mla.mla_decode(cfg, p.attn, h, cache_l)
    else:
        a, cache_l = attn.attention_decode(
            p.attn, h, cache_l, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_fn=_rope_fn_decode(cfg), window=cfg.window or None)
    x = x + a
    h = p.ffn_norm(x, eps=cfg.norm_eps)
    return x + _ffn(cfg, p, h)[0], cache_l


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _embed(cfg, params, batch):
    x = nnl.embedding(params.embed.embed, batch["tokens"])
    if cfg.family == "vlm" and "vision_embeds" in batch:
        v = batch["vision_embeds"].to(x.dtype)
        x = torch.cat([v, x[:, v.shape[1]:]], dim=1)
    return x


def _positions(cfg, batch):
    """(rope positions (B, S), or (3, B, S) for M-RoPE; mask positions
    (S,))."""
    B, S = batch["tokens"].shape
    device = batch["tokens"].device
    mask_pos = torch.arange(S, dtype=torch.int32, device=device)
    if cfg.rope == "mrope":
        pos = batch.get("positions_thw")
        if pos is None:
            pos = text_mrope_positions(B, S, device=device)
        return pos, mask_pos
    return mask_pos[None].expand(B, S), mask_pos


def _readout(cfg, params, x):
    x = params.final_norm(x, eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = nnl.embedding_logits(params.embed.embed, x)
    else:
        logits = (x @ params.lm_head.w).to(torch.float32)
    if cfg.vocab_padded != cfg.vocab:  # mask padding rows out of the softmax
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits + torch.where(pad, NEG_INF, 0.0)
    return logits


def forward(cfg, params, batch):
    """Token embeddings -> final hidden states. Returns (x, aux loss)."""
    _check_supported(cfg)
    x = _embed(cfg, params, batch)
    positions, mask_pos = _positions(cfg, batch)
    extra = {"positions": positions, "mask_positions": mask_pos}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    fn = maybe_remat(cfg, partial(_block_apply, cfg))
    for name, _, _ in _stacks(cfg):
        for p_l in getattr(params, name):
            x, a = fn(p_l, x, extra)
            if a is not None:
                aux_total = aux_total + a
    return x, aux_total


def cross_entropy(cfg, params, batch, x, aux):
    """The objective on final hidden states ``x``: the mean cross entropy
    over the padded vocab (padding rows masked by ``_readout``) under the
    optional ``loss_mask``, plus ``z_loss_coef`` times the mean squared
    log-partition and ``aux_loss_coef`` times the MoE aux loss. Returns
    (total, {"ce", "z_loss", "aux"})."""
    logits = _readout(cfg, params, x)  # (B, S, Vp) float32
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = ((logz - ll) * mask).sum() / denom
    z_loss = cfg.z_loss_coef * ((logz ** 2) * mask).sum() / denom
    total = ce + z_loss + cfg.aux_loss_coef * aux
    return total, {"ce": ce, "z_loss": z_loss, "aux": aux}


def loss_fn(cfg, params, batch):
    """batch {"tokens", "labels" (B, S) int, optional "loss_mask"} ->
    (scalar loss, metrics)."""
    check_trainable(cfg)
    x, aux = forward(cfg, params, batch)
    return cross_entropy(cfg, params, batch, x, aux)


def init_cache(cfg, batch, max_len, *, device=None):
    """Per stack, one bf16 cache per layer, as the reference's (whatever
    the parameters' dtype): a KV cache, a ring of ``window`` slots for
    sliding-window attention, or MLA's latent cache. On ``device`` (None:
    the CUDA device)."""
    _check_supported(cfg)
    device = resolve_device(device)

    def one():
        if cfg.use_mla:
            return mla.init_mla_cache(cfg, batch, max_len, device=device)
        return attn.init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                  cfg.head_dim, window=cfg.window or None,
                                  device=device)

    return {name: [one() for _ in range(n)] for name, n, _ in _stacks(cfg)}


def prefill(cfg, params, batch, cache):
    """batch["tokens"] (B, S) -> (last-position logits (B, Vp) float32,
    cache)."""
    x = _embed(cfg, params, batch)
    positions, mask_pos = _positions(cfg, batch)
    extra = {"positions": positions, "mask_positions": mask_pos}
    for name, _, _ in _stacks(cfg):
        for p_l, c_l in zip(getattr(params, name), cache[name]):
            x, _ = _block_prefill(cfg, p_l, x, c_l, extra)
    logits = _readout(cfg, params, x[:, -1:, :])
    return logits[:, 0], cache


def decode_step(cfg, params, cache, tokens):
    """tokens: (B, 1) -> (logits (B, Vp), cache)."""
    x = nnl.embedding(params.embed.embed, tokens)
    for name, _, _ in _stacks(cfg):
        for p_l, c_l in zip(getattr(params, name), cache[name]):
            x, _ = _block_decode(cfg, p_l, x, c_l)
    logits = _readout(cfg, params, x)
    return logits[:, 0], cache
