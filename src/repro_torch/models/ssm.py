"""Pure Mamba2 (SSD) language model (port of ``repro.models.ssm``), the
mamba2-1.3b family. Attention-free: the decode state is O(1) in sequence
length.

The layers are a ``ModuleList`` run in a Python loop. Parameter names are
the reference's key paths with the layer index in place of the stacked
axis (``layers.3.mixer.in_proj.w`` is ``layers.mixer.in_proj.w[3]``), so
converting is a rename and an unstack (``repro_torch.convert``). The
prefill runs every layer's chunked scan through the SSD kernel (K5,
``repro_torch.kernels.ssd_scan``), which also returns the final state the
decode starts from; decode is the plain single-token recurrence.

``forward`` and ``loss_fn`` are the training path, as in the reference:
every layer through ``mamba2_apply`` with the plain chunked scan
(``nn.ssd.ssd_chunked``, its bf16 intra-chunk variant when
``cfg.ssd_bf16``; K5 is forward-only) and the decoder's cross entropy;
``cfg.remat`` checkpoints each block. The prefill runs K5 whatever
``cfg.ssd_bf16`` says: its bf16 route already rounds the intra-chunk
operands to bf16.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.decoder import (Embedding, PARAM_DTYPE, _readout,
                                        _unported, cross_entropy,
                                        maybe_remat)
from repro_torch.nn import layers as nnl
from repro_torch.nn import ssd


def _check_supported(cfg):
    if cfg.family != "ssm":
        raise _unported(f"the {cfg.family!r} family in the ssm model")


def _ssm_kw(cfg):
    return dict(headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                n_groups=cfg.ssm_ngroups)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, cfg, *, generator=None):
        super().__init__()
        self.norm = nnl.RMSNorm(cfg.d_model, dtype=PARAM_DTYPE)
        self.mixer = ssd.Mamba2(cfg.d_model, d_inner=cfg.d_inner,
                                generator=generator, dtype=PARAM_DTYPE,
                                **_ssm_kw(cfg))


class SSMLM(nn.Module):
    """The ssm model's parameters: ``embed.embed``, ``final_norm.scale``,
    ``lm_head.w`` when the embeddings are not tied, and
    ``layers.<i>.{norm.scale, mixer.*}``."""

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
        self.layers = nn.ModuleList(Block(cfg, generator=generator)
                                    for _ in range(cfg.n_layers))


def init(cfg, seed=0, *, device=None):
    """Parameters drawn from a ``torch.Generator`` seeded with ``seed``, in
    float32 on the CPU (the reference's stddevs and constants; see
    ``nn.ssd.Mamba2``), the matrices, norms and conv cast to bf16, then
    moved to ``device`` (None: the CUDA device). The same seed gives the
    same weights on every device."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return SSMLM(cfg, generator=gen).to(device)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _block_apply(cfg, p, x):
    """One block over the whole sequence (training): x + mixer(norm x)."""
    h = p.norm(x, eps=cfg.norm_eps)
    ssd_fn = partial(ssd.ssd_chunked, bf16=True) if cfg.ssd_bf16 else None
    return x + ssd.mamba2_apply(p.mixer, h, chunk=cfg.ssm_chunk,
                                ssd_fn=ssd_fn, **_ssm_kw(cfg))


def forward(cfg, params, batch):
    """Token embeddings -> final hidden states. Returns (x, aux loss 0)."""
    _check_supported(cfg)
    x = nnl.embedding(params.embed.embed, batch["tokens"])
    fn = maybe_remat(cfg, partial(_block_apply, cfg))
    for p_l in params.layers:
        x = fn(p_l, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg, params, batch):
    """The decoder's objective (``models.decoder.cross_entropy``) on the
    ssm's hidden states."""
    x, aux = forward(cfg, params, batch)
    return cross_entropy(cfg, params, batch, x, aux)


def init_cache(cfg, batch, max_len, *, device=None):
    """Per layer a bf16 conv state (B, W-1, channels) and a float32 SSM
    state (B, H, P, N), as the reference's, on ``device`` (None: the CUDA
    device); ``max_len`` does not size them."""
    _check_supported(cfg)
    device = resolve_device(device)
    return {"layers": [ssd.init_ssm_cache(batch, cfg.d_model,
                                          d_inner=cfg.d_inner, device=device,
                                          **_ssm_kw(cfg))
                       for _ in range(cfg.n_layers)],
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _mamba2_apply_with_state(cfg, p, u, ssd_fn=None):
    """mamba2_apply that also returns the final SSD and conv states.
    ``ssd_fn`` (x, dt, A, B, C, chunk=) -> (y, state) defaults to the SSD
    kernel's wrapper."""
    fn = ssd_fn or partial(ssd_scan, return_state=True)
    b, s = u.shape[:2]
    z, x, dt, A, B, C, conv_state = ssd._ssd_inputs(
        p, p.in_proj(u), b, s, **_ssm_kw(cfg))
    y, final_state = fn(x, dt, A, B, C, chunk=cfg.ssm_chunk)
    return (ssd._gated_out(p, y, x, z),
            {"conv": conv_state, "ssm": final_state})


def _block_prefill(cfg, p, x, ssd_fn=None):
    """One block over the whole sequence from zero state: (x + mixer(norm
    x), the block's cache after it). Also the hybrid's Mamba2 layer."""
    h = p.norm(x, eps=cfg.norm_eps)
    y, cache_l = _mamba2_apply_with_state(cfg, p.mixer, h, ssd_fn)
    return x + y, cache_l


def _block_decode(cfg, p, x, cache_l):
    """One block, one token: (x + mixer(norm x), the block's cache one
    token on); the cache given is not written."""
    h = p.norm(x, eps=cfg.norm_eps)
    y, cache_l = ssd.mamba2_decode(p.mixer, h, cache_l, **_ssm_kw(cfg))
    return x + y, cache_l


def prefill(cfg, params, batch, cache, *, ssd_fn=None):
    """batch["tokens"] (B, S) -> (last-position logits (B, Vp) float32, the
    cache after S tokens). Every layer starts from zero state: the incoming
    cache's states are not read, as in the reference. ``ssd_fn`` replaces
    the SSD kernel (the plain ``nn.ssd.ssd_chunked`` takes the same
    arguments)."""
    _check_supported(cfg)
    x = nnl.embedding(params.embed.embed, batch["tokens"])
    layers = []
    for p_l in params.layers:
        x, c_l = _block_prefill(cfg, p_l, x, ssd_fn)
        layers.append(c_l)
    logits = _readout(cfg, params, x[:, -1:, :])
    return logits[:, 0], {"layers": layers,
                          "len": cache["len"] + batch["tokens"].shape[1]}


def decode_step(cfg, params, cache, tokens):
    """tokens: (B, 1) -> (logits (B, Vp), the cache one token on)."""
    x = nnl.embedding(params.embed.embed, tokens)
    layers = []
    for p_l, c_l in zip(params.layers, cache["layers"]):
        x, c_l = _block_decode(cfg, p_l, x, c_l)
        layers.append(c_l)
    logits = _readout(cfg, params, x)
    return logits[:, 0], {"layers": layers, "len": cache["len"] + 1}
