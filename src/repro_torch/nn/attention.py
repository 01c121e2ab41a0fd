"""Grouped-query attention (port of ``repro.nn.attention``): rope through a
closure, causal / sliding-window / full masking, three backends, and the
KV-cache prefill and decode paths.

Backends
  'full'    — materialize (B,H,S,S) scores.
  'chunked' — online softmax over KV chunks, O(S·C) live memory.
  'chunked_tri' — online softmax over (q block, kv block) pairs, only
              the pairs with unmasked entries (about half the scores of
              'chunked' for causal attention, the window's band for
              sliding), bf16 probabilities; other modes and decode take
              'chunked', as in the reference.
  'pallas'  — the flash-attention kernel (K4, ``repro_torch.kernels.
              flash_attention``): the CUDA kernel on the card, its plain
              version on the CPU. Cross-attention and decode fall through
              to 'full', as in the reference.

``attention_apply`` is the full-sequence path the training losses take;
``attention_prefill`` and ``attention_decode`` serve.

Shapes: x (B, S, d_model); q (B, S, Hq, D); k/v (B, S, Hkv, D). The KV
cache is a dict of tensors {"k", "v" (B, slots, Hkv, D), "pos" (B, slots),
"len" (B,)}; prefill and decode write it IN PLACE and return the same dict
(the reference returns a new one; no caller keeps the old cache).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.nn.layers import Linear, linear

NEG_INF = -1e30


class Attention(nn.Module):
    """The projections ``wq``, ``wk``, ``wv`` (d_model -> heads * head_dim)
    and ``wo`` (back), as the reference's ``attention_init`` names them."""

    def __init__(self, d_model, n_heads, n_kv_heads, head_dim, *,
                 qkv_bias=False, generator=None, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.wq = Linear(d_model, n_heads * head_dim, use_bias=qkv_bias, **kw)
        self.wk = Linear(d_model, n_kv_heads * head_dim, use_bias=qkv_bias,
                         **kw)
        self.wv = Linear(d_model, n_kv_heads * head_dim, use_bias=qkv_bias,
                         **kw)
        self.wo = Linear(n_heads * head_dim, d_model, use_bias=False, **kw)


def _project_qkv(params, x, x_kv, n_heads, n_kv_heads, head_dim):
    B, S = x.shape[:2]
    Skv = x_kv.shape[1]
    q = params.wq(x).reshape(B, S, n_heads, head_dim)
    k = params.wk(x_kv).reshape(B, Skv, n_kv_heads, head_dim)
    v = params.wv(x_kv).reshape(B, Skv, n_kv_heads, head_dim)
    return q, k, v


def _repeat_kv(k, n_heads):
    """(B,S,Hkv,D) -> (B,S,Hq,D) by repeating each kv head over its group."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _mask_bias(q_pos, k_pos, mode, window):
    """(Sq, Sk) additive bias in fp32. q_pos/k_pos are int vectors."""
    if mode == "full":
        return None
    diff = q_pos[:, None] - k_pos[None, :]
    ok = diff >= 0
    if mode == "sliding":
        ok = ok & (diff < window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _f32_scores(q, k):
    """einsum('bqhd,bkhd->bhqk') accumulated in float32 (the reference's
    ``preferred_element_type=float32``)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                        k.to(torch.float32))


def sdpa_full(q, k, v, q_pos, k_pos, *, mode="causal", window=None,
              k_len=None):
    """Materialized softmax(QK^T)V with fp32 scores; the probabilities are
    cast to q's dtype before the product with V, as in the reference."""
    n_heads = q.shape[2]
    k = _repeat_kv(k, n_heads)
    v = _repeat_kv(v, n_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _f32_scores(q, k) * scale
    bias = _mask_bias(q_pos, k_pos, mode, window)
    if bias is not None:
        scores = scores + bias[None, None]
    if k_len is not None:  # decode: mask out unwritten cache slots
        valid = k_pos[None, :] < k_len[:, None]                    # (B, Sk)
        scores = scores + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))


def sdpa_chunked(q, k, v, q_pos, k_pos, *, mode="causal", window=None,
                 k_len=None, chunk=1024):
    """Flash-style online softmax over KV chunks (the reference's lax.scan
    as a loop): O(B·Sq·H·D + B·C·H·D) live memory instead of O(B·H·Sq·Sk).
    """
    B, Sq, Hq, D = q.shape
    Dv = v.shape[-1]
    Skv = k.shape[1]
    chunk = min(chunk, Skv)
    n_chunks = (Skv + chunk - 1) // chunk
    pad = n_chunks * chunk - Skv
    int_max = torch.iinfo(torch.int32).max
    if pad:
        k = nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = nn.functional.pad(k_pos, (0, pad), value=int_max)
    k = _repeat_kv(k, Hq)
    v = _repeat_kv(v, Hq)
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, Sq, Dv), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        kc = k[:, c * chunk:(c + 1) * chunk]
        vc = v[:, c * chunk:(c + 1) * chunk]
        kp = k_pos[c * chunk:(c + 1) * chunk]
        s = _f32_scores(q, kc) * scale
        bias = _mask_bias(q_pos, kp, mode, window)
        if bias is not None:
            s = s + bias[None, None]
        else:  # 'full' mode: still mask chunk-padding slots (pos == INT32_MAX)
            s = s + torch.where(kp == int_max, NEG_INF, 0.0)[None, None, None, :]
        if k_len is not None:
            valid = kp[None, :] < k_len[:, None]
            s = s + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).to(torch.float32),
                          vc.to(torch.float32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-37)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B,Sq,Hq,Dv)


def sdpa_chunked_tri(q, k, v, q_pos, k_pos, *, mode="causal", window=None,
                     chunk=1024, probs_dtype=torch.bfloat16):
    """Triangular block-chunked online-softmax attention: q and kv are cut
    into C-sized blocks, and only the block pairs (i, j) that can hold an
    unmasked entry are scored (j <= i; for a sliding window also i - j <=
    ceil(window / C)). Each q block carries its own (m, l, acc) state. The
    reference scans the pairs one by one; here every pair at one offset
    i - j is one batched product, and the offsets run in the order that
    gives each q block the reference's order of pairs (the masked pairs
    first, then the others, each by ascending j). The probabilities are
    ``probs_dtype`` (bf16 by default, as in the reference), the normalizer
    and accumulator float32.

    Self-attention over contiguous positions from 0 (training and
    prefill): Sq == Skv, ``q_pos`` and ``k_pos`` are not read."""
    if mode not in ("causal", "sliding") or q.shape[1] != k.shape[1]:
        raise ValueError("sdpa_chunked_tri is causal or sliding-window "
                         "self-attention")
    B, S, Hq, D = q.shape
    Dv = v.shape[-1]
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        q, k, v = (nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
    n = (S + pad) // C
    f32 = torch.float32
    qb = q.reshape(B, n, C, Hq, D).to(f32)
    kb = _repeat_kv(k, Hq).reshape(B, n, C, Hq, D).to(f32)
    vb = _repeat_kv(v, Hq).reshape(B, n, C, Hq, Dv).to(probs_dtype).to(f32)
    scale = 1.0 / math.sqrt(D)
    sliding = mode == "sliding" and window is not None
    offsets = range(n)
    if sliding:
        offsets = range(min(n, -(-int(window) // C) + 1))

    def needs_mask(d):
        # the diagonal (where kv padding also lies) and the window's edge
        return d == 0 or (sliding and (d + 1) * C > window)

    order = ([d for d in reversed(offsets) if needs_mask(d)]
             + [d for d in reversed(offsets) if not needs_mask(d)])
    m = torch.full((B, Hq, n, C), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, Hq, n, C), dtype=f32, device=q.device)
    acc = torch.zeros((B, Hq, n, C, Dv), dtype=f32, device=q.device)
    for d in order:   # the pairs (i, i - d), i = d .. n - 1
        s = torch.einsum("bnqhd,bnkhd->bhnqk", qb[:, d:], kb[:, :n - d]) \
            * scale
        masked = needs_mask(d)
        if masked:
            ar = torch.arange(C, device=q.device)
            diff = d * C + ar[:, None] - ar[None, :]
            ok = diff >= 0
            if sliding:
                ok = ok & (diff < window)
            ok = ok.expand(n - d, C, C)
            if pad and d == 0:   # the last kv block's padding
                kpos = (n - 1) * C + ar
                ok = torch.cat([ok[:-1], ok[-1:] & (kpos < S)[None, None]])
            s = s.masked_fill(~ok, NEG_INF)
        mi, li, ai = m[:, :, d:], l[:, :, d:], acc[:, :, d:]
        m_new = torch.maximum(mi, s.amax(dim=-1))
        p = torch.exp((s - m_new[..., None]).to(probs_dtype))
        if masked:
            p = torch.where(m_new[..., None] <= NEG_INF / 2,
                            torch.zeros((), dtype=probs_dtype,
                                        device=q.device), p)
        corr = torch.exp(mi - m_new)
        l_new = li * corr + p.sum(dim=-1, dtype=f32)
        a_new = ai * corr[..., None] + torch.einsum(
            "bhnqk,bnkhd->bhnqd", p.to(f32), vb[:, :n - d])
        m = torch.cat([m[:, :, :d], m_new], dim=2)
        l = torch.cat([l[:, :, :d], l_new], dim=2)
        acc = torch.cat([acc[:, :, :d], a_new], dim=2)
    out = acc / torch.clamp_min(l, 1e-37)[..., None]      # (B,H,n,C,Dv)
    out = out.reshape(B, Hq, n * C, Dv)[:, :, :S]
    return out.transpose(1, 2).to(q.dtype)                 # (B,S,H,Dv)


def _sdpa(q, k, v, q_pos, k_pos, *, backend, mode, window, k_len=None,
          chunk=1024):
    if (backend == "chunked_tri" and k_len is None
            and mode in ("causal", "sliding")):
        return sdpa_chunked_tri(q, k, v, q_pos, k_pos, mode=mode,
                                window=window, chunk=chunk)
    if backend in ("chunked", "chunked_tri"):
        return sdpa_chunked(q, k, v, q_pos, k_pos, mode=mode, window=window,
                            k_len=k_len, chunk=chunk)
    if backend == "pallas":
        if k_len is None and mode in ("causal", "sliding"):
            return flash_attention(q, k, v, window=window)
        # fall through for cross/decode paths the kernel does not cover
    return sdpa_full(q, k, v, q_pos, k_pos, mode=mode, window=window,
                     k_len=k_len)


def attention_apply(params, x, positions, *, n_heads, n_kv_heads, head_dim,
                    rope_fn=None, mode="causal", window=None, backend="full",
                    x_kv=None, kv_positions=None, chunk=1024):
    """Self- or cross-attention over a full sequence (training). The
    'pallas' backend is the forward-only kernel K4, which has no backward
    in either package: the training losses refuse it before they get
    here."""
    x_kv = x if x_kv is None else x_kv
    q, k, v = _project_qkv(params, x, x_kv, n_heads, n_kv_heads, head_dim)
    kv_positions = positions if kv_positions is None else kv_positions
    if rope_fn is not None:
        q, k = rope_fn(q, k)
    q_pos = positions[0] if positions.ndim > 1 else positions
    k_pos = kv_positions[0] if kv_positions.ndim > 1 else kv_positions
    out = _sdpa(q, k, v, q_pos, k_pos, backend=backend, mode=mode,
                window=window, chunk=chunk)
    B, S = x.shape[:2]
    return params.wo(out.reshape(B, S, n_heads * head_dim))


# ---------------------------------------------------------------------------
# KV cache (decode). For sliding-window attention the cache is a ring buffer
# of ``window`` slots; otherwise it holds max_len slots.
# ---------------------------------------------------------------------------

def init_kv_cache(batch, max_len, n_kv_heads, head_dim, *, window=None,
                  dtype=torch.bfloat16, device=None):
    slots = min(max_len, window) if window else max_len
    return {
        "k": torch.zeros((batch, slots, n_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, slots, n_kv_heads, head_dim), dtype=dtype,
                         device=device),
        # absolute position per slot
        "pos": torch.full((batch, slots), -1, dtype=torch.int32,
                          device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def attention_prefill(params, x, positions, cache, **kw):
    """Run full-sequence attention and write the last ``slots`` keys and
    values into the cache. Returns (output, cache)."""
    n_heads, n_kv_heads, head_dim = kw["n_heads"], kw["n_kv_heads"], kw["head_dim"]
    q, k, v = _project_qkv(params, x, x, n_heads, n_kv_heads, head_dim)
    if kw.get("rope_fn") is not None:
        q, k = kw["rope_fn"](q, k)
    q_pos = positions[0] if positions.ndim > 1 else positions
    out = _sdpa(q, k, v, q_pos, q_pos, backend=kw.get("backend", "chunked"),
                mode=kw.get("mode", "causal"), window=kw.get("window"),
                chunk=kw.get("chunk", 1024))
    B, S = x.shape[:2]
    slots = cache["k"].shape[1]
    take = min(S, slots)
    pos = q_pos[None, -take:].to(torch.int32).expand(B, take)
    if kw.get("window"):   # a ring: position p in slot p % slots
        idx = (q_pos[-take:] % slots).long()
        for name, t in (("k", k[:, -take:]), ("v", v[:, -take:]),
                        ("pos", pos)):
            write_slots(cache[name], idx, t)
    else:                  # the first take slots
        cache["k"][:, :take] = k[:, -take:].to(cache["k"].dtype)
        cache["v"][:, :take] = v[:, -take:].to(cache["v"].dtype)
        cache["pos"][:, :take] = pos
    cache["len"] += S
    return params.wo(out.reshape(B, S, n_heads * head_dim)), cache


def write_slots(cache_t, idx, vals):
    """``cache_t[:, idx] = vals`` for distinct slots ``idx`` (n,), vals
    (B, n, ...), in place, as a scatter along the slot dim, which a
    batch-sharded cache writes locally."""
    shape = vals.shape
    view = idx.view(1, -1, *([1] * (len(shape) - 2))).expand(shape)
    cache_t.scatter_(1, view, vals.to(cache_t.dtype))


def write_slot(cache_t, slot, vals):
    """``cache_t[b, slot[b]] = vals[b]`` for every row b, in place, as a
    scatter along the slot dim, which a batch-sharded cache (a DTensor
    split over its rows) writes locally."""
    B = cache_t.shape[0]
    tail = cache_t.shape[2:]
    idx = slot.view(B, 1, *([1] * len(tail))).expand(B, 1, *tail)
    cache_t.scatter_(1, idx, vals.to(cache_t.dtype)[:, None])


def attention_decode(params, x, cache, *, n_heads, n_kv_heads, head_dim,
                     rope_fn=None, window=None):
    """One-token decode step. x: (B, 1, d_model). Returns (out, cache)."""
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, x, n_heads, n_kv_heads, head_dim)
    pos = cache["len"].clone()  # (B,) absolute position of the new token
    if rope_fn is not None:
        q, k = rope_fn(q, k, pos[:, None])
    slots = cache["k"].shape[1]
    # the reference's slot rule: a full non-window cache overwrites its last
    # slot
    slot = (pos % slots if window
            else torch.clamp_max(pos, slots - 1)).long()
    write_slot(cache["k"], slot, k[:, 0])
    write_slot(cache["v"], slot, v[:, 0])
    write_slot(cache["pos"], slot, pos)
    cache["len"].copy_(pos + 1)

    kc = _repeat_kv(cache["k"], n_heads)
    vc = _repeat_kv(cache["v"], n_heads)
    scale = 1.0 / math.sqrt(head_dim)
    s = _f32_scores(q, kc) * scale
    # validity: slot written (pos >= 0), within window if sliding
    kpos = cache["pos"]  # (B, slots)
    ok = (kpos >= 0) & (kpos <= pos[:, None])
    if window:
        ok = ok & (pos[:, None] - kpos < window)
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None, :]
    dt = torch.promote_types(q.dtype, vc.dtype)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(dt), vc.to(dt))
    return params.wo(out.reshape(B, 1, n_heads * head_dim)), cache
