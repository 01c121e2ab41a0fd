"""The roundings of the bf16 tensor-core routes of K4 (flash attention) and
K5 (SSD chunked scan), emulated in plain PyTorch and held against the JAX
package at the port's unchanged tolerances.

The CUDA kernels cannot run here, so these emulations show on the CPU that
the bf16 operands each route feeds its tensor cores fit the limits the
kernels are held to on the card (``chip_smoke.py``'s ``FA_TOL`` and
``SSD_TOL``, the reference's own, ``tests/test_kernels.py``):

- K4 rounds P to bf16 for its product with V, per kv tile of keys (128
  in the wgmma route, 64 at its 256-column instance for head dims above
  128 and in the mma.sync route it replaced) against that
  tile's running max, and sums l from the same rounded P; the scores, l
  and the accumulator stay float32. Held at 2e-2 absolute. Each block of
  q rows walks only the kv tiles from its window's first live tile
  (``kt_begin``) to its diagonal; skipping the others changes no bit. A
  head dim below the instance's panel (64 or 128) comes in as zero
  columns, with the scale of the true D; without the causal mask every
  tile is walked and the keys past Skv, zeros in the last tile, are
  masked by their index.
- K5 rounds three operands to bf16: (C B^T .* L) * dt (dt folded into the
  score, L factored around each 16-row tile's first row as the wgmma
  route's warps factor it), x * exp(dA_cum[Q-1] - dA_cum) * dt for the
  state update (the decay folded into x, not into B), and the bf16 copy of
  h that C h^T reads; products of bf16 inputs are exact in float32 and
  every sum is float32. A chunk above 128 is one chunk in two row tiles
  (the 16-row tiles of L's factorization start at each). Held at 5e-2 as
  atol and rtol on y and on the final state.

Each emulation is held against the reference's Pallas kernel in interpret
mode (as ``tests/test_kernels.py`` runs it) or, where that kernel does not
take the shape (a ragged S) and for K5's final state, against the
reference's oracle ``ssd_chunked``; and against the port's plain version,
which the kernels are held to on the card. The emulations are test
helpers: no path of the port runs them."""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.nn.ssd import ssd_chunked as jax_ssd_chunked

from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.ssd_scan.ref import ssd_reference

FA_TOL = 2e-2          # chip_smoke.py FA_TOL["bfloat16"]
SSD_TOL = 5e-2         # chip_smoke.py SSD_TOL["bfloat16"]
NEG_INF = -1e30
BF16 = torch.bfloat16
F32 = torch.float32


def fa_tc_emulation(q, k, v, *, window=None, tile=64, q_block=None,
                    causal=True, d_pad=None):
    """K4's bf16 route: float32 scores of bf16 inputs, scaled after the dot,
    the -1e30 masks, an online softmax over kv tiles of ``tile`` keys with
    P rounded to bf16 against each tile's running max and l summed from the
    rounded P, and the output rounded to bf16 once. With ``q_block``, each
    block of that many positions walks only the kernel's tiles: from
    ``kt_begin``, the tile holding its first row's first live key, to the
    tile holding its last row; else every row walks every tile. With
    ``d_pad`` the head dim is zero-padded to that panel width (the scale
    stays 1/sqrt(D)); with ``causal=False`` the keys are zero-padded to
    whole tiles and those past Skv masked by index."""
    S, Hq, D = q.shape[1], q.shape[2], q.shape[3]
    Skv, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    if d_pad is not None:
        q, k, v = (torch.nn.functional.pad(x, (0, d_pad - D))
                   for x in (q, k, v))
    n_keys = Skv if causal else -(-Skv // tile) * tile
    if n_keys > Skv:
        k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n_keys - Skv))
                for x in (k, v))
    kf = torch.repeat_interleave(k.to(F32), group, dim=2)
    vf = torch.repeat_interleave(v.to(F32), group, dim=2)
    s_all = torch.einsum("bqhd,bkhd->bhqk", q.to(F32), kf) * scale
    qp = torch.arange(S)[:, None]
    kp = torch.arange(n_keys)[None, :]
    live = qp >= kp if causal else kp < Skv
    if window is not None:
        live = live & (qp - kp < window)
    s_all = torch.where(live, s_all, NEG_INF)
    blocks = [(0, S, 0, Skv)]
    if q_block is not None:
        blocks = []
        for q0 in range(0, S, q_block):
            first = max(0, q0 - (window - 1)) if window is not None else 0
            blocks.append((q0, min(S, q0 + q_block), first // tile * tile,
                           min(Skv, -(-(q0 + q_block) // tile) * tile)))
    if not causal:
        blocks = [(0, S, 0, n_keys)]
    Dp = q.shape[3]
    out = torch.empty(s_all.shape[:-1] + (Dp,))
    for r0, r1, k_lo, k_hi in blocks:
        rows = s_all[..., r0:r1, :]
        m = torch.full(rows.shape[:-1], NEG_INF)
        l = torch.zeros(rows.shape[:-1])
        acc = torch.zeros(rows.shape[:-1] + (Dp,))
        for k0 in range(k_lo, k_hi, tile):
            s = rows[..., k0:min(k0 + tile, k_hi)]
            m_new = torch.maximum(m, s.amax(dim=-1))
            dead = (m_new <= NEG_INF / 2)[..., None]
            p = torch.where(dead, 0.0, torch.exp(s - m_new[..., None]))
            p = p.to(BF16).to(F32)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vf[:, k0:k0 + s.shape[-1]])
            m = m_new
        out[..., r0:r1, :] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out[..., :D].transpose(1, 2).to(q.dtype)


def ssd_tc_emulation(x, dt, A, B, C, *, chunk=128):
    """K5's bf16 route (wgmma), chunk by chunk with h carried in float32,
    in the kernel's order: y = (C bf16(h)^T) * exp(dA_cum) + bf16((C B^T *
    rf) * kd) x, and h <- h * exp(dA_cum[Q-1]) + bf16(x * w)^T B with w =
    exp(dA_cum[Q-1] - dA_cum) * dt, every product of bf16 operands summed
    in float32; y rounded to bf16 once. L is factored as the kernel's warps
    factor it around the first row r0 of each 16-row tile: below the tile's
    diagonal block rf = exp(cum[i] - cum[r0]) and kd = exp(cum[r0] -
    cum[j]) * dt[j], both at most 1 (times dt); on the diagonal block
    exp(cum[i] - cum[j]) * dt[j] and an exact 0 above the diagonal. A
    chunk above 128 is one chunk in two row tiles of Q / 2 positions, whose
    16-row tiles start at each row tile's first row (every key of row tile
    0 lies below the rows of row tile 1). A ragged S is padded with dt = 0,
    as the kernel reads zeros past S."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    xf = torch.nn.functional.pad(x.to(F32), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.to(F32), (0, 0, 0, pad))
    Bf = torch.repeat_interleave(
        torch.nn.functional.pad(B.to(F32), (0, 0, 0, 0, 0, pad)), rep, dim=2)
    Cf = torch.repeat_interleave(
        torch.nn.functional.pad(C.to(F32), (0, 0, 0, 0, 0, pad)), rep, dim=2)
    rows = torch.arange(chunk)
    R = chunk if chunk <= 128 else chunk // 2           # a row tile's rows
    r0 = rows // R * R + rows % R // 16 * 16            # each row's tile start
    tri = rows[:, None] >= rows[None, :]
    below = rows[None, :] < r0[:, None]                 # left of the diagonal block
    state = torch.zeros((b, h, p, n))
    ys = []
    for t0 in range(0, s + pad, chunk):
        X = xf[:, t0:t0 + chunk]                       # (b, Q, h, p)
        d = dtf[:, t0:t0 + chunk].permute(0, 2, 1)     # (b, h, Q)
        Bk, Ck = Bf[:, t0:t0 + chunk], Cf[:, t0:t0 + chunk]
        cum = torch.cumsum(d * A.to(F32)[:, None], dim=-1)   # (b, h, Q)
        scores = torch.einsum("bihn,bjhn->bhij", Ck, Bk)
        c_r0 = cum[..., r0]                                  # (b, h, Q): cum[r0(i)]
        rf = torch.exp(cum - c_r0)[..., :, None]             # rows
        kd = torch.exp(c_r0[..., :, None] - cum[..., None, :]) * d[..., None, :]
        diag = torch.exp(cum[..., :, None] - cum[..., None, :]) * d[..., None, :]
        gated = torch.where(below, scores * rf * kd,
                            torch.where(tri, scores * diag, 0.0))
        y_diag = torch.einsum("bhij,bjhp->bihp", gated.to(BF16).to(F32), X)
        y_off = torch.einsum("bihn,bhpn->bihp", Ck, state.to(BF16).to(F32)) * (
            torch.exp(cum).permute(0, 2, 1)[..., None])
        ys.append(y_off + y_diag)
        last = cum[..., -1]                                  # (b, h)
        w = (torch.exp(last[..., None] - cum) * d).permute(0, 2, 1)  # (b, Q, h)
        xw = (X * w[..., None]).to(BF16).to(F32)
        state = (state * torch.exp(last)[..., None, None]
                 + torch.einsum("bthp,bthn->bhpn", xw, Bk))
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(x.dtype), state


FA_CASES = [
    # B, S, Hq, Hkv, D, window, blk (the JAX kernel's block)
    (2, 128, 4, 2, 64, None, 64),
    (1, 200, 9, 3, 64, None, 64),     # smollm's heads, ragged S
    (1, 150, 4, 2, 64, 40, 64),       # window and ragged S
    (1, 300, 4, 2, 64, 5, 64),        # a window narrower than a warp's rows
    (1, 130, 2, 1, 128, None, 64),    # D = 128, ragged S
    (1, 256, 4, 1, 128, 100, 64),     # D = 128, window
]


def fa_operands(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, S, Hq, D)).astype(np.float32),
            rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32),
            rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,blk", FA_CASES)
def test_fa_bf16_rounding_fits_the_tolerance(B, S, Hq, Hkv, D, win, blk):
    q, k, v = fa_operands(B, S, Hq, Hkv, D, seed=S * 3 + D)
    want = jax_flash(jnp.asarray(q, jnp.bfloat16),
                     jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), causal=True, window=win,
                     blk_q=blk, blk_k=blk, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    got = fa_tc_emulation(tq, tk, tv, window=win)
    assert got.dtype == BF16 and got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.to(F32).numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=FA_TOL)
    plain = attention_reference(tq, tk, tv, window=win)
    torch.testing.assert_close(got.to(F32), plain.to(F32), rtol=0,
                               atol=FA_TOL)


# the wgmma route's 128-key tiles: GQA groups of 1, 3, 8 and 48 (the two
# consumers of a block take two heads of one kv head where the group is
# even, 128 positions of one head where it is 1 or odd), ragged S, and a
# window that starts inside a 128-key tile
FA_TILE128_CASES = [
    # B, S, Hq, Hkv, D, window, blk (the JAX kernel's block)
    (1, 256, 2, 2, 64, None, 64),     # group 1
    (1, 300, 9, 3, 64, None, 64),     # group 3 (smollm's), ragged S
    (1, 256, 8, 1, 64, None, 64),     # group 8
    (1, 192, 48, 1, 128, None, 64),   # group 48 (granite's), D = 128
    (1, 200, 4, 1, 128, None, 64),    # ragged S, D = 128
    (1, 384, 4, 2, 64, 100, 64),      # window edge inside a 128-key tile
    (1, 330, 2, 1, 128, 150, 64),     # the same, D = 128, ragged S
]


def _fa_jax(q, k, v, win, blk):
    return np.asarray(jax_flash(jnp.asarray(q, jnp.bfloat16),
                                jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(v, jnp.bfloat16), causal=True,
                                window=win, blk_q=blk, blk_k=blk,
                                interpret=True), np.float32)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,blk", FA_TILE128_CASES)
def test_fa_bf16_rounding_fits_the_tolerance_tile128(B, S, Hq, Hkv, D, win,
                                                     blk):
    q, k, v = fa_operands(B, S, Hq, Hkv, D, seed=S * 5 + Hq)
    want = _fa_jax(q, k, v, win, blk)
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    got = fa_tc_emulation(tq, tk, tv, window=win, tile=128)
    assert got.dtype == BF16 and got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.to(F32).numpy(), want, rtol=0,
                               atol=FA_TOL)
    plain = attention_reference(tq, tk, tv, window=win)
    torch.testing.assert_close(got.to(F32), plain.to(F32), rtol=0,
                               atol=FA_TOL)


# head dims below the instance's panel, zero-padded as the TMA fills them:
# SMOKE smollm's 24 and granite's 16 (panel 64), phi-3-mini's 96 (panel
# 128), with the wgmma route's 128-key tiles
FA_PADDED_CASES = [
    # B, S, Hq, Hkv, D, window, d_pad
    (2, 64, 3, 1, 24, None, 64),
    (2, 64, 6, 1, 16, None, 64),
    (2, 64, 4, 2, 16, 16, 64),        # SMOKE mixtral's window
    (1, 200, 4, 2, 96, None, 128),
    (1, 300, 9, 3, 96, 100, 128),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,d_pad", FA_PADDED_CASES)
def test_fa_bf16_rounding_with_padded_head_dims(B, S, Hq, Hkv, D, win,
                                                d_pad):
    q, k, v = fa_operands(B, S, Hq, Hkv, D, seed=S + D)
    want = _fa_jax(q, k, v, win, 64)
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    got = fa_tc_emulation(tq, tk, tv, window=win, tile=128, d_pad=d_pad)
    assert got.dtype == BF16 and got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.to(F32).numpy(), want, rtol=0,
                               atol=FA_TOL)
    plain = attention_reference(tq, tk, tv, window=win)
    torch.testing.assert_close(got.to(F32), plain.to(F32), rtol=0,
                               atol=FA_TOL)


# causal=False: every 128-key tile, keys past Skv masked by index; against
# the reference's kernel where it pads no key (Skv at most 512), and at
# Skv = 600 against its oracle (R8)
FA_NONCAUSAL_CASES = [
    # B, S, Skv, Hq, Hkv, D, d_pad
    (1, 64, 100, 3, 1, 24, 64),
    (2, 128, 256, 4, 4, 64, 64),      # seamless's cross heads, narrower
    (1, 50, 300, 2, 2, 96, 128),
    (1, 16, 600, 2, 2, 16, 64),
]


@pytest.mark.parametrize("B,S,Skv,Hq,Hkv,D,d_pad", FA_NONCAUSAL_CASES)
def test_fa_bf16_rounding_without_the_causal_mask(B, S, Skv, Hq, Hkv, D,
                                                  d_pad):
    from repro.kernels.flash_attention.ref import attention_reference as jref
    rng = np.random.default_rng(S + Skv)
    q, k, v = (rng.normal(0, 1, (B, n, h, D)).astype(np.float32)
               for n, h in ((S, Hq), (Skv, Hkv), (Skv, Hkv)))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    if Skv <= 512:
        want = jax_flash(jq, jk, jv, causal=False, interpret=True)
    else:
        want = jref(jq, jk, jv, causal=False)
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    got = fa_tc_emulation(tq, tk, tv, tile=128, causal=False, d_pad=d_pad)
    assert got.dtype == BF16 and got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.to(F32).numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=FA_TOL)
    plain = attention_reference(tq, tk, tv, causal=False)
    torch.testing.assert_close(got.to(F32), plain.to(F32), rtol=0,
                               atol=FA_TOL)


# the 256-column instance: head dims 136 to 256 through 64-key tiles (a
# block's two consumers take two heads of one kv head at GQA 2:1, 128
# positions of one head at 1:1), the columns past D zeros; gemma-2's GQA
# with a window edge inside a 64-key tile, causal and not
FA_D256_CASES = [
    # B, S, Skv, Hq, Hkv, D, window, causal, q_block
    (1, 192, 192, 4, 2, 256, None, True, 64),
    (1, 200, 200, 2, 2, 256, None, True, 128),     # ragged S, group 1
    (1, 320, 320, 4, 2, 256, 100, True, 64),       # window edge in a tile
    (1, 160, 160, 4, 2, 136, None, True, 64),      # D = 136: 120 zeros
    (1, 64, 150, 4, 2, 256, None, False, 64),      # every tile, Skv ragged
]


@pytest.mark.parametrize("B,S,Skv,Hq,Hkv,D,win,causal,q_block",
                         FA_D256_CASES)
def test_fa_bf16_rounding_at_the_256_column_instance(B, S, Skv, Hq, Hkv, D,
                                                     win, causal, q_block):
    rng = np.random.default_rng(S + Skv + D)
    q, k, v = (rng.normal(0, 1, (B, n, h, D)).astype(np.float32)
               for n, h in ((S, Hq), (Skv, Hkv), (Skv, Hkv)))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    blk = 32 if causal else 64
    want = np.asarray(jax_flash(jq, jk, jv, causal=causal, window=win,
                                blk_q=blk if S % blk == 0 else S,
                                blk_k=blk if Skv % blk == 0 else Skv,
                                interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    got = fa_tc_emulation(tq, tk, tv, window=win, tile=64, causal=causal,
                          q_block=q_block if causal else None, d_pad=256)
    assert got.dtype == BF16 and got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.to(F32).numpy(), want, rtol=0,
                               atol=FA_TOL)
    plain = attention_reference(tq, tk, tv, causal=causal, window=win)
    torch.testing.assert_close(got.to(F32), plain.to(F32), rtol=0,
                               atol=FA_TOL)


@pytest.mark.parametrize("q_block", [64, 128], ids=["pair", "rows"])
@pytest.mark.parametrize("S,win", [(512, 100), (700, 200), (384, None)])
def test_fa_walk_from_kt_begin_changes_nothing(S, win, q_block):
    """Each block of q rows (64 positions of two heads, or 128 of one)
    walks 128-key tiles from its ``kt_begin`` to its diagonal: the same
    bits as walking every tile, and within the tolerance of the JAX
    kernel."""
    q, k, v = fa_operands(1, S, 4, 2, 64, seed=S + q_block)
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    walked = fa_tc_emulation(tq, tk, tv, window=win, tile=128,
                             q_block=q_block)
    every = fa_tc_emulation(tq, tk, tv, window=win, tile=128)
    assert torch.equal(walked, every)
    np.testing.assert_allclose(walked.to(F32).numpy(),
                               _fa_jax(q, k, v, win, 64), rtol=0, atol=FA_TOL)


def test_fa_emulation_rounds_p_and_sums_l_from_it():
    """The emulation is not the float32 function: rounding P moves the
    output by more than float32 noise, and within the tolerance."""
    q, k, v = (torch.from_numpy(a).to(BF16)
               for a in fa_operands(1, 128, 2, 1, 64, seed=5))
    got = fa_tc_emulation(q, k, v).to(F32)
    plain = attention_reference(q, k, v).to(F32)
    diff = float((got - plain).abs().max())
    assert 0.0 < diff <= FA_TOL


SSD_CASES = [
    # b, s, h, p, g, n (chunk 128, the kernel's)
    (1, 256, 2, 64, 1, 128),     # mamba2's widths
    (2, 384, 2, 64, 1, 64),      # zamba2's state
    (1, 256, 4, 64, 2, 128),     # grouped B/C
    (1, 256, 2, 64, 1, 256),     # the largest state the kernel takes
    (1, 256, 3, 64, 1, 128),     # an odd number of heads per group
]
SSD_RAGGED_CASES = [
    (1, 300, 2, 64, 1, 128),     # S not a multiple of the chunk
    (2, 50, 2, 64, 1, 32),       # S below one chunk
    (1, 40, 3, 64, 1, 64),       # one chunk shorter than a warpgroup's rows
]


def ssd_operands(b, s, h, p, g, n, seed):
    """The reference test's distributions: x, B, C standard normal, dt in
    [0.001, 0.1], A in [-2, -0.5]."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, h, p)).astype(np.float32),
            rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2, (h,)).astype(np.float32),
            rng.normal(0, 1, (b, s, g, n)).astype(np.float32),
            rng.normal(0, 1, (b, s, g, n)).astype(np.float32))


def _ssd_both(arrays):
    x, dt, A, B, C = arrays
    j = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(B, jnp.bfloat16), jnp.asarray(C, jnp.bfloat16))
    t = (torch.from_numpy(x).to(BF16), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(B).to(BF16),
         torch.from_numpy(C).to(BF16))
    return j, t


def _ssd_close(got, want):
    np.testing.assert_allclose(got.to(F32).numpy(),
                               np.asarray(want, np.float32), rtol=SSD_TOL,
                               atol=SSD_TOL)


def _ssd_close_to_plain(t, y, state, chunk=128):
    want_y, want_state = ssd_reference(*t, chunk=chunk)
    torch.testing.assert_close(y.to(F32), want_y.to(F32), rtol=SSD_TOL,
                               atol=SSD_TOL)
    torch.testing.assert_close(state, want_state, rtol=SSD_TOL,
                               atol=SSD_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n", SSD_CASES)
def test_ssd_bf16_rounding_fits_the_tolerance(b, s, h, p, g, n):
    j, t = _ssd_both(ssd_operands(b, s, h, p, g, n, seed=s + n + h))
    want_y, _ = jax_ssd_scan(*j, chunk=128, interpret=True)
    _, want_state = jax_ssd_chunked(*j, chunk=128)
    y, state = ssd_tc_emulation(*t, chunk=128)
    assert y.dtype == BF16 and y.shape == (b, s, h, p)
    assert state.dtype == F32 and state.shape == (b, h, p, n)
    _ssd_close(y, want_y)
    _ssd_close(state, want_state)
    _ssd_close_to_plain(t, y, state)


@pytest.mark.parametrize("b,s,h,p,g,n", SSD_RAGGED_CASES)
def test_ssd_bf16_rounding_fits_the_tolerance_ragged(b, s, h, p, g, n):
    j, t = _ssd_both(ssd_operands(b, s, h, p, g, n, seed=s + n))
    want_y, want_state = jax_ssd_chunked(*j, chunk=128)
    y, state = ssd_tc_emulation(*t, chunk=128)
    assert y.shape == (b, s, h, p)
    _ssd_close(y, want_y)
    _ssd_close(state, want_state)
    _ssd_close_to_plain(t, y, state)


def test_ssd_emulation_rounds_its_operands():
    """The emulation is not the float32 function: its roundings move y and
    the state by more than float32 noise, and within the tolerance."""
    _, t = _ssd_both(ssd_operands(1, 256, 2, 64, 1, 64, seed=9))
    y, state = ssd_tc_emulation(*t, chunk=128)
    want_y, want_state = ssd_reference(*t, chunk=128)
    d_state = float((state - want_state).abs().max())
    assert 1e-5 < d_state <= SSD_TOL
    assert float((y.to(F32) - want_y.to(F32)).abs().max()) <= SSD_TOL * (
        1 + float(want_y.to(F32).abs().max()))


# chunks below 128: SMOKE mamba2's widths (p = n = 16) at its chunk 16,
# and mamba2's widths at chunk 64; the kernel computes each chunk in the
# 128 rows of its tiles, zeros past the chunk, which the emulation's sums
# leave exact
SSD_CHUNK_CASES = [
    # b, s, h, p, g, n, chunk
    (2, 64, 8, 16, 1, 16, 16),
    (1, 256, 2, 64, 1, 128, 64),
    (1, 192, 3, 64, 1, 64, 64),       # 3 heads a group
]


# chunks of two row tiles: Mamba2's default chunk of 256 at mamba2's and
# Codestral's widths (8 groups there, cut to 2 here), 144 and 240 (row
# tiles of 72 and 120 rows, the 16-row tiles starting at each), and head
# dims of two 64-column blocks (the blocks are independent: the emulation
# is the same function column by column)
SSD_WIDE_CASES = [
    # b, s, h, p, g, n, chunk
    (1, 512, 2, 64, 1, 128, 256),
    (1, 512, 4, 64, 2, 128, 256),
    (1, 288, 2, 64, 1, 64, 144),
    (1, 480, 2, 32, 1, 32, 240),
    (1, 256, 2, 128, 1, 64, 128),
    (1, 512, 2, 128, 1, 128, 256),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_WIDE_CASES)
def test_ssd_bf16_rounding_at_two_row_tiles(b, s, h, p, g, n, chunk):
    j, t = _ssd_both(ssd_operands(b, s, h, p, g, n, seed=s + chunk + p))
    want_y, _ = jax_ssd_scan(*j, chunk=chunk, interpret=True)
    _, want_state = jax_ssd_chunked(*j, chunk=chunk)
    y, state = ssd_tc_emulation(*t, chunk=chunk)
    assert y.dtype == BF16 and y.shape == (b, s, h, p)
    assert state.shape == (b, h, p, n)
    _ssd_close(y, want_y)
    _ssd_close(state, want_state)
    _ssd_close_to_plain(t, y, state, chunk=chunk)


def test_ssd_chunk_256_is_not_two_chunks_of_128():
    """The emulation at chunk 256 computes one chunk: its C B^T .* L
    reaches across the two row tiles, where two chunks of 128 pass the
    first half through h's bf16 copy and the state. The two differ (more
    than float32 noise), and the one at 256 is the closer to the
    reference's chunk of 256."""
    j, t = _ssd_both(ssd_operands(1, 512, 2, 64, 1, 128, seed=11))
    want_y, _ = jax_ssd_scan(*j, chunk=256, interpret=True)
    want = torch.from_numpy(np.asarray(want_y, np.float32))
    one, _ = ssd_tc_emulation(*t, chunk=256)
    two, _ = ssd_tc_emulation(*t, chunk=128)
    assert float((one.to(F32) - two.to(F32)).abs().max()) > 1e-2
    assert float((one.to(F32) - want).abs().mean()) < float(
        (two.to(F32) - want).abs().mean())


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CHUNK_CASES)
def test_ssd_bf16_rounding_at_smaller_chunks(b, s, h, p, g, n, chunk):
    j, t = _ssd_both(ssd_operands(b, s, h, p, g, n, seed=s + chunk))
    want_y, _ = jax_ssd_scan(*j, chunk=chunk, interpret=True)
    _, want_state = jax_ssd_chunked(*j, chunk=chunk)
    y, state = ssd_tc_emulation(*t, chunk=chunk)
    assert y.dtype == BF16 and y.shape == (b, s, h, p)
    assert state.shape == (b, h, p, n)
    _ssd_close(y, want_y)
    _ssd_close(state, want_state)
    _ssd_close_to_plain(t, y, state, chunk=chunk)
