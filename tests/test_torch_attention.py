"""The port's attention (``nn/attention.py``) against the JAX package:
``attention_prefill`` and then ``attention_decode`` step by step, with the
same parameters and NumPy-seeded inputs, for the three backends and the
causal and sliding-window masks, comparing the outputs and every cache
field after every call. The decodes run past the cache's last slot: the
full cache then keeps overwriting its last slot (the reference's
``min(pos, slots - 1)``), the window cache wraps around its ring.

Everything is float32, the caches too, so the two agree to float32
accuracy: 1e-5 on outputs and cached keys and values of order 1; positions
and lengths exactly."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(1)

from repro.nn import attention as ja
from repro.nn.rotary import apply_rope as j_rope

from repro_torch.nn import attention as ta
from repro_torch.nn.rotary import apply_rope as t_rope

B, D_MODEL, HQ, HKV, HD = 2, 48, 4, 2, 12
S, MAX_LEN, N_DECODE = 12, 16, 8
TOL = 1e-5


def _params():
    jp = ja.attention_init(jax.random.PRNGKey(0), D_MODEL, HQ, HKV, HD,
                           dtype=jnp.float32)
    tp = ta.Attention(D_MODEL, HQ, HKV, HD, dtype=torch.float32)
    tp.load_state_dict({f"{n}.w": torch.from_numpy(np.array(jp[n]["w"]))
                        for n in ("wq", "wk", "wv", "wo")})
    return jp, tp


def _check_cache(tc, jc):
    for f in ("k", "v"):
        np.testing.assert_allclose(tc[f].numpy(), np.asarray(jc[f]),
                                   rtol=0, atol=TOL)
    for f in ("pos", "len"):
        np.testing.assert_array_equal(tc[f].numpy(), np.asarray(jc[f]))


@pytest.mark.parametrize("backend", ["full", "chunked", "pallas"])
@pytest.mark.parametrize("window", [None, 5])
def test_prefill_then_decode_past_the_last_slot(backend, window):
    jp, tp = _params()
    rng = np.random.default_rng(0 if window is None else 1)
    x = rng.normal(0, 1, (B, S, D_MODEL)).astype(np.float32)
    steps = rng.normal(0, 1, (N_DECODE, B, 1, D_MODEL)).astype(np.float32)
    kw = dict(n_heads=HQ, n_kv_heads=HKV, head_dim=HD,
              mode="sliding" if window else "causal", window=window,
              backend=backend, chunk=5)
    mask_pos = np.arange(S, dtype=np.int32)
    positions = np.tile(mask_pos, (B, 1))

    jc = ja.init_kv_cache(B, MAX_LEN, HKV, HD, window=window,
                          dtype=jnp.float32)
    jo, jc = ja.attention_prefill(
        jp, jnp.asarray(x), jnp.asarray(mask_pos), jc,
        rope_fn=lambda q, k: j_rope(q, k, jnp.asarray(positions)), **kw)
    tc = ta.init_kv_cache(B, MAX_LEN, HKV, HD, window=window,
                          dtype=torch.float32)
    with torch.no_grad():
        to, tc2 = ta.attention_prefill(
            tp, torch.from_numpy(x), torch.from_numpy(mask_pos), tc,
            rope_fn=lambda q, k: t_rope(q, k, torch.from_numpy(positions)),
            **kw)
    assert tc2 is tc   # written in place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=TOL)
    _check_cache(tc, jc)

    slots = tc["k"].shape[1]
    assert S + N_DECODE > slots    # the decodes pass the last slot
    for xs in steps:
        jo, jc = ja.attention_decode(jp, jnp.asarray(xs), jc, n_heads=HQ,
                                     n_kv_heads=HKV, head_dim=HD,
                                     rope_fn=j_rope, window=window)
        with torch.no_grad():
            to, tc = ta.attention_decode(tp, torch.from_numpy(xs), tc,
                                         n_heads=HQ, n_kv_heads=HKV,
                                         head_dim=HD, rope_fn=t_rope,
                                         window=window)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=TOL)
        _check_cache(tc, jc)


def test_unported_backend_raises():
    """'chunked_tri' raised NotImplementedError until it was ported. Now
    ``_sdpa`` dispatches it as the reference does: causal and sliding
    self-attention without ``k_len`` to ``sdpa_chunked_tri``, 'full'-mode
    and decode (``k_len``) to ``sdpa_chunked``, each equal to the function
    it names. The function itself refuses what it cannot compute (another
    mode, Sq != Skv) with ValueError."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 12, 2, 8)).astype(
        np.float32)) for _ in range(3))
    pos = torch.arange(12)
    kw = dict(window=None, chunk=4)
    for mode, fn in (("causal", ta.sdpa_chunked_tri),
                     ("full", ta.sdpa_chunked)):
        torch.testing.assert_close(
            ta._sdpa(q, k, v, pos, pos, backend="chunked_tri", mode=mode,
                     **kw),
            fn(q, k, v, pos, pos, mode=mode, **kw), rtol=0, atol=0)
    k_len = torch.tensor([7])
    torch.testing.assert_close(
        ta._sdpa(q, k, v, pos, pos, backend="chunked_tri", mode="causal",
                 k_len=k_len, **kw),
        ta.sdpa_chunked(q, k, v, pos, pos, mode="causal", k_len=k_len, **kw),
        rtol=0, atol=0)
    with pytest.raises(ValueError):
        ta.sdpa_chunked_tri(q, k, v, pos, pos, mode="full", chunk=4)
    with pytest.raises(ValueError):
        ta.sdpa_chunked_tri(q, k[:, :8], v[:, :8], pos, pos[:8], chunk=4)


# the reference's cases (tests/test_kernels.py): B, S, Hq, Hkv, D, mode,
# window, chunk; the last two add a window with kv padding and MLA's
# head dims (q and k 24, v 16)
TRI_CASES = [
    (2, 128, 4, 2, 32, "causal", None, 32, 32),
    (1, 96, 3, 1, 16, "causal", None, 32, 16),
    (2, 128, 4, 4, 32, "sliding", 40, 32, 32),
    (1, 130, 2, 2, 16, "causal", None, 64, 16),
    (1, 130, 2, 2, 16, "sliding", 40, 32, 16),
    (2, 64, 4, 4, 24, "causal", None, 16, 16),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,mode,win,C,Dv", TRI_CASES)
def test_triangular_chunked_attention_matches_the_reference(B, S, Hq, Hkv,
                                                            D, mode, win, C,
                                                            Dv):
    """``sdpa_chunked_tri`` against the reference's on the same inputs:
    with float32 probabilities within 3e-5 of it and of ``sdpa_full``
    (the reference's own test's limit); with the default bf16
    probabilities within 2e-2 of both. The two packages differ by more
    than float32 rounding there: XLA on the CPU sums the unmasked pairs'
    probabilities before their bf16 rounding, the port after it."""
    rng = np.random.default_rng(hash((B, S, C, Dv)) % 2 ** 31)
    q = rng.normal(0, 1, (B, S, Hq, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, Hkv, Dv)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    args_j = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    args_t = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
    full = np.asarray(ja.sdpa_full(*args_j, mode=mode, window=win))
    for j_dt, t_dt, tol in ((jnp.float32, torch.float32, 3e-5),
                            (jnp.bfloat16, torch.bfloat16, 2e-2)):
        want = np.asarray(ja.sdpa_chunked_tri(
            *args_j, mode=mode, window=win, chunk=C, probs_dtype=j_dt))
        got = ta.sdpa_chunked_tri(*args_t, mode=mode, window=win, chunk=C,
                                  probs_dtype=t_dt)
        assert got.shape == (B, S, Hq, Dv) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
        np.testing.assert_allclose(got.numpy(), full, atol=tol, rtol=tol)


def test_triangular_chunked_attention_takes_gradients():
    """The loss paths differentiate through it: its gradients equal
    ``sdpa_full``'s within 1e-4 with float32 probabilities, on MLA's
    head dims (v narrower than q and k)."""
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.normal(0, 1, (2, 40, 4, 24)).astype(
        np.float32)).requires_grad_() for _ in range(2))
    v = torch.from_numpy(rng.normal(0, 1, (2, 40, 4, 16)).astype(
        np.float32)).requires_grad_()
    w = torch.from_numpy(rng.normal(0, 1, (2, 40, 4, 16)).astype(np.float32))
    pos = torch.arange(40)
    grads = []
    for fn in (lambda: ta.sdpa_chunked_tri(q, k, v, pos, pos, chunk=16,
                                           probs_dtype=torch.float32),
               lambda: ta.sdpa_full(q, k, v, pos, pos)):
        grads.append(torch.autograd.grad((fn() * w).sum(), (q, k, v)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
