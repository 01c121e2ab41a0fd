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
    q = torch.zeros((1, 4, 2, 8))
    pos = torch.arange(4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ta._sdpa(q, q, q, pos, pos, backend="chunked_tri", mode="causal",
                 window=None)
