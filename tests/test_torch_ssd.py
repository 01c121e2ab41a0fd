"""The port's Mamba2 layers (``nn/ssd.py``) against the JAX package on the
same NumPy-seeded inputs and parameters carried across by name.

Tolerances: float32 within 1e-4, atol and rtol, as the reference's own
SSD test (``tests/test_kernels.py``): the same float32 math, reductions in
another order. The causal conv in bf16 is exact: both sum the W taps as
bf16 products in the same order, rounding after each add, and gate with
the same silu. The Mamba2 block in bf16 within 5e-2 (atol and rtol, the
reference's bf16 SSD tolerance): its products and the scan round their
float32 results to bf16 once, where a last-ulp difference of the float32
sums flips a bf16 rounding now and then."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs import get_smoke_config as j_smoke
from repro.models import ssm as j_ssm_model
from repro.nn import ssd as jssd

from repro_torch.configs import get_smoke_config
from repro_torch.convert import flatten_tree
from repro_torch.models import ssm as t_ssm_model
from repro_torch.nn import ssd as tssd

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCH = "mamba2-1.3b"


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(getattr(torch, dtype)) if dtype else t


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_segsum_matches():
    x = np.random.default_rng(0).uniform(-1, 0, (2, 3, 9)).astype(np.float32)
    want = np.asarray(jssd.segsum(jnp.asarray(x)))
    got = tssd.segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.all(got[np.isinf(got)] < 0)
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_bf16_is_exact(with_state):
    """bf16 taps summed in the reference's order and dtype, with and
    without a carried state (S = 2 < W - 1 keeps zero pad rows in the new
    state when there is none)."""
    rng = np.random.default_rng(1)
    W, ch, S = 4, 24, 2
    x = rng.normal(0, 1, (2, S, ch))
    w = rng.normal(0, 0.5, (W, ch))
    b = rng.normal(0, 0.1, (ch,))
    st = rng.normal(0, 1, (2, W - 1, ch)) if with_state else None
    bf = jnp.bfloat16
    want, want_st = jssd._causal_conv(
        jnp.asarray(x, bf), jnp.asarray(w, bf), jnp.asarray(b, bf),
        state=None if st is None else jnp.asarray(st, bf))
    got, got_st = tssd._causal_conv(
        _t(x, "bfloat16"), _t(w, "bfloat16"), _t(b, "bfloat16"),
        state=None if st is None else _t(st, "bfloat16"))
    assert got.dtype == torch.bfloat16 and got_st.shape == (2, W - 1, ch)
    _close(got, want, 0)
    _close(got_st, want_st, 0)


def test_ssd_decode_step_matches():
    rng = np.random.default_rng(2)
    b, h, p, g, n = 2, 4, 8, 2, 16
    args = (rng.normal(0, 1, (b, h, p, n)), rng.normal(0, 1, (b, h, p)),
            rng.uniform(0.001, 0.1, (b, h)), -rng.uniform(0.5, 2, (h,)),
            rng.normal(0, 1, (b, g, n)), rng.normal(0, 1, (b, g, n)))
    want_y, want_s = jssd.ssd_decode_step(*(jnp.asarray(a, jnp.float32)
                                            for a in args))
    got_y, got_s = tssd.ssd_decode_step(*(_t(a) for a in args))
    _close(got_y, want_y, TOL["float32"])
    _close(got_s, want_s, TOL["float32"])


def test_ssd_bf16_variant_is_not_ported():
    """``ssd_chunked(bf16=True)`` and a config with ``ssd_bf16`` raised
    NotImplementedError until the variant was ported. Now the variant
    runs, on the reference's own inputs (``tests/test_kernels.py``:
    bf16 x, B and C, chunk 16): y equals the reference's bf16 variant
    within its bf16 tolerance (5e-2) and stays within 2% of the float32
    scan's largest |y|, as the reference's test asks; the state is
    float32 in both (within 1e-4). A float32 model with ``ssd_bf16``
    builds, and its loss runs the variant (it differs from the float32
    scan's loss)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 64, 4, 16))
    dt = rng.uniform(0.001, 0.1, (2, 64, 4))
    A = -rng.uniform(0.5, 2, (4,))
    B = rng.normal(0, 1, (2, 64, 1, 32))
    C = rng.normal(0, 1, (2, 64, 1, 32))
    j_args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt, jnp.float32),
              jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.bfloat16),
              jnp.asarray(C, jnp.bfloat16))
    t_args = tuple(_t(a, "bfloat16" if a.dtype == jnp.bfloat16 else None)
                   for a in j_args)
    want_y, want_s = jssd.ssd_chunked(*j_args, chunk=16, bf16=True)
    y16, s16 = tssd.ssd_chunked(*t_args, chunk=16, bf16=True)
    assert y16.dtype == torch.bfloat16 and s16.dtype == torch.float32
    _close(y16, want_y, TOL["bfloat16"])
    _close(s16, want_s, TOL["float32"])
    y32, _ = tssd.ssd_chunked(*t_args, chunk=16)
    rel = float((y32.float() - y16.float()).abs().max()
                / y32.float().abs().max())
    assert rel < 0.02, rel
    cfg = get_smoke_config(ARCH)
    params = t_ssm_model.init(cfg.replace(ssd_bf16=True), device="cpu")
    params = params.float()
    row = rng.integers(0, cfg.vocab, (2, 17), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(row[:, :-1].copy()),
             "labels": torch.from_numpy(row[:, 1:].copy())}
    with torch.no_grad():
        l16 = t_ssm_model.loss_fn(cfg.replace(ssd_bf16=True), params, batch)
        l32 = t_ssm_model.loss_fn(cfg, params, batch)
    assert torch.isfinite(l16[0]) and float(l16[0]) != float(l32[0])


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(2, 64, 4, 16, 1, 32, 16),
                                                (1, 50, 4, 8, 2, 16, 16),
                                                (1, 40, 2, 8, 1, 8, 64)])
def test_ssd_bf16_variant_matches_the_reference(b, s, h, p, g, n, chunk):
    """The bf16 variant against the reference's, also with a ragged
    length (the dt = 0 padding), two B/C groups and one padded chunk: y
    within the bf16 tolerance, the float32 state within 1e-4."""
    rng = np.random.default_rng(s + n)
    j_args = (jnp.asarray(rng.normal(0, 1, (b, s, h, p)), jnp.bfloat16),
              jnp.asarray(rng.uniform(0.001, 0.1, (b, s, h)), jnp.float32),
              jnp.asarray(-rng.uniform(0.5, 2, (h,)), jnp.float32),
              jnp.asarray(rng.normal(0, 1, (b, s, g, n)), jnp.bfloat16),
              jnp.asarray(rng.normal(0, 1, (b, s, g, n)), jnp.bfloat16))
    t_args = tuple(_t(a, "bfloat16" if a.dtype == jnp.bfloat16 else None)
                   for a in j_args)
    want_y, want_s = jssd.ssd_chunked(*j_args, chunk=chunk, bf16=True)
    got_y, got_s = tssd.ssd_chunked(*t_args, chunk=chunk, bf16=True)
    assert got_y.shape == (b, s, h, p) and got_s.shape == (b, h, p, n)
    _close(got_y, want_y, TOL["bfloat16"])
    _close(got_s, want_s, TOL["float32"])


def _block(dtype, seed=0):
    """The SMOKE config's Mamba2 block: the reference's init, and the same
    parameters in the port's module. float32 casts every leaf; bf16 keeps
    the reference's dtypes (A_log, D, dt_bias float32)."""
    cfg = get_smoke_config(ARCH)
    jp = jssd.mamba2_init(jax.random.PRNGKey(seed), cfg.d_model,
                          d_inner=cfg.d_inner, headdim=cfg.ssm_headdim,
                          d_state=cfg.ssm_state, n_groups=cfg.ssm_ngroups)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    with torch.device("meta"):
        mod = tssd.Mamba2(cfg.d_model, d_inner=cfg.d_inner,
                          headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                          n_groups=cfg.ssm_ngroups)
    state = {}
    for name, leaf in flatten_tree(jax.tree.map(np.asarray, jp)).items():
        t = _t(leaf)
        state[name] = (t.to(torch.bfloat16)
                       if np.asarray(leaf).dtype.name == "bfloat16" else t)
    mod.load_state_dict(state, strict=True, assign=True)
    return cfg, jp, mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_prefill_with_state_and_decode(dtype):
    """The block's forward, the prefill that also returns the conv and SSM
    states, and 3 decode steps from those states, past the chunk."""
    cfg, jp, mod = _block(dtype)
    jcfg = j_smoke(ARCH)
    b, s = 2, 21                       # 2 chunks of 16, the last ragged
    rng = np.random.default_rng(3)
    u = rng.normal(0, 1, (b, s + 3, cfg.d_model))
    ju = jnp.asarray(u, getattr(jnp, dtype))
    tu = _t(u, dtype)
    kw = dict(headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
              n_groups=cfg.ssm_ngroups)
    tol = TOL[dtype]
    with torch.no_grad():
        want = jssd.mamba2_apply(jp, ju[:, :s], chunk=cfg.ssm_chunk, **kw)
        got = tssd.mamba2_apply(mod, tu[:, :s], chunk=cfg.ssm_chunk, **kw)
        assert got.dtype == tu.dtype
        _close(got, want, tol)

        jout, jc = j_ssm_model._mamba2_apply_with_state(jcfg, jp, ju[:, :s],
                                                        None)
        tout, tc = t_ssm_model._mamba2_apply_with_state(cfg, mod, tu[:, :s])
        _close(tout, jout, tol)
        _close(tc["conv"], jc["conv"], tol)
        assert tc["ssm"].dtype == torch.float32
        _close(tc["ssm"], jc["ssm"], tol)
        for i in range(s, s + 3):
            jy, jc = jssd.mamba2_decode(jp, ju[:, i:i + 1], jc, **kw)
            ty, tc = tssd.mamba2_decode(mod, tu[:, i:i + 1], tc, **kw)
            _close(ty, jy, tol)
            _close(tc["ssm"], jc["ssm"], tol)


def test_mamba2_init_has_the_reference_constants():
    cfg = get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    mod = tssd.Mamba2(cfg.d_model, d_inner=cfg.d_inner,
                      headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                      generator=gen)
    ref = jssd.mamba2_init(jax.random.PRNGKey(0), cfg.d_model,
                           d_inner=cfg.d_inner, headdim=cfg.ssm_headdim,
                           d_state=cfg.ssm_state)
    for name in ("A_log", "D", "dt_bias"):
        assert getattr(mod, name).dtype == torch.float32
        _close(getattr(mod, name), ref[name], 1e-6)
    assert mod.conv_w.dtype == torch.bfloat16
    w = mod.conv_w.detach().float()
    assert float(w.abs().max()) <= 2 / math.sqrt(4) + 1e-2
    assert not bool(mod.conv_b.detach().any())
