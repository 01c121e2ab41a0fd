"""The port's multi-head latent attention (``repro_torch.models.mla``) in
the SMOKE deepseek-v2-236b (4 MoE layers of 8 routed experts, top-2, one
shared expert, ``moe_normalize=False``) against the JAX package, with the
JAX parameters carried across by ``convert.lm_params_from_jax`` and the
same NumPy-drawn prompts.

In float32, with the latent caches in float32 in both packages (as
``test_torch_lm_families`` keeps the KV caches), the prefill logits and
those of every absorbed decode step agree within 1e-4 under 'full' and
under 'chunked' (chunks of 8 over 24 positions) on both sides, and the
greedy tokens are identical; with the default bf16 caches the float32
greedy tokens are identical too. 'pallas' raises in the port: the reference's
flash-attention kernel takes one head dim for q, k and v, and MLA's v is
narrower than its q and k."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(2)

import repro.models.mla as j_mla
from repro.configs import get_smoke_config as j_smoke
from repro.models import get_model as j_get_model

import repro_torch.models.mla as t_mla
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import served_config
from repro_torch.models import get_model

ARCH = "deepseek-v2-236b"
B, S, GEN = 2, 24, 6


@pytest.fixture
def float32_latent_caches(monkeypatch):
    monkeypatch.setattr(j_mla, "init_mla_cache", functools.partial(
        j_mla.init_mla_cache, dtype=jnp.float32))
    monkeypatch.setattr(t_mla, "init_mla_cache", functools.partial(
        t_mla.init_mla_cache, dtype=torch.float32))


def _setup(dtype, **changes):
    jm = j_get_model(j_smoke(ARCH).replace(**changes))
    jparams = jm.init(jax.random.PRNGKey(0))
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    cfg = get_smoke_config(ARCH).replace(**changes)
    params = convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    return jm, jparams, get_model(cfg), params, tokens


def _generate(jm, jparams, m, params, tokens):
    """Prefill, then GEN greedy decode steps in each package: the logits of
    the prefill and of every step, and the tokens of both."""
    jlog, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                          jm.init_cache(B, S + GEN))
    with torch.inference_mode():
        tlog, tc = m.prefill(params, {"tokens": torch.from_numpy(tokens)},
                             m.init_cache(B, S + GEN, device="cpu"))
    logits = [(np.asarray(jlog, np.float32), tlog.numpy())]
    jt = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tlog, -1).to(torch.int32)[:, None]
    jtoks, ttoks = [np.asarray(jt)], [tt.numpy()]
    for _ in range(GEN):
        jlog, jc = jm.decode_step(jparams, jc, jt)
        with torch.inference_mode():
            tlog, tc = m.decode_step(params, tc, tt)
        logits.append((np.asarray(jlog, np.float32), tlog.numpy()))
        jt = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tlog, -1).to(torch.int32)[:, None]
        jtoks.append(np.asarray(jt))
        ttoks.append(tt.numpy())
    return logits, np.concatenate(jtoks, 1), np.concatenate(ttoks, 1), tc


@pytest.mark.parametrize("backend", ["full", "chunked"])
def test_float32_prefill_and_absorbed_decode_match(backend,
                                                   float32_latent_caches):
    jm, jparams, m, params, tokens = _setup("float32", attn_backend=backend,
                                            attn_chunk=8)
    logits, jtoks, ttoks, cache = _generate(jm, jparams, m, params, tokens)
    for jlog, tlog in logits:
        assert tlog.shape == (B, m.cfg.vocab_padded)
        np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ttoks, jtoks)
    c = cache["layers"][0]
    assert c["ckv"].dtype == torch.float32
    assert c["ckv"].shape == (B, S + GEN, m.cfg.kv_lora)
    assert c["len"].tolist() == [S + GEN] * B


def test_float32_greedy_tokens_match_with_bf16_caches():
    jm, jparams, m, params, tokens = _setup("float32")
    logits, jtoks, ttoks, cache = _generate(jm, jparams, m, params, tokens)
    assert cache["layers"][0]["ckv"].dtype == torch.bfloat16
    assert all(np.all(np.isfinite(t)) for _, t in logits)
    np.testing.assert_array_equal(ttoks, jtoks)


def test_params_round_trip_bit_for_bit():
    _, jparams, _, params, _ = _setup("bfloat16")
    a = params.layers[0].attn
    assert tuple(a.wuk.shape) == (24, 4, 16) and a.wdq.b is None
    assert a.wuk.dtype == torch.bfloat16
    assert hasattr(params.layers[0].ffn, "shared")
    back = convert.lm_params_to_jax(params)
    assert (jax.tree.structure(back)
            == jax.tree.structure(jax.tree.map(np.asarray, jparams)))
    for x, y in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(y, np.asarray(x, np.float32))
    # the port's own init gives the same tree
    cfg = get_smoke_config(ARCH)
    mine = convert.lm_params_to_jax(get_model(cfg).init(0, device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(back)
    assert cfg.moe_normalize is False


def test_pallas_raises_and_the_command_line_keeps_chunked():
    cfg = get_smoke_config(ARCH).replace(attn_backend="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model(cfg).init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="one head dim"):
        get_model(cfg).init_cache(B, S, device="cpu")
    params = get_model(get_smoke_config(ARCH)).init(0, device="cpu")
    x = torch.zeros((B, S, cfg.d_model), dtype=torch.bfloat16)
    pos = torch.arange(S)[None].expand(B, S)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        t_mla.mla_apply(cfg, params.layers[0].attn, x, pos,
                        backend="pallas")
    assert served_config(get_config(ARCH)).attn_backend == "chunked"
