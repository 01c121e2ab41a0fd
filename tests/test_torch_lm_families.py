"""The port's decoder families against the JAX package's
``repro.models.decoder``: the SMOKE mixtral-8x22b (MoE, top-2 of 4 experts,
a sliding window of 16), deepseek-7b (MHA), granite-34b (MQA, the GELU
MLP) and chatglm3-6b (GQA 2:1, partial rope, qkv biases), each with the
full model's structure, ``attn_backend="pallas"``, the JAX parameters
carried across by ``convert.lm_params_from_jax`` and the same NumPy-drawn
prompts. Mixtral's prompts are longer than its window and its decode goes
further past it, so its ring-buffer cache wraps.

In float32 the prefill and decode logits agree within 1e-4 (3e-6 on these
prompts) and the greedy tokens are identical. The logit comparison keeps
the KV caches in float32 in both packages: with the default bf16 cache, a
float32 key one last-place apart in the two frameworks rounds to bf16
apart now and then, which moved a decode logit by 2.4e-4 (granite). The
greedy tokens are compared with the default bf16 caches too."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(1)

import repro.nn.attention as j_attn
from repro.configs import get_smoke_config as j_smoke
from repro.models import get_model as j_get_model
from repro.nn import layers as jl
from repro.nn import rotary as jrot

import repro_torch.nn.attention as t_attn
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import get_model
from repro_torch.nn import layers as tl
from repro_torch.nn import rotary as trot

ARCHS = ["mixtral-8x22b", "deepseek-7b", "granite-34b", "chatglm3-6b"]
B, S, GEN = 2, 24, 12     # mixtral: window 16 < S < S + GEN


@pytest.fixture
def float32_kv_caches(monkeypatch):
    """Both packages' KV caches in float32 (see the module docstring)."""
    monkeypatch.setattr(j_attn, "init_kv_cache", functools.partial(
        j_attn.init_kv_cache, dtype=jnp.float32))
    monkeypatch.setattr(t_attn, "init_kv_cache", functools.partial(
        t_attn.init_kv_cache, dtype=torch.float32))


def _setup(arch, dtype="float32", **changes):
    jm = j_get_model(j_smoke(arch).replace(attn_backend="pallas", **changes))
    jparams = jm.init(jax.random.PRNGKey(0))
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    cfg = get_smoke_config(arch).replace(attn_backend="pallas", **changes)
    params = convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    return jm, jparams, get_model(cfg), params, tokens


def _generate(jm, jparams, m, params, tokens):
    """Prefill, then GEN greedy decode steps in each package. Returns the
    logits of the prefill and of every step, and the tokens of both."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_prefill_and_decode_logits_match(arch, float32_kv_caches):
    jm, jparams, m, params, tokens = _setup(arch)
    before = fa_ops.flash_attention.launches
    logits, jtoks, ttoks, cache = _generate(jm, jparams, m, params, tokens)
    assert fa_ops.flash_attention.launches == before   # CPU: no launches
    for jlog, tlog in logits:
        assert tlog.shape == (B, m.cfg.vocab_padded)
        np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ttoks, jtoks)
    if m.cfg.window:   # the ring holds the last `window` positions
        pos = cache["layers"][0]["pos"]
        assert pos.shape[1] == m.cfg.window < S
        assert sorted(pos[0].tolist()) == list(
            range(S + GEN - m.cfg.window, S + GEN))


def test_moe_with_leading_dense_layers(float32_kv_caches):
    """An MoE stack after dense-FFN layers (deepseek-v2's layout; no ported
    config has one): the reference's ``dense_layers`` then ``layers``
    stacks, converted both ways and run within 1e-4."""
    jm, jparams, m, params, tokens = _setup("mixtral-8x22b",
                                            n_dense_layers=1, d_ff_dense=96)
    assert len(params.dense_layers) == 1 and len(params.layers) == 3
    assert not hasattr(params.dense_layers[0].ffn, "router")
    logits, jtoks, ttoks, _ = _generate(jm, jparams, m, params, tokens)
    for jlog, tlog in logits:
        np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ttoks, jtoks)
    back = convert.lm_params_to_jax(params)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_greedy_tokens_match_with_bf16_caches(arch):
    jm, jparams, m, params, tokens = _setup(arch)
    _, jtoks, ttoks, _ = _generate(jm, jparams, m, params, tokens)
    np.testing.assert_array_equal(ttoks, jtoks)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip_is_exact(arch):
    _, jparams, _, params, _ = _setup(arch, "bfloat16")
    back = convert.lm_params_to_jax(params)
    ref = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert b.shape == a.shape
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_structure(arch):
    """The port's own init gives the reference's tree (names and shapes;
    the MoE router in float32, everything else in bf16)."""
    params = get_model(get_smoke_config(arch)).init(0, device="cpu")
    ref = jax.tree.map(np.asarray,
                       j_get_model(j_smoke(arch)).init(jax.random.PRNGKey(0)))
    mine = convert.lm_params_to_jax(params)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(mine)):
        assert a.shape == b.shape
    for name, p in params.named_parameters():
        want = torch.float32 if "router" in name else torch.bfloat16
        assert p.dtype == want, name


@pytest.mark.parametrize("fraction", [0.5, 0.25])
def test_partial_rope(fraction):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 7, 4, 24)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, 24)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10, dtype=np.int32), (2, 7))
    jq, jk = jrot.apply_partial_rope(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(pos), fraction=fraction)
    tq, tk = trot.apply_partial_rope(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(pos.copy()),
                                     fraction=fraction)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    rot = int(24 * fraction)
    np.testing.assert_array_equal(tq.numpy()[..., rot:], q[..., rot:])


@pytest.mark.parametrize("use_bias", [True, False])
def test_gelu_mlp(use_bias):
    jp = jl.gelu_mlp_init(jax.random.PRNGKey(0), 16, 40, use_bias=use_bias,
                          dtype=jnp.float32)
    if use_bias:   # the reference draws zero biases; make them count
        rng = np.random.default_rng(1)
        for name in ("up", "down"):
            jp[name]["b"] = jnp.asarray(rng.normal(
                size=jp[name]["b"].shape).astype(np.float32))
    mlp = tl.GeluMLP(16, 40, use_bias=use_bias)
    mlp.load_state_dict({n: torch.from_numpy(np.array(v)) for n, v in
                         convert.flatten_tree(
                             jax.tree.map(np.asarray, jp)).items()},
                        strict=True)
    x = np.random.default_rng(2).normal(size=(3, 5, 16)).astype(np.float32)
    want = jl.gelu_mlp(jp, jnp.asarray(x))
    with torch.inference_mode():
        got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_rope_none_prefill_decode_and_loss_match(float32_kv_caches):
    """``rope="none"`` raised until the sharding slice; the rope closures
    now return None, as the reference's ``_rope_fn`` and
    ``_rope_fn_decode`` do, and the SMOKE deepseek-7b without rope matches
    the reference: prefill and decode logits within 1e-4, the greedy
    tokens equal, and the loss (under 'full': K4 is forward-only) within
    1e-5 relative."""
    from repro_torch.models import decoder
    jm, jparams, m, params, tokens = _setup("deepseek-7b", rope="none")
    assert decoder._rope_fn(m.cfg, torch.zeros(B, S)) is None
    assert decoder._rope_fn_decode(m.cfg) is None
    logits, jtoks, ttoks, _ = _generate(jm, jparams, m, params, tokens)
    for jlog, tlog in logits:
        np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ttoks, jtoks)
    row = np.random.default_rng(6).integers(0, m.cfg.vocab, (B, S + 1),
                                            dtype=np.int32)
    batch = {"tokens": row[:, :-1].copy(), "labels": row[:, 1:].copy()}
    with torch.no_grad():
        loss, _ = get_model(m.cfg.replace(attn_backend="full")).loss_fn(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
    j_loss, _ = jax.jit(j_get_model(j_smoke("deepseek-7b").replace(
        rope="none")).loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
