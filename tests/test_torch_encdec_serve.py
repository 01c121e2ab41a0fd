"""The port's encoder-decoder (seamless-m4t-large-v2's SMOKE config: 2
encoder and 2 decoder layers, d_model 64, 4 heads) against the JAX
package's ``repro.models.encdec``, both under ``attn_backend="pallas"``
(the decoder's causal self-attention through K4: the port's plain version
on the CPU, the reference's kernel in interpret mode; the encoder and the
cross-attention 'full'; the parameter id is ``k4``, since the repo's
conftest skips tests keyed ``pallas`` on the CPU) and under 'full', with
the JAX parameters carried across by ``convert.lm_params_from_jax`` and
the same NumPy-drawn tokens and frames.

The reference fixes two tensors at bf16 whatever the parameters' type:
the frames entering the encoder and the cached cross K/V. Its encoder
cannot run float32 parameters at all (its layer scan's bf16 carry would
turn float32), so the float32 comparison takes both packages' bf16 there
to float32 (``jnp.bfloat16`` as ``repro.models.encdec`` sees it, and the
port's ``encdec.ACT_DTYPE``), with float32 self-attention KV caches on
both sides (see ``test_torch_lm_families``). Then the encoder output, the
prefill logits and those of every decode step agree within 1e-4 (2.2e-6
on these inputs) and the greedy tokens are identical.

With the reference's own bf16 parameters and caches, both packages fed
the reference's greedy tokens, every step's logits agree within 5e-2, the
bf16 gap of ``test_torch_lm_serve`` (0.035 here). The read-out is bf16,
so logits tie exactly now and then (a tie at step 3 on these inputs): the
port's greedy token is the reference's wherever the reference's top two
logits lie more than that 5e-2 apart, and elsewhere a token within 5e-2
of the top."""

import functools
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(2)

import repro.models.encdec as j_encdec
import repro.nn.attention as j_attn
from repro.configs import get_smoke_config as j_smoke
from repro.models import get_model as j_get_model

import repro_torch.models.encdec as t_encdec
import repro_torch.nn.attention as t_attn
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.serve import draw_prompts, prompts_on
from repro_torch.models import get_model

ARCH = "seamless-m4t-large-v2"
B, S, GEN = 2, 24, 6


@pytest.fixture
def float32_throughout(monkeypatch):
    """Both packages' bf16 frames, cross K/V and KV caches in float32 (see
    the module docstring)."""
    monkeypatch.setattr(j_encdec, "jnp", types.SimpleNamespace(
        **{**vars(jnp), "bfloat16": jnp.float32}))
    monkeypatch.setattr(t_encdec, "ACT_DTYPE", torch.float32)
    monkeypatch.setattr(j_attn, "init_kv_cache", functools.partial(
        j_attn.init_kv_cache, dtype=jnp.float32))
    monkeypatch.setattr(t_attn, "init_kv_cache", functools.partial(
        t_attn.init_kv_cache, dtype=torch.float32))


def _setup(dtype, backend="pallas"):
    jcfg = j_smoke(ARCH).replace(attn_backend=backend)
    jm = j_get_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    cfg = get_smoke_config(ARCH).replace(attn_backend=backend)
    params = convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "frames": rng.normal(0, 1, (B, S // cfg.src_ratio, cfg.d_model)
                                  ).astype(np.float32)}
    return jcfg, jm, jparams, get_model(cfg), params, batch


def _generate(jm, jparams, m, params, batch, *, forced=False):
    """Prefill, then GEN greedy decode steps in each package: the logits of
    the prefill and of every step, and the tokens of both. ``forced``:
    both packages decode the reference's tokens."""
    jlog, jc = jm.prefill(jparams, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                          jm.init_cache(B, S + GEN))
    with torch.inference_mode():
        tlog, tc = m.prefill(params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()},
                             m.init_cache(B, S + GEN, device="cpu"))
    logits = [(np.asarray(jlog, np.float32), tlog.float().numpy())]
    jt = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tlog, -1).to(torch.int32)[:, None]
    jtoks, ttoks = [np.asarray(jt)], [tt.numpy()]
    for _ in range(GEN):
        jlog, jc = jm.decode_step(jparams, jc, jt)
        with torch.inference_mode():
            tlog, tc = m.decode_step(params, tc, tt)
        logits.append((np.asarray(jlog, np.float32), tlog.float().numpy()))
        jt = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tlog, -1).to(torch.int32)[:, None]
        jtoks.append(np.asarray(jt))
        ttoks.append(tt.numpy())
        if forced:
            tt = torch.from_numpy(np.array(jt))
    return logits, np.concatenate(jtoks, 1), np.concatenate(ttoks, 1), tc


@pytest.mark.parametrize("backend", [pytest.param("pallas", id="k4"),
                                     "full"])
def test_float32_encode_prefill_and_decode_match(backend,
                                                 float32_throughout):
    jcfg, jm, jparams, m, params, batch = _setup("float32", backend)
    j_enc = j_encdec.encode(jcfg, jparams, jnp.asarray(batch["frames"]))
    with torch.inference_mode():
        t_enc = t_encdec.encode(m.cfg, params,
                                torch.from_numpy(batch["frames"]))
    assert t_enc.dtype == torch.float32
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), rtol=0,
                               atol=1e-4)
    before = fa_ops.flash_attention.launches
    logits, jtoks, ttoks, cache = _generate(jm, jparams, m, params, batch)
    assert fa_ops.flash_attention.launches == before   # CPU: no launches
    for jlog, tlog in logits:
        assert tlog.shape == (B, m.cfg.vocab_padded)
        np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ttoks, jtoks)
    assert cache["cross_k"][0].shape == (B, S // 4, 4, 16)
    assert cache["len"].tolist() == [S + GEN] * B


def test_bf16_logits_and_greedy_tokens_match():
    _, jm, jparams, m, params, batch = _setup("bfloat16")
    assert params.dec_layers[0].cross_attn.wq.w.dtype == torch.bfloat16
    logits, jtoks, ttoks, cache = _generate(jm, jparams, m, params, batch,
                                            forced=True)
    assert cache["cross_k"][0].dtype == torch.bfloat16
    live = slice(0, m.cfg.vocab)
    for step, (jlog, tlog) in enumerate(logits):
        np.testing.assert_allclose(tlog, jlog, rtol=0, atol=5e-2)
        top2 = np.sort(jlog[:, live], -1)[:, -2:]
        chosen = np.take_along_axis(jlog, ttoks[:, step:step + 1], 1)[:, 0]
        clear = top2[:, 1] - top2[:, 0] > 5e-2
        np.testing.assert_array_equal(ttoks[clear, step], jtoks[clear, step])
        assert np.all(top2[:, 1] - chosen <= 5e-2)


def test_k4_runs_the_decoders_self_attention_only(monkeypatch):
    """Under 'pallas' a prefill calls K4 once per decoder layer (the causal
    self-attention) and never for the encoder or the cross-attention; a
    decode step never."""
    calls = []
    real = t_attn.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape, k.shape))
        return real(q, k, v, **kw)

    monkeypatch.setattr(t_attn, "flash_attention", counted)
    cfg = get_smoke_config(ARCH).replace(attn_backend="pallas")
    m = get_model(cfg)
    params = m.init(0, device="cpu")
    batch = prompts_on(draw_prompts(cfg, B, S, 0), "cpu")
    with torch.inference_mode():
        logits, cache = m.prefill(params, batch,
                                  m.init_cache(B, S + GEN, device="cpu"))
        assert len(calls) == cfg.n_dec_layers
        assert all(q == k == (B, S, 4, 16) for q, k in calls)
        m.decode_step(params, cache, torch.argmax(logits, -1)[:, None])
    assert len(calls) == cfg.n_dec_layers


def test_params_round_trip_bit_for_bit():
    _, _, jparams, _, params, _ = _setup("bfloat16")
    back = convert.lm_params_to_jax(params)
    assert set(back["dec_layers"]) == {"self_norm", "self_attn",
                                       "cross_norm", "cross_attn",
                                       "ffn_norm", "ffn"}
    assert (jax.tree.structure(back)
            == jax.tree.structure(jax.tree.map(np.asarray, jparams)))
    for x, y in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(y, np.asarray(x, np.float32))
    cfg = get_smoke_config(ARCH)
    mine = convert.lm_params_to_jax(get_model(cfg).init(0, device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(back)


def test_serve_draws_the_reference_frames():
    """``draw_prompts`` is the reference serve's NumPy draw: tokens, then
    max(prompt_len // src_ratio, 8) frames, byte for byte, and the same
    bf16 values once cast."""
    cfg = get_smoke_config(ARCH)
    seed, prompt_len = 4, 40
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, prompt_len),
                          dtype=np.int32)
    ref = np.asarray(rng.normal(
        0, 1, (B, max(prompt_len // cfg.src_ratio, 8), cfg.d_model)))
    got = draw_prompts(cfg, B, prompt_len, seed)
    assert set(got) == {"tokens", "frames"} and ref.shape[1] == 10
    assert got["tokens"].tobytes() == tokens.tobytes()
    assert got["frames"].tobytes() == ref.tobytes()
    on = prompts_on(got, "cpu")
    assert on["frames"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        on["frames"].float().numpy(),
        np.asarray(jnp.asarray(ref, jnp.bfloat16).astype(jnp.float32)))
