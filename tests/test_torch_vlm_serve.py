"""The port's VLM backbone (qwen2-vl-72b's SMOKE config: 4 layers, GQA
2:1, qkv biases, M-RoPE with sections (4, 4, 4)) against the JAX package,
both under ``attn_backend="pallas"`` (the port's K4 runs its plain version
on the CPU; the reference's kernel runs in interpret mode), with the JAX
parameters carried across by ``convert.lm_params_from_jax`` and the same
NumPy-drawn prompts: text only, with vision embeddings in place of the
first 8 tokens, and with those and a real (t, h, w) grid for them (t = 0,
a 2 x 4 grid, the text going on from the grid's largest id + 1 on all
three sections; decode gives the cache position to all three, as the
reference does).

In float32, with the KV caches in float32 in both packages (see
``test_torch_lm_families``), the prefill and decode logits agree within
1e-4 and the greedy tokens are identical; with the default bf16 caches
the float32 greedy tokens are identical too."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(2)

import repro.nn.attention as j_attn
from repro.configs import get_smoke_config as j_smoke
from repro.models import get_model as j_get_model

import repro_torch.nn.attention as t_attn
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.serve import draw_prompts, prompts_on
from repro_torch.models import get_model

ARCH = "qwen2-vl-72b"
B, S, GEN = 2, 24, 6
GRID_H, GRID_W = 2, 4     # the SMOKE config's 8 vision tokens


@pytest.fixture
def float32_kv_caches(monkeypatch):
    monkeypatch.setattr(j_attn, "init_kv_cache", functools.partial(
        j_attn.init_kv_cache, dtype=jnp.float32))
    monkeypatch.setattr(t_attn, "init_kv_cache", functools.partial(
        t_attn.init_kv_cache, dtype=torch.float32))


def grid_positions(batch, seq, grid_h, grid_w):
    """(3, batch, seq) M-RoPE ids: t = 0 and (h, w) over the grid for the
    first grid_h * grid_w tokens, then text from the largest id + 1 on all
    three."""
    V = grid_h * grid_w
    ids = np.empty((3, seq), np.int32)
    ids[0, :V] = 0
    ids[1, :V] = np.arange(V) // grid_w
    ids[2, :V] = np.arange(V) % grid_w
    ids[:, V:] = max(grid_h, grid_w) + np.arange(seq - V)
    return np.broadcast_to(ids[:, None], (3, batch, seq)).copy()


def _setup(dtype):
    jm = j_get_model(j_smoke(ARCH).replace(attn_backend="pallas"))
    jparams = jm.init(jax.random.PRNGKey(0))
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    cfg = get_smoke_config(ARCH).replace(attn_backend="pallas")
    params = convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, get_model(cfg), params


def _batch(cfg, kind):
    rng = np.random.default_rng(5)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if kind != "text":
        out["vision_embeds"] = rng.normal(
            0, 1, (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if kind == "grid":
        out["positions_thw"] = grid_positions(B, S, GRID_H, GRID_W)
    return out


def _generate(jm, jparams, m, params, batch):
    """Prefill, then GEN greedy decode steps in each package: the logits of
    the prefill and of every step, and the tokens of both."""
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
    return logits, np.concatenate(jtoks, 1), np.concatenate(ttoks, 1)


@pytest.mark.parametrize("kind", ["text", "vision", "grid"])
def test_float32_prefill_and_decode_logits_match(kind, float32_kv_caches):
    jm, jparams, m, params = _setup("float32")
    batch = _batch(m.cfg, kind)
    before = fa_ops.flash_attention.launches
    logits, jtoks, ttoks = _generate(jm, jparams, m, params, batch)
    assert fa_ops.flash_attention.launches == before   # CPU: no launches
    for jlog, tlog in logits:
        assert tlog.shape == (B, m.cfg.vocab_padded)
        np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ttoks, jtoks)


def test_the_grid_and_the_vision_embeds_move_the_logits(float32_kv_caches):
    """The three inputs give three prefills: the embeddings and the grid's
    ids each reach the logits."""
    _, _, m, params = _setup("float32")
    with torch.inference_mode():
        out = [m.prefill(params, {k: torch.from_numpy(v) for k, v in
                                  _batch(m.cfg, kind).items()},
                         m.init_cache(B, S + GEN, device="cpu"))[0]
               for kind in ("text", "vision", "grid")]
    assert float((out[0] - out[1]).abs().max()) > 1e-2
    assert float((out[1] - out[2]).abs().max()) > 1e-2


def test_float32_greedy_tokens_match_with_bf16_caches():
    jm, jparams, m, params = _setup("float32")
    logits, jtoks, ttoks = _generate(jm, jparams, m, params,
                                     _batch(m.cfg, "grid"))
    assert all(np.all(np.isfinite(t)) for _, t in logits)
    np.testing.assert_array_equal(ttoks, jtoks)


def test_params_with_qkv_biases_round_trip_bit_for_bit():
    _, jparams, _, params = _setup("bfloat16")
    assert params.layers[0].attn.wq.b.dtype == torch.bfloat16
    back = convert.lm_params_to_jax(params)
    assert "b" in back["layers"]["attn"]["wk"]
    assert (jax.tree.structure(back)
            == jax.tree.structure(jax.tree.map(np.asarray, jparams)))
    for x, y in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(y, np.asarray(x, np.float32))


def test_serve_draws_the_reference_vision_embeds():
    """``draw_prompts`` is the reference serve's NumPy draw: tokens, then
    min(n_vision_tokens, prompt_len // 2) embeddings, byte for byte, and
    the same bf16 values once cast."""
    cfg = get_smoke_config(ARCH)
    seed, prompt_len = 3, 12
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, prompt_len),
                          dtype=np.int32)
    V = min(cfg.n_vision_tokens, prompt_len // 2)
    ref = np.asarray(rng.normal(0, 1, (B, V, cfg.d_model)))
    got = draw_prompts(cfg, B, prompt_len, seed)
    assert set(got) == {"tokens", "vision_embeds"} and V == 6
    assert got["tokens"].tobytes() == tokens.tobytes()
    assert got["vision_embeds"].tobytes() == ref.tobytes()
    on = prompts_on(got, "cpu")
    assert on["vision_embeds"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        on["vision_embeds"].float().numpy(),
        np.asarray(jnp.asarray(ref, jnp.bfloat16).astype(jnp.float32)))
