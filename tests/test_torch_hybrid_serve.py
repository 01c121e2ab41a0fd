"""The port's hybrid serving slice against the JAX package: the SMOKE
zamba2-1.2b (7 Mamba2 layers, the shared attention block every 3: 2 groups
+ 1 tail layer, the full model's structure) with ``attn_backend="pallas"``,
the JAX parameters carried across by ``convert.lm_params_from_jax``, the
same NumPy-drawn prompts. The prefill runs every Mamba2 layer's scan
through the K5 wrapper and every shared-block invocation through the K4
wrapper (their plain versions on the CPU).

In float32 the prefill and decode logits agree within 1e-4 and the greedy
tokens of 4 decode steps are identical. The float32 comparison keeps the KV
caches in float32 in both packages: with the default bf16 cache, a float32
key one last-place apart in the two frameworks rounds to bf16 apart now
and then (6.0e-5 on these prompts, against 3.7e-6 with float32 caches).
In bf16 (the reference's parameter dtype) the prefill logits agree within
5e-2, atol and rtol, the reference's bf16 SSD tolerance that
``test_torch_ssm_serve.py`` holds mamba2 to: 0.045 at logits up to 3.1 on
these prompts (0.064 on shorter ones), where the Mamba2 layers' bf16
roundings flip with the float32 summation order."""

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

import repro_torch.nn.attention as t_attn
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.serve import serve
from repro_torch.models import get_model, hybrid

ARCH = "zamba2-1.2b"
B, S, GEN = 2, 40, 4     # 3 chunks of 16, the last ragged


@pytest.fixture
def float32_kv_caches(monkeypatch):
    """Both packages' KV caches in float32 (see the module docstring)."""
    monkeypatch.setattr(j_attn, "init_kv_cache", functools.partial(
        j_attn.init_kv_cache, dtype=jnp.float32))
    monkeypatch.setattr(t_attn, "init_kv_cache", functools.partial(
        t_attn.init_kv_cache, dtype=torch.float32))


def _setup(dtype):
    jcfg = j_smoke(ARCH).replace(attn_backend="pallas")
    jm = j_get_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    cfg = get_smoke_config(ARCH).replace(attn_backend="pallas")
    params = convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    return jm, jparams, get_model(cfg), params, tokens


def _generate(jm, jparams, m, params, tokens):
    """Prefill, then GEN greedy decode steps in each package. Returns the
    logits of the prefill and of every step, and the tokens of both."""
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                        jm.init_cache(B, S + GEN))
    with torch.inference_mode():
        tl, tc = m.prefill(params, {"tokens": torch.from_numpy(tokens)},
                           m.init_cache(B, S + GEN, device="cpu"))
    assert tc["len"].tolist() == [S] * B
    logits = [(np.asarray(jl, np.float32), tl.numpy())]
    jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    jtoks, ttoks = [np.asarray(jt)], [tt.numpy()]
    for _ in range(GEN):
        jl, jc = jm.decode_step(jparams, jc, jt)
        with torch.inference_mode():
            tl, tc = m.decode_step(params, tc, tt)
        logits.append((np.asarray(jl, np.float32), tl.numpy()))
        jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
        jtoks.append(np.asarray(jt))
        ttoks.append(tt.numpy())
    return logits, np.concatenate(jtoks, 1), np.concatenate(ttoks, 1)


def test_float32_logits_and_greedy_tokens_match(float32_kv_caches):
    jm, jparams, m, params, tokens = _setup("float32")
    before = (fa_ops.flash_attention.launches, ssd_ops.ssd_scan.launches)
    logits, jtoks, ttoks = _generate(jm, jparams, m, params, tokens)
    assert (fa_ops.flash_attention.launches,
            ssd_ops.ssd_scan.launches) == before     # CPU: no launches
    assert logits[0][1].shape == (B, m.cfg.vocab_padded)
    for jl, tl in logits:
        assert tl.dtype == np.float32
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ttoks, jtoks)


def test_bf16_logits_match_within_the_ssd_tolerance():
    jm, jparams, m, params, tokens = _setup("bfloat16")
    assert params.embed.embed.dtype == torch.bfloat16
    assert params.groups[0][0].mixer.A_log.dtype == torch.float32
    logits, _, _ = _generate(jm, jparams, m, params, tokens)
    jl, tl = logits[0]
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=5e-2, atol=5e-2)


def test_convert_round_trip_is_exact():
    _, jparams, _, params, _ = _setup("bfloat16")
    back = convert.lm_params_to_jax(params)
    ref = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert b.shape == a.shape
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))
    # groups.* are (G, attn_every, ...) in the reference
    np.testing.assert_array_equal(
        back["groups"]["mixer"]["D"][1, 2],
        params.groups[1][2].mixer.D.detach().numpy())


def test_init_has_the_reference_structure():
    cfg = get_smoke_config(ARCH)
    params = get_model(cfg).init(0, device="cpu")
    ref = j_get_model(j_smoke(ARCH)).init(jax.random.PRNGKey(0))
    mine = convert.lm_params_to_jax(params)
    ref = jax.tree.map(np.asarray, ref)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(mine)):
        assert a.shape == b.shape


def test_the_shared_block_exists_once_with_one_cache_per_invocation():
    cfg = get_smoke_config(ARCH)
    G, tail = hybrid._group_shape(cfg)
    assert (G, tail) == (2, 1)
    m = get_model(cfg)
    params = m.init(0, device="cpu")
    names = [n for n, _ in params.named_parameters()]
    assert sum(n.startswith("shared.attn.wq") for n in names) == 1
    assert not any(".attn." in n for n in names if not n.startswith("shared"))
    assert len(params.groups) == G and len(params.tail) == tail
    assert all(len(g) == cfg.attn_every for g in params.groups)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, 8), dtype=np.int32))
    with torch.inference_mode():
        _, cache = m.prefill(params, {"tokens": tokens},
                             m.init_cache(B, 12, device="cpu"))
        tok = tokens[:, -1:]
        _, cache = m.decode_step(params, cache, tok)
    assert len(cache["attn"]) == G and len(cache["tail"]) == tail
    assert cache["attn"][0]["k"] is not cache["attn"][1]["k"]
    assert not torch.equal(cache["attn"][0]["k"], cache["attn"][1]["k"])
    assert [c["len"].tolist() for c in cache["attn"]] == [[9] * B] * G
    assert cache["len"].tolist() == [9] * B


def test_serve_runs_on_the_cpu_when_asked_and_is_seeded():
    cfg = get_smoke_config(ARCH).replace(attn_backend="pallas")
    toks, info = serve(cfg, batch=2, prompt_len=12, gen=4, seed=3,
                       device="cpu")
    again, _ = serve(cfg, batch=2, prompt_len=12, gen=4, seed=3,
                     device="cpu")
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    torch.testing.assert_close(toks, again, rtol=0, atol=0)
    assert info["prefill_s"] > 0 and info["tok_per_s"] > 0


def test_training_is_not_ported_yet():
    """``loss_fn`` and ``hybrid.forward`` raised NotImplementedError until
    the training slice was ported; they now run, and the loss on the port's
    own float32 parameters equals the reference's on the same values within
    1e-5. The refusal that stays: a loss under the forward-only kernels
    (``attn_backend="pallas"``)."""
    cfg = get_smoke_config(ARCH)
    params = get_model(cfg).init(0, device="cpu").float()
    row = np.random.default_rng(5).integers(0, cfg.vocab, (B, S + 1),
                                            dtype=np.int32)
    batch = {"tokens": row[:, :-1].copy(), "labels": row[:, 1:].copy()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, metrics = get_model(cfg).loss_fn(params, tb)
        x, aux = hybrid.forward(cfg, params, tb)
    assert x.shape == (B, S, cfg.d_model) and float(aux) == 0.0
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_jax(params))
    j_loss, _ = jax.jit(j_get_model(j_smoke(ARCH)).loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model(cfg.replace(attn_backend="pallas")).loss_fn(params, tb)


def test_ssd_bf16_is_accepted_as_the_reference_takes_it(float32_kv_caches):
    """``cfg.ssd_bf16`` raised in the hybrid until the sharding slice. The
    reference's hybrid reads it only through the ssm model's blocks, and
    so does the port's: the prefill runs K5 (its plain version here)
    whatever the flag says, so its logits equal the flag-off logits bit
    for bit, and stay within the bf16 SSD tolerance (5e-2) of the
    reference's prefill with the flag, which rounds the intra-chunk math
    to bf16; the loss takes the bf16 scan in both packages and agrees
    within 1e-5 relative."""
    jm, jparams, m, params, tokens = _setup("float32")
    cfg16 = m.cfg.replace(ssd_bf16=True)
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.inference_mode():
        off, _ = m.prefill(params, batch, m.init_cache(B, S, device="cpu"))
        m16 = get_model(cfg16)
        on, _ = m16.prefill(params, batch, m16.init_cache(B, S, device="cpu"))
    assert torch.equal(on, off)
    jm16 = j_get_model(j_smoke(ARCH).replace(attn_backend="pallas",
                                             ssd_bf16=True))
    jl, _ = jm16.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                         jm16.init_cache(B, S))
    np.testing.assert_allclose(on.numpy(), np.asarray(jl, np.float32),
                               rtol=5e-2, atol=5e-2)
    row = np.random.default_rng(6).integers(0, m.cfg.vocab, (B, S + 1),
                                            dtype=np.int32)
    lb = {"tokens": row[:, :-1].copy(), "labels": row[:, 1:].copy()}
    with torch.no_grad():
        loss, _ = get_model(cfg16.replace(attn_backend="full")).loss_fn(
            params, {k: torch.from_numpy(v) for k, v in lb.items()})
    j_loss, _ = jax.jit(j_get_model(j_smoke(ARCH).replace(
        ssd_bf16=True)).loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in lb.items()})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)


def test_rope_none_prefill_and_decode_match(float32_kv_caches):
    """``rope="none"`` raised in the hybrid until the sharding slice; the
    shared block now attends without rope, as the reference's does:
    float32 prefill and decode logits within 1e-4, greedy tokens equal."""
    jcfg = j_smoke(ARCH).replace(attn_backend="pallas", rope="none")
    jm = j_get_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jm.init(jax.random.PRNGKey(0)))
    cfg = get_smoke_config(ARCH).replace(attn_backend="pallas", rope="none")
    params = convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    logits, jtoks, ttoks = _generate(jm, jparams, get_model(cfg), params,
                                     tokens)
    for jl, tl in logits:
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ttoks, jtoks)
