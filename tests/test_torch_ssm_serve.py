"""The port's mamba2 serving slice against the JAX package: the SMOKE
mamba2-1.3b (4 layers, the full model's structure), the JAX parameters
carried across by ``convert.lm_params_from_jax``, the same NumPy-drawn
prompts. The prefill runs every layer's scan through the K5 wrapper (its
plain version on the CPU) and the decode the plain recurrence.

In float32 the prefill logits agree within 1e-4 (the same float32 math
with reductions in another order; logits of order 3) and the greedy
tokens of 8 decode steps are identical. In bf16 (the reference's own
parameter dtype) the logits agree within 5e-2, atol and rtol, the
reference's bf16 SSD tolerance (``tests/test_kernels.py``): both compute
each layer's scan in float32 and round it to bf16, and a last-ulp
difference of a float32 sum flips a bf16 rounding now and then, which
four layers carry to the logits (0.038 on these prompts and 0.03 to
0.06 on others, at logits up to 3, where float32 agrees within 3e-6)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(1)

from repro.configs import get_smoke_config as j_smoke
from repro.models import get_model as j_get_model

from repro_torch import convert
from repro_torch.configs import concrete_inputs, get_smoke_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import init_state
from repro_torch.models import get_model, ssm
from repro_torch.nn.ssd import ssd_chunked

ARCH = "mamba2-1.3b"
B, S, GEN = 2, 40, 8     # 3 chunks of 16, the last ragged


def _setup(dtype):
    jm = j_get_model(j_smoke(ARCH))
    jparams = jm.init(jax.random.PRNGKey(0))
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    cfg = get_smoke_config(ARCH)
    params = convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    return jm, jparams, get_model(cfg), params, tokens


def _generate(jm, jparams, m, params, tokens):
    """Prefill, then GEN greedy decode steps in each package. Returns the
    prefill logits and the generated tokens of both."""
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                        jm.init_cache(B, S + GEN))
    with torch.inference_mode():
        tl, tc = m.prefill(params, {"tokens": torch.from_numpy(tokens)},
                           m.init_cache(B, S + GEN, device="cpu"))
    assert tc["len"].tolist() == [S] * B
    prefill = (np.asarray(jl, np.float32), tl.numpy())
    jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    jtoks, ttoks = [np.asarray(jt)], [tt.numpy()]
    for _ in range(GEN):
        jl, jc = jm.decode_step(jparams, jc, jt)
        with torch.inference_mode():
            tl, tc = m.decode_step(params, tc, tt)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
        jtoks.append(np.asarray(jt))
        ttoks.append(tt.numpy())
    return prefill, np.concatenate(jtoks, 1), np.concatenate(ttoks, 1)


def test_float32_logits_and_greedy_tokens_match():
    jm, jparams, m, params, tokens = _setup("float32")
    before = ssd_ops.ssd_scan.launches
    (jl, tl), jtoks, ttoks = _generate(jm, jparams, m, params, tokens)
    assert ssd_ops.ssd_scan.launches == before   # CPU: no launches
    assert tl.shape == (B, m.cfg.vocab_padded) and tl.dtype == np.float32
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ttoks, jtoks)


def test_bf16_logits_match_within_the_ssd_tolerance():
    jm, jparams, m, params, tokens = _setup("bfloat16")
    assert params.embed.embed.dtype == torch.bfloat16
    assert params.layers[0].mixer.A_log.dtype == torch.float32
    (jl, tl), _, _ = _generate(jm, jparams, m, params, tokens)
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=5e-2, atol=5e-2)


def test_prefill_through_the_wrapper_equals_the_plain_ssd_fn():
    """On the CPU the K5 wrapper is the plain version: a prefill with
    ``ssd_fn=ssd_chunked`` gives the same logits and states bit for bit."""
    _, _, m, params, tokens = _setup("bfloat16")
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.inference_mode():
        a, ca = m.prefill(params, batch, m.init_cache(B, S, device="cpu"))
        b, cb = m.prefill(params, batch, m.init_cache(B, S, device="cpu"),
                          ssd_fn=ssd_chunked)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for la, lb in zip(ca["layers"], cb["layers"]):
        torch.testing.assert_close(la["ssm"], lb["ssm"], rtol=0, atol=0)


def test_decode_past_the_chunk_stays_finite():
    """As the reference's test_long_context_families_decode_past_window:
    an 8-token prompt, then 24 decode steps (past the SMOKE chunk of 16),
    the state O(1) in length."""
    cfg = get_smoke_config(ARCH)
    m = get_model(cfg)
    params = m.init(3, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8),
                                           dtype=np.int32))
    with torch.inference_mode():
        logits, cache = m.prefill(params, {"tokens": tokens},
                                  m.init_cache(2, 64, device="cpu"))
        shapes = [tuple(c["ssm"].shape) for c in cache["layers"]]
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for _ in range(24):
            logits, cache = m.decode_step(params, cache, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    assert bool(torch.isfinite(logits).all())
    assert [tuple(c["ssm"].shape) for c in cache["layers"]] == shapes
    assert cache["len"].tolist() == [8 + 24] * 2


def test_convert_round_trip_is_exact():
    _, jparams, _, params, _ = _setup("bfloat16")
    back = convert.lm_params_to_jax(params)
    ref = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert b.shape == a.shape
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))
    mixer = params.layers[1].mixer
    for name in ("A_log", "D", "dt_bias"):
        assert getattr(mixer, name).dtype == torch.float32
    assert mixer.in_proj.w.dtype == torch.bfloat16


def test_serve_runs_on_the_cpu_when_asked_and_is_seeded():
    cfg = get_smoke_config(ARCH)
    toks, info = serve(cfg, batch=2, prompt_len=20, gen=4, seed=3,
                       device="cpu")
    again, _ = serve(cfg, batch=2, prompt_len=20, gen=4, seed=3,
                     device="cpu")
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    torch.testing.assert_close(toks, again, rtol=0, atol=0)
    assert info["prefill_s"] > 0 and info["tok_per_s"] > 0


def test_init_has_the_reference_structure():
    """The port's own init gives the reference's parameter tree: the same
    names, shapes and dtypes (bf16; A_log, D and dt_bias float32), unit
    norm scales, and matrices with the reference's stddev 1/sqrt(d_in)
    (truncated at 2 stddevs)."""
    cfg = get_smoke_config(ARCH)
    params = get_model(cfg).init(0, device="cpu")
    ref = j_get_model(j_smoke(ARCH)).init(jax.random.PRNGKey(0))
    mine = convert.lm_params_to_jax(params)
    assert jax.tree.structure(mine) == jax.tree.structure(
        jax.tree.map(np.asarray, ref))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(mine)):
        assert a.shape == b.shape
    f32 = {"A_log", "D", "dt_bias"}
    for name, p in params.named_parameters():
        want = torch.float32 if name.split(".")[-1] in f32 else torch.bfloat16
        assert p.dtype == want, name
    w = params.layers[0].mixer.out_proj.w.detach().float()
    std = 1 / np.sqrt(cfg.d_inner)
    assert float(w.abs().max()) <= 2 * std + 1e-3
    assert abs(float(w.std()) / std - 0.88) < 0.05   # truncated normal's
    assert torch.equal(params.final_norm.scale.detach().float(),
                       torch.ones(cfg.d_model))


def test_unported_parts_raise_and_nothing_falls_back_to_the_cpu(
        monkeypatch):
    """``loss_fn`` and ``ssm.forward`` raised NotImplementedError until the
    training slice was ported; they now run, and the loss on the port's own
    float32 parameters equals the reference's on the same values within
    1e-5. ``ssd_bf16`` raised too until its variant was ported; now its
    loss equals the reference's ``ssd_bf16`` loss within 1e-5. No entry
    point, the new train state and ``concrete_inputs`` included, falls
    back to the CPU unasked."""
    cfg = get_smoke_config(ARCH)
    m = get_model(cfg)
    params = m.init(0, device="cpu").float()
    row = np.random.default_rng(5).integers(0, cfg.vocab, (B, S + 1),
                                            dtype=np.int32)
    batch = {"tokens": row[:, :-1].copy(), "labels": row[:, 1:].copy()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, _ = m.loss_fn(params, tb)
        x, aux = ssm.forward(cfg, params, tb)
    assert x.shape == (B, S, cfg.d_model) and float(aux) == 0.0
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_jax(params))
    j_loss, _ = jax.jit(j_get_model(j_smoke(ARCH)).loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    with torch.no_grad():
        loss16, _ = get_model(cfg.replace(ssd_bf16=True)).loss_fn(params, tb)
    j_loss16, _ = jax.jit(j_get_model(j_smoke(ARCH).replace(
        ssd_bf16=True)).loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss16), float(j_loss16), rtol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: m.init(0), lambda: m.init_cache(2, 8),
                 lambda: serve(cfg, batch=1, prompt_len=4, gen=1),
                 lambda: init_state(cfg, 0),
                 lambda: concrete_inputs(cfg, "train_4k", scale=256)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_prefill_at_chunk_256_matches_the_reference():
    """The slice at Mamba2's own default chunk: SMOKE mamba2-1.3b with
    ``ssm_chunk=256`` in both packages, 2 prompts of 512 tokens (two whole
    chunks; the reference's kernel takes Q = min(chunk, s), so shorter
    prompts would never reach a chunk of 256), the JAX weights carried
    across in float32. The prefill logits agree within 1e-4, as the other
    families' (``tests/test_torch_lm_families.py``), and every layer's scan
    went through the K5 wrapper at chunk 256."""
    b, s = 2, 512
    jcfg = j_smoke(ARCH).replace(ssm_chunk=256)
    jm = j_get_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jm.init(jax.random.PRNGKey(0)))
    cfg = get_smoke_config(ARCH).replace(ssm_chunk=256)
    params = convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    m = get_model(cfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (b, s),
                                               dtype=np.int32)
    jl, _ = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                       jm.init_cache(b, s))
    chunks = []

    def counted(*args, chunk):
        chunks.append(chunk)
        return ssd_ops.ssd_scan(*args, chunk=chunk, return_state=True)

    with torch.inference_mode():
        tl, _ = m.prefill(params, {"tokens": torch.from_numpy(tokens)},
                          m.init_cache(b, s, device="cpu"), ssd_fn=counted)
    assert chunks == [256] * cfg.n_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                               rtol=0, atol=1e-4)
