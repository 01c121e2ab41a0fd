"""The port's LM serving slice against the JAX package: the SMOKE
smollm-135m (4 layers, the full model's structure) with
``attn_backend="pallas"``, the JAX parameters carried across by
``convert.lm_params_from_jax``, the same NumPy-drawn prompts.

In float32 the prefill logits agree within 1e-4 (30 float32 products and
reductions in another order per token; logits of order 3) and the greedy
tokens of 8 decode steps are identical. In bf16 (the reference's own
parameter dtype) the logits agree within 5e-2, the gap the JAX package's
own 'pallas' and 'full' backends show on this model (0.045 at logits of
magnitude 2.7): bf16 rounds at other places in the two frameworks."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(1)

from repro.configs import get_smoke_config as j_smoke
from repro.models import get_model as j_get_model

from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.serve import serve
from repro_torch.models import get_model

ARCH = "smollm-135m"
B, S, GEN = 2, 24, 8


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
    prefill logits and the generated tokens of both."""
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                        jm.init_cache(B, S + GEN))
    with torch.inference_mode():
        tl, tc = m.prefill(params, {"tokens": torch.from_numpy(tokens)},
                           m.init_cache(B, S + GEN, device="cpu"))
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
    before = fa_ops.flash_attention.launches
    (jl, tl), jtoks, ttoks = _generate(jm, jparams, m, params, tokens)
    assert fa_ops.flash_attention.launches == before   # CPU: no launches
    assert tl.shape == (B, m.cfg.vocab_padded) and tl.dtype == np.float32
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ttoks, jtoks)


def test_bf16_logits_match_within_the_backends_gap():
    jm, jparams, m, params, tokens = _setup("bfloat16")
    assert params.embed.embed.dtype == torch.bfloat16
    (jl, tl), _, _ = _generate(jm, jparams, m, params, tokens)
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=5e-2)


def test_convert_round_trip_is_exact():
    _, jparams, _, params, _ = _setup("bfloat16")
    back = convert.lm_params_to_jax(params)
    assert (jax.tree.structure(back)
            == jax.tree.structure(jax.tree.map(np.asarray, jparams)))
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        assert b.shape == a.shape
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))


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


def test_init_has_the_reference_structure():
    """The port's own init gives the reference's parameter tree: the same
    names, shapes and dtype (bf16), unit norm scales, and matrices with the
    reference's stddev 1/sqrt(d_in) (truncated at 2 stddevs)."""
    cfg = get_smoke_config(ARCH)
    params = get_model(cfg).init(0, device="cpu")
    ref = j_get_model(j_smoke(ARCH)).init(jax.random.PRNGKey(0))
    mine = convert.lm_params_to_jax(params)
    assert jax.tree.structure(mine) == jax.tree.structure(
        jax.tree.map(np.asarray, ref))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(mine)):
        assert a.shape == b.shape
    assert all(p.dtype == torch.bfloat16 for p in params.parameters())
    w = params.layers[0].ffn.down.w.detach().float()
    std = 1 / np.sqrt(cfg.d_ff)
    assert float(w.abs().max()) <= 2 * std + 1e-3
    assert abs(float(w.std()) / std - 0.88) < 0.05   # truncated normal's
    assert torch.equal(params.final_norm.scale.float(),
                       torch.ones(cfg.d_model))


def test_unported_archs_and_families_raise():
    """Every arch and family of the reference is ported now: the
    deepseek-v2 config resolves and ``get_model`` builds each family.
    Until the training slice of the last three archs, the losses of the
    vlm, MLA and encdec models, the 'chunked_tri' backend and ``ssd_bf16``
    raised here; now the three losses run (finite, with the decoder's
    metrics; held against the reference in ``test_torch_train_archs``),
    a 'chunked_tri' prefill gives the 'chunked' one's logits within the
    reference's bf16-probability tolerance, and an ``ssd_bf16`` mamba2
    builds and trains. What stays refused, with NotImplementedError
    naming ROADMAP.md: a loss under the forward-only K4
    (``attn_backend="pallas"``, the three new losses included) and MLA
    under 'pallas' (the kernel takes one head dim for q, k and v); an
    unknown arch raises KeyError."""
    from repro_torch.configs import concrete_inputs
    assert get_config("deepseek-v2-236b").use_mla
    with pytest.raises(KeyError, match="ROADMAP.md"):
        get_config("no-such-arch")
    for arch in ("smollm-135m", "mixtral-8x22b", "qwen2-vl-72b",
                 "mamba2-1.3b", "zamba2-1.2b", "seamless-m4t-large-v2"):
        get_model(get_smoke_config(arch))
    cfg = get_smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model(cfg.replace(attn_backend="pallas")).loss_fn(None, None)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 9), dtype=np.int32))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    with torch.no_grad():
        loss, metrics = get_model(cfg).loss_fn(
            get_model(cfg).init(0, device="cpu"), batch)
    assert torch.isfinite(loss) and set(metrics) == {"ce", "z_loss", "aux"}
    mla = get_smoke_config("deepseek-v2-236b")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model(mla.replace(attn_backend="pallas")).init(0, device="cpu")
    for arch in ("qwen2-vl-72b", "deepseek-v2-236b", "seamless-m4t-large-v2"):
        acfg = get_smoke_config(arch)
        m = get_model(acfg)
        params = m.init(0, device="cpu")
        b = concrete_inputs(acfg, "train_4k", scale=256, device="cpu")
        with torch.no_grad():
            loss, metrics = m.loss_fn(params, b)
        assert torch.isfinite(loss) and set(metrics) == {"ce", "z_loss",
                                                         "aux"}
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            get_model(acfg.replace(attn_backend="pallas")).loss_fn(params, b)
    params = get_model(cfg).init(0, device="cpu")
    with torch.no_grad():
        logits = [get_model(cfg.replace(attn_backend=be, attn_chunk=4))
                  .prefill(params, {"tokens": tokens},
                           get_model(cfg).init_cache(2, 9, device="cpu"))[0]
                  for be in ("chunked_tri", "chunked")]
    torch.testing.assert_close(logits[0], logits[1], rtol=2e-2, atol=2e-2)
    scfg = get_smoke_config("mamba2-1.3b").replace(ssd_bf16=True)
    with torch.no_grad():
        loss, _ = get_model(scfg).loss_fn(
            get_model(scfg).init(0, device="cpu"), batch)
    assert torch.isfinite(loss)