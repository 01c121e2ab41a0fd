"""The domain of the port's K4 (flash attention) and K5 (SSD chunked scan)
CUDA kernels against every call the served prefill makes.

``serve --smoke`` serves an arch's SMOKE config under 'pallas' (head dims
16 and 24, Mamba2 layers at chunk 16 with p = n = 16), the full configs
their published widths. Each arch's served prefill is run here on the
``meta`` device, its depth cut where the full config would be large (the
call shapes do not depend on depth), with the two wrappers replaced by
recorders; every recorded call must pass the kernels' own domain checks
(``kernel.check_head_dim`` and ``kernel.check_widths``), which the
wrappers run before a launch on the card, and the calls must be one K4
per causal self-attention layer and one K5 per Mamba2 layer. MLA
(deepseek-v2) keeps its own backend (R6): its q and k are wider than its
v, and the kernel takes one head dim for all three.

Then SMOKE qwen2-vl, granite and mamba2 are served on the CPU under
'pallas' (the wrappers' plain versions) with the JAX package's parameters
carried across by ``convert.lm_params_from_jax``, in float32: the prefill
logits against the reference's within 1e-4, and the served greedy tokens
equal to the reference's greedy loop on the same prompts."""

from unittest import mock

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(2)

from repro.configs import get_smoke_config as j_smoke
from repro.models import get_model as j_get_model

import repro_torch.models.ssm as t_ssm
import repro_torch.nn.attention as t_attn
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.launch.serve import draw_prompts, serve, served_config
from repro_torch.models import get_model

B = 2


def _cut(cfg):
    """The config at the depth that still makes every kind of call once:
    one layer; the hybrid's one shared-block invocation; the enc-dec's one
    encoder and one decoder layer."""
    if cfg.family == "hybrid":
        return cfg.replace(n_layers=cfg.attn_every)
    if cfg.family == "encdec":
        return cfg.replace(n_layers=2, n_enc_layers=1, n_dec_layers=1)
    return cfg.replace(n_layers=1)


def _expected(cfg):
    """K4 and K5 calls of one prefill: K4 once per causal self-attention
    layer (the hybrid's shared block per invocation, the enc-dec's decoder
    only, MLA never), K5 once per Mamba2 layer."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every, cfg.n_layers
    if cfg.family == "ssm":
        return 0, cfg.n_layers
    if cfg.family == "encdec":
        return cfg.n_dec_layers, 0
    return (0 if cfg.use_mla else cfg.n_layers), 0


def _record_prefill(cfg, prompt_len):
    """The served prefill of ``cfg`` on meta tensors (``serve --smoke``'s
    request of ``B`` prompts; the widths, not the length, set the call
    shapes' domain): the K4 and K5 calls it makes, as (q, k, v shapes,
    causal, window, dtype) and (p, n, chunk, dtype)."""
    k4, k5 = [], []

    def fa(q, k, v, *, causal=True, window=None):
        k4.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), causal,
                   window, q.dtype))
        return torch.empty_like(q)

    def scan(x, dt, A, B, C, *, chunk=128, return_state=False):
        k5.append((x.shape[3], B.shape[3], chunk, x.dtype))
        b, _, h, p = x.shape
        return (torch.empty_like(x),
                torch.empty((b, h, p, B.shape[3]), device=x.device))

    m = get_model(cfg)
    with torch.device("meta"):   # the init's draws too: nothing on the host
        params = m.init(0, device="meta")
    draws = draw_prompts(cfg, B, prompt_len, 0)
    batch = {k: torch.empty(v.shape, device="meta", dtype=(
        torch.int32 if k == "tokens" else torch.bfloat16))
        for k, v in draws.items()}
    with mock.patch.object(t_attn, "flash_attention", fa), \
            mock.patch.object(t_ssm, "ssd_scan", scan), \
            torch.inference_mode():
        m.prefill(params, batch, m.init_cache(B, prompt_len + 8,
                                              device="meta"))
    return k4, k5


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_served_prefill_calls_are_in_the_kernel_domain(arch, size):
    if size == "smoke":
        cfg = served_config(get_smoke_config(arch))
    else:
        cfg = _cut(served_config(get_config(arch)))
    k4, k5 = _record_prefill(cfg, 64)
    assert (len(k4), len(k5)) == _expected(cfg)
    for q, k, v, causal, window, dtype in k4:
        assert causal and k == v and q[3] == k[3] and q[2] % k[2] == 0
        fa_kernel.check_head_dim(q[3], dtype)
        fa_kernel.check_head_dim(q[3], torch.float32)
    for p, n, chunk, dtype in k5:
        ssd_kernel.check_widths(p, n, chunk)
    if size == "smoke" and k4:   # the widths `serve --smoke` failed on
        assert k4[0][0][3] in (16, 24)
    if size == "smoke" and k5:
        assert k5[0][:3] == (16, 16, 16)


@pytest.mark.parametrize("get", [get_smoke_config, get_config],
                         ids=["smoke", "full"])
def test_mla_stays_outside_the_kernel(get):
    """R6: the served MLA config keeps its own backend ('chunked' at full
    width, 'full' in SMOKE); its q and k heads are wider than its v heads,
    which the wrapper refuses on any device."""
    cfg = served_config(get("deepseek-v2-236b"))
    assert cfg.use_mla and cfg.attn_backend != "pallas"
    dqk = cfg.nope_head_dim + cfg.rope_head_dim
    assert dqk != cfg.v_head_dim
    q = torch.zeros((1, 8, cfg.n_heads, dqk))
    v = torch.zeros((1, 8, cfg.n_kv_heads, cfg.v_head_dim))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q[:, :, :cfg.n_kv_heads], v)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "granite-34b",
                                  "mamba2-1.3b"])
def test_smoke_serve_with_the_reference_weights(arch):
    P, G = 64, 8
    jm = j_get_model(j_smoke(arch).replace(attn_backend="pallas"))
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jm.init(jax.random.PRNGKey(0)))
    cfg = served_config(get_smoke_config(arch))
    assert cfg.attn_backend == "pallas"
    params = convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    draws = draw_prompts(cfg, B, P, 0)
    # the embeddings in bf16, as both packages' serve casts them
    jbatch = {k: jnp.asarray(v, None if k == "tokens" else jnp.bfloat16)
              for k, v in draws.items()}
    tbatch = {k: torch.from_numpy(v).to(
        None if k == "tokens" else torch.bfloat16) for k, v in draws.items()}
    jlog, jcache = jm.prefill(jparams, jbatch, jm.init_cache(B, P + G))
    m = get_model(cfg)
    with torch.inference_mode():
        tlog, _ = m.prefill(params, tbatch,
                            m.init_cache(B, P + G, device="cpu"))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog, np.float32),
                               rtol=0, atol=1e-4)
    jt = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
    want = [np.asarray(jt)]
    for _ in range(G - 1):
        step, jcache = jm.decode_step(jparams, jcache, jt)
        jt = jnp.argmax(step, -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(jt))
    before = fa_ops.flash_attention.launches
    toks, _ = serve(cfg, batch=B, prompt_len=P, gen=G, seed=0, device="cpu",
                    params=params)
    assert fa_ops.flash_attention.launches == before   # the CPU: no launch
    np.testing.assert_array_equal(toks.numpy(), np.concatenate(want, 1))
