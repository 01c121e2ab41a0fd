"""The port's training objectives against the JAX package's: ``loss_fn``
and its gradients for the SMOKE smollm-135m (dense; the 'full' backend and
'chunked' with four KV chunks), mixtral-8x22b (MoE, sliding window, the
aux loss), mamba2-1.3b (ssm) and zamba2-1.2b (hybrid), with the JAX
parameters carried across by ``convert.lm_params_from_jax`` in float32 and
the same NumPy-drawn batch. Loss and metrics agree within 1e-5 relative,
gradients within 1e-4 of ``jax.grad``. ``cfg.remat`` (``torch.utils.
checkpoint``) changes no value, and a loss under the forward-only K4
backend raises."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(2)

from repro.configs import get_smoke_config as j_smoke
from repro.models import get_model as j_get_model

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import decoder, get_model, hybrid

B, S = 2, 32
CASES = {"smollm": ("smollm-135m", {}),
         "smollm_chunked": ("smollm-135m", dict(attn_backend="chunked",
                                                attn_chunk=8)),
         "mixtral": ("mixtral-8x22b", {}),
         "mamba2": ("mamba2-1.3b", {}),
         "zamba2": ("zamba2-1.2b", {})}


def _batch(vocab, seed=1, mask=False):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, vocab, (B, S + 1), dtype=np.int32)
    out = {"tokens": row[:, :-1].copy(), "labels": row[:, 1:].copy()}
    if mask:
        out["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jm = j_get_model(j_smoke(arch))
    return jax.tree.map(lambda a: a.astype(jnp.float32),
                        jax.jit(jm.init)(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _reference(case, mask=False):
    """The JAX loss, metrics and gradients (float32 NumPy trees), the
    parameters and the batch, on float32 parameters."""
    arch, changes = CASES[case]
    jm = j_get_model(j_smoke(arch).replace(**changes))
    jp = _jax_params(arch)
    batch = _batch(j_smoke(arch).vocab, mask=mask)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, jp),
            batch)


def _port(case, changes=()):
    arch, base = CASES[case]
    cfg = get_smoke_config(arch).replace(**base, **dict(changes))
    *_, jp, _ = _reference(case)
    return cfg, convert.lm_params_from_jax(cfg, jp, device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_and_grads(cfg, params, batch):
    loss, metrics = get_model(cfg).loss_fn(params, _torch_batch(batch))
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return loss.detach(), metrics, dict(zip(names, grads))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_metrics_and_gradients_match_the_reference(case):
    j_loss, j_metrics, j_grads, _, batch = _reference(case)
    cfg, params = _port(case)
    loss, metrics, grads = _loss_and_grads(cfg, params, batch)
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), v, rtol=1e-5,
                                   atol=1e-12)
    if case == "mixtral":
        assert j_metrics["aux"] > 0
    want = convert.lm_params_from_jax(cfg, j_grads, device="cpu")
    for name, g in want.named_parameters():
        np.testing.assert_allclose(grads[name].numpy(), g.detach().numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", ["smollm", "mixtral"])
def test_loss_mask_matches_the_reference(case):
    j_loss, j_metrics, _, _, batch = _reference(case, mask=True)
    cfg, params = _port(case)
    with torch.no_grad():
        loss, metrics = get_model(cfg).loss_fn(params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), j_metrics["ce"],
                               rtol=1e-5)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("case", ["smollm", "zamba2"])
def test_remat_changes_no_value(case, policy):
    _, _, _, _, batch = _reference(case)
    cfg, params = _port(case)
    base = _loss_and_grads(cfg, params, batch)
    cfg_r, params_r = _port(case, dict(remat=True, remat_policy=policy))
    remat = _loss_and_grads(cfg_r, params_r, batch)
    assert torch.equal(base[0], remat[0])
    for name, g in base[2].items():
        assert torch.equal(g, remat[2][name]), name


def test_forward_returns_hidden_states_and_the_aux_loss():
    _, j_metrics, _, _, batch = _reference("mixtral")
    cfg, params = _port("mixtral")
    with torch.no_grad():
        x, aux = decoder.forward(cfg, params, _torch_batch(batch))
    assert x.shape == (B, S, cfg.d_model) and x.dtype == torch.float32
    np.testing.assert_allclose(float(aux), j_metrics["aux"], rtol=1e-5)


@pytest.mark.parametrize("case", ["smollm", "zamba2"])
def test_a_loss_under_the_forward_only_kernel_raises(case):
    cfg, params = _port(case, dict(attn_backend="pallas"))
    batch = _torch_batch(_reference(case)[4])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model(cfg).loss_fn(params, batch)
    if case == "zamba2":   # the forward alone (serving's prefill path) runs
        with torch.no_grad():
            x, _ = hybrid.forward(cfg, params, batch)
        assert torch.isfinite(x).all()
