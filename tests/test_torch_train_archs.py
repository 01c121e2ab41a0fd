"""The training objectives of the last three archs against the JAX
package's: ``loss_fn`` and its gradients for the SMOKE qwen2-vl-72b (vlm:
vision embeddings over the first 8 tokens and a real (t, h, w) M-RoPE
grid for them), deepseek-v2-236b (MLA with q/k head dim 24 and v 16, 8
experts; 'full', and 'chunked' with four KV chunks) and
seamless-m4t-large-v2 (enc-dec), with the JAX parameters carried across
by ``convert.lm_params_from_jax`` in float32 and the same NumPy-drawn
batch. Loss and metrics agree within 1e-5 relative, gradients within 1e-4
of ``jax.value_and_grad``, as in ``test_torch_train_loss``.

The reference's enc-dec fixes the frames entering its encoder at bf16 and
cannot run float32 parameters (its encoder's layer scan would carry bf16
into float32), so its comparison takes both packages' bf16 there to
float32 (``jnp.bfloat16`` as ``repro.models.encdec`` sees it, and the
port's ``encdec.ACT_DTYPE``), as ``test_torch_encdec_serve`` does.

Then one ``make_train_step`` step per arch against the reference's
(params and AdamW moments within 1e-5), ``cfg.remat`` changing no value
of the enc-dec loss, and a loss under the forward-only K4 raising."""

import contextlib
import functools
import types
from unittest import mock

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(2)

import repro.models.encdec as j_encdec
from repro.configs import get_smoke_config as j_smoke
from repro.launch import steps as j_steps
from repro.models import get_model as j_get_model

import repro_torch.models.encdec as t_encdec
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import get_model

B, S = 2, 32
GRID_H, GRID_W = 2, 4          # the vision tokens' (h, w) grid at t = 0
VLM, MLA, ENCDEC = "qwen2-vl-72b", "deepseek-v2-236b", "seamless-m4t-large-v2"
CASES = {"qwen2vl": (VLM, {}),
         "deepseek_v2": (MLA, {}),
         "deepseek_v2_chunked": (MLA, dict(attn_backend="chunked",
                                           attn_chunk=8)),
         "seamless": (ENCDEC, {})}
# as in test_torch_train_step: at this peak lr Adam's first step moves a
# parameter whose gradient is near eps by a fraction of lr on float32
# rounding alone, which stays under 1e-5
SCHED = dict(peak_lr=3e-4, warmup_steps=5, total_steps=40)


@contextlib.contextmanager
def float32_lift(arch):
    """The enc-dec's fixed bf16 taken to float32 in both packages (see the
    module docstring); nothing for the other archs."""
    if arch != ENCDEC:
        yield
        return
    with mock.patch.object(j_encdec, "jnp", types.SimpleNamespace(
            **{**vars(jnp), "bfloat16": jnp.float32})), \
            mock.patch.object(t_encdec, "ACT_DTYPE", torch.float32):
        yield


def grid_positions():
    """(3, B, S) M-RoPE ids: t = 0 and (h, w) over the grid for the first
    GRID_H * GRID_W tokens, then text from the grid's largest id + 1 on all
    three sections."""
    V = GRID_H * GRID_W
    ids = np.zeros((3, S), np.int32)
    ids[1, :V] = np.arange(V) // GRID_W
    ids[2, :V] = np.arange(V) % GRID_W
    ids[:, V:] = max(GRID_H, GRID_W) + np.arange(S - V)
    return np.ascontiguousarray(np.broadcast_to(ids[:, None], (3, B, S)))


def _batch(arch, seed=1):
    cfg = j_smoke(arch)
    rng = np.random.default_rng(seed)
    row = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
    out = {"tokens": row[:, :-1].copy(), "labels": row[:, 1:].copy()}
    if cfg.family == "vlm":
        V = GRID_H * GRID_W
        out["vision_embeds"] = rng.normal(0, 1, (B, V, cfg.d_model)).astype(
            np.float32)
        out["positions_thw"] = grid_positions()
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            0, 1, (B, S // cfg.src_ratio, cfg.d_model)).astype(np.float32)
    return out


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jm = j_get_model(j_smoke(arch))
    return jax.tree.map(lambda a: a.astype(jnp.float32),
                        jax.jit(jm.init)(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The JAX loss, metrics and gradients (float32 NumPy trees), the
    parameters and the batch, on float32 parameters."""
    arch, changes = CASES[case]
    jm = j_get_model(j_smoke(arch).replace(**changes))
    jp = _jax_params(arch)
    batch = _batch(arch)
    with float32_lift(arch):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            jm.loss_fn, has_aux=True))(jp, _jnp(batch))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, jp),
            batch)


def _port(case, changes=()):
    arch, base = CASES[case]
    cfg = get_smoke_config(arch).replace(**base, **dict(changes))
    *_, jp, _ = _reference(case)
    return cfg, convert.lm_params_from_jax(cfg, jp, device="cpu")


def _loss_and_grads(cfg, params, batch):
    with float32_lift(cfg.name):
        loss, metrics = get_model(cfg).loss_fn(params, _torch(batch))
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
    if cfg.use_mla:
        assert j_metrics["aux"] > 0
    # the gradient trees convert as the parameter trees do
    want = convert.lm_params_from_jax(cfg, j_grads, device="cpu")
    assert {n for n, _ in want.named_parameters()} == set(grads)
    for name, g in want.named_parameters():
        assert float(grads[name].abs().max()) > 0, name
        np.testing.assert_allclose(grads[name].numpy(), g.detach().numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_the_vision_embeds_and_the_grid_move_the_loss():
    """The VLM loss reads both inputs: without the embeddings, or on text
    positions, it is another loss."""
    *_, batch = _reference("qwen2vl")
    cfg, params = _port("qwen2vl")
    m = get_model(cfg)
    with torch.no_grad():
        losses = [float(m.loss_fn(params, _torch(b))[0]) for b in (
            batch,
            {k: v for k, v in batch.items() if k != "vision_embeds"},
            {k: v for k, v in batch.items() if k != "positions_thw"})]
    assert abs(losses[0] - losses[1]) > 1e-3
    assert abs(losses[0] - losses[2]) > 1e-6


def _port_tree(cfg, tree):
    module = convert.lm_params_from_jax(cfg, jax.tree.map(np.asarray, tree),
                                        device="cpu")
    return {n: p.detach() for n, p in module.named_parameters()}


@pytest.mark.parametrize("arch", [VLM, MLA, ENCDEC])
def test_one_train_step_matches_the_reference(arch):
    cfg = get_smoke_config(arch)
    jp = _jax_params(arch)
    batch = _batch(arch, seed=2)
    with float32_lift(arch):
        jstate = {"params": jp,
                  "opt": jax.jit(j_steps.adamw_init)(jp)}
        js, jm = jax.jit(j_steps.make_train_step(j_smoke(arch), **SCHED))(
            jstate, _jnp(batch))
        params = _port_tree(cfg, jp)
        ts, tm = steps.make_train_step(cfg, **SCHED)(
            {"params": params, "opt": steps.adamw_init(params)},
            _torch(batch))
    assert set(tm) == set(jm) == {"loss", "lr", "ce", "z_loss", "aux",
                                  "grad_norm"}
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for part, jtree, ttree in (("params", js["params"], ts["params"]),
                               ("m", js["opt"]["m"], ts["opt"]["m"]),
                               ("v", js["opt"]["v"], ts["opt"]["v"])):
        want = _port_tree(cfg, jtree)
        assert set(want) == set(ttree)
        for n, w in want.items():
            np.testing.assert_allclose(ttree[n].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{part} {n}")
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == 1


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_changes_no_value(policy):
    """The enc-dec's encoder and decoder blocks under remat: the same loss
    and the same gradients, bit for bit."""
    *_, batch = _reference("seamless")
    cfg, params = _port("seamless")
    base = _loss_and_grads(cfg, params, batch)
    cfg_r, params_r = _port("seamless", dict(remat=True,
                                             remat_policy=policy))
    remat = _loss_and_grads(cfg_r, params_r, batch)
    assert torch.equal(base[0], remat[0])
    for name, g in base[2].items():
        assert torch.equal(g, remat[2][name]), name


@pytest.mark.parametrize("arch", [VLM, MLA, ENCDEC])
def test_a_loss_under_the_forward_only_kernel_raises(arch):
    """K4 has no backward: each of the three losses under 'pallas' raises
    NotImplementedError naming ROADMAP.md (deepseek-v2's MLA has no
    'pallas' route at all)."""
    cfg = get_smoke_config(arch).replace(attn_backend="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model(cfg).loss_fn(None, _torch(_batch(arch)))
