"""The port's train step against the JAX package's ``repro.launch.steps``:
the LR schedules step for step (to one float32 ulp: XLA's cos and torch's
differ in the last place now and then), one ``make_train_step`` step (params,
AdamW moments, grad norm, lr) within 1e-5, five steps on five fixed
batches within 1e-4, and the memorization trend on one fixed batch (the
loss falls, in step with the reference's), all on the SMOKE smollm-135m in
float32 with the JAX parameters carried across by ``convert``; then
``init_state`` and ``state_shape``, and that a step leaves its input state
untouched. Gradient norms agree only to float32 rounding: the port sums
the per-layer leaves, the reference one stacked leaf per parameter."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(2)

from repro.configs import get_smoke_config as j_smoke
from repro.launch import steps as j_steps
from repro.optim import schedules as j_sched

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.optim import schedules

ARCH = "smollm-135m"
B, S = 4, 32
# the reference's peak lr (3e-4): Adam's first step is lr * g / (|g| + eps),
# so a gradient element near eps moves its parameter by a fraction of lr
# on float32 rounding alone; at 3e-4 with this warmup that stays under 1e-5
SCHED = dict(peak_lr=3e-4, warmup_steps=5, total_steps=40)


def _batches(n, vocab, seed=2):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, vocab, (n, B, S + 1), dtype=np.int32)
    return [{"tokens": r[:, :-1].copy(), "labels": r[:, 1:].copy()}
            for r in rows]


@functools.lru_cache(maxsize=None)
def _reference_state():
    state = jax.jit(functools.partial(j_steps.init_state, j_smoke(ARCH)))(
        jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, state)


def _port_tree(cfg, tree):
    """A reference (stacked) parameter-shaped tree -> the port's
    {name: tensor}."""
    module = convert.lm_params_from_jax(cfg, jax.tree.map(np.asarray, tree),
                                        device="cpu")
    return {n: p.detach() for n, p in module.named_parameters()}


def _port_state(cfg, jstate):
    opt = jstate["opt"]
    return {"params": _port_tree(cfg, jstate["params"]),
            "opt": {"m": _port_tree(cfg, opt["m"]),
                    "v": _port_tree(cfg, opt["v"]),
                    "step": torch.tensor(int(opt["step"]),
                                         dtype=torch.int32)}}


def _run_both(batches, **sched):
    """The reference's and the port's steps over ``batches`` from the same
    state: (reference states and metrics, port states and metrics)."""
    cfg = get_smoke_config(ARCH)
    jstep = jax.jit(j_steps.make_train_step(j_smoke(ARCH), **sched))
    tstep = steps.make_train_step(cfg, **sched)
    js = _reference_state()
    ts = _port_state(cfg, js)
    jout, tout = [], []
    for b in batches:
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        jout.append((js, jm))
        tout.append((ts, tm))
    return cfg, jout, tout


def _assert_state_close(cfg, jstate, tstate, tol):
    for part, jtree, ttree in (
            ("params", jstate["params"], tstate["params"]),
            ("m", jstate["opt"]["m"], tstate["opt"]["m"]),
            ("v", jstate["opt"]["v"], tstate["opt"]["v"])):
        want = _port_tree(cfg, jtree)
        assert set(want) == set(ttree)
        for n, w in want.items():
            np.testing.assert_allclose(ttree[n].numpy(), w.numpy(), rtol=0,
                                       atol=tol, err_msg=f"{part} {n}")
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"])


@pytest.mark.parametrize("warmup,total", [(5, 40), (100, 30), (0, 10),
                                          (10, 10)])
def test_schedules_equal_the_reference_at_every_step(warmup, total):
    s = np.arange(0, total + 15, dtype=np.int32)
    for name, kw in (("cosine_schedule", dict(total_steps=total)),
                     ("linear_warmup", {})):
        want = np.asarray(getattr(j_sched, name)(
            jnp.asarray(s), peak_lr=3e-4, warmup_steps=warmup, **kw))
        got = getattr(schedules, name)(
            torch.from_numpy(s), peak_lr=3e-4, warmup_steps=warmup, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=0,
                                   err_msg=name)


def test_one_train_step_matches_the_reference():
    cfg, jout, tout = _run_both(_batches(1, 512), **SCHED)
    (js, jm), (ts, tm) = jout[0], tout[0]
    _assert_state_close(cfg, js, ts, 1e-5)
    assert set(tm) == {"loss", "lr", "ce", "z_loss", "aux", "grad_norm"}
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-12, err_msg=k)


def test_five_steps_on_fixed_batches_match_the_reference():
    cfg, jout, tout = _run_both(_batches(5, 512), **SCHED)
    for (js, jm), (ts, tm) in zip(jout, tout):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    _assert_state_close(cfg, jout[-1][0], tout[-1][0], 1e-4)


def test_memorization_trend_on_one_fixed_batch():
    """R3's sanity floor: with a short warmup the loss on one fixed batch
    falls, step for step with the reference's."""
    batch = _batches(1, 512, seed=7)[0]
    _, jout, tout = _run_both([batch] * 16, peak_lr=3e-4, warmup_steps=2,
                              total_steps=16)
    jl = np.array([float(m["loss"]) for _, m in jout])
    tl = np.array([float(m["loss"]) for _, m in tout])
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0] - 0.5
    assert np.all(np.diff(tl[2:]) < 0)


def test_init_state_and_state_shape():
    cfg = get_smoke_config(ARCH)
    a = steps.init_state(cfg, 3, device="cpu")
    b = steps.init_state(cfg, 3, device="cpu")
    c = steps.init_state(cfg, 4, device="cpu")
    shape = steps.state_shape(cfg)
    assert all(torch.equal(a["params"][n], b["params"][n])
               for n in a["params"])
    assert not torch.equal(a["params"]["embed.embed"],
                           c["params"]["embed.embed"])
    assert a["opt"]["step"].dtype == torch.int32 and int(a["opt"]["step"]) == 0
    for part in ("m", "v"):
        assert all(t.dtype == torch.float32 and not t.any()
                   for t in a["opt"][part].values())
    for n, p in a["params"].items():
        s = shape["params"][n]
        assert s.device.type == "meta" and (s.shape, s.dtype) == (p.shape,
                                                                  p.dtype)
        assert shape["opt"]["m"][n].shape == p.shape
    j_shape = j_steps.state_shape(j_smoke(ARCH))
    assert (sum(x.size for x in jax.tree.leaves(j_shape))
            == sum(t.numel() for part in ("m", "v")
                   for t in shape["opt"][part].values())
            + sum(t.numel() for t in shape["params"].values()) + 1)


def test_a_step_leaves_its_input_untouched():
    cfg = get_smoke_config(ARCH)
    state = steps.init_state(cfg, 0, device="cpu")
    before = {n: t.clone() for n, t in state["params"].items()}
    step = steps.make_train_step(cfg, **SCHED)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1, 512)[0].items()}
    new, metrics = step(state, batch)
    assert all(torch.equal(before[n], state["params"][n]) for n in before)
    assert int(state["opt"]["step"]) == 0 and int(new["opt"]["step"]) == 1
    assert any(not torch.equal(before[n], new["params"][n]) for n in before)
    assert all(not t.requires_grad for t in new["params"].values())
    assert torch.isfinite(metrics["loss"])
