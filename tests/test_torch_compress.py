"""The port's int8 gradient compression (``runtime/compress.py``) against
the JAX package's on the same NumPy-drawn ``{name: tensor}`` gradients:
``quantize_dequantize_int8`` bit for bit on float32 and on bf16 trees
(both quantize in float32, round half to even and cast back to the
gradient's dtype), the int8 codes and scales, ``int8_roundtrip_error``
within float32 rounding of its sums (1e-6 relative), three calls of the
error-feedback compressor bit for bit (its residual kept in the
gradients' dtype, as ``g + r`` and ``g - out`` keep it in both), and one
``make_train_step(compress_fn=)`` step of the SMOKE smollm-135m in
float32 against the reference's."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(2)

from repro.configs import get_smoke_config as j_smoke
from repro.launch import steps as j_steps
from repro.models import get_model as j_get_model
from repro.runtime import compress as j_compress

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.runtime import compress, int8_roundtrip_error, \
    make_int8_compressor

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _grads(seed, dtype):
    """A gradient tree in the reference's layout, stacks of layers
    included (``layers``: 3 layers whose magnitudes differ by 10x, so the
    stack's shared scale matters; ``groups``: 2 x 2), several scales, a
    zero tensor (the scale's 1e-12 floor) and a tensor whose codes fall on
    halves (2.5 rounds to 2, 3.5 to 4). Returns the reference's nested
    tree and the port's {name: tensor} of the same values."""
    rng = np.random.default_rng(seed)
    wq = rng.normal(0, 1e-3, (3, 48, 32)) * 10.0 ** np.arange(3)[:, None,
                                                                 None]
    tree = {"layers": {"attn": {"wq": {"w": wq}},
                       "ffn_norm": {"scale": rng.normal(0, 2.0, (3, 32))}},
            "groups": {"mixer": {"D": rng.normal(0, 1.0, (2, 2, 8))}},
            "embed": {"embed": rng.standard_t(3, (64, 16)) * 1e-2},
            "zero": np.zeros((5,)),
            "halves": np.array([127.0, 2.5, 3.5, -2.5, -3.5, 0.5, -0.5])}
    j_dt, t_dt = DTYPES[dtype]
    j = jax.tree.map(lambda a: jnp.asarray(a, j_dt), tree)
    t = {n: torch.from_numpy(a).to(t_dt) for n, a in _port_names(j).items()}
    return j, t


def _port_names(jtree):
    """The reference's tree -> {port name: float32 array}, each stack
    unstacked as ``convert.lm_params_from_jax`` unstacks it."""
    out = {}
    for name, a in convert.flatten_tree(jtree).items():
        a = np.array(a, np.float32)
        stack, _, rest = name.partition(".")
        depth = convert._STACKS.get(stack, 0)
        if not depth:
            out[name] = a
            continue
        for idx in np.ndindex(*a.shape[:depth]):
            out[".".join([stack, *map(str, idx), rest])] = a[idx].copy()
    return out


def _equal(jtree, ttree):
    want = _port_names(jtree)
    j_dt = {str(a.dtype) for a in jax.tree.leaves(jtree)}.pop()
    assert set(want) == set(ttree)
    for n, w in want.items():
        assert ttree[n].dtype == DTYPES[j_dt][1], n
        np.testing.assert_array_equal(ttree[n].float().numpy(), w,
                                      err_msg=n)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_dequantize_is_the_reference_bit_for_bit(dtype):
    j, t = _grads(0, dtype)
    _equal(j_compress.quantize_dequantize_int8(j),
           compress.quantize_dequantize_int8(t))
    out = compress.quantize_dequantize_int8(t)
    assert float(out["zero"].abs().max()) == 0
    assert out["halves"].float().tolist() == [127.0, 2.0, 4.0, -2.0, -4.0,
                                              0.0, -0.0]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_codes_and_scales_are_the_reference_s(dtype):
    """One scale per reference leaf: the layers of a stack share the
    stacked array's, bit for bit; codes times scale is the reference's
    round trip."""
    j, t = _grads(1, dtype)
    codes, scales = compress.int8_codes(t)
    flat = convert.flatten_tree(j)
    for n, g in t.items():
        _, want_scale = j_compress._qdq(flat[convert.reference_name(n)])
        assert codes[n].dtype == torch.int8 and codes[n].shape == g.shape
        assert scales[n].dtype == torch.float32
        assert float(scales[n]) == float(want_scale), n
        assert int(codes[n].abs().max()) <= 127
    dq = {n: (codes[n].float() * scales[n]).to(g.dtype)
          for n, g in t.items()}
    _equal(j_compress.quantize_dequantize_int8(j), dq)
    assert len({float(scales[f"layers.{i}.attn.wq.w"])
                for i in range(3)}) == 1


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_roundtrip_error_matches_the_reference(dtype):
    j, t = _grads(2, dtype)
    want = float(j_compress.int8_roundtrip_error(j))
    got = int8_roundtrip_error(t)
    assert got.dtype == torch.float32 and 0 < float(got) < 0.05
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_error_feedback_over_three_calls_is_the_reference_s(dtype):
    j_fn = j_compress.make_int8_compressor(error_feedback=True)
    t_fn = make_int8_compressor(error_feedback=True)
    assert make_int8_compressor() is compress.quantize_dequantize_int8
    outs = []
    for call in range(3):
        j, t = _grads(10 + call, dtype)
        outs.append(t_fn(t))
        _equal(j_fn(j), outs[-1])
    # the residual moved the second call off the plain round trip
    _, t = _grads(11, dtype)
    plain = compress.quantize_dequantize_int8(t)
    assert any(not torch.equal(plain[n], outs[1][n]) for n in plain)


@functools.lru_cache(maxsize=None)
def _reference_state(arch):
    state = jax.jit(functools.partial(j_steps.init_state, j_smoke(arch)))(
        jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, state)


def _port_tree(cfg, tree):
    module = convert.lm_params_from_jax(cfg, jax.tree.map(np.asarray, tree),
                                        device="cpu")
    return {n: p.detach() for n, p in module.named_parameters()}


def test_train_step_with_the_compressor_matches_the_reference():
    """One step of the SMOKE smollm-135m with the int8 hook, from the same
    float32 state and batch: loss and metrics within 1e-5 relative, params
    and AdamW moments within 1e-5 (``test_torch_train_step``'s limits),
    and the hook moved the step off the uncompressed one."""
    arch = "smollm-135m"
    sched = dict(peak_lr=3e-4, warmup_steps=5, total_steps=40)
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(4)
    row = rng.integers(0, cfg.vocab, (4, 33), dtype=np.int32)
    batch = {"tokens": row[:, :-1].copy(), "labels": row[:, 1:].copy()}
    js = _reference_state(arch)
    js, jm = jax.jit(j_steps.make_train_step(
        j_smoke(arch), compress_fn=j_compress.make_int8_compressor(),
        **sched))(js, {k: jnp.asarray(v) for k, v in batch.items()})
    init = _reference_state(arch)
    state = {"params": _port_tree(cfg, init["params"]),
             "opt": steps.adamw_init(_port_tree(cfg, init["params"]))}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ts, tm = steps.make_train_step(cfg, compress_fn=make_int8_compressor(),
                                   **sched)(state, tb)
    plain, _ = steps.make_train_step(cfg, **sched)(state, tb)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for part, jtree, ttree in (("params", js["params"], ts["params"]),
                               ("m", js["opt"]["m"], ts["opt"]["m"]),
                               ("v", js["opt"]["v"], ts["opt"]["v"])):
        for n, w in _port_tree(cfg, jtree).items():
            np.testing.assert_allclose(ttree[n].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{part} {n}")
    assert any(not torch.equal(plain["opt"]["m"][n], ts["opt"]["m"][n])
               for n in ts["opt"]["m"])
