"""The port's SSD chunked scan (K5, ``kernels/ssd_scan``) against the JAX
package.

On the CPU the wrapper runs its plain version (``ref.py``, which is
``nn.ssd.ssd_chunked``); its y is held against the reference's Pallas
kernel in interpret mode (as ``tests/test_kernels.py`` runs it) over the
reference's own shape grid, and its final state against the reference's
``ssd_chunked``, which the prefill reads it from. Tolerances are the
reference's own (``tests/test_kernels.py``: atol = rtol = 1e-4 in float32,
5e-2 in bf16): the same float32 math summed in another order, and in bf16
y rounded once from float32 in both. Ragged lengths (S not a multiple of
the chunk, and S below one chunk) are held against ``ssd_chunked``, which
pads with dt = 0; the Pallas kernel asserts S % chunk == 0. The CUDA
kernel is compared with the plain version in the ``cuda``-marked tests,
which need a card."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.nn.ssd import ssd_chunked as jax_ssd_chunked

from repro_torch.kernels.ssd_scan import kernel, ops
from repro_torch.kernels.ssd_scan.ref import ssd_reference

TOL = {"float32": 1e-4, "bfloat16": 5e-2}

SSD_CASES = [
    # b, s, h, p, g, n, chunk (the reference's grid, tests/test_kernels.py)
    (2, 64, 4, 16, 1, 32, 16),
    (1, 128, 8, 8, 2, 16, 32),
    (2, 96, 2, 32, 1, 8, 48),
    (1, 64, 4, 64, 4, 64, 64),  # one chunk (no recurrence)
]
RAGGED_CASES = [
    (2, 100, 4, 16, 1, 32, 32),   # S not a multiple of the chunk
    (1, 20, 4, 16, 2, 16, 32),    # S below one chunk
]


def operands(b, s, h, p, g, n, seed):
    """The reference test's distributions: x, B, C standard normal, dt in
    [0.001, 0.1], A in [-2, -0.5]."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, h, p)).astype(np.float32),
            rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2, (h,)).astype(np.float32),
            rng.normal(0, 1, (b, s, g, n)).astype(np.float32),
            rng.normal(0, 1, (b, s, g, n)).astype(np.float32))


def _both(arrays, dtype):
    """(jax, torch) operands: x, B and C in ``dtype``, dt and A float32
    (bf16 rounding to nearest even in both)."""
    x, dt, A, B, C = arrays
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = (jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(B, jd), jnp.asarray(C, jd))
    t = (torch.from_numpy(x).to(td), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(B).to(td),
         torch.from_numpy(C).to(td))
    return j, t


def _close(got, want, dtype):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("b,s,h,p,g,n,Q", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_interpret_kernel_and_oracle_state(b, s, h, p, g, n, Q,
                                                         dtype):
    j, t = _both(operands(b, s, h, p, g, n, seed=s * 7 + p), dtype)
    want_y, _ = jax_ssd_scan(*j, chunk=Q, interpret=True)
    _, want_state = jax_ssd_chunked(*j, chunk=Q)
    before = ops.ssd_scan.launches
    y, state = ops.ssd_scan(*t, chunk=Q, return_state=True)
    assert ops.ssd_scan.launches == before  # the CPU launches nothing
    assert y.dtype == t[0].dtype and y.shape == (b, s, h, p)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    _close(y, want_y, dtype)
    _close(state, want_state, dtype)


@pytest.mark.parametrize("b,s,h,p,g,n,Q", RAGGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_lengths_match_the_padded_oracle(b, s, h, p, g, n, Q, dtype):
    j, t = _both(operands(b, s, h, p, g, n, seed=s + n), dtype)
    want_y, want_state = jax_ssd_chunked(*j, chunk=Q)
    y, state = ops.ssd_scan(*t, chunk=Q, return_state=True)
    assert y.shape == (b, s, h, p)
    _close(y, want_y, dtype)
    _close(state, want_state, dtype)


def test_state_is_returned_only_when_asked():
    _, t = _both(operands(1, 32, 2, 8, 1, 8, seed=0), "float32")
    y, state = ops.ssd_scan(*t, chunk=16)
    assert state is None
    y2, _ = ops.ssd_scan(*t, chunk=16, return_state=True)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, (x, dt, A, B, C) = _both(operands(1, 16, 4, 8, 2, 8, seed=1),
                                "float32")
    with pytest.raises(ValueError):
        ops.ssd_scan(x[0], dt, A, B, C)                   # x not 4-d
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt[:, :8], A, B, C)               # dt's length
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A[:3], B, C)                  # A's heads
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, B, C[..., :4])             # C unlike B
    with pytest.raises(ValueError):                       # 3 groups, 4 heads
        ops.ssd_scan(x, dt, A, B[:, :, :1].repeat(1, 1, 3, 1),
                     C[:, :, :1].repeat(1, 1, 3, 1))
    with pytest.raises(ValueError):
        ops.ssd_scan(x[:, :0], dt[:, :0], A, B[:, :0], C[:, :0])  # s = 0
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt, A, B.to(torch.bfloat16), C)   # mixed dtypes
    with pytest.raises(TypeError):
        ops.ssd_scan(x.double(), dt, A, B.double(), C.double())
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt.to(torch.bfloat16), A, B, C)   # dt not float32
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, B, C, chunk=0)
    with pytest.raises(ValueError):
        ops.ssd_scan(x.to("meta"), dt.to("meta"), A.to("meta"),
                     B.to("meta"), C.to("meta"))          # not CUDA or CPU


# the main path's widths (p = 64, chunk 128) at small b and s, one case each:
CUDA_SHAPES = [dict(b=2, s=256, h=4, g=1, n=128),   # mamba2's n, exact chunks
               dict(b=1, s=300, h=4, g=1, n=64),    # zamba2's n, a ragged S
               dict(b=2, s=50, h=2, g=1, n=128),    # S below a chunk
               dict(b=1, s=384, h=8, g=4, n=128),   # grouped B/C
               dict(b=1, s=256, h=2, g=1, n=32),    # the least n, half a slab
               dict(b=1, s=200, h=2, g=1, n=96),    # n across two slabs
               dict(b=1, s=384, h=4, g=2, n=256),   # the largest n, 4 slabs
               dict(b=1, s=300, h=3, g=1, n=256)]   # 3 heads a group, ragged


def _cuda_operands(shape, dtype):
    rng_args = (shape["b"], shape["s"], shape["h"], 64, shape["g"],
                shape["n"])
    _, t = _both(operands(*rng_args, seed=shape["s"]), dtype)
    return [a.cuda() for a in t]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES,
                         ids=[f"s{s['s']}h{s['h']}g{s['g']}n{s['n']}"
                              for s in CUDA_SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _cuda_operands(shape, dtype)
    before = ops.ssd_scan.launches
    y, state = ops.ssd_scan(*args, chunk=128, return_state=True)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    want_y, want_state = ssd_reference(*args, chunk=128)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(state, want_state, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
def test_cuda_kernel_takes_strided_views_and_refuses_other_widths():
    """The model passes x, B and C as views into the conv's output; the
    kernel reads them in place. It refuses head dims, chunks and state
    dims off its domain (``kernel.check_widths``)."""
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    b, s, h, g, n = 2, 200, 4, 1, 128
    x, dt, A, B, C = _cuda_operands(dict(b=b, s=s, h=h, g=g, n=n),
                                    "bfloat16")
    xbc = torch.cat([x.reshape(b, s, -1), B.reshape(b, s, -1),
                     C.reshape(b, s, -1)], dim=-1)
    xv = xbc[..., :h * 64].reshape(b, s, h, 64)
    Bv = xbc[..., h * 64:h * 64 + g * n].reshape(b, s, g, n)
    Cv = xbc[..., h * 64 + g * n:].reshape(b, s, g, n)
    assert not xv.is_contiguous()
    y, state = ops.ssd_scan(xv, dt, A, Bv, Cv, return_state=True)
    want_y, want_state = ssd_reference(x, dt, A, B, C)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=5e-2,
                               atol=5e-2)
    torch.testing.assert_close(state, want_state, rtol=5e-2, atol=5e-2)
    for what, args, chunk in (
            ("p = 136", (torch.cat([x, x, x[..., :8]], -1), dt, A, B, C),
             128),
            ("chunk 40", (x, dt, A, B, C), 40),           # not 16 | chunk
            ("chunk 272", (x, dt, A, B, C), 272),         # above 256
            ("n = 264", (x, dt, A, torch.cat([B, B, B[..., :8]], -1),
                         torch.cat([C, C, C[..., :8]], -1)), 128)):
        before = ops.ssd_scan.launches
        with pytest.raises(ValueError):
            ops.ssd_scan(*args, chunk=chunk)
        assert ops.ssd_scan.launches == before, what


@pytest.mark.cuda
def test_cuda_kernel_takes_views_on_8_byte_boundaries():
    """Sequence strides that are multiples of 4 elements but not of 8 put
    bf16 rows on 8-byte boundaries only: the kernel copies them 8 bytes at
    a time."""
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    b, s, h, g, n = 2, 300, 4, 1, 64
    x, dt, A, B, C = _cuda_operands(dict(b=b, s=s, h=h, g=g, n=n),
                                    "bfloat16")
    pad = torch.zeros((b, s, 4), dtype=x.dtype, device=x.device)
    xbc = torch.cat([x.reshape(b, s, -1), B.reshape(b, s, -1),
                     C.reshape(b, s, -1), pad], dim=-1)
    assert xbc.stride(1) % 8 == 4
    xv = xbc[..., :h * 64].reshape(b, s, h, 64)
    Bv = xbc[..., h * 64:h * 64 + g * n].reshape(b, s, g, n)
    Cv = xbc[..., h * 64 + g * n:h * 64 + 2 * g * n].reshape(b, s, g, n)
    before = ops.ssd_scan.launches
    y, state = ops.ssd_scan(xv, dt, A, Bv, Cv, return_state=True)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    want_y, want_state = ssd_reference(x, dt, A, B, C)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=5e-2,
                               atol=5e-2)
    torch.testing.assert_close(state, want_state, rtol=5e-2, atol=5e-2)


# chunks above 128 and head dims above 64: the plain version against the
# reference's kernel in interpret mode (y) and its oracle (the state), the
# reference's Q = min(chunk, s) taken at s >= chunk
WIDE_CASES = [
    # b, s, h, p, g, n, chunk
    (1, 512, 2, 32, 1, 32, 256),
    (1, 256, 2, 128, 1, 32, 128),
    (1, 512, 2, 128, 1, 16, 256),
    (1, 288, 2, 16, 1, 24, 144),
]


@pytest.mark.parametrize("b,s,h,p,g,n,Q", WIDE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_chunks_and_head_dims_match_interpret_kernel(b, s, h, p, g, n,
                                                          Q, dtype):
    j, t = _both(operands(b, s, h, p, g, n, seed=s + p + Q), dtype)
    kernel.check_widths(p, n, Q)
    want_y, _ = jax_ssd_scan(*j, chunk=Q, interpret=True)
    _, want_state = jax_ssd_chunked(*j, chunk=Q)
    y, state = ops.ssd_scan(*t, chunk=Q, return_state=True)
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    _close(y, want_y, dtype)
    _close(state, want_state, dtype)


# widths off the kernel's step of 8: the wrapper's zero columns (as it adds
# them on CUDA: x's p, B's and C's n), the plain version, and the slice,
# against the reference at the true widths
PADDED_CASES = [
    # b, s, h, p, g, n, chunk, padded p, padded n
    (1, 128, 2, 12, 1, 20, 32, 16, 24),
    (2, 96, 4, 12, 2, 20, 48, 16, 24),
    (1, 256, 2, 100, 1, 30, 256, 104, 32),
]


@pytest.mark.parametrize("b,s,h,p,g,n,Q,pp,nn", PADDED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_widths_match_interpret_kernel(b, s, h, p, g, n, Q, pp, nn,
                                              dtype):
    j, t = _both(operands(b, s, h, p, g, n, seed=s + n), dtype)
    want_y, _ = jax_ssd_scan(*j, chunk=Q, interpret=True)
    _, want_state = jax_ssd_chunked(*j, chunk=Q)
    x, dt, A, B, C = t
    xp, Bp, Cp = ops.pad_widths(x, B, C)
    assert xp.shape[3] == pp and Bp.shape[3] == Cp.shape[3] == nn
    kernel.check_widths(pp, nn, Q)
    with pytest.raises(ValueError):
        kernel.check_widths(p, n, Q)
    yp, sp = ssd_reference(xp, dt, A, Bp, Cp, chunk=Q)
    # the zero columns stay zero: y's past p, the state's past p and n
    assert not yp[..., p:].any()
    assert not sp[:, :, p:].any() and not sp[..., n:].any()
    _close(yp[..., :p], want_y, dtype)
    _close(sp[:, :, :p, :n], want_state, dtype)
    y, state = ops.ssd_scan(*t, chunk=Q, return_state=True)
    torch.testing.assert_close(y.float(), yp[..., :p].float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(state, sp[:, :, :p, :n], rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_width_and_chunk_domain():
    for p, n, chunk in ((8, 8, 16), (16, 16, 16), (64, 128, 64),
                        (40, 72, 48), (64, 256, 128), (24, 200, 112),
                        (72, 128, 128), (64, 128, 144), (64, 128, 256),
                        (128, 128, 128), (128, 256, 256), (120, 8, 240)):
        kernel.check_widths(p, n, chunk)
    for p, n, chunk in ((136, 128, 128), (4, 16, 16), (12, 16, 16),
                        (64, 260, 128), (64, 12, 128), (64, 0, 128),
                        (64, 128, 40), (64, 128, 8), (64, 128, 272),
                        (256, 128, 128), (64, 264, 256), (64, 128, 264)):
        with pytest.raises(ValueError):
            kernel.check_widths(p, n, chunk)
    with pytest.raises(ValueError, match="up to 256"):
        kernel.check_widths(64, 128, 272)
    with pytest.raises(ValueError, match="up to 128"):
        kernel.check_widths(136, 128, 128)
    with pytest.raises(ValueError, match="up to 256"):
        kernel.check_widths(64, 264, 128)


# the domain on the card: SMOKE mamba2's widths at chunk 16, chunk 64 at
# the path's widths, and other chunks, head dims and state dims off the
# 64-column panels, ragged S, groups
CUDA_DOMAIN_SHAPES = [
    dict(b=2, s=64, h=8, p=16, g=1, n=16, chunk=16),     # SMOKE mamba2
    dict(b=1, s=300, h=4, p=64, g=1, n=128, chunk=64),   # ragged
    dict(b=1, s=256, h=2, p=8, g=1, n=8, chunk=32),
    dict(b=1, s=200, h=4, p=40, g=2, n=72, chunk=48),
    dict(b=1, s=250, h=3, p=64, g=1, n=200, chunk=80),   # n over 4 slabs
    dict(b=2, s=100, h=2, p=24, g=1, n=96, chunk=112),
    dict(b=1, s=384, h=2, p=56, g=1, n=136, chunk=128),
    dict(b=1, s=20, h=2, p=16, g=1, n=16, chunk=16),     # one ragged chunk
    # chunks of two row tiles: 256 (Codestral's n and groups, ragged S),
    # 144 and 240 (row tiles of 72 and 120 rows), one chunk below S; head
    # dims of two 64-column blocks (128, 72) at chunk 128 and 256 with the
    # largest n; widths off the step of 8, padded by the wrapper
    dict(b=1, s=600, h=4, p=64, g=2, n=128, chunk=256),
    dict(b=2, s=300, h=2, p=64, g=1, n=64, chunk=144),
    dict(b=1, s=500, h=3, p=32, g=1, n=256, chunk=240),
    dict(b=1, s=100, h=2, p=64, g=1, n=128, chunk=256),
    dict(b=1, s=384, h=2, p=128, g=1, n=128, chunk=128),
    dict(b=1, s=520, h=2, p=128, g=1, n=256, chunk=256),
    dict(b=1, s=300, h=2, p=72, g=1, n=96, chunk=176),
    dict(b=2, s=130, h=4, p=12, g=2, n=20, chunk=64),
    dict(b=1, s=256, h=2, p=100, g=1, n=30, chunk=256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_DOMAIN_SHAPES,
                         ids=[f"s{s['s']}p{s['p']}n{s['n']}q{s['chunk']}"
                              for s in CUDA_DOMAIN_SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_over_its_domain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dims = [shape[k] for k in ("b", "s", "h", "p", "g", "n")]
    _, t = _both(operands(*dims, seed=shape["s"] + shape["n"]), dtype)
    args = [a.cuda() for a in t]
    before = ops.ssd_scan.launches
    y, state = ops.ssd_scan(*args, chunk=shape["chunk"], return_state=True)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    want_y, want_state = ssd_reference(*args, chunk=shape["chunk"])
    assert state.shape == want_state.shape
    torch.testing.assert_close(y.float(), want_y.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(state, want_state, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 4], ids=["tma", "cp_async"])
def test_cuda_kernel_takes_views_at_two_row_tiles(pad):
    """Codestral's mixer widths cut to 2 heads (p = 64, one group of n =
    128) at chunk 256 and a p = 128 head at chunk 144, as views into one
    buffer on 16-byte row boundaries (TMA) and on 8-byte ones (cp.async),
    with a ragged S."""
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    for b, s, h, p, g, n, chunk in ((1, 600, 2, 64, 1, 128, 256),
                                    (1, 300, 2, 128, 1, 64, 144)):
        _, t = _both(operands(b, s, h, p, g, n, seed=pad + p), "bfloat16")
        x, dt, A, B, C = [a.cuda() for a in t]
        tail = torch.zeros((b, s, pad), dtype=x.dtype, device=x.device)
        xbc = torch.cat([x.reshape(b, s, -1), B.reshape(b, s, -1),
                         C.reshape(b, s, -1), tail], dim=-1)
        xv = xbc[..., :h * p].reshape(b, s, h, p)
        Bv = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
        Cv = xbc[..., h * p + g * n:h * p + 2 * g * n].reshape(b, s, g, n)
        y, state = ops.ssd_scan(xv, dt, A, Bv, Cv, chunk=chunk,
                                return_state=True)
        want_y, want_state = ssd_reference(x, dt, A, B, C, chunk=chunk)
        torch.testing.assert_close(y.float(), want_y.float(), rtol=5e-2,
                                   atol=5e-2)
        torch.testing.assert_close(state, want_state, rtol=5e-2, atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 4], ids=["tma", "cp_async"])
def test_cuda_kernel_takes_smoke_views_at_chunk_16(pad):
    """SMOKE mamba2's mixer: x, B and C views into the conv's output at
    p = n = 16, chunk 16, on 16-byte row boundaries (TMA boxes of 16 rows)
    and on 8-byte ones (cp.async)."""
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    b, s, h, p, g, n = 2, 64, 8, 16, 1, 16
    _, t = _both(operands(b, s, h, p, g, n, seed=pad), "bfloat16")
    x, dt, A, B, C = [a.cuda() for a in t]
    tail = torch.zeros((b, s, pad), dtype=x.dtype, device=x.device)
    xbc = torch.cat([x.reshape(b, s, -1), B.reshape(b, s, -1),
                     C.reshape(b, s, -1), tail], dim=-1)
    xv = xbc[..., :h * p].reshape(b, s, h, p)
    Bv = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
    Cv = xbc[..., h * p + g * n:h * p + 2 * g * n].reshape(b, s, g, n)
    y, state = ops.ssd_scan(xv, dt, A, Bv, Cv, chunk=16, return_state=True)
    want_y, want_state = ssd_reference(x, dt, A, B, C, chunk=16)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=5e-2,
                               atol=5e-2)
    torch.testing.assert_close(state, want_state, rtol=5e-2, atol=5e-2)
