"""The fixed summation order of the contention kernel (K3,
``csrc/contention.cu``), emulated in plain PyTorch and held against the JAX
package at the kernel's tolerance.

The CUDA kernel cannot run here, so this emulation shows on the CPU that
the order in which the kernel adds its flows keeps it within 2e-5 of the
reference (``chip_smoke.py`` phase 7's limit, the reference's own for this
kernel). The kernel's sums over the F flows of one (env, substep):

- F <= 32: G = the next power of two >= F lanes, one flow each (the rest
  zero), folded by an xor butterfly: lane p adds lane p ^ G/2, then
  p ^ G/4, ... which is the halves of the vector added, repeatedly.
- F > 32: CL blocks of T threads (``launch_shape``: the instance's block
  size or F rounded up to a warp, and the smallest power-of-two cluster up
  to 8 that holds F flows on chip); thread t of the cluster owns flows
  t + k * CL * T and adds them in k order from 0; each warp folds its 32
  partials as above; the block's warp totals (zeros past the last warp, 32
  in all) are folded the same way; then every thread adds the blocks'
  totals in rank order.
- More flows than a cluster of 8 holds on chip: the same sums, with each
  thread walking its flows in a loop (``"stream"``). There the water-fill
  carries per (link, stage) the prefix Q_r of spill / wt over the rounds
  instead of each flow's alloc: an uncapped flow's alloc after round r is
  a0 + eff * Q_r, and a flow that reaches its headroom stays there.

Every other operation is the plain version's, element by element. The
emulation is held against the reference's ``contention_rates_reference``
and its Pallas kernel in interpret mode (as ``tests/test_kernels.py`` runs
it), env by env, and against the port's plain version. On a card the
``cuda``-marked test holds the kernel to the emulation bit for bit. The
emulation is a test helper: no path of the port runs it."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.kernels.contention.ops import contention_rates as jax_kernel
from repro.kernels.contention.ref import contention_rates_reference as jax_ref

from repro_torch.kernels.contention.ref import contention_rates_reference

ATOL = 2e-5            # chip_smoke.py phase 7, tests/test_torch_contention.py
# (threads, on-chip flows a thread) of the block kernel, by (template link
# count, objectives): csrc/contention.cu BlockShape
BLOCK_SHAPE = {(1, False): (1024, 4), (1, True): (512, 4),
               (2, False): (512, 2), (2, True): (512, 2),
               (3, False): (256, 2), (3, True): (256, 2),
               (4, False): (256, 1), (4, True): (256, 1),
               (8, False): (256, 1), (8, True): (256, 1)}
MAX_CLUSTER = 8


def launch_shape(F, L, objectives):
    """The kernel's launch for F flows at L links: ("group", G) for
    F <= 32, else (layout, T, CL, K) with K flows a thread, layout "block"
    where the cluster holds them on chip and "stream" past that."""
    if F <= 32:
        G = 1
        while G < F:
            G *= 2
        return ("group", G)
    threads, flows = BLOCK_SHAPE[(L if L <= 4 else 8, bool(objectives))]
    T = min(threads, -(-F // 32) * 32)
    cl = 1
    while cl < MAX_CLUSTER and cl * T * flows < F:
        cl *= 2
    layout = "block" if cl * T * flows >= F else "stream"
    return (layout, T, cl, -(-F // (cl * T)))


def _fold(x):
    """The xor butterfly over the last axis (a power of two): its halves
    added until one value is left."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def ordered_sum(x, shape):
    """Sum x (E, S, F, ...) over the flow axis in the kernel's order for
    ``shape`` (``launch_shape``'s result)."""
    x = x.movedim(2, -1)
    F = x.shape[-1]
    pad = lambda n: torch.nn.functional.pad(x, (0, n - F))
    if shape[0] == "group":
        return _fold(pad(shape[1]))
    _, T, cl, K = shape
    nt = cl * T
    slots = pad(K * nt).reshape(*x.shape[:-1], K, nt)
    part = torch.zeros_like(slots[..., 0, :])
    for k in range(K):                       # a thread's flows, in k order
        part = part + slots[..., k, :]
    warps = _fold(part.reshape(*x.shape[:-1], cl, T // 32, 32))
    block = _fold(torch.nn.functional.pad(warps, (0, 32 - T // 32)))
    if cl == 1:
        return block[..., 0]
    total = torch.zeros_like(block[..., 0])
    for r in range(cl):                      # block totals, in rank order
        total = total + block[..., r]
    return total


def contention_order_emulation(threads, act, onpath, tpt, bw, floor=None,
                               cap=None, *, rounds=0):
    """``ref.contention_rates_reference`` with every sum over flows taken
    in the kernel's order (both floor and cap, or neither), and past what
    a cluster holds on chip the water-fill in the kernel's prefix form."""
    F, L = act.shape[2], onpath.shape[-1]
    shape = launch_shape(F, L, floor is not None)
    osum = lambda x: ordered_sum(x, shape)
    eff = (threads[:, None, :, None, :] * act[..., None, None]
           * onpath[..., None])                          # (E, S, F, L, 3)
    total = torch.clamp_min(osum(eff), 1e-9)             # (E, S, L, 3)
    share = eff / total[:, :, None]
    if floor is None:
        link_rate = torch.minimum(eff * tpt[:, :, None],
                                  share * bw[:, :, None])
    else:
        cap_b = cap[:, None, :, None, None]
        demand = torch.minimum(eff * tpt[:, :, None], cap_b)
        guaranteed = torch.minimum(floor[:, None, :, None, None], demand)
        g_tot = osum(guaranteed)
        guaranteed = guaranteed * torch.clamp_max(
            bw / torch.clamp_min(g_tot, 1e-9), 1.0)[:, :, None]
        residual = torch.clamp_min(bw - osum(guaranteed), 0.0)
        alloc = share * residual[:, :, None]
        headroom = cap_b - guaranteed
        if shape[0] == "stream":
            alloc = _prefix_water_fill(alloc, eff, headroom, osum, rounds)
            rounds = 0
        for _ in range(rounds):
            spill = osum(torch.clamp_min(alloc - headroom, 0.0))
            alloc = torch.minimum(alloc, headroom)
            w = torch.where(alloc < headroom, eff, torch.zeros_like(eff))
            w_tot = torch.clamp_min(osum(w), 1e-9)
            alloc = alloc + (w / w_tot[:, :, None]) * spill[:, :, None]
        if rounds:
            alloc = torch.minimum(alloc, headroom)
        link_rate = torch.minimum(demand, guaranteed + alloc)
    constraining = torch.where(onpath[..., None] > 0, link_rate,
                               torch.full_like(link_rate, float("inf")))
    rate = constraining.amin(dim=3)
    has_path = onpath.sum(dim=3) > 0
    return (torch.where(has_path[..., None], rate, torch.zeros_like(rate))
            * act[..., None])


def _prefix_water_fill(a0, eff, headroom, osum, rounds):
    """The water-fill of the kernel's streamed layout: round r adds up the
    spill of the flows that reach their headroom in it and the eff of those
    below it, and moves Q (E, S, L, 3) by spill / wt; a flow's alloc is
    a0 + eff * Q until it reaches its headroom. The rounds stop once no
    (link, stage) spills (every later round would change nothing)."""
    if not rounds:
        return a0
    zero = torch.zeros_like(eff)
    q1 = torch.zeros_like(osum(eff))          # Q_{r-1}
    q2 = q1                                   # Q_{r-2}
    for r in range(1, rounds + 1):
        u1 = a0 + eff * q1[:, :, None]
        fresh = (a0 + eff * q2[:, :, None] < headroom) | (r == 1)
        spill = osum(torch.where(fresh, torch.clamp_min(u1 - headroom, 0.0),
                                 zero))
        w_tot = torch.clamp_min(osum(torch.where(u1 < headroom, eff, zero)),
                                1e-9)
        q1, q2 = q1 + spill / w_tot, q1
        if not bool((spill > 0).any()):
            break
    return torch.minimum(a0 + eff * q1[:, :, None], headroom)


def spilling(x):
    """x with no floors and the capped flows' caps below a fair share of a
    link (about 4 / F of its bw), so the water-fill has spill to move."""
    F = x["act"].shape[2]
    rng = np.random.default_rng(F)
    capped = np.isfinite(x["cap"])
    return dict(x, floor=np.zeros_like(x["floor"]),
                cap=np.where(capped, rng.uniform(0.2, 2.0, capped.shape) / F,
                             np.inf).astype(np.float32))


def operands(seed, *, E, S, F, L):
    """tests/test_torch_contention.py's operand distribution; the one-link
    embedding (onpath all ones) at L = 1, as the fleet runs it."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    x = dict(
        threads=f32(rng.integers(1, 30, (E, F, 3))),
        act=f32(rng.integers(0, 2, (E, S, F))),
        onpath=f32(rng.integers(0, 2, (E, S, F, L))),
        tpt=f32(rng.uniform(0.02, 0.5, (E, S, L, 3))),
        bw=f32(rng.uniform(0.1, 2.0, (E, S, L, 3))),
        floor=f32(rng.uniform(0.0, 1.5, (E, F))),
        cap=f32(np.where(rng.random((E, F)) < 0.5, np.inf,
                         rng.uniform(0.05, 1.5, (E, F)))))
    if L == 1:
        x["onpath"][:] = 1.0
    return x


def _args(x, objectives, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    return ([t[k] for k in ("threads", "act", "onpath", "tpt", "bw")]
            + ([t["floor"], t["cap"]] if objectives else [None, None]))


def _hold_against_reference(x, objectives, rounds):
    got = contention_order_emulation(*_args(x, objectives),
                                     rounds=rounds).numpy()
    plain = contention_rates_reference(*_args(x, objectives),
                                       rounds=rounds).numpy()
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=0)
    for e in range(got.shape[0]):
        args = [jnp.asarray(x[k][e]) for k in
                ("threads", "act", "onpath", "tpt", "bw")]
        fl, cp = ((jnp.asarray(x["floor"][e]), jnp.asarray(x["cap"][e]))
                  if objectives else (None, None))
        want = np.asarray(jax_ref(*args, fl, cp, rounds=rounds))
        interp = np.asarray(jax_kernel(*args, fl, cp, rounds=rounds))
        np.testing.assert_allclose(got[e], want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[e], interp, atol=ATOL, rtol=0)


# tests/test_torch_contention.py CUDA_SHAPES, the shapes chip_smoke.py
# phase 7 runs: the fleet's training batch, the scale-out fleet dense and
# compact, and a topology-shaped solve with water-filling
CUDA_SHAPES = [dict(E=16, S=50, F=4, L=1, rounds=0),
               dict(E=1, S=50, F=4096, L=1, rounds=0),
               dict(E=1, S=50, F=256, L=1, rounds=0),
               dict(E=4, S=50, F=8, L=3, rounds=8)]
# the edges of the cuda-marked tests: one flow, the first flow count past a
# lane group, 257 flows (one block at 2 and 3 links); rounds = F
EDGE_SHAPES = [dict(E=2, S=4, F=F, L=L, rounds=F)
               for F in (1, 33, 257) for L in (2, 3)]
# flow counts that take a cluster of 2, 4 and 8 blocks with objectives (600
# at 3 links; 600 and 2048 at 4), and 2100 at 4 links, past what a cluster
# of 8 holds on chip (the streamed layout); the caps make the water-fill
# spill (``spilling``)
CLUSTER_SHAPES = [dict(E=1, S=3, F=600, L=3, rounds=4),
                  dict(E=1, S=3, F=600, L=4, rounds=4),
                  dict(E=1, S=2, F=2048, L=4, rounds=4),
                  dict(E=1, S=2, F=2100, L=4, rounds=8)]
# the compact topology's solve (chip_smoke.py phase 19): A flows over 3
# links in one block, floors and finite caps, rounds = A
COMPACT_SHAPES = [dict(E=1, S=3, F=40, L=3, rounds=40),
                  dict(E=1, S=2, F=256, L=3, rounds=256)]


def floored(x):
    """``spilling`` with floors kept, at a tenth of a fair share of a link
    or less, as the compact topology's capped solve has them."""
    F = x["act"].shape[2]
    rng = np.random.default_rng(F + 1)
    floor = rng.uniform(0.0, 0.1, x["floor"].shape) / F
    return dict(spilling(x), floor=floor.astype(np.float32))


@pytest.mark.parametrize("objectives", [False, True])
@pytest.mark.parametrize("shape", CUDA_SHAPES,
                         ids=[f"E{s['E']}F{s['F']}L{s['L']}"
                              for s in CUDA_SHAPES])
def test_emulated_order_fits_the_tolerance(shape, objectives):
    x = operands(shape["F"], E=shape["E"], S=shape["S"], F=shape["F"],
                 L=shape["L"])
    _hold_against_reference(x, objectives, shape["rounds"])


@pytest.mark.parametrize("objectives", [False, True])
@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=[f"F{s['F']}L{s['L']}" for s in EDGE_SHAPES])
def test_emulated_order_fits_the_tolerance_at_the_edges(shape, objectives):
    x = operands(shape["F"] + shape["L"], E=shape["E"], S=shape["S"],
                 F=shape["F"], L=shape["L"])
    _hold_against_reference(x, objectives, shape["rounds"])


@pytest.mark.parametrize("shape", CLUSTER_SHAPES,
                         ids=[f"F{s['F']}L{s['L']}" for s in CLUSTER_SHAPES])
def test_emulated_order_fits_the_tolerance_in_clusters(shape):
    """With objectives and a water-fill that moves spill in every round it
    runs: in clusters of 2, 4 and 8, and in the streamed layout, whose
    prefix form of the water-fill is held to the reference here."""
    F, L = shape["F"], shape["L"]
    x = spilling(operands(F + L, E=shape["E"], S=shape["S"], F=F, L=L))
    args = _args(x, True)
    moved = contention_rates_reference(*args, rounds=shape["rounds"])
    still = contention_rates_reference(*args, rounds=0)
    assert float((moved - still).abs().max()) > 1e-4   # it spilled
    _hold_against_reference(x, True, shape["rounds"])


@pytest.mark.parametrize("shape", COMPACT_SHAPES,
                         ids=[f"F{s['F']}L{s['L']}" for s in COMPACT_SHAPES])
def test_emulated_order_fits_the_tolerance_on_the_compact_topology(shape):
    """The compact topology's layout: one block of A flows over 3 links,
    floors and finite caps below a fair share, ``rounds = A`` spill rounds
    that move bandwidth."""
    F, L = shape["F"], shape["L"]
    x = floored(operands(F + L, E=shape["E"], S=shape["S"], F=F, L=L))
    assert launch_shape(F, L, True)[:3] == ("block", -(-F // 32) * 32, 1)
    args = _args(x, True)
    moved = contention_rates_reference(*args, rounds=shape["rounds"])
    still = contention_rates_reference(*args, rounds=0)
    assert float((moved - still).abs().max()) > 1e-4   # it spilled
    assert float(x["floor"].min()) < float(x["floor"].max())
    _hold_against_reference(x, True, shape["rounds"])


@pytest.mark.parametrize("F,L,objectives,layout", [
    (1, 1, False, ("group", 1)), (5, 2, True, ("group", 8)),
    (32, 3, False, ("group", 32)), (33, 1, False, ("block", 64, 1, 1)),
    (257, 3, True, ("block", 256, 1, 2)),
    (40, 3, True, ("block", 64, 1, 1)), (256, 3, True, ("block", 256, 1, 1)),
    (4096, 3, True, ("block", 256, 8, 2)),
    (1000, 2, False, ("block", 512, 1, 2)),
    (4096, 1, False, ("block", 1024, 1, 4)),
    (4096, 1, True, ("block", 512, 2, 4)),
    (600, 4, True, ("block", 256, 4, 1)),
    (2048, 8, True, ("block", 256, 8, 1)),
    (600, 3, True, ("block", 256, 2, 2)),
    (2100, 4, False, ("stream", 256, 8, 2)),
    (2100, 4, True, ("stream", 256, 8, 2))])
def test_ordered_sum_adds_every_flow_once(F, L, objectives, layout):
    """The launch each shape takes, and each flow landing in exactly one
    slot of one thread: a one-hot row sums to one wherever the one sits,
    and all ones to F."""
    shape = launch_shape(F, L, objectives)
    assert shape == layout
    got = ordered_sum(torch.eye(F)[None], shape)   # row s: the one at s
    assert torch.equal(got, torch.ones(1, F))
    assert float(ordered_sum(torch.ones(1, 1, F), shape)) == F


def test_prefix_water_fill_stops_where_the_rounds_change_nothing():
    """The streamed layout's early stop: once no (link, stage) spills, more
    rounds give the same bits."""
    x = spilling(operands(3, E=1, S=2, F=2100, L=4))
    args = _args(x, True)
    few = contention_order_emulation(*args, rounds=40)
    many = contention_order_emulation(*args, rounds=400)
    assert torch.equal(few, many)


def test_order_differs_from_a_plain_sum():
    """The emulation is not the plain sum under another name: at the
    scale-out's 4096 flows the two differ in the last bits."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 50, 4096)).astype(np.float32))
    got = ordered_sum(x, launch_shape(4096, 1, False))
    assert not torch.equal(got, x.sum(dim=2))
    torch.testing.assert_close(got, x.double().sum(dim=2).float(),
                               atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES + EDGE_SHAPES + CLUSTER_SHAPES
                         + COMPACT_SHAPES,
                         ids=[f"E{s['E']}F{s['F']}L{s['L']}R{s['rounds']}"
                              for s in CUDA_SHAPES + EDGE_SHAPES
                              + CLUSTER_SHAPES + COMPACT_SHAPES])
def test_cuda_kernel_is_the_emulation_bit_for_bit(shape):
    """On a card: the kernel's output equals the emulation's on the same
    CUDA tensors, so the order emulated here is the order the kernel
    takes: in lane groups, in one block, in clusters of 2, 4 and 8 blocks
    (CLUSTER_SHAPES with objectives), in the streamed layout, and on the
    compact topology's floors and caps (COMPACT_SHAPES)."""
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    from repro_torch.kernels.contention import kernel
    F, L = shape["F"], shape["L"]
    x = operands(F + L, E=shape["E"], S=shape["S"], F=F, L=L)
    if shape in CLUSTER_SHAPES:
        x = spilling(x)
    if shape in COMPACT_SHAPES:
        x = floored(x)
    for objectives in (False, True):
        args = _args(x, objectives, "cuda")
        got = kernel.launch(*args, rounds=shape["rounds"])
        want = contention_order_emulation(*args, rounds=shape["rounds"])
        torch.cuda.synchronize()
        assert torch.equal(got, want), float((got - want).abs().max())
