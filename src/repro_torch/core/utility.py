"""The paper's utility function (§IV-B) and the per-flow objective layer
(port of ``repro.core.utility``).

    U(n, t) = U_read + U_network + U_write,   U_i = t_i / k^{n_i}

k = 1.02 as in the paper. ``flow_utility`` scales each flow's utility by a
priority weight, and ``deadline_penalty`` is the smooth softplus hinge on a
flow's goodput deficit against the rate it still needs.
"""

from __future__ import annotations

import numpy as np
import torch

K_DEFAULT = 1.02


def stage_utility(t, n, *, k=K_DEFAULT):
    """t: throughput, n: thread count (tensors)."""
    return t / torch.pow(torch.as_tensor(k, dtype=torch.float32,
                                         device=n.device), n)


def utility(throughputs, threads, *, k=K_DEFAULT):
    """throughputs/threads: (..., 3) for (read, network, write)."""
    k = torch.as_tensor(k, dtype=torch.float32, device=threads.device)
    return torch.sum(throughputs / torch.pow(k, threads), dim=-1)


def r_max(bottleneck, n_star, *, k=K_DEFAULT):
    """Theoretical maximum reward (§IV-E):
    R_max = b * (k^-n_r* + k^-n_n* + k^-n_w*). Host-side, in float32."""
    n_star = torch.as_tensor(np.asarray(n_star), dtype=torch.float32)
    k = torch.as_tensor(k, dtype=torch.float32)
    return float(bottleneck * torch.sum(torch.pow(k, -n_star)))


def needed_rate(demand, delivered, deadline, t, *, min_horizon=1.0):
    """Rate a flow still NEEDS to finish ``demand`` by ``deadline``:
    (demand - delivered) / (deadline - t), the time window clamped to
    ``min_horizon``. Flows without a finite deadline AND demand need exactly
    0.0 — the double mask keeps inf/inf out of the value path."""
    demand = torch.as_tensor(demand, dtype=torch.float32)
    deadline = torch.as_tensor(deadline, dtype=torch.float32,
                               device=demand.device)
    remaining = torch.clamp_min(demand - delivered, 0.0)
    time_left = torch.clamp_min(deadline - t, min_horizon)
    finite = torch.isfinite(deadline) & torch.isfinite(demand)
    zero = torch.zeros((), dtype=torch.float32, device=demand.device)
    return torch.where(finite, torch.where(finite, remaining, zero) / time_left,
                       zero)


def needed_rate_np(demand, delivered, deadline, t, *, min_horizon=1.0):
    """NumPy twin of ``needed_rate`` for the live controller's hot path:
    the same float32 program, including the double-where mask."""
    demand = np.asarray(demand, np.float32)
    deadline = np.asarray(deadline, np.float32)
    delivered = np.asarray(delivered, np.float32)
    t = np.float32(t)
    remaining = np.maximum(demand - delivered, np.float32(0.0))
    time_left = np.maximum(deadline - t, np.float32(min_horizon))
    finite = np.isfinite(deadline) & np.isfinite(demand)
    return np.where(finite,
                    np.where(finite, remaining, np.float32(0.0)) / time_left,
                    np.float32(0.0))


def deadline_penalty(goodput, needed, *, scale=1.0, sharp=8.0):
    """Smooth deadline-miss hinge ``scale * softplus(sharp * deficit /
    scale) / sharp``, with softplus as log(1 + e^x) (``jax.nn.softplus``),
    not torch's thresholded form."""
    x = (needed - goodput) / scale
    y = sharp * x
    return scale * torch.logaddexp(y, torch.zeros_like(y)) / sharp


def flow_utility(throughputs, threads, *, weight=None, k=K_DEFAULT):
    """(F,) per-flow paper utility, optionally priority-weighted; with
    ``weight=None`` exactly ``utility`` per flow."""
    u = utility(throughputs, threads, k=k)
    if weight is None:
        return u
    return torch.as_tensor(weight, dtype=torch.float32, device=u.device) * u
