"""AdamW with float32 moments and global-norm clipping (port of
``repro.optim.adamw``).

These are the reference's formulas, not ``torch.optim.AdamW``: b2 defaults
to 0.95, the clip scale is ``min(1, max_norm / max(norm, 1e-9))`` (not
``clip_grad_norm_``'s ``max_norm / (norm + 1e-6)``), and weight decay is
applied inside the same update as the Adam step.

Parameters, gradients and moments are dicts of name -> tensor. The global
norm sums the leaves in the JAX package's tree order (nested keys sorted),
so its float32 rounding follows the reference's. The moments' dtype is the
step's arithmetic: float32 as ``adamw_init`` makes them (the reference's);
float64 moments run the whole step in float64, which isolates float32
rounding when two devices' updates are compared.
"""

from __future__ import annotations

import torch


def tree_order(names):
    """Names in ``jax.tree.leaves`` order: nested dict keys, sorted level by
    level."""
    return sorted(names, key=lambda n: n.split("."))


def adamw_init(params):
    return {
        "m": {n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in params.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32,
                            device=next(iter(params.values())).device),
    }


def global_norm(tree, dtype=torch.float32):
    total = 0
    for n in tree_order(tree):
        total = total + torch.sum(torch.square(tree[n].to(dtype)))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm, dtype=torch.float32):
    norm = global_norm(grads, dtype)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return ({n: (g.to(dtype) * scale).to(g.dtype)
             for n, g in grads.items()}, norm)


def adamw_update(params, grads, opt_state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, max_grad_norm=1.0):
    """Returns (new_params, new_opt_state, metrics). Pure: no input is
    modified."""
    dtype = next(iter(opt_state["m"].values())).dtype
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm, dtype)
    step = opt_state["step"] + 1
    sf = step.to(dtype)
    bc1 = 1.0 - torch.pow(torch.full_like(sf, b1), sf)
    bc2 = 1.0 - torch.pow(torch.full_like(sf, b2), sf)
    new_p, new_m, new_v = {}, {}, {}
    for n, p in params.items():
        gf = grads[n].to(dtype)
        m = b1 * opt_state["m"][n] + (1.0 - b1) * gf
        v = b2 * opt_state["v"][n] + (1.0 - b2) * torch.square(gf)
        mhat = m / bc1
        vhat = v / bc2
        pf = p.to(dtype)
        pf = pf - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf)
        new_p[n], new_m[n], new_v[n] = pf.to(p.dtype), m, v
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm}
