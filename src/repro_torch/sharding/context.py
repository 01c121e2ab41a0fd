"""Active-mesh context (a copy of ``repro.sharding.context``): lets
mesh-agnostic nn code build shardings while a program is being lowered.

The reference's only reader is the triangular attention's batch-dim
constraint (``repro.nn.attention._constrain_batch_dim0``), a sharding
annotation for XLA that changes no value. The port's attention runs eagerly,
with no sharding propagation to pin, so nothing in the port reads this
context; it is kept so code written against the reference's launch layer
runs unchanged."""

from __future__ import annotations

import contextlib

_ACTIVE = []


@contextlib.contextmanager
def activation_mesh(mesh):
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh():
    return _ACTIVE[-1] if _ACTIVE else None
