"""Marlin baseline (ICS'23): the prior modular-architecture SOTA. Three
INDEPENDENT single-variable gradient-descent optimizers, one per stage, each
maximizing its own stage utility U_i = t_i / k^{n_i} by finite-difference
hill climbing on its own concurrency.

This reproduces Marlin's characteristic instability: each stage's utility
depends on the other stages through the staging buffers (paper Fig. 1), so
per-stage gradients are misleading — e.g. read throughput stops responding to
read concurrency once the sender buffer fills, and the optimizer oscillates
(paper Fig. 5, second row). No fix is attempted here; that IS the baseline.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.utility import K_DEFAULT


class MarlinOptimizer:
    def __init__(self, *, n_start=(2, 2, 2), n_max=100, k=K_DEFAULT,
                 step_init=2.0, step_min=1.0, seed=0):
        self.n = np.asarray(n_start, dtype=float)
        self.n_max = n_max
        self.k = k
        self.prev_u = None
        self.prev_n = self.n.copy()
        self.direction = np.ones(3)
        self.step_size = np.full(3, step_init)
        self.step_min = step_min
        self.rng = np.random.default_rng(seed)

    def _stage_utility(self, throughputs):
        return np.asarray(throughputs) / (self.k ** self.n)

    def update(self, throughputs):
        """Feed the latest per-stage throughputs; returns next (n_r,n_n,n_w).
        Each stage runs its own 1-D gradient sign step."""
        u = self._stage_utility(throughputs)
        if self.prev_u is None:
            self.prev_u = u
            self.prev_n = self.n.copy()
            self.n = np.clip(self.n + self.direction * self.step_size, 1, self.n_max)
            return self.n.astype(int)
        dn = self.n - self.prev_n
        du = u - self.prev_u
        for i in range(3):
            if abs(dn[i]) > 1e-9:
                grad = du[i] / dn[i]
                if grad > 0:
                    self.step_size[i] = min(self.step_size[i] * 1.25, 8.0)
                else:
                    self.direction[i] = -self.direction[i]
                    self.step_size[i] = max(self.step_size[i] * 0.5, self.step_min)
            else:
                # no movement -> probe in the current direction
                self.step_size[i] = max(self.step_size[i], self.step_min)
        self.prev_u = u
        self.prev_n = self.n.copy()
        self.n = np.clip(self.n + self.direction * self.step_size, 1, self.n_max)
        return self.n.astype(int)

    def current(self):
        return self.n.astype(int)
