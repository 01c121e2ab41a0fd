"""Exploration & logging phase (§IV-A).

A short "random-threads" run: every interval we set random thread counts
<n_r, n_n, n_w> and record per-stage throughputs <T_r, T_n, T_w>. From the log:

    B_i   = max T_i                  (stage bandwidth)
    TPT_i = max T_i / n_i            (throughput per thread)
    b     = min(B_r, B_n, B_w)       (end-to-end bottleneck)
    n_i*  = b / TPT_i                (threads to hit b, near-linear scaling)
    R_max = b * (k^-n_r* + k^-n_n* + k^-n_w*)

Works against anything exposing ``probe(threads) -> [T_r, T_n, T_w]`` — the
dense simulator (``SimEnv``, optionally under a schedule table's opening
bin — see repro.scenarios.evaluate.exploration_baseline), the event oracle,
or the real TransferEngine. ``bandwidth.max()`` is the natural ``bw_ref``
observation-normalization reference to hand an AutoMDTController.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.utility import r_max as _r_max, K_DEFAULT


@dataclass
class ExplorationResult:
    bandwidth: np.ndarray   # (3,) B_i
    tpt: np.ndarray         # (3,) TPT_i
    bottleneck: float       # b
    n_star: np.ndarray      # (3,) float
    r_max: float
    log: list               # [(threads, throughputs)]

    def n_star_int(self):
        return np.maximum(np.ceil(self.n_star - 1e-6), 1).astype(int)


def explore(probe_fn, *, n_samples=600, n_max=100, k=K_DEFAULT, seed=0,
            warmup_per_sample=0):
    """probe_fn(threads (3,)) -> throughputs (3,). ``n_samples`` defaults to
    the paper's 10-minute run at 1-second intervals."""
    rng = np.random.default_rng(seed)
    log = []
    B = np.zeros(3)
    TPT = np.zeros(3)
    for _ in range(n_samples):
        n = rng.integers(1, n_max + 1, size=3)
        tps = np.asarray(probe_fn(n.astype(float)), dtype=float)
        log.append((n.copy(), tps.copy()))
        B = np.maximum(B, tps)
        TPT = np.maximum(TPT, tps / np.maximum(n, 1))
    b = float(B.min())
    n_star = b / np.maximum(TPT, 1e-12)
    return ExplorationResult(bandwidth=B, tpt=TPT, bottleneck=b,
                             n_star=n_star, r_max=_r_max(b, n_star, k=k),
                             log=log)
