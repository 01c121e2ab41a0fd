"""Globus-style baseline: a MONOLITHIC static configuration. One concurrency
value serves read, network and write alike (the coupling the paper's §III
criticizes), fixed for the whole transfer — the paper's comparison used
concurrency=4, parallelism=8 with globus-url-copy. Static values are chosen
conservatively because aggressive settings create end-system overhead, which
is exactly why fixed configurations underutilize fast links."""

from __future__ import annotations

import numpy as np


class GlobusController:
    def __init__(self, *, concurrency=4, parallelism=8):
        self.concurrency = concurrency
        self.parallelism = parallelism

    def update(self, throughputs):
        return self.current()

    def current(self):
        # monolithic: the same socket threads do read/transfer/write
        n = self.concurrency
        return np.array([n, n, n], dtype=int)
