"""AutoMDT-tuned input data pipeline (a copy of ``repro.data.pipeline``;
only its imports and ``InputPipeline.next_batch``, which hands out torch
tensors on a device, differ).

The training input path has the same 3-stage shape as a file transfer:
storage -> host staging (read), cross-host routing (network), host -> device
feed (write). We drive it with the SAME TransferEngine and let an AutoMDT
controller (or a static/Marlin baseline) tune the three concurrencies, so
the paper's technique is a first-class feature of the training framework.

Source = deterministic synthetic corpus (one chunk = one tokenized sequence
row). Sink assembles rows into (batch, seq) token matrices and exposes
next_batch() for the train loop; labels are the 1-shifted tokens.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.transfer.engine import TransferEngine, StageThrottle


class SyntheticTokenSource:
    """Deterministic pseudo-corpus: chunk i = int32 tokens of sequence row i."""

    def __init__(self, vocab, seq, total_rows, seed=0):
        self.vocab = vocab
        self.seq = seq
        self.total = total_rows
        self.seed = seed
        self._next = 0
        self._lock = threading.Lock()

    def row(self, i):
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        return rng.integers(0, self.vocab, size=self.seq + 1, dtype=np.int32)

    def next_chunk(self):
        with self._lock:
            if self._next >= self.total:
                return None
            i = self._next
            self._next += 1
        return i, self.row(i).tobytes()

    def exhausted(self):
        with self._lock:
            return self._next >= self.total


class BatchSink:
    """Reassembles rows into (B, S) batches; the engine's write stage is the
    host->device feed."""

    def __init__(self, batch, seq, *, max_ready=4):
        self.batch = batch
        self.seq = seq
        self._rows = []
        self._lock = threading.Lock()
        self._ready = queue.Queue(maxsize=max_ready)

    def write_chunk(self, cid, payload):
        row = np.frombuffer(payload, dtype=np.int32)
        with self._lock:
            self._rows.append(row)
            if len(self._rows) >= self.batch:
                rows = self._rows[:self.batch]
                self._rows = self._rows[self.batch:]
                mat = np.stack(rows)
            else:
                return
        self._ready.put(mat)  # blocks when the device is behind (backpressure)

    def next_batch(self, timeout=60.0):
        mat = self._ready.get(timeout=timeout)
        return {"tokens": mat[:, :-1], "labels": mat[:, 1:]}


class InputPipeline:
    def __init__(self, *, vocab, batch, seq, total_rows, controller=None,
                 throttles=(None, None, None), sender_buf=32 << 20,
                 receiver_buf=32 << 20, initial_concurrency=(2, 2, 2),
                 n_max=32, metric_interval=0.25, seed=0):
        self.source = SyntheticTokenSource(vocab, seq, total_rows, seed=seed)
        self.sink = BatchSink(batch, seq)
        self.engine = TransferEngine(
            self.source, self.sink, sender_buf=sender_buf,
            receiver_buf=receiver_buf, throttles=throttles,
            initial_concurrency=initial_concurrency, n_max=n_max,
            metric_interval=metric_interval)
        self.controller = controller
        self._stop = threading.Event()
        self._ctrl_thread = None
        if controller is not None:
            self._ctrl_thread = threading.Thread(target=self._ctrl_loop,
                                                 daemon=True)
            self._ctrl_thread.start()

    def _ctrl_loop(self):
        interval = self.engine.metric_interval
        while not self._stop.is_set() and not self.engine.done():
            obs = self.engine.observe()
            if hasattr(self.controller, "step"):        # AutoMDT
                n = self.controller.step(obs)
            else:                                        # Marlin/Globus
                n = self.controller.update(obs["throughputs"])
            self.engine.set_concurrency(n)
            self._stop.wait(interval)

    def next_batch(self, timeout=60.0, *, device=None):
        """The next {"tokens", "labels"} (B, S) int32 tensors on ``device``
        (None: the CUDA device)."""
        import torch
        from repro_torch.device import resolve_device
        device = resolve_device(device)
        host = self.sink.next_batch(timeout=timeout)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in host.items()}

    def observe(self):
        return self.engine.observe()

    def close(self):
        self._stop.set()
        if self._ctrl_thread:
            self._ctrl_thread.join(timeout=1.0)
        self.engine.close()
