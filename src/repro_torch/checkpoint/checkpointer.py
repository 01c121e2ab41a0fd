"""Checkpointing through the modular transfer engine (port of
``repro.checkpoint``, without JAX).

Serialize: the state (nested dicts and lists of tensors, NumPy arrays or
scalars) is flattened by key path in sorted-key order (``jax.tree`` order);
each leaf becomes a contiguous byte span of one blob, indexed by its
"/"-joined path. The blob is then pumped through a 3-stage TransferEngine
(device->host staging = read, staging -> store route = network,
fsync/commit = write) whose concurrency an AutoMDT controller can tune, or
written directly with ``use_engine=False``; the bytes on disk are the same.
``AsyncCheckpointer`` keeps the save off the training loop.

Layout per checkpoint: ``<dir>/step_<N>/ckpt.bin + manifest.json``.
Writes are atomic (tmp dir + rename); ``keep`` old checkpoints are
retained; the blob's sha256 is verified on restore. A bf16 leaf is stored
as its raw 2-byte words under the dtype string ``"bfloat16"`` (the
reference's), so a checkpoint written by either package reads back in the
other. A DTensor leaf is saved as its full tensor, and ``load_checkpoint``'s
``shardings`` lays the restored leaves onto a mesh
(``repro_torch.runtime.elastic``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.transfer.engine import TransferEngine, FileSink

BF16 = "bfloat16"


class _BlobSource:
    def __init__(self, blob, chunk_bytes=4 << 20):
        self.blob = blob
        self.chunk = chunk_bytes
        self._off = 0
        self._lock = threading.Lock()

    def next_chunk(self):
        with self._lock:
            if self._off >= len(self.blob):
                return None
            off = self._off
            n = min(self.chunk, len(self.blob) - off)
            self._off += n
        return off, self.blob[off:off + n]

    def exhausted(self):
        with self._lock:
            return self._off >= len(self.blob)


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in sorted-key order (``jax.tree`` order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _map(fn, tree):
    """``tree`` with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _rebuild(like, arrays, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, arrays, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, arrays, prefix + (str(i),))
                          for i, v in enumerate(like))
    arr = arrays["/".join(prefix)]
    if isinstance(like, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            arr.copy())
        return t.to(like.device)
    return arr


def _full(leaf):
    """A DTensor leaf's full tensor; any other leaf as it is."""
    if "torch.distributed.tensor" not in sys.modules:
        return leaf   # no DTensor can exist yet
    from repro_torch.runtime.elastic import full_tensor
    return full_tensor(leaf)


def _host(leaf):
    """A host copy of one leaf: a CPU tensor for a tensor (a DTensor's full
    tensor), else a NumPy array."""
    if isinstance(leaf, torch.Tensor):
        return _full(leaf).detach().to("cpu", copy=True)
    return np.array(leaf)


def _leaf_bytes(leaf):
    """-> (raw bytes, dtype string, shape)."""
    if isinstance(leaf, torch.Tensor):
        t = _full(leaf).detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), BF16, list(t.shape)
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr.tobytes(), str(arr.dtype), list(arr.shape)


def serialize_state(state):
    """-> (blob bytes, index list). Index entry: [path, dtype, shape, off, n]."""
    index, parts, off = [], [], 0
    for path, leaf in _leaves(state):
        raw, dtype, shape = _leaf_bytes(leaf)
        index.append([path, dtype, shape, off, len(raw)])
        parts.append(raw)
        off += len(raw)
    return b"".join(parts), index


def deserialize_state(blob, index, like):
    """Rebuild the state with ``like``'s structure and the manifest's dtypes
    and shapes. A leaf whose ``like`` is a tensor comes back as a tensor on
    that tensor's device; any other leaf as a NumPy array, except that a
    bf16 leaf (which NumPy cannot hold) is a CPU bf16 tensor."""
    arrays = {}
    for path, dtype, shape, off, n in index:
        raw = blob[off:off + n]
        if dtype == BF16:
            words = np.frombuffer(raw, dtype=np.int16).reshape(shape)
            arrays[path] = torch.from_numpy(words.copy()).view(torch.bfloat16)
        else:
            arrays[path] = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(
                shape)
    return _rebuild(like, arrays)


def save_checkpoint(ckpt_dir, state, step, *, keep=3, controller=None,
                    throttles=(None, None, None), chunk_bytes=4 << 20,
                    use_engine=True):
    """Returns the checkpoint path. Blocking (AsyncCheckpointer wraps this)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    blob, index = serialize_state(state)
    digest = hashlib.sha256(blob).hexdigest()
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    bin_path = os.path.join(tmp, "ckpt.bin")

    if use_engine:
        src = _BlobSource(blob, chunk_bytes)
        sink = FileSink(bin_path)
        eng = TransferEngine(src, sink, throttles=throttles,
                             initial_concurrency=(2, 2, 2),
                             metric_interval=0.2)
        try:
            while not eng.done():
                if controller is not None:
                    eng.set_concurrency(controller.step(eng.observe()))
                time.sleep(0.02)
        finally:
            eng.close()
            sink.close()
    else:
        with open(bin_path, "wb") as f:
            f.write(blob)

    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "sha256": digest, "index": index}, f)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)

    for s in sorted(latest_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
    return final


def latest_steps(ckpt_dir):
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.startswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
    return out


def latest_step(ckpt_dir):
    steps = latest_steps(ckpt_dir)
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir, like, *, step=None, shardings=None):
    """-> (state, step). Verifies sha256. ``shardings`` (optional tree of
    ``repro_torch.sharding.rules.Sharding``, e.g. ``to_shardings`` of the
    specs) lays each leaf onto its mesh and placements after the check:
    the elastic-scaling restore path. Every rank of the meshes reads the
    checkpoint and calls this alike."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(d, "ckpt.bin"), "rb") as f:
        blob = f.read()
    if hashlib.sha256(blob).hexdigest() != manifest["sha256"]:
        raise IOError(f"checkpoint {d} corrupt: sha mismatch")
    state = deserialize_state(blob, manifest["index"], like)
    if shardings is not None:
        from repro_torch.runtime.elastic import apply_shardings
        state = apply_shardings(state, shardings)
    return state, step


class AsyncCheckpointer:
    """Non-blocking saves: the caller's host snapshot happens inline (a
    device-to-host copy), serialization + engine transfer run on a worker
    thread. ``wait()`` drains; at most one save in flight (newer supersedes
    queued). ``saves`` records each finished save as {"step", "bytes",
    "snapshot_s", "seconds"}: the inline snapshot's time and the worker's
    (serialize, sha256, the engine, the rename)."""

    def __init__(self, ckpt_dir, *, keep=3, controller=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.controller = controller
        self._pending = None
        self._lock = threading.Lock()
        self._thread = None
        self.last_error = None
        self.saves = []

    def save(self, state, step):
        t0 = time.perf_counter()
        snapshot = _map(_host, state)
        snapshot_s = time.perf_counter() - t0
        with self._lock:
            self._pending = (snapshot, step, snapshot_s)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._drain, daemon=True)
                self._thread.start()

    def _drain(self):
        while True:
            with self._lock:
                if self._pending is None:
                    return
                snapshot, step, snapshot_s = self._pending
                self._pending = None
            try:
                t0 = time.perf_counter()
                save_checkpoint(self.ckpt_dir, snapshot, step, keep=self.keep,
                                controller=self.controller)
                self.saves.append({
                    "step": step, "bytes": sum(
                        x.nbytes for _, x in _leaves(snapshot)),
                    "snapshot_s": snapshot_s,
                    "seconds": time.perf_counter() - t0})
            except Exception as e:  # surfaced via last_error + wait()
                self.last_error = e

    def wait(self):
        t = self._thread
        if t is not None:
            t.join()
        # hand the error off exactly once — a failed save must not poison
        # every later wait() after subsequent saves succeeded
        err, self.last_error = self.last_error, None
        if err:
            raise err
