"""Atomic, sha256-verified checkpoints of NumPy state (the on-disk format of
``repro.checkpoint``, without JAX).

Layout per checkpoint: ``<dir>/step_<N>/ckpt.bin + manifest.json``. The
state is a nested dict (or list) of arrays; each leaf becomes a contiguous
byte span of one blob, indexed by its "/"-joined key path in sorted-key
order, so a checkpoint written by either package reads back in the other.
Writes go to a temporary directory renamed into place; ``keep`` old
checkpoints are retained. The blob is written directly; the reference's
engine-pumped save (``use_engine=True``) is not ported.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np


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


def _rebuild(like, arrays, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, arrays, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, arrays, prefix + (str(i),))
                          for i, v in enumerate(like))
    return arrays["/".join(prefix)]


def serialize_state(state):
    """-> (blob bytes, index list). Index entry: [path, dtype, shape, off, n]."""
    index, parts, off = [], [], 0
    for path, leaf in _leaves(state):
        arr = np.asarray(leaf)
        raw = arr.tobytes()
        index.append([path, str(arr.dtype), list(arr.shape), off, len(raw)])
        parts.append(raw)
        off += len(raw)
    return b"".join(parts), index


def deserialize_state(blob, index, like):
    """Rebuild the state with ``like``'s structure and the manifest's dtypes
    and shapes."""
    arrays = {}
    for path, dtype, shape, off, n in index:
        arrays[path] = np.frombuffer(blob[off:off + n],
                                     dtype=np.dtype(dtype)).reshape(shape)
    return _rebuild(like, arrays)


def save_checkpoint(ckpt_dir, state, step, *, keep=3, use_engine=False):
    """Returns the checkpoint path. Blocking. ``use_engine=True`` (the
    reference's save through a TransferEngine) raises NotImplementedError."""
    if use_engine:
        raise NotImplementedError("the engine-pumped checkpoint save lands "
                                  "with the async checkpointer's slice")
    os.makedirs(ckpt_dir, exist_ok=True)
    blob, index = serialize_state(state)
    digest = hashlib.sha256(blob).hexdigest()
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "ckpt.bin"), "wb") as f:
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


def load_checkpoint(ckpt_dir, like, *, step=None):
    """-> (state, step). Verifies sha256."""
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
    return deserialize_state(blob, manifest["index"], like), step
