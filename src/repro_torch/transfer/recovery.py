"""Liveness-fault resilience for the live pipeline.

Three layers, matching the sim's fault compilation in
``repro.scenarios.faults``:

  * **Retry + circuit breaker** (``RetryPolicy`` / ``CircuitBreaker`` /
    ``acquire_with_retry``): an opt-in replacement for the blocking
    ``StageThrottle``/``PathGate`` acquire — non-blocking ``try_acquire``
    polls under exponential backoff, and a per-stage breaker OPENs after a
    run of consecutive refusals (a stage hang / link blackout) so parked
    workers poll the cooldown clock instead of hammering the bucket lock,
    then HALF_OPENs a single probe to detect recovery. Pass
    ``TransferEngine(..., retry=RetryPolicy())`` to enable; the default
    (None) is the original blocking acquire, untouched.

  * **Delivered-byte cursor** (``FlowCursor`` / ``CursorSink``): the
    receiver-side record of exactly which byte ranges have been written.
    ``SyntheticSource``/``FileSink`` chunk ids ARE byte offsets, so
    the cursor is an interval set keyed by them. It lives with the SINK —
    an engine crash (kill_flow) loses in-flight buffers, never the cursor.

  * **Checkpointed restart** (``save_cursor`` / ``load_cursor`` /
    ``ResumableSource`` / ``CheckpointedFlow``): the cursor persists
    through ``repro.checkpoint`` (atomic, sha256-verified), and a restart
    builds a source over the COMPLEMENT of the delivered set — every
    missing chunk is re-read (no lost bytes), every delivered chunk is
    skipped (no replayed bytes). Property-pinned in
    tests/test_recovery.py: after kill + restart the delivered intervals
    cover [0, total) exactly once and the ChecksumSink digest equals the
    uninterrupted reference.

    Caveat: the IN-PROCESS cursor is exact; the on-disk checkpoint is as
    fresh as the last ``checkpoint()`` call. A cold (cross-process)
    restart re-sends anything delivered after that — idempotent for the
    offset-addressed ``FileSink``, but counted as replay by the property.
    Checkpoint on kill (``CheckpointedFlow.kill`` does) or periodically.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import numpy as np

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclass
class RetryPolicy:
    """Knobs for ``acquire_with_retry``: exponential backoff between
    ``try_acquire`` polls, and the breaker's trip threshold / cooldown."""

    base_backoff: float = 0.005   # first retry sleep, seconds
    max_backoff: float = 0.1      # backoff ceiling
    failure_threshold: int = 8    # consecutive refusals that OPEN the breaker
    cooldown: float = 0.25        # seconds OPEN before a HALF_OPEN probe


class CircuitBreaker:
    """Three-state breaker around a throttle acquire. CLOSED passes every
    attempt; ``failure_threshold`` CONSECUTIVE refusals OPEN it for
    ``cooldown`` seconds (``allow()`` returns False — callers park);
    after the cooldown one probe is let through (HALF_OPEN): success
    re-CLOSEs, refusal re-OPENs for another cooldown. Thread-safe; one
    breaker is shared by all workers of a stage."""

    def __init__(self, failure_threshold=8, cooldown=0.25):
        self.failure_threshold = int(failure_threshold)
        self.cooldown = float(cooldown)
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self):
        with self._lock:
            return self._state

    def allow(self):
        """May an acquire attempt proceed right now? OPEN answers False
        until the cooldown lapses, then admits exactly ONE probe (the
        half-open contract) until that probe reports back."""
        with self._lock:
            if self._state == HALF_OPEN:
                if self._probing:
                    return False       # one probe outstanding — hold
                self._probing = True
                return True
            if self._state != OPEN:
                return True
            if time.monotonic() - self._opened_at < self.cooldown:
                return False
            if self._probing:
                return False
            self._state = HALF_OPEN
            self._probing = True
            return True

    def record_success(self):
        with self._lock:
            self._state = CLOSED
            self._failures = 0
            self._probing = False

    def record_failure(self):
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == HALF_OPEN \
                    or self._failures >= self.failure_threshold:
                self._state = OPEN
                self._opened_at = time.monotonic()
                self._failures = 0


def acquire_with_retry(throttle, nbytes, *, policy: RetryPolicy,
                       breaker: CircuitBreaker = None, should_abort=None):
    """Retry-with-backoff twin of ``StageThrottle.acquire``: poll the
    non-blocking ``try_acquire`` under exponential backoff, reporting each
    outcome to the breaker; while the breaker is OPEN, park on the
    cooldown clock instead of polling the bucket. Returns the per-thread
    pacing sleep on grant, or None once ``should_abort()`` turns true
    (engine shutdown) — the same contract as the blocking acquire, so
    ``TransferEngine._worker`` is agnostic. Throttles without
    ``try_acquire`` (e.g. ``FlowGate``) fall back to their blocking
    acquire, with the breaker recording the outcome coarsely."""
    probe = getattr(throttle, "try_acquire", None)
    if probe is None:
        sleep = throttle.acquire(nbytes, should_abort)
        if breaker is not None:
            (breaker.record_success if sleep is not None
             else breaker.record_failure)()
        return sleep
    backoff = policy.base_backoff
    while True:
        if should_abort is not None and should_abort():
            return None
        if breaker is not None and not breaker.allow():
            time.sleep(min(policy.cooldown, 0.05))  # sliced: abort-aware
            continue
        sleep = probe(nbytes)
        if sleep is not None:
            if breaker is not None:
                breaker.record_success()
            return sleep
        if breaker is not None:
            breaker.record_failure()
        time.sleep(backoff)
        backoff = min(backoff * 2.0, policy.max_backoff)


# ---------------------------------------------------------------------------
# Delivered-byte cursor
# ---------------------------------------------------------------------------


class FlowCursor:
    """Thread-safe record of delivered byte ranges [off, off+n). Intervals
    are kept merged and sorted; ``replayed`` counts bytes added twice (the
    no-replay property asserts it stays 0)."""

    def __init__(self, total_bytes, intervals=()):
        self.total = int(total_bytes)
        self._lock = threading.Lock()
        self._iv = []           # sorted, disjoint [start, end) pairs
        self.replayed = 0
        for s, e in intervals:
            self.add(int(s), int(e) - int(s))

    def add(self, off, n):
        if n <= 0:
            return
        start, end = int(off), int(off) + int(n)
        with self._lock:
            merged, overlap = [], 0
            for s, e in self._iv:
                if e < start or s > end:
                    merged.append((s, e))
                else:  # touching or overlapping: merge, count true overlap
                    overlap += max(0, min(e, end) - max(s, start))
                    start, end = min(s, start), max(e, end)
            merged.append((start, end))
            merged.sort()
            self._iv = merged
            self.replayed += overlap

    def intervals(self):
        with self._lock:
            return tuple(self._iv)

    def delivered_bytes(self):
        with self._lock:
            return sum(e - s for s, e in self._iv)

    def missing(self):
        """The complement of the delivered set within [0, total)."""
        gaps, pos = [], 0
        for s, e in self.intervals():
            if s > pos:
                gaps.append((pos, s))
            pos = max(pos, e)
        if pos < self.total:
            gaps.append((pos, self.total))
        return tuple(gaps)

    def complete(self):
        return self.intervals() == ((0, self.total),) if self.total \
            else True


class CursorSink:
    """Wrap any sink so every successfully written chunk is recorded in a
    ``FlowCursor``. Chunk ids must be int byte offsets (``SyntheticSource``
    / ``ResumableSource`` / the checkpointer's ``_BlobSource``)."""

    def __init__(self, inner, cursor: FlowCursor):
        self.inner = inner
        self.cursor = cursor

    def write_chunk(self, cid, payload):
        self.inner.write_chunk(cid, payload)   # raises -> nothing recorded
        self.cursor.add(int(cid), len(payload))

    def __getattr__(self, name):  # close(), digest(), path, ...
        return getattr(self.inner, name)


class ResumableSource:
    """``SyntheticSource`` twin that yields only the chunks NOT yet
    delivered: same chunk grid (cid = byte offset, offsets on multiples of
    ``chunk_bytes``), same deterministic payload bytes, but offsets inside
    ``skip`` are never produced. A restart over the cursor's intervals
    therefore re-reads every missing chunk exactly once and replays
    nothing — byte-for-byte the chunks an uninterrupted run would have
    produced (``ChecksumSink.reference`` agrees).

    ``skip`` intervals must sit on the chunk grid (whole chunks delivered
    or not at all — ``sink.write_chunk`` is atomic per chunk, so a crashed
    engine can't leave a half-delivered chunk)."""

    def __init__(self, total_bytes, chunk_bytes=1 << 20, seed=0, skip=()):
        self.total = int(total_bytes)
        self.chunk = int(chunk_bytes)
        self._payload = bytes((seed + i) % 251 for i in range(self.chunk))
        self._lock = threading.Lock()
        skip = sorted((int(s), int(e)) for s, e in skip)
        for s, e in skip:
            if s % self.chunk or (e % self.chunk and e != self.total):
                raise ValueError(f"delivered interval [{s}, {e}) is not "
                                 f"chunk-aligned (chunk={self.chunk})")
        self._pending = []
        for off in range(0, self.total, self.chunk):
            end = min(off + self.chunk, self.total)
            if not any(s <= off and end <= e for s, e in skip):
                self._pending.append(off)
        self._idx = 0

    def next_chunk(self):
        with self._lock:
            if self._idx >= len(self._pending):
                return None
            off = self._pending[self._idx]
            self._idx += 1
        n = min(self.chunk, self.total - off)
        return off, self._payload[:n]

    def exhausted(self):
        with self._lock:
            return self._idx >= len(self._pending)


# ---------------------------------------------------------------------------
# Cursor checkpointing + the kill/restart harness
# ---------------------------------------------------------------------------


def save_cursor(ckpt_dir, cursor: FlowCursor, step: int, *, keep=3):
    """Persist the cursor through the atomic checkpointer (sha256-verified
    tmp+rename; ``use_engine=False`` — a fault-recovery save must not
    depend on the faulted pipeline)."""
    from repro_torch.checkpoint import save_checkpoint
    iv = np.asarray(cursor.intervals() or np.zeros((0, 2)), np.int64)
    state = {"total": np.int64(cursor.total),
             "intervals": iv.reshape(-1, 2)}
    return save_checkpoint(ckpt_dir, state, step, keep=keep,
                           use_engine=False)


def load_cursor(ckpt_dir, *, step=None) -> FlowCursor:
    """Rebuild a FlowCursor from the latest (or given) checkpoint; None if
    the directory holds no checkpoints."""
    from repro_torch.checkpoint import load_checkpoint, latest_step
    if step is None and latest_step(ckpt_dir) is None:
        return None
    like = {"total": np.int64(0), "intervals": np.zeros((0, 2), np.int64)}
    state, _ = load_checkpoint(ckpt_dir, like, step=step)
    iv = np.asarray(state["intervals"]).reshape(-1, 2)
    return FlowCursor(int(state["total"]), intervals=iv.tolist())


class CheckpointedFlow:
    """One flow's kill/restart lifecycle: a deterministic source, a
    cursor-wrapped sink, and an engine that can be crashed and resurrected
    without losing or replaying a byte.

        flow = CheckpointedFlow(total, sink, ckpt_dir=d, seed=3)
        eng = flow.start()           # resumes from d's cursor if present
        ...
        flow.kill()                  # crash: buffers drop, cursor survives
        eng = flow.restart()         # re-reads ONLY the missing chunks
        ...
        flow.close()

    ``engine_factory(source, sink) -> engine`` hooks the flow into a
    SharedLink / MultiLink (default: a standalone TransferEngine built
    with ``engine_kwargs``). The cursor checkpoints to ``ckpt_dir`` on
    every ``kill()``/``checkpoint()``; ``start()`` loads it, so a cold
    restart in a fresh process resumes from the same offsets."""

    def __init__(self, total_bytes, sink, *, ckpt_dir=None,
                 chunk_bytes=1 << 20, seed=0, engine_factory=None,
                 engine_kwargs=None):
        self.total = int(total_bytes)
        self.sink = sink
        self.ckpt_dir = ckpt_dir
        self.chunk = int(chunk_bytes)
        self.seed = seed
        self.engine_factory = engine_factory
        self.engine_kwargs = dict(engine_kwargs or {})
        self.cursor = None
        self.engine = None
        self._step = 0

    def _build(self):
        source = ResumableSource(self.total, self.chunk, seed=self.seed,
                                 skip=self.cursor.intervals())
        sink = CursorSink(self.sink, self.cursor)
        if self.engine_factory is not None:
            self.engine = self.engine_factory(source, sink)
        else:
            from repro_torch.transfer.engine import TransferEngine
            self.engine = TransferEngine(source, sink, **self.engine_kwargs)
        return self.engine

    def start(self):
        if self.engine is not None:
            raise RuntimeError("flow already started")
        if self.ckpt_dir is not None:
            self.cursor = load_cursor(self.ckpt_dir)
        if self.cursor is None:
            self.cursor = FlowCursor(self.total)
        return self._build()

    def checkpoint(self):
        if self.ckpt_dir is not None and self.cursor is not None:
            self._step += 1
            save_cursor(self.ckpt_dir, self.cursor, self._step)

    def kill(self):
        """Crash the engine: workers stop, in-flight chunks drop on the
        floor. The cursor (receiver-side) survives and is checkpointed."""
        if self.engine is not None:
            self.engine.close()
            self.engine = None
        self.checkpoint()

    def restart(self):
        """A fresh engine over the missing byte ranges only."""
        if self.engine is not None:
            raise RuntimeError("kill() the flow before restarting it")
        if self.cursor is None:
            raise RuntimeError("start() the flow first")
        return self._build()

    def done(self):
        return self.cursor is not None and self.cursor.complete()

    def close(self):
        """Clean shutdown: unlike ``kill()`` this is the orderly path, but
        it checkpoints too, so the on-disk cursor matches the final state
        (a cold restart of a finished flow has nothing to re-send)."""
        if self.engine is not None:
            self.engine.close()
            self.engine = None
        self.checkpoint()
