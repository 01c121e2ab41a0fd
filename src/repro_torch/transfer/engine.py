"""The modular transfer engine: a REAL 3-stage threaded pipeline.

    source --[read pool]--> sender buffer --[network pool]--> receiver
    buffer --[write pool]--> sink

Each stage has its own independently-resizable thread pool (the paper's
modular architecture) and two bounded staging buffers couple them (the
"application-level staging directory" — /dev/shm on a DTN; an in-memory byte
ledger here). Per-thread rate caps (TPT) and per-stage aggregate caps (B)
reproduce the paper's throttled bottleneck scenarios; with throttles disabled
the engine moves bytes as fast as the host allows (this is the engine the
data pipeline and checkpointer use).

Controllers drive it through two methods, matching §IV-F:
    observe()            -> thread counts, per-stage throughputs, free space
    set_concurrency(n3)  -> resize the three pools

Thread pools resize cooperatively: each worker checks its (stage, epoch)
ticket; stale workers exit at the next chunk boundary, so a resize never
drops bytes.
"""

from __future__ import annotations

import hashlib
import io
import os
import threading
import time
from dataclasses import dataclass
from types import SimpleNamespace


_UNSET = object()


class StageThrottle:
    """Token bucket for aggregate stage bandwidth + per-thread rate cap.

    Rates are mutable at runtime via set_rates() (thread-safe) — this is what
    lets a scenario replayer replay a time-varying scenario against the live
    pipeline while workers are mid-acquire."""

    def __init__(self, aggregate_bps=None, per_thread_bps=None):
        self.aggregate_bps = aggregate_bps
        self.per_thread_bps = per_thread_bps
        self._lock = threading.Lock()
        self._tokens = float(aggregate_bps) if aggregate_bps else 0.0
        self._t = time.monotonic()

    def set_rates(self, aggregate_bps=_UNSET, per_thread_bps=_UNSET):
        """Retune either cap live. None disables a cap; ZERO means fully
        blocked (an outage bin) — acquire() parks until a retune, matching
        the simulator where rate = min(n*tpt, 0) moves nothing. Tokens are
        clamped to the new burst so a cap cut takes effect within one chunk,
        but a NEGATIVE balance (debt from an oversized chunk) is never
        forgiven by a retune — otherwise an outage/recovery cycle would
        erase the owed wait and the average rate would exceed the cap."""
        with self._lock:
            if aggregate_bps is not _UNSET:
                enabling = aggregate_bps and not self.aggregate_bps
                self.aggregate_bps = aggregate_bps
                if aggregate_bps:
                    cap = float(aggregate_bps)
                    if enabling:
                        self._tokens = cap if self._tokens >= 0.0 \
                            else self._tokens
                    else:
                        self._tokens = min(self._tokens, cap)
                    self._t = time.monotonic()
                else:
                    self._tokens = min(self._tokens, 0.0)
            if per_thread_bps is not _UNSET:
                self.per_thread_bps = per_thread_bps

    def rates(self):
        with self._lock:
            return self.aggregate_bps, self.per_thread_bps

    def _try_withdraw(self, nbytes):
        """The ONE definition of the token-bucket accounting (refill, burst
        clamp, debt rule) shared by ``acquire`` and ``try_acquire``.
        Returns ``(granted, wait_s)``: granted True means the tokens were
        withdrawn; wait_s is how long a blocked caller should wait before
        retrying (None when the bucket is in an outage — wait for a retune).

        A chunk larger than one second of aggregate tokens (nbytes > cap)
        can never accumulate enough: it runs on DEBT — the bucket only needs
        to be full, the withdrawal may drive it negative, and subsequent
        withdrawals wait the deficit out. Average rate stays at the cap; the
        oversized chunk passes within ~1 s instead of parking forever."""
        with self._lock:
            agg = self.aggregate_bps
            per_thread = self.per_thread_bps
            if agg == 0 or per_thread == 0:  # 0, not None: outage bin
                return False, None
            if agg is None:
                return True, None
            now = time.monotonic()
            cap = float(agg)  # burst = 1 second
            self._tokens = min(self._tokens + (now - self._t) * agg, cap)
            self._t = now
            need_tokens = min(float(nbytes), cap)
            if self._tokens >= need_tokens:
                self._tokens -= nbytes  # may go negative: debt
                return True, None
            return False, (need_tokens - self._tokens) / agg

    def _refund(self, nbytes):
        """Return tokens withdrawn by a granted ``try_acquire`` that a
        composite caller (``PathGate``) could not use because a LATER bucket
        in its chain refused — the all-or-nothing acquire over a link path
        must not burn capacity on links it didn't traverse. Clamped to the
        burst so a refund never manufactures tokens beyond one second of
        the cap."""
        with self._lock:
            if self.aggregate_bps:
                self._tokens = min(self._tokens + float(nbytes),
                                   float(self.aggregate_bps))

    def _per_thread_sleep(self, nbytes):
        with self._lock:
            per_thread = self.per_thread_bps
        if per_thread:
            return nbytes / per_thread
        return 0.0

    def acquire(self, nbytes, should_abort=None):
        """Blocks to enforce the aggregate cap. Returns per-thread sleep that
        the caller must additionally honor for its own chunk, or None when
        ``should_abort()`` turned true mid-wait (engine shutdown: outage bins
        and token waits would otherwise never observe it). Rates are re-read
        every iteration so a live retune is honored mid-wait — a zero rate
        (outage) parks here instead of sleeping nbytes/0 forever in the
        caller."""
        while True:
            if should_abort is not None and should_abort():
                return None
            granted, wait = self._try_withdraw(nbytes)
            if granted:
                break
            if wait is None:
                wait = 0.05  # outage: wait for a retune to lift it
            time.sleep(min(max(wait, 1e-4), 0.05))
        return self._per_thread_sleep(nbytes)

    def try_acquire(self, nbytes):
        """Non-blocking acquire: withdraw the tokens if the bucket can grant
        them RIGHT NOW (same accounting as ``acquire``, including the
        oversized-chunk debt rule), else return None without waiting.
        Returns the per-thread pacing sleep on success. Used by ``FlowGate``
        to poll a reserved floor bucket and the shared pool side by side."""
        granted, _ = self._try_withdraw(nbytes)
        if not granted:
            return None
        return self._per_thread_sleep(nbytes)


class FlowGate:
    """One flow's view of a shared stage pool: the per-engine throttle that
    makes a ``SharedLink`` honor a FlowObjective's rate floor and cap.

    cap   a PRIVATE token bucket the flow must also clear — waiting here is
          the flow's own problem and starves nobody (min of the two caps,
          exactly like the simulator clamping demand to rate_cap).
    floor a PRIVATE reserved bucket refilled at the floor rate that grants
          tokens ahead of the shared pool: while the shared pool is drained
          by competitors, the floored flow still advances at >= floor.
          The reserve is additive — the link's true capacity is the shared
          pool PLUS the attached floors (provision the pool net of floors
          to keep the total exact; ``SharedLink.reserved_bps`` reports the
          outstanding total). Grants from either bucket honor the SHARED
          pool's per-thread pacing rate, matching how the sim applies
          per-thread rates independently of the floor carve-out."""

    def __init__(self, shared: StageThrottle, *, floor_bps=None,
                 cap_bps=None):
        self.shared = shared
        self.floor = StageThrottle(floor_bps) if floor_bps else None
        self.cap = StageThrottle(cap_bps) if cap_bps else None

    def set_rates(self, **kw):
        """Retunes the SHARED pool (floor/cap are per-flow constants)."""
        self.shared.set_rates(**kw)

    def rates(self):
        return self.shared.rates()

    def acquire(self, nbytes, should_abort=None):
        sleep_cap = 0.0
        if self.cap is not None:
            sleep_cap = self.cap.acquire(nbytes, should_abort)
            if sleep_cap is None:
                return None
        if self.floor is None:
            sleep = self.shared.acquire(nbytes, should_abort)
            if sleep is None:
                return None
            return max(sleep, sleep_cap)
        while True:
            if should_abort is not None and should_abort():
                return None
            agg, per_thread = self.shared.rates()
            if agg == 0 or per_thread == 0:
                # a replayed OUTAGE bin zeroes the shared pool; the sim
                # scales floors inside the scheduled capacity, so zero
                # capacity suspends the floor too — matching parity. (A
                # partial brownout still leaves the provisioned floor
                # whole; see the README live-twin caveats.)
                time.sleep(0.05)
                continue
            granted, wait_f = self.floor._try_withdraw(nbytes)
            if not granted:
                granted, wait_s = self.shared._try_withdraw(nbytes)
                if not granted:
                    # sleep the shorter of the two buckets' computed
                    # deficits instead of busy-polling at a fixed tick
                    waits = [w for w in (wait_f, wait_s) if w is not None]
                    time.sleep(min(max(min(waits, default=0.05), 1e-4),
                                   0.05))
                    continue
            return max(self.shared._per_thread_sleep(nbytes), sleep_cap)


class BoundedBuffer:
    """Bounded FIFO of (chunk_id, payload) with byte-level capacity."""

    def __init__(self, capacity_bytes):
        self.capacity = capacity_bytes
        self.used = 0
        self._q = []
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)

    def put(self, item, nbytes, *, timeout=0.05):
        """Waits under the condition in a loop until space frees or the
        deadline passes — a spurious wakeup (or a near-miss notify) re-checks
        and keeps waiting instead of reporting failure early."""
        deadline = time.monotonic() + timeout
        with self._not_full:
            while self.used + nbytes > self.capacity:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._not_full.wait(remaining)
            self._q.append((item, nbytes))
            self.used += nbytes
            self._not_empty.notify()
            return True

    def get(self, *, timeout=0.05):
        deadline = time.monotonic() + timeout
        with self._not_empty:
            while not self._q:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._not_empty.wait(remaining)
            item, nbytes = self._q.pop(0)
            self.used -= nbytes
            self._not_full.notify()
            return item, nbytes

    @property
    def free(self):
        return self.capacity - self.used


# ---------------------------------------------------------------------------
# Sources / sinks
# ---------------------------------------------------------------------------

class SyntheticSource:
    """total_bytes of deterministic pseudo-data in chunk_bytes chunks."""

    def __init__(self, total_bytes, chunk_bytes=1 << 20, seed=0):
        self.total = int(total_bytes)
        self.chunk = int(chunk_bytes)
        self._next = 0
        self._lock = threading.Lock()
        self._payload = bytes((seed + i) % 251 for i in range(self.chunk))

    def next_chunk(self):
        with self._lock:
            if self._next >= self.total:
                return None
            cid = self._next
            n = min(self.chunk, self.total - self._next)
            self._next += n
        return cid, self._payload[:n]

    def exhausted(self):
        with self._lock:
            return self._next >= self.total


class FileSource:
    """Reads real files from a directory (mixed-size datasets)."""

    def __init__(self, paths, chunk_bytes=1 << 20):
        self.paths = list(paths)
        self.chunk = chunk_bytes
        self._lock = threading.Lock()
        self._fidx = 0
        self._off = 0
        self.total = sum(os.path.getsize(p) for p in self.paths)

    def next_chunk(self):
        with self._lock:
            while self._fidx < len(self.paths):
                p = self.paths[self._fidx]
                size = os.path.getsize(p)
                if self._off >= size:
                    self._fidx += 1
                    self._off = 0
                    continue
                off = self._off
                n = min(self.chunk, size - off)
                self._off += n
                fidx = self._fidx
                break
            else:
                return None
        with open(self.paths[fidx], "rb") as f:
            f.seek(off)
            return (fidx, off), f.read(n)

    def exhausted(self):
        with self._lock:
            return self._fidx >= len(self.paths)


class NullSink:
    def write_chunk(self, cid, payload):
        pass


class ChecksumSink:
    """Order-independent checksum so tests can verify byte integrity."""

    def __init__(self):
        self._lock = threading.Lock()
        self.digest = 0
        self.nbytes = 0

    def write_chunk(self, cid, payload):
        h = int.from_bytes(
            hashlib.blake2b(payload, digest_size=8,
                            key=repr(cid).encode()[:16]).digest(), "big")
        with self._lock:
            self.digest ^= h
            self.nbytes += len(payload)

    @staticmethod
    def reference(chunks):
        d = 0
        for cid, payload in chunks:
            d ^= int.from_bytes(
                hashlib.blake2b(payload, digest_size=8,
                                key=repr(cid).encode()[:16]).digest(), "big")
        return d


class FileSink:
    """Offset-addressed sink. Int chunk ids (SyntheticSource) are byte
    offsets into the single output at ``path``. Tuple ids ``(fidx, off)``
    (FileSource) are per-file offsets: file ``fidx`` goes to ``paths[fidx]``
    when given, else ``<path>.<fidx>`` — chunks land at their true offsets
    even when write workers race out of order."""

    def __init__(self, path, *, paths=None):
        self.path = path
        self.paths = list(paths) if paths is not None else None
        self._lock = threading.Lock()
        self._files = {}  # fidx (or None for the single output) -> handle
        self._closed = False

    def _handle(self, fidx):
        if self._closed:
            # a straggler worker past close() must fail loudly, not reopen
            # "wb" and truncate data already on disk
            raise ValueError("write to closed FileSink")
        f = self._files.get(fidx)
        if f is None:
            if fidx is None:
                p = self.path
            elif self.paths is not None:
                p = self.paths[fidx]
            else:
                p = f"{self.path}.{fidx}"
            f = open(p, "wb")
            self._files[fidx] = f
        return f

    def write_chunk(self, cid, payload):
        if isinstance(cid, tuple):
            fidx, off = cid
        else:
            fidx, off = None, (cid if isinstance(cid, int) else None)
        with self._lock:
            f = self._handle(fidx)
            if off is not None:
                f.seek(off)
            f.write(payload)

    def close(self):
        with self._lock:
            self._closed = True
            for f in self._files.values():
                f.close()
            self._files.clear()


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclass
class _StageStats:
    moved: int = 0


class TransferEngine:
    READ, NET, WRITE = 0, 1, 2

    def __init__(self, source, sink, *,
                 sender_buf=64 << 20, receiver_buf=64 << 20,
                 throttles=(None, None, None),
                 initial_concurrency=(1, 1, 1), n_max=64,
                 metric_interval=1.0, retry=None):
        self.source = source
        self.sink = sink
        self.buffers = (BoundedBuffer(sender_buf), BoundedBuffer(receiver_buf))
        self.throttles = [t or StageThrottle() for t in throttles]
        self.retry = retry
        self.breakers = None
        if retry is not None:
            # opt-in resilience (repro.transfer.recovery): stage acquires
            # poll try_acquire under backoff, and a per-stage circuit
            # breaker parks the stage's workers through an outage instead
            # of letting them hammer the bucket lock. None (default) is
            # the blocking acquire, untouched.
            from repro_torch.transfer.recovery import CircuitBreaker
            self.breakers = [CircuitBreaker(retry.failure_threshold,
                                            retry.cooldown)
                             for _ in range(3)]
        self.n_max = n_max
        self.metric_interval = metric_interval
        self._stats = [_StageStats(), _StageStats(), _StageStats()]
        self._stats_lock = threading.Lock()
        self._inflight = 0  # chunks held by workers (not in any buffer)
        self._alive = True
        self._epoch = [0, 0, 0]
        self._pools = [[], [], []]
        self._pool_lock = threading.Lock()
        self._last_obs_t = time.monotonic()
        self._last_moved = [0, 0, 0]
        self._last_tps = [0.0, 0.0, 0.0]
        self.set_concurrency(initial_concurrency)

    # -- worker loops -----------------------------------------------------
    def _acquire(self, stage, nbytes):
        """Throttle acquire that observes engine shutdown: close() flips
        _alive and workers parked in an outage bin or a token wait unwind
        within one poll interval instead of never. With ``retry`` set, the
        acquire goes through the backoff + circuit-breaker path instead of
        blocking (same grant/abort contract)."""
        if self.retry is not None:
            from repro_torch.transfer.recovery import acquire_with_retry
            return acquire_with_retry(
                self.throttles[stage], nbytes, policy=self.retry,
                breaker=self.breakers[stage],
                should_abort=lambda: not self._alive)
        return self.throttles[stage].acquire(
            nbytes, should_abort=lambda: not self._alive)

    def _sleep(self, seconds):
        """Per-thread pacing sleep, sliced so close() interrupts it."""
        deadline = time.monotonic() + seconds
        while self._alive:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            time.sleep(min(remaining, 0.05))

    def _worker(self, stage, epoch):
        while self._alive and self._epoch[stage] == epoch:
            if stage == self.READ:
                item = self.source.next_chunk()
                if item is None:
                    time.sleep(0.002)
                    continue
                self._track(+1)
                cid, payload = item
                sleep = self._acquire(0, len(payload))
                if sleep is None:  # shutdown mid-acquire
                    self._track(-1)
                    return
                if sleep:
                    self._sleep(sleep)
                while self._alive and not self.buffers[0].put(
                        (cid, payload), len(payload)):
                    pass  # put() parks on the condition until space frees or
                    # its deadline lapses; retry only re-arms the deadline
                self._track(-1)
                self._count(0, len(payload))
            elif stage == self.NET:
                got = self.buffers[0].get()
                if got is None:
                    continue
                self._track(+1)
                (cid, payload), n = got
                sleep = self._acquire(1, n)
                if sleep is None:
                    self._track(-1)
                    return
                if sleep:
                    self._sleep(sleep)
                while self._alive and not self.buffers[1].put(
                        (cid, payload), n):
                    pass
                self._track(-1)
                self._count(1, n)
            else:
                got = self.buffers[1].get()
                if got is None:
                    continue
                self._track(+1)
                (cid, payload), n = got
                sleep = self._acquire(2, n)
                if sleep is None:
                    self._track(-1)
                    return
                if sleep:
                    self._sleep(sleep)
                self.sink.write_chunk(cid, payload)
                self._track(-1)
                self._count(2, n)

    def _track(self, d):
        with self._stats_lock:
            self._inflight += d

    def _count(self, stage, n):
        with self._stats_lock:
            self._stats[stage].moved += n

    # -- control & observation (the §IV-F interface) ----------------------
    def set_concurrency(self, n3):
        with self._pool_lock:
            for stage, n in enumerate(n3):
                n = max(1, min(int(n), self.n_max))
                cur = [t for t in self._pools[stage] if t.is_alive()]
                if n == len(cur):
                    continue
                # bump epoch: old threads retire; spawn the new size
                self._epoch[stage] += 1
                epoch = self._epoch[stage]
                pool = []
                for _ in range(n):
                    t = threading.Thread(target=self._worker,
                                         args=(stage, epoch), daemon=True)
                    t.start()
                    pool.append(t)
                self._pools[stage] = pool

    def concurrency(self):
        return tuple(len([t for t in p if t.is_alive()]) for p in self._pools)

    def observe(self):
        return self.observe_at(time.monotonic())

    def observe_at(self, now):
        """observe() against a CALLER-supplied ``time.monotonic()`` stamp —
        the batched-telemetry hook: a fleet pass reads the clock once and
        snapshots every engine against it, so per-flow rate windows cannot
        skew apart across a large fleet (``SharedLink.observe_all``)."""
        dt = max(now - self._last_obs_t, 1e-6)
        with self._stats_lock:
            moved = [s.moved for s in self._stats]
        if dt >= self.metric_interval * 0.5:
            tps = [(m - lm) / dt for m, lm in zip(moved, self._last_moved)]
            self._last_moved = moved
            self._last_obs_t = now
            self._last_tps = tps
        else:
            tps = self._last_tps
        return {
            "threads": list(self.concurrency()),
            "throughputs": tps,
            "sender_free": self.buffers[0].free,
            "receiver_free": self.buffers[1].free,
            "sender_capacity": self.buffers[0].capacity,
            "receiver_capacity": self.buffers[1].capacity,
        }

    def probe(self, threads):
        """Exploration-phase interface: set threads, wait one interval,
        return per-stage throughputs. The wait is the abort-aware ``_sleep``
        so ``close()`` mid-probe returns within one slice instead of hanging
        a full metric_interval."""
        self.set_concurrency([int(x) for x in threads])
        before = self._snapshot()
        self._sleep(self.metric_interval)
        after = self._snapshot()
        return [(a - b) / self.metric_interval for a, b in zip(after, before)]

    def _snapshot(self):
        with self._stats_lock:
            return [s.moved for s in self._stats]

    def wait(self, interval):
        time.sleep(interval)

    def bytes_written(self):
        with self._stats_lock:
            return self._stats[2].moved

    def done(self):
        with self._stats_lock:
            inflight = self._inflight
        return (self.source.exhausted() and self.buffers[0].used == 0
                and self.buffers[1].used == 0 and inflight == 0)

    @property
    def alive(self):
        """False once close() has been called. A closed-but-unfinished
        engine never reports done(), so controller run loops must also
        check liveness or they spin forever after a mid-run teardown."""
        return self._alive

    def close(self):
        """Terminate all workers, including those parked in an outage bin or
        a throttle token wait (acquire observes shutdown via should_abort)."""
        self._alive = False
        for p in self._pools:
            for t in p:
                t.join(timeout=1.0)


class SharedLink:
    """One bottleneck, many transfers: a single pool of per-stage
    StageThrottles shared by every TransferEngine attached to it. The token
    buckets ARE the live contention model — N flows' workers draw from the
    same aggregate budget, so each flow's share of a stage follows its
    thread count, exactly like the simulator's thread-proportional split in
    ``repro.core.fleet`` (sim-trained fleet policies drop onto a SharedLink
    unchanged).

        link = SharedLink(aggregate_bps=(cap, cap, cap))
        engines = [link.attach(src_i, sink_i, n_max=40) for ...]
        FleetController(params, n_flows=len(engines), ...).run(engines)

    A scenario replayer retunes a SharedLink directly (it only needs the
    ``throttles`` attribute), replaying time-varying conditions against the
    whole fleet at once.

    Heterogeneous objectives: ``attach(..., rate_floor=..., rate_cap=...)``
    wraps the shared throttles in a per-engine ``FlowGate`` — the cap is a
    private bucket the flow must also clear, the floor a private reserved
    bucket that keeps the flow advancing at >= floor while competitors
    drain the shared pool. Floors are ADDITIVE reserves: provision the
    shared pool net of the floors you intend to grant (``reserved_bps``
    reports the outstanding total per stage)."""

    def __init__(self, aggregate_bps=(None, None, None),
                 per_thread_bps=(None, None, None)):
        self.throttles = tuple(
            StageThrottle(a, p)
            for a, p in zip(aggregate_bps, per_thread_bps))
        self.engines = []
        self.reserved_bps = [0.0, 0.0, 0.0]  # floors granted so far

    def attach(self, source, sink, *, rate_floor=None, rate_cap=None,
               **engine_kw):
        """Create a TransferEngine whose three stages draw from this link's
        shared throttles. Per-engine knobs (buffers, n_max, concurrency,
        metric_interval) pass through. ``rate_floor`` / ``rate_cap``:
        optional per-flow guaranteed / maximum rates in bytes/s — a scalar
        applies to all three stages, a 3-tuple sets them per stage (None
        entries disable)."""
        if rate_floor is None and rate_cap is None:
            throttles = self.throttles
        else:
            def _per_stage(v):
                if v is None or isinstance(v, (int, float)):
                    return (v, v, v)
                return tuple(v)
            floors, caps = _per_stage(rate_floor), _per_stage(rate_cap)
            throttles = tuple(
                FlowGate(shared, floor_bps=f, cap_bps=c)
                for shared, f, c in zip(self.throttles, floors, caps))
            for stage, f in enumerate(floors):
                self.reserved_bps[stage] += f or 0.0
        eng = TransferEngine(source, sink, throttles=throttles,
                             **engine_kw)
        self.engines.append(eng)
        return eng

    def observe(self):
        """Per-flow observe() dicts, in attach order — the input shape
        FleetController.step expects."""
        return [e.observe() for e in self.engines]

    def observe_all(self):
        """Batched telemetry: every engine snapshotted against ONE
        ``time.monotonic()`` stamp (``TransferEngine.observe_at``), so the
        per-flow rate windows stay aligned fleet-wide — the per-interval
        pass ``FleetController.run`` makes."""
        now = time.monotonic()
        return [e.observe_at(now) for e in self.engines]

    def bytes_written(self):
        return sum(e.bytes_written() for e in self.engines)

    def bytes_written_all(self):
        """Per-flow delivered-byte counters in attach order — the (F,)
        ``delivered`` vector the objective-aware controller feeds
        ``objective_features`` (one lock pass per engine, no summing)."""
        return [e.bytes_written() for e in self.engines]

    def close(self):
        for e in self.engines:
            e.close()


class PathGate:
    """A chunk must clear EVERY link on its flow's path: the composite
    throttle a ``MultiLink`` hands a TransferEngine stage. ``acquire`` is
    all-or-nothing — it polls ``try_acquire`` on each pool in path order
    and, if any pool refuses, REFUNDS the pools already granted before
    backing off, so a flow blocked at its bottleneck link never burns
    capacity on (= never steals tokens from) the other links it crosses.
    The effective rate is the min over the path's pools — the live twin of
    the simulator's min-over-links combine in ``_topology_substep_rates``.

    ``set_pools`` swaps the path at runtime (thread-safe): a live reroute,
    the engine's workers pick up the new pools on their next chunk."""

    def __init__(self, pools):
        self._lock = threading.Lock()
        self._pools = list(pools)

    def set_pools(self, pools):
        with self._lock:
            self._pools = list(pools)

    def pools(self):
        with self._lock:
            return list(self._pools)

    def set_rates(self, **kw):
        """Retunes every pool on the current path (scenario replayer contract);
        per-link retuning goes through ``MultiLink.link(e)`` instead."""
        for p in self.pools():
            p.set_rates(**kw)

    def rates(self):
        """The binding pool's rates: the smallest aggregate cap on the path
        (None = uncapped; any zero reports zero — an outage anywhere on the
        path is an outage for the flow)."""
        pools = self.pools()
        if not pools:
            return None, None
        agg = [p.rates()[0] for p in pools]
        per = [p.rates()[1] for p in pools]
        pick = lambda vs: (0 if any(v == 0 for v in vs) else
                           None if all(v is None for v in vs) else
                           min(v for v in vs if v is not None))
        return pick(agg), pick(per)

    def acquire(self, nbytes, should_abort=None):
        while True:
            if should_abort is not None and should_abort():
                return None
            pools = self.pools()
            if not pools:  # empty path: unthrottled (a None throttle)
                return 0.0
            granted, sleep = [], 0.0
            for p in pools:
                s = p.try_acquire(nbytes)
                if s is None:
                    for g in granted:
                        g._refund(nbytes)
                    break
                granted.append(p)
                sleep = max(sleep, s)
            else:
                return sleep
            time.sleep(0.01)

    def try_acquire(self, nbytes):
        pools = self.pools()
        granted, sleep = [], 0.0
        for p in pools:
            s = p.try_acquire(nbytes)
            if s is None:
                for g in granted:
                    g._refund(nbytes)
                return None
            granted.append(p)
            sleep = max(sleep, s)
        return sleep


class MultiLink:
    """E bottlenecks, many transfers over link paths: the live twin of the
    topology core (``repro.core.topology``). Each link owns one pool of
    per-stage StageThrottles; ``attach(..., path=[0, 2])`` builds a
    TransferEngine whose stages draw through a ``PathGate`` over THAT
    path's pools — every chunk pays every link it crosses, the flow runs at
    the min over its links, and contention on each link follows thread
    counts, exactly like the per-link work-conserving solve in the sim
    (topology-trained policies drop onto a MultiLink unchanged, via
    ``TopologyController``).

        net = MultiLink(3, aggregate_bps=cap)          # 3 links, same cap
        e0 = net.attach(src0, sink0, path=[0, 1], n_max=40)
        e1 = net.attach(src1, sink1, path=[0, 2], n_max=40)
        net.reroute(e1, [2])                           # live failover

    A scenario replayer replays per-link conditions via ``net.link(e)`` (a
    retunable ``throttles`` view of one link's pools). ``aggregate_bps`` /
    ``per_thread_bps``: a list of E per-stage 3-tuples, or one 3-tuple /
    scalar applied to every link."""

    def __init__(self, n_links, aggregate_bps=None, per_thread_bps=None):
        if n_links < 1:
            raise ValueError("MultiLink needs n_links >= 1")

        def _per_link(v):
            if isinstance(v, (list,)) and len(v) == n_links:
                rows = v
            else:
                rows = [v] * n_links
            out = []
            for r in rows:
                if r is None or isinstance(r, (int, float)):
                    out.append((r, r, r))
                else:
                    out.append(tuple(r))
            return out

        aggs, pers = _per_link(aggregate_bps), _per_link(per_thread_bps)
        self.links = [tuple(StageThrottle(a, p) for a, p in zip(agg, per))
                      for agg, per in zip(aggs, pers)]
        self.engines = []
        self._paths = {}  # id(engine) -> (path tuple, per-stage PathGates)

    @property
    def n_links(self):
        return len(self.links)

    def link(self, e):
        """One link's pools as a retunable ``throttles`` object — what a
        scenario replayer needs to replay THIS link's schedule."""
        return SimpleNamespace(throttles=list(self.links[e]))

    def _check_path(self, path):
        path = [int(e) for e in path]
        if not path:
            raise ValueError("path needs at least one link")
        if len(set(path)) != len(path):
            raise ValueError(f"path revisits a link: {path}")
        for e in path:
            if not 0 <= e < self.n_links:
                raise ValueError(f"link {e} out of range "
                                 f"[0, {self.n_links})")
        return path

    def attach(self, source, sink, *, path, **engine_kw):
        """Create a TransferEngine routed over ``path`` (link indices, in
        traversal order). Per-engine knobs pass through."""
        path = self._check_path(path)
        gates = tuple(
            PathGate([self.links[e][stage] for e in path])
            for stage in range(3))
        eng = TransferEngine(source, sink, throttles=gates, **engine_kw)
        self.engines.append(eng)
        self._paths[id(eng)] = (tuple(path), gates)
        return eng

    def reroute(self, engine, path):
        """Swap ``engine``'s path live: its PathGates atomically adopt the
        new links' pools; workers mid-acquire pick them up on the next poll
        tick (blocked-at-a-dead-link flows unpark onto the backup)."""
        path = self._check_path(path)
        old_path, gates = self._paths[id(engine)]
        for stage, gate in enumerate(gates):
            gate.set_pools([self.links[e][stage] for e in path])
        self._paths[id(engine)] = (tuple(path), gates)

    def path_of(self, engine):
        return self._paths[id(engine)][0]

    def onpath(self):
        """(F, E) 0/1 route matrix in attach order — what
        ``TopologyController.set_paths`` / ``topology_features`` take."""
        mat = [[0.0] * self.n_links for _ in self.engines]
        for f, e in enumerate(self.engines):
            for l in self._paths[id(e)][0]:
                mat[f][l] = 1.0
        return mat

    def observe(self):
        """Per-flow observe() dicts, in attach order."""
        return [e.observe() for e in self.engines]

    def observe_all(self):
        """Batched telemetry (SharedLink twin): one shared timestamp for
        the whole fleet's snapshots."""
        now = time.monotonic()
        return [e.observe_at(now) for e in self.engines]

    def bytes_written(self):
        return sum(e.bytes_written() for e in self.engines)

    def bytes_written_all(self):
        """Per-flow delivered-byte counters in attach order."""
        return [e.bytes_written() for e in self.engines]

    def close(self):
        for e in self.engines:
            e.close()
