"""Concurrent front for BatchedStreamingServer (counterpart of
``mla_tpu/serve/ticker.py``): handler threads only touch host buffers, and
ONE tick thread owns device dispatch. It gathers every ready stream into
one packed buffer and runs one packed step (one host-to-device copy per
tick), so concurrent streams share a device step. A short batching grace
window lets near-simultaneous streams share one tick.

Locking (take ``dev`` before ``cond`` when both are needed; the tick thread
never holds ``cond`` while taking ``dev``):
  - ``cond`` guards the server's host state: slot table, per-stream
    buffers and adpcm remainders, ``_fed``, and wakes the tick thread.
  - ``dev`` guards the read -> compute -> assign window of the device
    state (``states``, ``tl``, ``model``), so an ``open()``'s slot reset is
    never lost to an in-flight tick's state swap.

Unlike the reference, whose dispatch is asynchronous and short, the port's
step issues a few hundred eager launches from the tick thread, all under
``dev``: an ``open``, ``flush``, reload commit or snapshot waits up to one
step's host time for it. The step stays under ``dev`` all the same; that
lock is what keeps the slot reset.

Every thread launches on the default stream, so a reader's device work is
ordered after the step whose states it snapshotted. The steps are
functional (``states, tl = step(states, tl, ...)``) and a slot reset builds
new tensors, so a (model, states, tl) triple taken under the locks is a
consistent snapshot, read outside them. ``torch.inference_mode`` is
thread-local: the server's device methods carry it themselves.

API semantics match the serial server: ``feed`` returns only after the
chunks it completed are folded into device state (so a ``scores()`` right
after a feed reflects that audio, and the HTTP ``advanced`` field stays
deterministic), but feeds on different streams overlap with each other and
with device compute.

Spans (``utils/profiling.py``; recorded only while a profiler runs): the
tick thread's ``mla.tick`` (attributes ``tick``, ``streams``,
``ready_rows`` and ``rows``, the patch rows the step computed by the
server's ``patch_rows`` count) over its ``mla.tick.gather``,
``mla.tick.upload`` and ``mla.tick.step``, the last two with the card's
time on a single device (none on a mesh); one ``mla.queue`` per chunk
(``stream``, ``seq``, ``tick``) from the feed that made it ready to the
start of the gather that took it; and a reader's ``mla.scores.read``, the
finalize and its copy to the host.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

import numpy as np

from mla_tpu_torch.serve.server import BatchedStreamingServer
from mla_tpu_torch.utils import profiling


class TickLoop:
    """One device-owning tick thread + thread-safe stream operations.

    >>> loop = TickLoop(BatchedStreamingServer(cfg, state_dict))
    >>> sid = loop.open()
    >>> loop.feed(sid, samples)     # from any thread; returns when folded
    >>> loop.scores(sid); loop.close(sid); loop.stop()
    """

    def __init__(self, server: BatchedStreamingServer, batch_grace: float = 0.005):
        """``batch_grace``: after the first stream becomes ready, wait up
        to this long for more streams to fill a chunk before dispatching
        (one step serves every ready stream for the cost of one). 0
        dispatches the moment anything is ready."""
        self.srv = server
        self.batch_grace = float(batch_grace)
        self.cond = threading.Condition()
        self.dev = threading.Lock()
        self._dispatching = False
        self._stop = False
        self.ticks = 0           # completed device ticks
        self.ticked_streams = 0  # sum of active stream counts over ticks
        self._taken = np.zeros(server.S, np.int64)  # chunks gathered per stream since open
        # while tracing: per stream, (seq, perf_counter_ns) of each chunk a
        # feed made ready, oldest first (read by the gather's mla.queue spans)
        self._made_ready: Dict[int, collections.deque] = {}
        self._thread = threading.Thread(target=self._run, name="mla-tick", daemon=True)
        self._thread.start()

    # --- lifecycle ---
    def open(self) -> int:
        # the slot reset replaces device state -> dev; the slot table -> cond
        with self.dev, self.cond:
            sid = self.srv.open()
            self._taken[sid] = 0
            self._made_ready.pop(sid, None)
            return sid

    def close(self, sid: int):
        with self.cond:
            self.srv.close(sid)
            self._made_ready.pop(sid, None)
            self.cond.notify_all()

    def stop(self):
        with self.cond:
            self._stop = True
            self.cond.notify_all()
        self._thread.join(timeout=10)

    # --- data path ---
    def feed(self, sid: int, samples: np.ndarray, wire: Optional[bool] = None,
             sync: bool = True, max_backlog: int = 8) -> int:
        """Append audio. ``sync=True`` (default): block until every chunk
        this feed completed has been folded into device state, and return
        their count (the HTTP ``advanced`` field). ``sync=False``: return as
        soon as the audio is buffered (with the chunks made ready), so a
        client pipelines its next upload while the device ticks;
        backpressure holds the feed only beyond ``max_backlog`` buffered
        chunks. ``scores`` and ``flush`` always wait for the stream to
        drain, so final results are identical either way. Encoding runs
        under ``cond``: the adpcm encoder's per-stream remainder needs the
        buffer lock."""
        with self.cond:
            tracing = profiling.enabled()
            before = self.srv.chunks_ready(sid) if tracing else 0
            self.srv.feed(sid, samples, wire=wire)
            n = self.srv.chunks_ready(sid)
            if tracing and n > before:
                now = time.perf_counter_ns()
                first = int(self._taken[sid]) + before
                self._made_ready.setdefault(sid, collections.deque()).extend(
                    (first + j, now) for j in range(n - before))
            if n:
                self.cond.notify_all()
        if sync:
            if n:
                self._wait_drained(sid)
        elif n > max_backlog:
            with self.cond:
                while (0 <= sid < self.srv.S and self.srv._bufs[sid] is not None
                       and self.srv.chunks_ready(sid) > max_backlog):
                    self.cond.wait()
        return n

    def pending(self, sid: int) -> int:
        with self.cond:
            return self.srv.pending(sid)

    def open_streams(self) -> int:
        with self.cond:
            return sum(b is not None for b in self.srv._bufs)

    def backlog(self) -> int:
        """Chunks buffered but not yet folded, across all streams (+1 while
        a tick is in flight): 0 means device state reflects every fed
        chunk."""
        with self.cond:
            return (sum(self.srv.chunks_ready(s) for s in range(self.srv.S))
                    + (1 if self._dispatching else 0))

    def _wait_drained(self, sid: int):
        """Wait until the stream has no full chunk buffered AND no tick is
        in flight (a gather empties the buffer before the state swap)."""
        with self.cond:
            while (0 <= sid < self.srv.S and self.srv._bufs[sid] is not None
                   and (self.srv.chunks_ready(sid) or self._dispatching)):
                self.cond.wait()

    def flush(self, sid: int) -> bool:
        """Fold the sub-chunk tail (``server.flush`` semantics). Whole
        chunks are left to the tick thread first; the tail's step runs
        under both locks."""
        self._wait_drained(sid)
        with self.dev, self.cond:
            return self.srv.flush(sid)

    def scores(self, sid: int) -> np.ndarray:
        """Scores reflecting all audio fed before this call. The finalize
        and its device-to-host copy run outside every lock, on a snapshot."""
        self._wait_drained(sid)
        with self.cond:
            self.srv._check(sid)
            if not self.srv._fed[sid]:
                raise RuntimeError(f"stream {sid} has no processed audio yet")
            model, states = self.srv.model, self.srv.states
        with profiling.annotate("mla.scores.read"):
            return self.srv.scores_from(model, states, sid)

    def reload_weights(self, state_dict) -> None:
        """Weight swap while streams stay open (``server.reload_weights``
        semantics). The new model is built and uploaded before the locks
        are taken; only the commit, one attribute store, holds them."""
        staged = self.srv.prepare_reload(state_dict)
        with self.dev, self.cond:
            self.srv.commit_reload(staged)

    def timeline(self, sid: int):
        """Localization window (``server.timeline`` semantics)."""
        return self.timeline_with_scores(sid)[1:]

    def timeline_with_scores(self, sid: int):
        """(scores, start_patch, levels) from ONE consistent snapshot: the
        HTTP timeline route labels the window with the clip scores, so both
        must reflect the same folded chunks. The snapshot is taken under
        ``dev`` as well as ``cond``: the tick thread stores states and tl
        under ``dev``, so a cond-only reader could pair a pre-tick states
        with a post-tick ring. The one device-to-host copy runs outside the
        locks."""
        self._wait_drained(sid)
        with self.dev, self.cond:
            self.srv._check(sid)
            if not self.srv._fed[sid]:
                raise RuntimeError(f"stream {sid} has no processed audio yet")
            model, states, tl = self.srv.model, self.srv.states, self.srv.tl
        return self.srv.timeline_with_scores_from(model, states, tl, sid)

    # --- tick thread ---
    def _n_ready(self) -> int:
        return sum(self.srv.chunks_ready(s) > 0 for s in range(self.srv.S))

    def _run(self):
        srv = self.srv
        dev = srv.device if srv._shards is None else None  # device time on one device only
        while True:
            with self.cond:
                n = self._n_ready()
                while not self._stop and n == 0:
                    self.cond.wait()
                    n = self._n_ready()
                if self._stop:
                    return
                if self.batch_grace > 0:
                    # some streams ready, maybe not all: give stragglers a
                    # moment so their chunks ride the same tick
                    deadline = time.monotonic() + self.batch_grace
                    while (not self._stop and n < self.open_count_locked()
                           and time.monotonic() < deadline):
                        self.cond.wait(deadline - time.monotonic())
                        n = self._n_ready()
                    if self._stop:
                        return
                if n == 0:  # a close took the ready streams during the grace
                    continue
                # the tick's span runs from the gather to the step's
                # assignment, across the locks: opened and closed by hand
                tick = profiling.annotate("mla.tick", tick=self.ticks)
                tick.__enter__()
                # a staging buffer per tick (pinned on the card): the
                # server hands one out again only after the copy from it
                # has finished, so no tick's bytes are overwritten while in
                # flight, and the gather rewrites only its changed rows
                with profiling.annotate("mla.tick.gather") as gather:
                    buf = srv.packed_buffer()
                    active = srv.gather_ready_packed(buf)
                if self._made_ready:
                    self._queue_spans(active, gather.start_ns if gather else 0)
                self._taken += active
                self._dispatching = True
            with profiling.annotate("mla.tick.upload", dev):
                dev_buf = srv.put_packed(buf)  # the upload, outside both locks
            del buf
            with profiling.annotate("mla.tick.step", dev), self.dev:
                rows = srv.patch_rows
                srv.states, srv.tl = srv._packed_step(srv.states, srv.tl, dev_buf)
                srv.dispatches += 1
                rows = srv.patch_rows - rows
            streams = int(active.sum())
            tick.set(streams=streams, ready_rows=streams * srv.chunk_patches, rows=rows)
            tick.__exit__(None, None, None)
            with self.cond:
                srv._fed |= active
                self._dispatching = False
                self.ticks += 1
                self.ticked_streams += streams
                self.cond.notify_all()

    def _queue_spans(self, active: np.ndarray, gathered_ns: int):
        """One ``mla.queue`` span per chunk the gather took that a traced
        feed made ready, ending at the gather's start (caller holds cond)."""
        for sid in np.flatnonzero(active):
            stamps = self._made_ready.get(int(sid))
            if not stamps:
                continue
            seq = int(self._taken[sid])
            while stamps and stamps[0][0] < seq:  # chunks taken while tracing was off
                stamps.popleft()
            if stamps and stamps[0][0] == seq:
                profiling.record("mla.queue", stamps.popleft()[1], gathered_ns,
                                 stream=int(sid), seq=seq, tick=self.ticks)
            if not stamps:
                del self._made_ready[int(sid)]

    def open_count_locked(self) -> int:
        """Open streams that could still contribute to this tick: any open
        slot with buffered audio (caller holds cond)."""
        return sum(b is not None and len(b) > 0 for b in self.srv._bufs) or 1
