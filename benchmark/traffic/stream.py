"""Live-stream traffic: S streams of PCM16 audio, each sending one hop of
audio every hop's duration, in real time, into the tick loop
(``serve.ticker.TickLoop`` over ``serve.server.BatchedStreamingServer``).
Open loop: a piece is handed over when it is due, whatever the server is
doing. Stream i's first piece is a whole chunk, the later ones a hop each,
due at phase_i + k * period; the phases are fixed offsets over the period
dealt in a seeded order.

Each stream's client feeds its piece (``TickLoop.feed``) and then asks for
its scores (``TickLoop.scores``), which return once the chunk is folded. A
chunk's latency runs from when its last sample was due to when its client
holds the updated scores. One generator thread hands the pieces over; a
small pool of client threads waits for the scores. A stream's next piece
is not fed before its client holds the last one's scores.

Set-up opens every stream and feeds one period before the window. The
window measures the chunks due within it; after it closes their scores are
awaited (up to a minute), and every answer is compared with the reference's
scores for the same audio.

Parameters: streams, chunk_patches, wire, clients (threads that wait for
scores), trace_seconds (the traced part at the window's end).
"""

from __future__ import annotations

import math
import queue
import threading
import time

import numpy as np
import torch

from benchmark import inputs, yardstick
from benchmark.core import nearest_rank
from benchmark.reference import compare
from benchmark.reference import model as ref
from benchmark.tracing import span

DRAIN_S = 60.0  # how long after the window's close the last answers are awaited


def chunk_geometry(fe, chunk_patches: int) -> tuple:
    """(chunk samples, hop samples, period seconds) of ``chunk_patches``
    whole patches: a chunk spans its frames' windows, and chunks step by
    whole patches."""
    g = yardstick.frontend_geometry(fe)
    frames = chunk_patches * g["patch_frames"]
    chunk = (frames - 1 + -(-g["window"] // g["hop"])) * g["hop"]
    hop = frames * g["hop"]
    return chunk, hop, hop / fe["sample_rate"]


def _sleep_until(t: float):
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.0005) if left < 0.002 else left - 0.001)


def make_inputs(r) -> dict:
    """The weights, every stream's PCM16 audio (on the device) and the
    streams' phases of a run, from its seed."""
    p, fe = r.params, r.config["frontend"]
    chunk, hop, period = chunk_geometry(fe, p["chunk_patches"])
    n_pieces = 2 + math.ceil(r.seconds / period)  # the pre-window piece, the window, one spare
    clips = inputs.make_clips(p["streams"], chunk + (n_pieces - 1) * hop, fe["sample_rate"],
                              r.seed, "stream audio", r.device)
    return {"weights": inputs.make_weights(r.config["model"], r.seed, r.device),
            "audio": inputs.pcm16(clips), "n_pieces": n_pieces,
            "phases": inputs.stream_phases(p["streams"], period, r.seed)}


def reference_scores(inp: dict, n_chunks: int, r, prec: str = "f32") -> torch.Tensor:
    """[S, n_chunks, C]: each stream's scores after each of its first
    n_chunks chunks, by the reference, from the audio the generator fed."""
    fe, cp = r.config["frontend"], r.params["chunk_patches"]
    chunk, hop, _ = chunk_geometry(fe, cp)
    wav = inp["audio"][:, : chunk + (n_chunks - 1) * hop].float() / 32768.0
    return ref.stream_scores(wav, n_chunks, cp, inp["weights"], r.config["model"], fe, prec)


def run(r) -> dict:
    from mla_tpu_torch.serve.server import BatchedStreamingServer
    from mla_tpu_torch.serve.ticker import TickLoop

    p, m, fe = r.params, r.config["model"], r.config["frontend"]
    dev, on = r.device, r.trace
    n_streams, cp = p["streams"], p["chunk_patches"]
    chunk, hop, period = chunk_geometry(fe, cp)
    r.mark("imports")
    inp = make_inputs(r)
    weights, n_pieces, phases = inp["weights"], inp["n_pieces"], inp["phases"]
    audio = inp["audio"].cpu().numpy()
    r.mark("inputs")
    srv = BatchedStreamingServer(r.cfg, inputs.program_state_dict(weights), max_streams=n_streams,
                                 chunk_patches=cp, transfer_dtype=p["wire"], device=dev)
    if (srv.chunk_samples, srv.hop_samples) != (chunk, hop):
        raise RuntimeError(f"the server's chunk / hop {srv.chunk_samples} / {srv.hop_samples} "
                           f"samples are not the configuration's {chunk} / {hop}")
    r.mark("server")
    srv.warmup(packed=True)
    r.mark("warm-up")
    loop = TickLoop(srv)
    sids = [loop.open() for _ in range(n_streams)]
    r.mark("streams open")
    if on:  # the profiler is on before any thread of the traffic runs, and off after
        r.tracer.begin()

    # (offset from the generator's start, stream, piece): every piece due
    # before the window closes; the window opens one period in
    t_close_off = period + r.seconds
    plan = sorted((float(phases[i] + k * period), i, k) for i in range(n_streams)
                  for k in range(n_pieces) if phases[i] + k * period < t_close_off)
    locks = [threading.Lock() for _ in range(n_streams)]
    work: "queue.Queue" = queue.Queue()
    answers, late, errors = {}, {}, []

    def piece(i: int, k: int) -> np.ndarray:
        start = 0 if k == 0 else chunk + (k - 1) * hop
        return audio[i, start: chunk if k == 0 else start + hop]

    def generate(t_g0: float):
        for off, i, k in plan:
            due = t_g0 + off
            _sleep_until(due)
            locks[i].acquire()  # the stream's client holds the last scores
            late[(i, k)] = time.perf_counter() - due
            try:
                with span("generate", on):
                    x = piece(i, k)
                with span("feed", on):
                    loop.feed(sids[i], x, sync=False)
            except Exception as e:  # noqa: BLE001 - a failed feed is a failed chunk
                errors.append(f"feed {i}/{k}: {e!r}")
                locks[i].release()
                continue
            work.put((i, k, due))

    def client():
        while True:
            item = work.get()
            if item is None:
                return
            i, k, due = item
            try:
                with span("scores", on):
                    s = loop.scores(sids[i])
                answers[(i, k)] = (time.perf_counter() - due, s)
            except Exception as e:  # noqa: BLE001 - a failed read is a failed chunk
                errors.append(f"scores {i}/{k}: {e!r}")
            finally:
                locks[i].release()

    clients = [threading.Thread(target=client, name=f"bench-client-{j}", daemon=True)
               for j in range(p["clients"])]
    for c in clients:
        c.start()
    t_g0 = time.perf_counter() + 0.05
    gen = threading.Thread(target=generate, args=(t_g0,), name="bench-generate", daemon=True)
    gen.start()
    t_w0, t_w1 = t_g0 + period, t_g0 + t_close_off
    _sleep_until(t_w0)
    ticks0, streams0 = loop.ticks, loop.ticked_streams
    r.setup_s = t_w0 - r.t_start  # the window opens on the schedule: set-up is all before it
    r.note(f"{r.name}: set-up {r.setup_s:.6f} s, one period of it traffic; done by then "
           f"{r.marks}")
    trace_at = r.trace_start_at(t_w0)
    if on:
        _sleep_until(trace_at)
        traced0 = loop.ticked_streams
        r.tracer.open()
    _sleep_until(t_w1)
    ticks1, streams1 = loop.ticks, loop.ticked_streams
    backlog = loop.backlog()
    traced = loop.ticked_streams - traced0 if on else 0
    r.window_closed(keep_profiling=True)
    gen.join(timeout=DRAIN_S)
    for _ in clients:
        work.put(None)
    t_end = time.perf_counter() + DRAIN_S
    for c in clients:
        c.join(timeout=max(0.0, t_end - time.perf_counter()))
    stuck = gen.is_alive() or any(c.is_alive() for c in clients)
    loop.stop()
    if on:
        r.tracer.end()

    in_window = [(i, k) for off, i, k in plan if off >= period]
    lat = [answers[key][0] * 1e3 for key in in_window if key in answers]
    failed = len(in_window) - len(lat)
    r.counters.update(
        gen_late_ms=[late[key] * 1e3 for key in in_window if key in late],
        ticks=ticks1 - ticks0, ticked_streams=streams1 - streams0, traced_rows=traced,
        row_bound_s=yardstick.frontend_bound_s(1, chunk, fe, fe["precision"]),
        row_flops=cp * yardstick.forward_flops_per_patch(m, fe) + yardstick.head_flops_per_clip(m))
    r.note(f"{r.name}: {len(in_window)} chunks due in the window, {len(lat)} answered; p50 "
           f"{nearest_rank(lat, 0.5) if lat else None} ms; {ticks1 - ticks0} ticks, "
           f"{streams1 - streams0} streams ticked; backlog at the close {backlog}; peak "
           f"{r.memory_peak_bytes} bytes; errors {errors[:3]}; threads left {stuck}")

    del loop, srv
    if r.on_card:
        torch.cuda.empty_cache()
    want = reference_scores(inp, 1 + max(k for _, _, k in plan), r)
    got = {key: torch.from_numpy(np.asarray(v[1], np.float32)) for key, v in answers.items()}
    gap = max((compare.max_abs_gap(v, want[i, k]) for (i, k), v in got.items()),
              default=float("inf"))
    return {"attempted": len(in_window), "failed": failed + (1 if stuck else 0),
            "metrics": {"chunk_p95_ms": nearest_rank(lat, 0.95) if lat else float("inf")},
            "checks": {"score_gap": (gap, r.limits["score_gap"])}}


def control(r) -> dict:
    """The reading of the control (the reference in fp8 in the program's
    place) against the reference, over every chunk a window of this run's
    length serves."""
    inp = make_inputs(r)
    n_chunks = inp["n_pieces"] - 1
    want = reference_scores(inp, n_chunks, r)
    return {"control": {"score_gap": compare.max_abs_gap(
        reference_scores(inp, n_chunks, r, "fp8"), want)}}
