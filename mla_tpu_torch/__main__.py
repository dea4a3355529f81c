"""CLI of the PyTorch port (counterpart of ``mla_tpu/__main__.py``). The
``train``, ``serve``, ``tag``, ``export``, ``cv``, ``parity`` and ``doctor``
verbs are ported so far (ROADMAP.md queue A, item 10 lists the rest):

    python -m mla_tpu_torch train --config us8k_fused_frontend [--set k=v ...]
                                  [--workspace W] [--resume] [--device cpu]
    python -m mla_tpu_torch serve [--config streaming_inference] [--native]
                                  [--checkpoint latest|random] [--port 8000]
                                  [--transfer_dtype int16] [--device cpu] ...
    python -m mla_tpu_torch tag --url http://127.0.0.1:8000 --wav clip.wav
                                [--wire adpcm4] [--top_k 5]
    python -m mla_tpu_torch export --out model.mlxt [--streaming]
                                   [--input_dtype adpcm4] [--batch 8] [--device cpu] ...
    python -m mla_tpu_torch cv --wav_dir D --labels_csv meta.csv [--folds 1,2]
                               [--set k=v ...] [--device cpu]
    python -m mla_tpu_torch parity [--device cpu]
    python -m mla_tpu_torch doctor [--quick] [--device_timeout 120] [--device cpu]

``train``, ``serve`` and ``export`` run on the card (``--device cpu`` asks
for the CPU). ``train`` prints one JSON line: the final logged loss and the
last eval stats. ``serve`` prints ``serving <variant> on
http://host:port/v1 (...)`` and serves until interrupted; ``tag`` tags a wav
through a running service and prints its top-k as one JSON line; ``export``
writes a ``torch.export`` artifact (``serve/export.py``) and prints its
header as one JSON line. ``cv`` runs the fold rotation on the card and prints
the per-fold and mean / std stats as one JSON line; ``parity`` prints one
JSON line per check and exits 1 when one that ran failed; ``doctor`` prints
one JSON report and exits 0 (ok), 1 (degraded) or 2 (no device).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _jdump(obj) -> str:
    """Strict-JSON dumps: non-finite floats (e.g. d' = inf at AUC 1.0)
    become strings so downstream parsers do not choke on 'Infinity'."""

    def clean(v):
        if isinstance(v, float) and not np.isfinite(v):
            return str(v)
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        return v

    return json.dumps(clean(obj))


def _parse_sets(pairs):
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def cmd_train(args):
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.train.loop import fit

    cfg = get_config(args.config, _parse_sets(args.set))
    result = fit(cfg, workspace=args.workspace, auto_resume=args.resume, device=args.device)
    last_eval = result.eval_stats[-1] if result.eval_stats else {}
    print(_jdump({"final_loss": result.history[-1]["loss"] if result.history else None,
                  **last_eval,
                  **({"interrupted": True} if result.interrupted else {})}))


def _write_timeline_csv(path, start_patch, hop_s, col_names, probs, atts):
    """The per-patch localization CSV (``tag --timeline``): one row per 0.96 s
    patch with absolute patch indices and times, columns prob:<label>
    (segment classifier) and att:<label> (time-normalized attention weight;
    uniform = 1/n_patches) per selected class, level-averaged. probs / atts:
    [T, k] arrays, columns ordered like col_names."""
    probs = np.asarray(probs, np.float32)
    atts = np.asarray(atts, np.float32)
    with open(path, "w") as fh:
        cols = ",".join(f"prob:{n},att:{n}" for n in col_names)
        fh.write(f"patch,time_s,{cols}\n")
        for t in range(probs.shape[0]):
            patch = start_patch + t
            vals = ",".join(f"{probs[t, j]:.6f},{atts[t, j]:.6f}"
                            for j in range(probs.shape[1]))
            fh.write(f"{patch},{patch * hop_s:.3f},{vals}\n")
    print(f"# timeline: {probs.shape[0]} patches x top-{len(col_names)} "
          f"classes -> {path}", file=sys.stderr)


def _threshold_desc(args):
    """The operating point recorded in an events file: the scalar
    --event_threshold, or the provenance of a per-class --thresholds table."""
    t = getattr(args, "thresholds", None)
    return f"per-class ({t})" if t else args.event_threshold


def _serving_weights(args, cfg):
    """The weights ``serve`` starts with: the workspace's latest checkpoint
    (EMA parameters where the config evaluates with them), or seeded random
    weights with ``--checkpoint random`` or when there is no checkpoint."""
    from mla_tpu_torch.models.zoo import build_model

    if args.checkpoint != "random":
        from mla_tpu_torch.train.loop import resume
        from mla_tpu_torch.train.state import eval_params, variables_from_state

        try:
            state, _ = resume(cfg, args.workspace, device="cpu")
            return variables_from_state(state, eval_params(cfg, state))
        except FileNotFoundError:
            print("# no checkpoint found: using random weights (demo mode)", file=sys.stderr)
    return build_model(cfg.model, device="cpu", seed=0).state_dict()


def cmd_serve(args):
    """Run the HTTP streaming-inference service: open / feed / scores /
    flush / close per stream, one batched device step per tick across all
    open streams."""
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.serve.http import create_server, start_reload_watcher
    from mla_tpu_torch.train.checkpoint import CheckpointManager

    cfg = get_config(args.config, _parse_sets(args.set))
    # the step on disk BEFORE loading: a checkpoint that lands while the
    # server is built and warmed up still triggers the watcher's reload
    ckdir = os.path.join(args.workspace or cfg.workspace, "checkpoints", cfg.name)
    loaded_step = (CheckpointManager(ckdir).latest_step()
                   if args.checkpoint != "random" and os.path.isdir(ckdir) else None)
    state_dict = _serving_weights(args, cfg)

    def reload_fn():
        # POST /v1/reload and the --reload_every watcher: re-read the
        # workspace's latest checkpoint; a missing one is an error here,
        # not a fall-back to random weights mid-service
        from mla_tpu_torch.train.loop import resume
        from mla_tpu_torch.train.state import eval_params, variables_from_state

        state, _ = resume(cfg, args.workspace, device="cpu")
        return (variables_from_state(state, eval_params(cfg, state)),
                {"step": int(state.step)})

    kwargs = dict(port=args.port, host=args.host, max_streams=args.max_streams,
                  chunk_patches=args.chunk_patches, transfer_dtype=args.transfer_dtype,
                  timeline_cap=args.timeline_cap, reload_fn=reload_fn, device=args.device)
    if args.native:
        from mla_tpu_torch.serve.native_front import create_native_server

        srv = create_native_server(cfg, state_dict, **kwargs)
    else:
        srv = create_server(cfg, state_dict, **kwargs)
    if args.reload_every > 0:
        start_reload_watcher(srv, ckdir, args.reload_every, initial_step=loaded_step)
    host, port = srv.server_address[:2]
    front = "native C++ front" if args.native else "stdlib front"
    print(f"serving {cfg.model.variant} on http://{host}:{port}/v1 "
          f"({front}, max_streams={args.max_streams})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


def cmd_export(args):
    """Export the waveform -> probs forward (or, with --streaming, the
    chunk-fold + finalize pair) with the serving weights in it, as a
    ``torch.export`` artifact on --device."""
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.serve.export import export_forward, export_streaming

    cfg = get_config(args.config, _parse_sets(args.set))
    state_dict = _serving_weights(args, cfg)
    if args.streaming:
        meta = export_streaming(cfg, state_dict, args.out, streams=args.batch,
                                chunk_patches=args.chunk_patches, input_dtype=args.input_dtype,
                                timeline_cap=args.timeline_cap, device=args.device)
    else:
        meta = export_forward(cfg, state_dict, args.out, batch=args.batch, seconds=args.seconds,
                              input_dtype=args.input_dtype, device=args.device)
    print(_jdump({"out": args.out, **meta}))


def cmd_tag(args):
    """Client side of ``serve``: tag a wav through a running service,
    uploading in the chosen wire encoding (serve/client.py). With
    ``--timeline CSV`` / ``--events JSON`` the clip goes through the stream
    API instead of /v1/tag, so the per-patch localization window can be
    fetched after the flush (the service must run with --timeline_cap >
    0); events are detected on the client (serve/events.py)."""
    from mla_tpu_torch.data import audio_io
    from mla_tpu_torch.serve.client import TagClient

    c = TagClient(args.url)
    if args.timeline or args.events:
        sr = int(c.health().get("sample_rate", 16000))
        wav = audio_io.load_wav_16k(args.wav, sr)
        wire = "int16" if args.wire == "wav" else args.wire
        with c.stream(wire=wire) as s:
            s.feed(wav)
            s.flush()
            top = s.scores(top_k=args.top_k)
            tl = s.timeline(top_k=args.top_k)
        if args.timeline:
            _write_timeline_csv(args.timeline, tl["start_patch"], tl["hop_s"],
                                [n for n, _ in tl["classes"]], tl["probs"], tl["weights"])
        if args.events:
            from mla_tpu_torch.serve.events import events_from_timeline_payload

            threshold = args.event_threshold
            if args.thresholds:
                with open(args.thresholds) as fh:
                    threshold = json.load(fh)["thresholds"]
            events = events_from_timeline_payload(
                tl, threshold=threshold, merge_gap_s=args.event_gap,
                min_dur_s=args.event_min_dur)
            with open(args.events, "w") as fh:
                json.dump({"hop_s": tl["hop_s"], "threshold": _threshold_desc(args),
                           "events": events}, fh, indent=1)
            print(f"# events: {len(events)} -> {args.events}", file=sys.stderr)
    elif args.wire == "wav":
        top = c.tag_file(args.wav, top_k=args.top_k)
    else:
        sr = int(c.health().get("sample_rate", 16000))
        wav = audio_io.load_wav_16k(args.wav, sr)
        top = c.tag(wav, top_k=args.top_k, wire=args.wire)
    print(_jdump({"top_k": [[n, float(p)] for n, p in top]}))


def cmd_cv(args):
    """k-fold cross-validation: pack each fold rotation once, run fit() per
    held-out fold on --device, print the per-fold and mean / std final eval
    metrics (the ESC-50 / UrbanSound8K protocol)."""
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.train.cv import cross_validate

    cfg = get_config(args.config, _parse_sets(args.set))
    folds = [int(f) for f in args.folds.split(",")] if args.folds else None
    out = cross_validate(cfg, args.wav_dir, args.labels_csv,
                         workspace=args.workspace or cfg.workspace, folds=folds,
                         log=not args.quiet, device=args.device)
    print(_jdump(out))


def cmd_parity(args):
    """The parity harness on --device: one JSON line per check; exit 1 when
    a check that ran failed."""
    from mla_tpu_torch import parity

    return parity.main(device=args.device)


def cmd_doctor(args):
    """Environment self-check: prints one JSON report; exit 0 = ok,
    1 = degraded, 2 = no device."""
    from mla_tpu_torch.utils import doctor

    report = doctor.run(device=args.device, device_timeout_s=args.device_timeout,
                        quick=args.quick)
    print(_jdump(report))
    return {"ok": 0, "degraded": 1, "no-device": 2}[report["verdict"]["status"]]


def main(argv=None):
    p = argparse.ArgumentParser(prog="mla_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    st = sub.add_parser("train", help="train per config")
    st.add_argument("--config", default="esc50_single_attention")
    st.add_argument("--workspace", default=None)
    st.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint and continue")
    st.add_argument("--set", nargs="*")
    st.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    st.set_defaults(fn=cmd_train)

    ss = sub.add_parser("serve", help="HTTP streaming-inference service")
    ss.add_argument("--config", default="streaming_inference")
    ss.add_argument("--workspace", default=None)
    ss.add_argument("--checkpoint", default="latest",
                    help="'latest' (the workspace's newest checkpoint; random weights "
                         "when there is none) or 'random' (seeded random weights)")
    ss.add_argument("--host", default="127.0.0.1")
    ss.add_argument("--port", type=int, default=8000)
    ss.add_argument("--max_streams", type=int, default=8)
    ss.add_argument("--chunk_patches", type=int, default=5,
                    help="patches per device tick: each tick folds chunk_patches * 0.96 s "
                         "per stream, so scores lag by that much; larger values spread the "
                         "fixed per-tick cost over more audio")
    ss.add_argument("--transfer_dtype", default="int16",
                    choices=["int16", "float32", "uint8", "adpcm4", "adpcm2"],
                    help="the wire the server buffers and uploads: int16 halves the "
                         "host-to-device bytes of float32, uint8 (8-bit mu-law) quarters "
                         "them, adpcm4 / adpcm2 (block ADPCM, decoded on the card) are "
                         "~1/8 and ~1/13")
    ss.add_argument("--native", action="store_true",
                    help="serve through the C++ front (native/serve_front.cpp): HTTP "
                         "parsing, stream buffers and backpressure run without the GIL; "
                         "Python runs device ticks and rare control requests")
    ss.add_argument("--timeline_cap", type=int, default=0,
                    help="enable GET /v1/streams/<sid>/timeline: keep the last N patches' "
                         "localization readout in a ring on the device (0 = off)")
    ss.add_argument("--reload_every", type=float, default=0,
                    help="poll the workspace every N seconds and swap weights whenever "
                         "training wrote a newer checkpoint (0 = off); POST /v1/reload "
                         "triggers the same swap on demand")
    ss.add_argument("--set", nargs="*")
    ss.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    ss.set_defaults(fn=cmd_serve)

    sg = sub.add_parser("tag", help="tag a wav via a running serve endpoint")
    sg.add_argument("--url", default="http://127.0.0.1:8000")
    sg.add_argument("--wav", required=True)
    sg.add_argument("--top_k", type=int, default=5)
    sg.add_argument("--wire", default="adpcm4",
                    choices=["wav", "float32", "int16", "mulaw", "adpcm4", "adpcm2"],
                    help="upload encoding; adpcm4 is ~1/8 of float32 and decodes on the "
                         "serving device")
    sg.add_argument("--timeline", default=None, metavar="CSV",
                    help="also fetch the per-patch localization window (the server must "
                         "run with --timeline_cap > 0) and write it as CSV")
    sg.add_argument("--events", default=None, metavar="JSON",
                    help="also detect discrete events from the timeline window "
                         "(on the client)")
    sg.add_argument("--event_threshold", type=float, default=0.5)
    sg.add_argument("--thresholds", default=None, metavar="JSON",
                    help="per-class thresholds, a JSON file with a 'thresholds' table "
                         "(overrides --event_threshold)")
    sg.add_argument("--event_gap", type=float, default=0.0)
    sg.add_argument("--event_min_dur", type=float, default=0.0)
    sg.set_defaults(fn=cmd_tag)
    sx = sub.add_parser("export", help="export waveform -> probs as a torch.export artifact")
    sx.add_argument("--config", default="streaming_inference")
    sx.add_argument("--workspace", default=None)
    sx.add_argument("--checkpoint", default="latest",
                    help="'latest' (the workspace's newest checkpoint; random weights "
                         "when there is none) or 'random' (seeded random weights)")
    sx.add_argument("--out", required=True)
    sx.add_argument("--batch", type=int, default=8,
                    help="clips per call (one-shot) / streams (--streaming)")
    sx.add_argument("--seconds", type=float, default=10.0)
    sx.add_argument("--streaming", action="store_true",
                    help="export the O(1)-state streaming tagger instead: a chunk-fold + "
                         "finalize program pair for unbounded audio (loop chunks, read scores "
                         "any time; load_exported_streaming)")
    sx.add_argument("--chunk_patches", type=int, default=5,
                    help="patches per chunk call (--streaming)")
    sx.add_argument("--timeline_cap", type=int, default=0,
                    help="with --streaming: fold the localization ring inside the chunk "
                         "program (StreamingArtifact.timeline reads the window; 0 = off)")
    sx.add_argument("--input_dtype", default="float32",
                    choices=["float32", "int16", "uint8", "adpcm4", "adpcm2"],
                    help="bake the wire in: int16 PCM, uint8 mu-law and adpcm4 / adpcm2 wire "
                         "inputs are decoded inside the exported program")
    sx.add_argument("--set", nargs="*")
    sx.add_argument("--device", default=None,
                    help="torch device the program is exported on; default the card "
                         "(raises without one)")
    sx.set_defaults(fn=cmd_export)

    sc = sub.add_parser("cv", help="k-fold cross-validation (ESC-50 / US8K protocol)")
    sc.add_argument("--config", default="esc50_single_attention")
    sc.add_argument("--wav_dir", required=True, help="wav corpus root")
    sc.add_argument("--labels_csv", required=True, help="metadata CSV with a 'fold' column")
    sc.add_argument("--workspace", default=None)
    sc.add_argument("--folds", default=None,
                    help="comma-separated held-out folds to run (default: all)")
    sc.add_argument("--quiet", action="store_true")
    sc.add_argument("--set", nargs="*")
    sc.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    sc.set_defaults(fn=cmd_cv)

    sy = sub.add_parser("parity", help="run the reference-parity harness")
    sy.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    sy.set_defaults(fn=cmd_parity)

    sd = sub.add_parser("doctor", help="environment self-check (device probe, fetch RTT, "
                        "synchronize, builds, TF32 flags, exclusive-card spread)")
    sd.add_argument("--quick", action="store_true", help="skip the GEMM throughput spot check")
    sd.add_argument("--device_timeout", type=float, default=120.0,
                    help="seconds before the device probe is declared hung")
    sd.add_argument("--device", default=None,
                    help="check this torch device (default the card; 'cpu' checks the host)")
    sd.set_defaults(fn=cmd_doctor)
    args = p.parse_args(argv)
    rc = args.fn(args)
    return 0 if rc is None else rc


if __name__ == "__main__":
    sys.exit(main())
