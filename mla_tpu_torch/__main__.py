"""CLI of the PyTorch port (counterpart of ``mla_tpu/__main__.py``), with
every verb of the reference's:

    python -m mla_tpu_torch configs
    python -m mla_tpu_torch summary [--config audioset_full_dp] [--set k=v ...]
    python -m mla_tpu_torch prep --out pack.h5 [--config C] [--split train|eval]
                                 [--quantize] [--tfrecords GLOB | --wav_dir D
                                 [--labels_csv meta.csv] [--folds 1,2]]
    python -m mla_tpu_torch extract --wav a.wav --out patches.npy [--device cpu]
    python -m mla_tpu_torch embed --wav a.wav --out emb.npy [--checkpoint latest|random]
                                  [--device cpu]
    python -m mla_tpu_torch train --config us8k_fused_frontend [--set k=v ...]
                                  [--workspace W] [--resume] [--device cpu]
    python -m mla_tpu_torch eval [--config C] [--workspace W] [--per_class out.csv]
                                 [--calibrate thr.json] [--events [--sweep]]
                                 [--device cpu]
    python -m mla_tpu_torch cv --wav_dir D --labels_csv meta.csv [--folds 1,2]
                               [--set k=v ...] [--device cpu]
    python -m mla_tpu_torch infer (--wav a.wav | --wav_dir D) [--stream]
                                  [--timeline CSV] [--events JSON] [--plot PNG]
                                  [--device cpu]
    python -m mla_tpu_torch weights (--out w.npz [--ema] | --load w.npz
                                    [--allow_partial]) [--config C] [--workspace W]
    python -m mla_tpu_torch export --out model.mlxt [--streaming]
                                   [--input_dtype adpcm4] [--batch 8] [--device cpu] ...
    python -m mla_tpu_torch serve [--config streaming_inference] [--native]
                                  [--checkpoint latest|random] [--port 8000]
                                  [--transfer_dtype int16] [--device cpu] ...
    python -m mla_tpu_torch tag --url http://127.0.0.1:8000 --wav clip.wav
                                [--wire adpcm4] [--top_k 5]
    python -m mla_tpu_torch profile [--config C] [--out DIR] [--steps 10] [--device cpu]
    python -m mla_tpu_torch parity [--device cpu]
    python -m mla_tpu_torch doctor [--quick] [--device_timeout 120] [--device cpu]

Verbs that run a model run it on the card (``--device cpu`` asks for the
CPU); ``summary`` builds on the meta device and reads no weights.
``weights`` is the bridge to the reference's checkpoints: ``--out`` writes
the flat ``.npz`` that ``python -m mla_tpu weights --load`` reads, and
``--load`` reads the one its ``--out`` writes. ``train``, ``eval``, ``cv``
and ``profile`` print one JSON line of stats; ``infer`` one line of top-k
(one per clip with ``--wav_dir``); ``serve`` prints ``serving <variant> on
http://host:port/v1 (...)`` and serves until interrupted; ``export`` prints
its artifact's header; ``parity`` prints one JSON line per check and exits
1 when one that ran failed; ``doctor`` prints one JSON report and exits 0
(ok), 1 (degraded) or 2 (no device).
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


def _load_cfg(args):
    from mla_tpu_torch.config import get_config

    return get_config(args.config, _parse_sets(args.set))


def _input_kind(cfg) -> str:
    return "features" if cfg.model.trunk == "none" else "waveform"


def cmd_configs(_args):
    from mla_tpu_torch.config import list_configs

    print("\n".join(list_configs()))


def cmd_summary(args):
    """Per-module parameter table (Keras ``model.summary()``'s role) under
    the flat format's names and layout, as the reference prints it: built on
    the meta device, so no weight is materialized."""
    import torch

    from mla_tpu_torch.models.convert import flat_shapes
    from mla_tpu_torch.models.zoo import AudioTagger

    cfg = _load_cfg(args)
    with torch.device("meta"):
        shapes = flat_shapes(AudioTagger(cfg.model).state_dict())

    def rows_of(collection):
        # (path, shape, count) per leaf, each path level in sorted order
        keys = sorted((k for k in shapes if k.startswith(collection + "/")),
                      key=lambda k: k.split("/"))
        return [(k.split("/", 1)[1], shapes[k], int(np.prod(shapes[k]) or 1)) for k in keys]

    rows = rows_of("params")
    width = max(len(r[0]) for r in rows)
    groups = {}
    for name, shape, count in rows:
        print(f"{name:<{width}}  {str(shape):<20} {count:>12,}")
        groups[name.split("/")[0]] = groups.get(name.split("/")[0], 0) + count
    total = sum(c for _, _, c in rows)
    print("-" * (width + 35))
    for g, c in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"{g:<{width}}  {'':<20} {c:>12,}  ({100*c/total:.1f}%)")
    bn = sum(c for _, _, c in rows_of("batch_stats"))
    print(f"{'TOTAL params':<{width}}  {'':<20} {total:>12,}")
    if bn:
        print(f"{'batch_stats (non-trainable)':<{width}}  {'':<20} {bn:>12,}")
    print(f"~{(total + bn) * 4 / 1e6:.1f} MB f32; variant={cfg.model.variant} "
          f"trunk={cfg.model.trunk} classes={cfg.model.n_classes}")


def cmd_prep(args):
    """Pack the configured synthetic dataset to HDF5, or AudioSet TFRecords
    with --tfrecords=<glob>, or a local wav corpus (ESC-50 / US8K style)
    with --wav_dir [--labels_csv]."""
    cfg = _load_cfg(args)
    if args.wav_dir:
        from mla_tpu_torch.data.folder import pack_folder

        folds = [int(f) for f in args.folds.split(",")] if args.folds else None
        n, classes = pack_folder(args.wav_dir, args.out, cfg.data.clip_seconds,
                                 cfg.frontend.sample_rate, labels_csv=args.labels_csv,
                                 n_classes=cfg.model.n_classes, folds=folds)
        print(f"packed {n} clips / {len(classes)} classes -> {args.out}")
        return
    if args.tfrecords:
        from mla_tpu_torch.data.audioset import pack_audioset

        n = pack_audioset(args.tfrecords, args.out, cfg.model.n_classes)
        print(f"packed {n} AudioSet clips -> {args.out}")
        return
    from mla_tpu_torch.data import hdf5
    from mla_tpu_torch.data.synthetic import make_dataset

    ds = make_dataset(cfg.data, cfg.model.n_classes, args.split, _input_kind(cfg), cfg.frontend)
    hdf5.pack_hdf5(args.out, ds.x, ds.y.astype(bool), ds.ids, quantize=args.quantize)
    print(f"packed {len(ds.x)} clips ({ds.kind}) -> {args.out}")


def cmd_extract(args):
    """Wav file -> log-mel patches .npy through the torch-ops front-end on
    --device."""
    import torch

    from mla_tpu_torch._device import resolve_device
    from mla_tpu_torch.data import audio_io
    from mla_tpu_torch.ops.frontend import waveform_to_patches

    cfg = _load_cfg(args)
    dev = resolve_device(args.device)
    wav = audio_io.load_wav_16k(args.wav, cfg.frontend.sample_rate)
    with torch.inference_mode():
        patches = waveform_to_patches(torch.from_numpy(wav).to(dev), cfg.frontend).cpu().numpy()
    np.save(args.out, patches)
    print(f"{args.wav}: {len(wav)} samples -> patches {patches.shape} -> {args.out}")


def _initialize(args):
    """Bring up the process group when a launcher set one up (e.g. ``python
    -m torch.distributed.run --nproc_per_node N -m mla_tpu_torch train``);
    gloo for --device cpu, otherwise the card's default."""
    from mla_tpu_torch.parallel.distributed import initialize

    return initialize(backend="gloo" if args.device == "cpu" else None)


def cmd_train(args):
    from mla_tpu_torch.parallel import distributed
    from mla_tpu_torch.train.loop import fit

    _initialize(args)
    try:
        cfg = _load_cfg(args)
        result = fit(cfg, workspace=args.workspace, auto_resume=args.resume, device=args.device)
        last_eval = result.eval_stats[-1] if result.eval_stats else {}
        if distributed.is_primary():
            print(_jdump({"final_loss": result.history[-1]["loss"] if result.history else None,
                          **last_eval,
                          **({"interrupted": True} if result.interrupted else {})}))
    finally:
        distributed.shutdown()


def cmd_eval(args):
    """calculate_stats on the eval set from the latest checkpoint, on
    --device; with --per_class, --calibrate and --events the per-class
    table, the calibrated thresholds and the event-detection scores."""
    from mla_tpu_torch.parallel import distributed

    _initialize(args)
    try:
        _eval(args, distributed.is_primary())
    finally:
        distributed.shutdown()


def _eval(args, primary: bool):
    """The eval verb's work; in a process group every rank forwards its
    rows of each batch (with train.model_parallel > 1 over its shards of
    the checkpoint) and only the primary writes and prints."""
    from mla_tpu_torch._device import resolve_device
    from mla_tpu_torch.data.labels import labels_for
    from mla_tpu_torch.data.synthetic import make_dataset
    from mla_tpu_torch.train.loop import data_parallel, eval_scores, resume
    from mla_tpu_torch.train.state import eval_params, make_eval_step, variables_from_state
    from mla_tpu_torch.utils.metrics import calculate_stats

    cfg = _load_cfg(args)
    dev = resolve_device(args.device)
    dp = data_parallel(cfg, dev)
    state, _ = resume(cfg, args.workspace, device=dev, dp=dp)
    kind = _input_kind(cfg)
    eval_ds = make_dataset(cfg.data, cfg.model.n_classes, "eval", kind, cfg.frontend)
    # one pass, each batch uploaded and the last padded by repeating its
    # last row: the scores feed the stats and the per-class outputs alike
    scores = eval_scores(cfg, state, eval_ds, make_eval_step(cfg, state.model, kind), dev,
                         dp=dp)
    # the whole weights (tensor parallel: gathered, every rank joining)
    variables = variables_from_state(state, eval_params(cfg, state)) if args.events else None
    if not primary:
        return
    stats = calculate_stats(scores, eval_ds.y)
    names = labels_for(cfg.data.dataset, cfg.model.n_classes)
    if args.per_class:
        from mla_tpu_torch.utils.metrics import write_per_class_csv

        write_per_class_csv(args.per_class, scores, eval_ds.y, names)
    if args.calibrate:
        # per-class decision thresholds at a precision target (maximal
        # recall), for infer --events / tag --events via --thresholds
        from mla_tpu_torch.utils.metrics import calibrate_thresholds

        thr = calibrate_thresholds(scores, eval_ds.y, args.target_precision)
        with open(args.calibrate, "w") as fh:
            # full precision: rounding could move a threshold across the
            # score boundary the calibrator placed it between
            json.dump({"target_precision": args.target_precision,
                       "thresholds": {n: float(t) for n, t in zip(names, thr)}}, fh, indent=1)
        print(f"# thresholds: {len(thr)} classes at precision>={args.target_precision} "
              f"-> {args.calibrate}", file=sys.stderr)
    if args.events:
        # the timeline -> detect_events chain scored against known event
        # boundaries, DCASE segment-based
        from mla_tpu_torch.train.sed_eval import evaluate_sed, sweep_sed_threshold

        sed = dict(n_clips=args.sed_clips, merge_gap_s=args.event_gap,
                   min_dur_s=args.event_min_dur, segment_s=args.segment_s, device=dev)
        stats["events"] = evaluate_sed(cfg, variables, threshold=_resolve_threshold(args, names),
                                       **sed)
        if args.sweep:
            # the segment-F1-optimal scalar threshold: one device pass,
            # every candidate scored on the host
            grid = (np.array([float(v) for v in args.sweep.split(",")])
                    if args.sweep != "default" else None)
            stats["events_sweep"] = sweep_sed_threshold(cfg, variables, thresholds=grid, **sed)
    print(_jdump(stats))


def cmd_embed(args):
    """Wav -> segment embeddings [T, embed_dim] .npy (f32) through the
    configured front-end (the fused kernel under frontend.impl="pallas") and
    trunk, on --device."""
    import torch

    from mla_tpu_torch._device import resolve_device
    from mla_tpu_torch.data import audio_io
    from mla_tpu_torch.ops.frontend import apply_frontend
    from mla_tpu_torch.serve.streaming import _model_with_weights

    cfg = _load_cfg(args)
    dev = resolve_device(args.device)
    wav = audio_io.load_wav_16k(args.wav, cfg.frontend.sample_rate)
    model = _model_with_weights(cfg, _serving_weights(args, cfg), dev)
    with torch.inference_mode():
        patches = apply_frontend(torch.from_numpy(wav)[None].to(dev), cfg.frontend)
        emb = model.embed(patches)[0].float().cpu().numpy()
    np.save(args.out, emb)
    print(f"{args.wav}: embeddings {emb.shape} -> {args.out}")


def cmd_infer(args):
    """Tag a wav (one-shot, or chunk by chunk with --stream) or every wav
    under --wav_dir on --device; print the top-k as JSON."""
    from mla_tpu_torch._device import resolve_device
    from mla_tpu_torch.data import audio_io
    from mla_tpu_torch.data.labels import labels_for
    from mla_tpu_torch.ops.frontend import patch_hop_seconds
    from mla_tpu_torch.serve.streaming import StreamingTagger, tag_clip

    cfg = _load_cfg(args)
    dev = resolve_device(args.device)
    state_dict = _serving_weights(args, cfg)
    want_tl = bool(args.timeline or args.events or args.plot)
    if args.wav_dir:
        if args.wav:
            raise SystemExit("infer: pass one of --wav / --wav_dir")
        if args.plot:
            raise SystemExit("infer: --plot is single-clip (--wav); batch "
                             "mode writes --timeline CSVs to plot from")
        _infer_dir(args, cfg, state_dict, dev)
        return
    if not args.wav:
        raise SystemExit("infer: one of --wav / --wav_dir is required")
    wav = audio_io.load_wav_16k(args.wav, cfg.frontend.sample_rate)
    hop_s = patch_hop_seconds(cfg.frontend)
    start_patch = 0
    if args.stream:
        # --stream is for long-form audio in O(1) memory, so the timeline
        # comes from the tagger's ring on the device (the last
        # --timeline_cap patches), not a whole-clip one-shot forward
        tagger = StreamingTagger(cfg, state_dict, timeline_cap=args.timeline_cap if want_tl else 0,
                                 device=dev)
        block = cfg.frontend.sample_rate  # feed 1 s at a time
        for s in range(0, len(wav), block):
            tagger.feed(wav[s: s + block])
        tagger.flush()
        scores = tagger.scores()
        if want_tl:
            start_patch, levels = tagger.timeline()
            w = np.mean([wl for wl, _ in levels], axis=0)
            f = np.mean([fl for _, fl in levels], axis=0)
    else:
        scores = tag_clip(cfg, state_dict, wav, device=dev)
        if want_tl:
            w, f = _timeline_mean(cfg, state_dict, wav, dev)
    names = labels_for(cfg.data.dataset, cfg.model.n_classes, args.labels_csv)
    top = np.argsort(-scores)[: args.top_k]
    if want_tl:
        if args.timeline:
            _write_timeline_csv(args.timeline, start_patch, hop_s, [names[i] for i in top],
                                f[:, top], w[:, top])
        if args.events:
            _write_events(w, f, hop_s, start_patch, top, names, args)
        if args.plot:
            from mla_tpu_torch.utils import plot as uplot

            mel = mel_hop = None
            if not args.stream:
                # one-shot: the clip's patches tile the log-mel spectrogram
                # exactly (the VGGish non-overlapping default)
                import torch

                from mla_tpu_torch.ops.frontend import waveform_to_patches

                with torch.inference_mode():
                    patches = waveform_to_patches(torch.from_numpy(wav)[None].to(dev),
                                                  cfg.frontend)[0].cpu().numpy()
                mel = uplot.continuous_mel(patches, cfg.frontend)
                mel_hop = cfg.frontend.stft_hop_seconds
            uplot.plot_timeline(args.plot, hop_s, [names[i] for i in top], f[:, top], w[:, top],
                                start_patch=start_patch, mel=mel, mel_hop_s=mel_hop,
                                title=os.path.basename(args.wav))
    print(_jdump({"top_k": [[names[i], float(scores[i])] for i in top]}))


def _infer_dir(args, cfg, state_dict, dev):
    """Tag every wav under --wav_dir (recursive), one JSONL line per clip
    on stdout. Clips of any length go through one reset() StreamingTagger.

    ``--events JSON`` puts each clip's events into its line and (unless the
    path is ``-``) writes one combined ``{relpath: events}`` file;
    ``--timeline DIR`` writes one per-patch CSV per clip under DIR (the
    corpus layout mirrored). Both read the tagger's ring on the device, so a
    clip longer than ``--timeline_cap`` patches reports its last cap
    patches, as ``infer --stream --timeline`` does."""
    import glob as _glob

    from mla_tpu_torch.data import audio_io
    from mla_tpu_torch.data.labels import labels_for
    from mla_tpu_torch.ops.frontend import patch_hop_seconds
    from mla_tpu_torch.serve.events import detect_events
    from mla_tpu_torch.serve.streaming import StreamingTagger

    want_tl = bool(args.timeline or args.events)
    paths = sorted(_glob.glob(os.path.join(args.wav_dir, "**", "*.wav"), recursive=True))
    if not paths:
        raise SystemExit(f"infer: no .wav files under {args.wav_dir}")
    names = labels_for(cfg.data.dataset, cfg.model.n_classes, args.labels_csv)
    threshold = _resolve_threshold(args, names) if args.events else None
    if args.timeline:
        os.makedirs(args.timeline, exist_ok=True)
    hop_s = patch_hop_seconds(cfg.frontend)
    tagger = StreamingTagger(cfg, state_dict, timeline_cap=args.timeline_cap if want_tl else 0,
                             device=dev)
    block = 10 * cfg.frontend.sample_rate
    all_events = {}
    for path in paths:
        wav = audio_io.load_wav_16k(path, cfg.frontend.sample_rate)
        tagger.reset()
        for s in range(0, len(wav), block):
            tagger.feed(wav[s: s + block])
        tagger.flush()
        scores = tagger.scores()
        top = np.argsort(-scores)[: args.top_k]
        line = {"wav": path,
                "seconds": round(len(wav) / cfg.frontend.sample_rate, 3),
                "top_k": [[names[i], float(scores[i])] for i in top]}
        if want_tl:
            start_patch, levels = tagger.timeline()
            w = np.mean([wl for wl, _ in levels], axis=0)
            f = np.mean([fl for _, fl in levels], axis=0)
            rel = os.path.relpath(path, args.wav_dir)
            if args.timeline:
                out_csv = os.path.join(args.timeline, os.path.splitext(rel)[0] + ".timeline.csv")
                os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
                _write_timeline_csv(out_csv, start_patch, hop_s, [names[i] for i in top],
                                    f[:, top], w[:, top])
            if args.events:
                events = detect_events(f, w, hop_s=hop_s, start_patch=start_patch,
                                       threshold=threshold, merge_gap_s=args.event_gap,
                                       min_dur_s=args.event_min_dur, class_names=names,
                                       classes=[int(i) for i in top])
                line["events"] = events
                all_events[rel] = events
        print(_jdump(line))
    if args.events and args.events != "-":
        with open(args.events, "w") as fh:
            json.dump({"hop_s": hop_s, "threshold": _threshold_desc(args),
                       "clips": all_events}, fh, indent=1)
        print(f"# events: {sum(len(v) for v in all_events.values())} over "
              f"{len(all_events)} clips -> {args.events}", file=sys.stderr)


def _timeline_mean(cfg, state_dict, wav, dev):
    """One-shot level-mean localization readout over the whole clip:
    (weights [T, C], probs [T, C]) through ``AudioTagger.timeline``."""
    import torch

    from mla_tpu_torch.ops.frontend import apply_frontend
    from mla_tpu_torch.serve.streaming import _model_with_weights

    model = _model_with_weights(cfg, state_dict, dev)
    with torch.inference_mode():
        tl = model.timeline(apply_frontend(torch.from_numpy(wav)[None].to(dev), cfg.frontend))
        w = np.mean([wl.float().cpu().numpy()[0] for wl, _ in tl], axis=0)
        f = np.mean([fl.float().cpu().numpy()[0] for _, fl in tl], axis=0)
    return w, f


def _write_timeline_csv(path, start_patch, hop_s, col_names, probs, atts):
    """The per-patch localization CSV, one writer for ``infer --timeline`` and
    ``tag --timeline`` so the format cannot fork: one row per 0.96 s
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
    --event_threshold, or the provenance of a per-class --thresholds table
    (one definition for infer, infer --wav_dir and tag)."""
    t = getattr(args, "thresholds", None)
    return f"per-class ({t})" if t else args.event_threshold


def _resolve_threshold(args, names):
    """The event operating point: the scalar --event_threshold, or the
    per-class table from ``eval --calibrate`` via --thresholds (one resolver
    for infer, infer --wav_dir and eval --events)."""
    if not args.thresholds:
        return args.event_threshold
    with open(args.thresholds) as fh:
        table = json.load(fh)["thresholds"]
    missing = [n for n in names if n not in table]
    if missing:
        raise SystemExit(
            f"--thresholds file lacks {len(missing)} of this "
            f"config's classes (e.g. {missing[:3]}) — calibrate with "
            "the same config/labels")
    return np.asarray([table[n] for n in names], np.float32)


def _write_events(w, f, hop_s, start_patch, top, names, args):
    """The discrete events of the clip's top-k classes (serve/events.py) as
    one JSON file: threshold, gap merge and minimum duration per
    --event_threshold / --event_gap / --event_min_dur, or per-class
    thresholds from ``eval --calibrate`` via --thresholds."""
    from mla_tpu_torch.serve.events import detect_events

    events = detect_events(f, w, hop_s=hop_s, start_patch=start_patch,
                           threshold=_resolve_threshold(args, names),
                           merge_gap_s=args.event_gap, min_dur_s=args.event_min_dur,
                           class_names=names, classes=[int(i) for i in top])
    with open(args.events, "w") as fh:
        json.dump({"hop_s": hop_s, "threshold": _threshold_desc(args), "events": events},
                  fh, indent=1)
    print(f"# events: {len(events)} -> {args.events}", file=sys.stderr)


def _serving_weights(args, cfg):
    """The weights ``serve``, ``export``, ``infer`` and ``embed`` start with:
    the workspace's latest checkpoint (EMA parameters where the config
    evaluates with them), or seeded random weights with ``--checkpoint
    random`` or when there is no checkpoint."""
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


def cmd_weights(args):
    """Bare-weight interchange: --out dumps the latest checkpoint's
    parameters and batch-norm statistics as a flat .npz (the reference's
    keys); --load imports such an .npz into a fresh step-0 checkpoint that
    eval, infer and train --resume read."""
    from mla_tpu_torch.models.convert import flat_to_state_dict, state_dict_to_flat
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.train.checkpoint import CheckpointManager
    from mla_tpu_torch.train.state import create_train_state, variables_from_state

    cfg = _load_cfg(args)
    workspace = args.workspace or cfg.workspace
    ckpt_dir = os.path.join(workspace, "checkpoints", cfg.name)
    if args.out:
        from mla_tpu_torch.train.loop import resume

        state, _ = resume(cfg, workspace, device="cpu")
        # the parameters and the batch-norm running averages, which are part
        # of the model function in eval mode; --ema dumps the EMA shadow in
        # place of the online parameters
        params = None
        if args.ema:
            if state.ema_params is None:
                raise SystemExit("checkpoint has no EMA shadow "
                                 "(trained with train.ema_decay=0)")
            params = state.ema_params
        flat = state_dict_to_flat(variables_from_state(state, params))
        np.savez_compressed(args.out, **flat)
        print(f"{len(flat)} weight arrays -> {args.out}")
        return
    if args.load:
        flat = dict(np.load(args.load))
        model = build_model(cfg.model, device="cpu", seed=cfg.train.seed)
        # validate against the config's template of keys and shapes
        tmpl = state_dict_to_flat(model.state_dict())
        missing = sorted(set(tmpl) - set(flat))
        extra = sorted(set(flat) - set(tmpl))
        if (missing or extra) and not args.allow_partial:
            raise SystemExit(f"weight-key mismatch: missing {missing[:4]}, "
                             f"unexpected {extra[:4]} "
                             "(--allow_partial warm-starts the intersection)")
        # --allow_partial: transfer learning; the matched keys (e.g. a
        # pretrained trunk) are imported, the rest keeps its fresh init
        # (e.g. new heads for another class count)
        used = {k: flat[k] for k in tmpl if k in flat}
        mismatched = {k for k, v in used.items() if np.shape(v) != np.shape(tmpl[k])}
        if mismatched and not args.allow_partial:
            k = sorted(mismatched)[0]
            raise SystemExit(f"{k}: shape {np.shape(used[k])} != expected {np.shape(tmpl[k])}")
        used = {k: v for k, v in used.items() if k not in mismatched}
        merged = dict(tmpl)
        merged.update(used)
        model.load_state_dict(flat_to_state_dict(merged, model))
        # built after the import, so the EMA shadow (when enabled) starts
        # from the imported weights, not from the random init
        state = create_train_state(cfg, model)
        CheckpointManager(ckpt_dir).save(
            0, state, {"imported_from": os.path.basename(args.load), "step": 0})
        print(f"imported {len(used)}/{len(tmpl)} arrays -> checkpoint step 0 in {ckpt_dir}")
        return
    raise SystemExit("weights: pass --out=<npz> or --load=<npz>")


def cmd_profile(args):
    """A ``torch.profiler`` trace of the configured train step on --device:
    one step outside the trace, then --steps inside it; prints the host
    timing and the card's allocator byte counters as one JSON line."""
    import time as _time

    import torch

    from mla_tpu_torch._device import resolve_device
    from mla_tpu_torch.data.synthetic import make_dataset
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.train.state import create_train_state, make_train_step
    from mla_tpu_torch.utils import profiling

    cfg = _load_cfg(args)
    dev = resolve_device(args.device)
    kind = _input_kind(cfg)
    ds = make_dataset(cfg.data, cfg.model.n_classes, "train", kind, cfg.frontend)
    bs = min(args.batch or cfg.train.batch_size, len(ds.x))
    x = torch.from_numpy(np.ascontiguousarray(ds.x[:bs], np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(ds.y[:bs], np.float32)).to(dev)
    model = build_model(cfg.model, device=dev, seed=cfg.train.seed)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, kind,
                           clip_samples=x.shape[1] if kind == "waveform" else None)
    state, loss = step(state, x, y)
    float(loss)  # first call and its wait outside the trace
    with profiling.trace(args.out) as trace_dir:
        t0 = _time.perf_counter()
        for _ in range(args.steps):
            state, loss = step(state, x, y)
        float(loss)  # waits for the last step
        dt = _time.perf_counter() - t0
    print(_jdump({
        "trace_dir": trace_dir,
        "steps": args.steps,
        "batch": bs,
        "mean_step_ms": round(dt / args.steps * 1e3, 3),
        "clips_per_sec": round(bs * args.steps / dt, 1),
        "memory": profiling.memory_stats(dev),
    }))


def cmd_serve(args):
    """Run the HTTP streaming-inference service: open / feed / scores /
    flush / close per stream, one batched device step per tick across all
    open streams."""
    from mla_tpu_torch.serve.http import create_server, start_reload_watcher
    from mla_tpu_torch.train.checkpoint import CheckpointManager

    cfg = _load_cfg(args)
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

    mesh = None
    if args.shard_streams:
        from mla_tpu_torch.parallel import mesh as pmesh

        # every visible card (--device cpu: the CPU as one shard)
        mesh = pmesh.make_mesh(devices=["cpu"] if args.device == "cpu" else None)
    kwargs = dict(port=args.port, host=args.host, max_streams=args.max_streams,
                  chunk_patches=args.chunk_patches, transfer_dtype=args.transfer_dtype,
                  timeline_cap=args.timeline_cap, reload_fn=reload_fn, device=args.device,
                  mesh=mesh)
    if args.native:
        from mla_tpu_torch.serve.native_front import create_native_server

        srv = create_native_server(cfg, state_dict, **kwargs)
    else:
        srv = create_server(cfg, state_dict, **kwargs)
    if args.reload_every > 0:
        start_reload_watcher(srv, ckdir, args.reload_every, initial_step=loaded_step)
    host, port = srv.server_address[:2]
    sharded = f", streams sharded over {mesh.shape}" if mesh is not None else ""
    front = "native C++ front" if args.native else "stdlib front"
    print(f"serving {cfg.model.variant} on http://{host}:{port}/v1 "
          f"({front}, max_streams={args.max_streams}{sharded})", flush=True)
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
    from mla_tpu_torch.serve.export import export_forward, export_streaming

    cfg = _load_cfg(args)
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
    from mla_tpu_torch.train.cv import cross_validate

    cfg = _load_cfg(args)
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


_CHECKPOINT_HELP = ("'latest' (the workspace's newest checkpoint; random weights when there "
                    "is none) or 'random' (seeded random weights)")


def _device_arg(parser):
    parser.add_argument("--device", default=None,
                        help="torch device; default the card (raises without one)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="mla_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("configs", help="list named configs").set_defaults(fn=cmd_configs)

    ssum = sub.add_parser("summary", help="per-module parameter table")
    ssum.add_argument("--config", default="audioset_full_dp")
    ssum.add_argument("--set", nargs="*")
    ssum.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("prep", help="build + pack dataset to HDF5")
    sp.add_argument("--config", default="default")
    sp.add_argument("--split", default="train", choices=["train", "eval"])
    sp.add_argument("--out", required=True)
    sp.add_argument("--quantize", action="store_true")
    sp.add_argument("--tfrecords", default=None,
                    help="glob of AudioSet SequenceExample tfrecord shards")
    sp.add_argument("--wav_dir", default=None,
                    help="local wav corpus root (class subdirs or --labels_csv)")
    sp.add_argument("--labels_csv", default=None,
                    help="ESC-50/US8K-style metadata CSV for --wav_dir")
    sp.add_argument("--folds", default=None,
                    help="comma-separated CSV 'fold' values to keep, e.g. --folds=1,2,3,4 "
                         "(train) / --folds=5 (eval): the ESC-50/US8K cross-validation "
                         "protocol")
    sp.add_argument("--set", nargs="*")
    sp.set_defaults(fn=cmd_prep)

    se = sub.add_parser("extract", help="wav -> log-mel patches .npy")
    se.add_argument("--config", default="default")
    se.add_argument("--wav", required=True)
    se.add_argument("--out", required=True)
    se.add_argument("--set", nargs="*")
    _device_arg(se)
    se.set_defaults(fn=cmd_extract)

    st = sub.add_parser("train", help="train per config")
    st.add_argument("--config", default="esc50_single_attention")
    st.add_argument("--workspace", default=None)
    st.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint and continue")
    st.add_argument("--set", nargs="*")
    _device_arg(st)
    st.set_defaults(fn=cmd_train)

    sv = sub.add_parser("eval", help="evaluate latest checkpoint")
    sv.add_argument("--config", default="esc50_single_attention")
    sv.add_argument("--workspace", default=None)
    sv.add_argument("--per_class", default=None,
                    help="write per-class AP/AUC/d' CSV to this path")
    sv.add_argument("--calibrate", default=None, metavar="JSON",
                    help="write per-class decision thresholds calibrated on the eval set "
                         "(maximal recall at --target_precision); infer --events reads them "
                         "via --thresholds")
    sv.add_argument("--target_precision", type=float, default=0.8)
    sv.add_argument("--events", action="store_true",
                    help="also score the event-detection surface end to end: timeline -> "
                         "detect_events on the synthetic event-boundary corpus, DCASE "
                         "segment-based F1 / error rate (train/sed_eval.py)")
    sv.add_argument("--thresholds", default=None, metavar="JSON",
                    help="per-class thresholds for --events (an eval --calibrate output); "
                         "default scalar 0.5")
    sv.add_argument("--event_threshold", type=float, default=0.5)
    sv.add_argument("--event_gap", type=float, default=0.0,
                    help="merge events separated by gaps <= this (s)")
    sv.add_argument("--event_min_dur", type=float, default=0.0,
                    help="drop events shorter than this (s)")
    sv.add_argument("--segment_s", type=float, default=None,
                    help="scoring grid for --events (default: the timeline's 0.96 s patch "
                         "hop; 1.0 = DCASE grid)")
    sv.add_argument("--sed_clips", type=int, default=None,
                    help="event-corpus size for --events (default data.n_eval_clips)")
    sv.add_argument("--sweep", nargs="?", const="default", default=None,
                    metavar="T1,T2,...",
                    help="with --events: sweep the scalar event threshold and report the "
                         "segment-F1-optimal operating point (default grid 0.05..0.95 step "
                         "0.05; the timelines are computed once)")
    sv.add_argument("--set", nargs="*")
    _device_arg(sv)
    sv.set_defaults(fn=cmd_eval)

    se2 = sub.add_parser("embed", help="wav -> segment embeddings .npy")
    se2.add_argument("--config", default="streaming_inference")
    se2.add_argument("--wav", required=True)
    se2.add_argument("--out", required=True)
    se2.add_argument("--workspace", default=None)
    se2.add_argument("--checkpoint", default="latest", help=_CHECKPOINT_HELP)
    se2.add_argument("--set", nargs="*")
    _device_arg(se2)
    se2.set_defaults(fn=cmd_embed)

    si = sub.add_parser("infer", help="tag a wav file")
    si.add_argument("--config", default="streaming_inference")
    si.add_argument("--wav", default=None)
    si.add_argument("--wav_dir", default=None,
                    help="batch mode: tag every .wav under this directory (recursive), one "
                         "JSONL line per clip, all through one streaming tagger")
    si.add_argument("--workspace", default=None)
    si.add_argument("--checkpoint", default="latest", help=_CHECKPOINT_HELP)
    si.add_argument("--stream", action="store_true", help="chunked streaming path")
    si.add_argument("--top_k", type=int, default=5)
    si.add_argument("--labels_csv", default=None,
                    help="AudioSet class_labels_indices.csv for display names")
    si.add_argument("--timeline", default=None, metavar="CSV",
                    help="also write the per-patch localization readout (attention weights "
                         "+ segment probs for the clip's top-k classes)")
    si.add_argument("--events", default=None, metavar="JSON",
                    help="also write discrete events (threshold + gap merge + minimum "
                         "duration over the top-k classes' per-patch probs; "
                         "serve/events.py)")
    si.add_argument("--event_threshold", type=float, default=0.5)
    si.add_argument("--thresholds", default=None, metavar="JSON",
                    help="per-class thresholds from eval --calibrate (overrides "
                         "--event_threshold)")
    si.add_argument("--event_gap", type=float, default=0.0,
                    help="merge events separated by gaps <= this (seconds)")
    si.add_argument("--event_min_dur", type=float, default=0.0,
                    help="drop events shorter than this (seconds)")
    si.add_argument("--timeline_cap", type=int, default=256,
                    help="with --stream or --wav_dir: size of the localization ring on the "
                         "device that --timeline / --events read (the last N patches, so "
                         "long-form audio stays O(1) memory)")
    si.add_argument("--plot", default=None, metavar="PNG",
                    help="render the timeline as a figure (top-k class probability and "
                         "attention curves over clip time, log-mel underlay; needs "
                         "matplotlib); single --wav only")
    si.add_argument("--set", nargs="*")
    _device_arg(si)
    si.set_defaults(fn=cmd_infer)

    sw = sub.add_parser("weights", help="flat-.npz weight export/import")
    sw.add_argument("--config", default="streaming_inference")
    sw.add_argument("--workspace", default=None)
    sw.add_argument("--out", default=None, help="dump latest checkpoint params to .npz")
    sw.add_argument("--load", default=None, help="import .npz as a step-0 checkpoint")
    sw.add_argument("--ema", action="store_true",
                    help="--out dumps the EMA (Polyak) shadow instead of the online params")
    sw.add_argument("--allow_partial", action="store_true",
                    help="warm-start only the matching keys (transfer learning: pretrained "
                         "trunk + fresh heads)")
    sw.add_argument("--set", nargs="*")
    sw.set_defaults(fn=cmd_weights)

    spr = sub.add_parser("profile", help="trace the train step (torch.profiler)")
    spr.add_argument("--config", default="esc50_single_attention")
    spr.add_argument("--out", default=None,
                     help="trace directory (default mla_tpu_torch_trace in the temp dir)")
    spr.add_argument("--steps", type=int, default=10)
    spr.add_argument("--batch", type=int, default=None)
    spr.add_argument("--set", nargs="*")
    _device_arg(spr)
    spr.set_defaults(fn=cmd_profile)

    ss = sub.add_parser("serve", help="HTTP streaming-inference service")
    ss.add_argument("--config", default="streaming_inference")
    ss.add_argument("--workspace", default=None)
    ss.add_argument("--checkpoint", default="latest", help=_CHECKPOINT_HELP)
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
    ss.add_argument("--shard_streams", action="store_true",
                    help="shard the per-tick stream axis over all visible cards "
                         "(max_streams must divide by the card count)")
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
    _device_arg(ss)
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
    sx.add_argument("--checkpoint", default="latest", help=_CHECKPOINT_HELP)
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
    _device_arg(sc)
    sc.set_defaults(fn=cmd_cv)

    sy = sub.add_parser("parity", help="run the reference-parity harness")
    _device_arg(sy)
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
