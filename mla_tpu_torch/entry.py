"""The flagship program (counterpart of ``__graft_entry__.py::entry``): a
batch of raw waveforms -> the log-mel front-end -> the CompactCNN trunk ->
multi-level attention -> clip probabilities, on the ``audioset_full_dp``
preset as shipped (CompactCNN 64/128/256/512 x 2 convs, 3 blocks of 512,
527 classes, bf16 compute, the torch-ops front-end at "default").

    fn, (model, wav) = entry()          # the card; entry(device="cpu") on the CPU
    probs = fn(model, wav)              # [4, 527]

and the multi-device dryrun (counterpart of ``__graft_entry__.py::
dryrun_multichip``) on a single-process grid: ``dryrun_multichip(8)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mla_tpu_torch._device import resolve_device
from mla_tpu_torch.config import Config, get_config
from mla_tpu_torch.models.zoo import AudioTagger, build_model
from mla_tpu_torch.ops import frontend as fe
from mla_tpu_torch.utils import profiling

FLAGSHIP = "audioset_full_dp"
# the reference's tiny overrides (__graft_entry__.py::_flagship_cfg)
TINY = {"model.conv_channels": "8,16", "model.convs_per_stage": "1",
        "model.hidden_units": "64", "model.n_classes": "32", "data.clip_seconds": "2.0"}
BATCH, SECONDS = 4, 10


def flagship_config(tiny: bool = False, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """The flagship preset, or its tiny cut, with dotted-path ``overrides``
    on top (e.g. {"frontend.impl": "pallas"})."""
    return get_config(FLAGSHIP, {**(TINY if tiny else {}), **(overrides or {})})


def example_waveforms(cfg: Config) -> np.ndarray:
    """[4, 10 * sample_rate] f32 noise at 0.1, drawn as the reference's
    entry() draws it."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((BATCH, SECONDS * cfg.frontend.sample_rate)).astype(np.float32) * 0.1


def flagship_forward(cfg: Config) -> Callable[[AudioTagger, torch.Tensor], torch.Tensor]:
    """fn(model, wav): waveform [B, n] -> probs [B, C] through the front-end
    ``cfg.frontend.impl`` selects, without autograd; while tracing, one
    ``mla.forward`` span with device time."""
    def fn(model: AudioTagger, wav: torch.Tensor) -> torch.Tensor:
        with profiling.annotate("mla.forward", wav.device), torch.inference_mode():
            return model(fe.apply_frontend(wav, cfg.frontend))

    return fn


def entry(device=None, seed: int = 0) -> Tuple[Callable, Tuple[AudioTagger, torch.Tensor]]:
    """-> (fn, (model, wav)): the flagship forward, a 4 x 10 s batch on
    ``device`` (None = the card; raises without one unless device="cpu"),
    and the model in eval mode with random weights drawn from a
    ``torch.Generator`` seeded by ``seed``."""
    dev = resolve_device(device)
    cfg = flagship_config()
    model = build_model(cfg.model, device=dev, seed=seed)
    wav = torch.from_numpy(example_waveforms(cfg)).to(dev)
    return flagship_forward(cfg), (model, wav)


def dryrun_multichip(n_devices: int = 8, device=None) -> Dict[str, Any]:
    """The twin of the reference's ``dryrun_multichip``, in one process over
    a single-process grid of ``n_devices`` entries, each ``device`` (None =
    the card; "cpu" on the CPU): the ("data", "model") mesh with model = 2
    when ``n_devices`` is even and at least 4, on the tiny flagship in f32
    (TF32 off). In order:

    1. the tensor-parallel train step over the model axis (the grid's first
       row) at the batch 2 x data, against the one-process step (loss
       within 1e-5 relative, finite);
    2. context-parallel pooling: each grid entry folds 2 of 2n patches and
       ``combine_stream_states`` joins them, against whole-clip
       ``attention_pool``;
    3. one adpcm4 tick of the server over the grid, given the trained
       weights sharded over it (``place_sharded``: a tensor-parallel replica
       per data row), against the unsharded server on the same bytes (rtol
       1e-4, atol 1e-5, the reference's);
    4. a second chunk through the packed tick, held the same way;
    5. the ring's window of both ticks: finite, in range, 4 patches long.

    Prints its ``ok`` line and returns what it checked."""
    import dataclasses

    from mla_tpu_torch._device import tf32_off
    from mla_tpu_torch.ops import attention_pool as ap
    from mla_tpu_torch.parallel import tensor
    from mla_tpu_torch.parallel.mesh import make_mesh
    from mla_tpu_torch.serve.server import BatchedStreamingServer
    from mla_tpu_torch.train.state import create_train_state, make_train_step, \
        variables_from_state

    dev = resolve_device(device)
    mp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    dp = n_devices // mp
    mesh = make_mesh(dp, mp, devices=[dev] * n_devices)
    cfg = flagship_config(tiny=True)
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size=2 * dp, data_parallel=dp,
                                       model_parallel=mp),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    bs, c = cfg.train.batch_size, cfg.model.n_classes
    rng = np.random.default_rng(0)
    wav = rng.standard_normal((bs, int(cfg.data.clip_seconds * cfg.frontend.sample_rate))
                              ).astype(np.float32)
    y = (rng.random((bs, c)) < 0.1).astype(np.float32)

    def one_step(axis):
        model = build_model(cfg.model, device=dev, seed=cfg.train.seed)
        if axis is not None:
            tensor.tensor_parallel(model, axis, cfg.model.hidden_units)
        step = make_train_step(cfg, model, "waveform", clip_samples=wav.shape[1])
        state, loss = step(create_train_state(cfg, model), torch.from_numpy(wav).to(dev),
                           torch.from_numpy(y).to(dev))
        return state, float(loss)

    with tf32_off():
        state, loss = one_step(tensor.ModelAxis(devices=list(mesh.devices[0])))
        _, ref_loss = one_step(None)
        if not np.isfinite(loss) or abs(loss - ref_loss) > 1e-5 * abs(ref_loss):
            raise RuntimeError(f"dryrun train loss {loss} against one process {ref_loss}")

        # context parallel: 2n patches, two to each grid entry, combined once
        t_len = 2 * n_devices
        g = torch.from_numpy(rng.standard_normal((bs, t_len, c)).astype(np.float32))
        cl = torch.from_numpy(rng.standard_normal((bs, t_len, c)).astype(np.float32))
        parts = [ap.update_stream_state(ap.init_stream_state((bs, c), device=d),
                                        g[:, 2 * k:2 * k + 2].to(d), cl[:, 2 * k:2 * k + 2].to(d),
                                        "exp")
                 for k, d in enumerate(mesh.devices.reshape(-1))]
        out = ap.stream_finalize(ap.combine_stream_states(parts, "exp")).cpu().numpy()
        whole = ap.attention_pool(g, cl, "exp").numpy()
        np.testing.assert_allclose(out, whole, rtol=1e-4, atol=1e-5)

        # the server over the grid, on the trained weights sharded over it
        variables = variables_from_state(state)
        kw = dict(chunk_patches=2, transfer_dtype="adpcm4", device=dev)
        srv = BatchedStreamingServer(cfg, tensor.place_sharded(variables, mesh,
                                                               cfg.model.hidden_units),
                                     max_streams=dp, mesh=mesh, timeline_cap=4, **kw)
        if mp > 1 and srv._tp_rows is None:
            raise RuntimeError("the server did not keep the tensor-parallel layout")
        feed = wav[0][: srv.chunk_samples]
        if len(feed) < srv.chunk_samples:
            raise RuntimeError(f"the clip ({wav.shape[1]} samples) is shorter than one "
                               f"serving chunk ({srv.chunk_samples})")
        sid = srv.open()
        srv.feed(sid, feed)
        advanced = srv.tick()
        if advanced != 1:
            raise RuntimeError(f"the sharded tick advanced {advanced} streams")
        ref_srv = BatchedStreamingServer(cfg, variables, max_streams=1, **kw)
        rsid = ref_srv.open()
        ref_srv.feed(rsid, feed)
        ref_srv.tick()
        np.testing.assert_allclose(srv.scores(sid), ref_srv.scores(rsid), rtol=1e-4, atol=1e-5)
        # a second chunk through the packed tick (the rows layout on a mesh)
        srv.feed(sid, feed)
        buf = srv.packed_buffer()
        active = srv.gather_ready_packed(buf)
        if active is None or not active[sid]:
            raise RuntimeError("the packed gather missed the stream")
        srv.states, srv.tl = srv._packed_step(srv.states, srv.tl, srv.put_packed(buf))
        srv._fed |= active
        ref_srv.feed(rsid, feed)
        ref_srv.tick()
        scores = srv.scores(sid)
        np.testing.assert_allclose(scores, ref_srv.scores(rsid), rtol=1e-4, atol=1e-5)
    # the ring, written by both ticks (2 patches each)
    start, levels = srv.timeline(sid)
    if start != 0 or len(levels) != cfg.model.n_blocks:
        raise RuntimeError(f"timeline start {start}, {len(levels)} levels")
    for w, f in levels:
        if not (w.shape == (4, c) and np.isfinite(w).all() and (w >= 0).all()
                and np.isfinite(f).all() and (f >= 0).all() and (f <= 1).all()):
            raise RuntimeError("the sharded server's timeline window is out of range")
    print(f"dryrun_multichip ok: mesh=({dp},{mp}) loss={loss:.4f} (one process "
          f"{ref_loss:.4f}) cp_combine ok tp_serve(adpcm4)==unsharded ok tp_packed_tick ok "
          "tp_timeline ok")
    return {"mesh": (dp, mp), "loss": loss, "one_process_loss": ref_loss,
            "tensor_parallel_server": srv._tp_rows is not None, "scores": scores}
