"""Export of the PyTorch port (mla_tpu_torch/serve/export.py) against the
JAX package's: the one-shot artifact and the streaming pair, exported and
loaded on the CPU, against the reference's artifacts on all five wires and
against the port's live BatchedStreamingServer fed the same bytes, with and
without the timeline ring; the shape contract, the refusals, the export
verb, a loader process that imports no model code, and the registered ADPCM
decode op the ADPCM artifacts' prologue runs."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import os  # noqa: E402
import subprocess  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.data import adpcm as jadpcm  # noqa: E402
from mla_tpu.serve import export as jex  # noqa: E402
from mla_tpu_torch.data import adpcm  # noqa: E402
from mla_tpu_torch.data.audio_io import mulaw_encode, pcm16_quantize  # noqa: E402
from mla_tpu_torch.ops import adpcm as ops  # noqa: E402
from mla_tpu_torch.serve import export as ex  # noqa: E402
from mla_tpu_torch.serve.server import BatchedStreamingServer  # noqa: E402
from mla_tpu_torch.serve.streaming import _samples_per_patches, _whole_patches  # noqa: E402
from tests.torch_port_common import configs, jax_weights, torch_state_dict  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)  # probs, scores and timelines, port against JAX (f32)
WIRES = ("float32", "int16", "uint8", "adpcm4", "adpcm2")
CHUNK = 2  # patches per chunk call
STREAMS = 2
CAP = 4  # the ring's patches, >= CHUNK


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    variables, flat = jax_weights(jcfg.model)
    return jcfg, tcfg, variables, torch_state_dict(tcfg.model, flat)


def _encode(wav: np.ndarray, wire: str) -> np.ndarray:
    """float32 samples [..., n] -> the wire's array (adpcm: whole blocks of
    SERVE_BLOCK samples)."""
    if wire == "int16":
        return pcm16_quantize(wav)
    if wire == "uint8":
        return mulaw_encode(wav)
    if wire.startswith("adpcm"):
        enc = adpcm.adpcm4_encode if wire == "adpcm4" else adpcm.adpcm2_encode
        return enc(pcm16_quantize(wav), block=adpcm.SERVE_BLOCK)
    return wav.astype(np.float32)


def _units(samples: int, wire: str) -> int:
    """Wire units (samples, or bytes on the adpcm wires) of ``samples``."""
    if wire.startswith("adpcm"):
        return samples // adpcm.SERVE_BLOCK * adpcm.wire_block_bytes(adpcm.SERVE_BLOCK,
                                                                       int(wire[-1]))
    return samples


@pytest.mark.parametrize("wire", WIRES)
def test_oneshot_artifact_matches_jax(setup, tmp_path, wire):
    """The port's one-shot artifact, exported and loaded on the CPU, against
    JAX's on the same wire bytes; on the adpcm wires the decode the prologue
    runs (the registered op) is bit-exact against JAX's decoder."""
    jcfg, tcfg, variables, sd = setup
    meta = ex.export_forward(tcfg, sd, str(tmp_path / "p.mlxt"), batch=2, seconds=2.0,
                             input_dtype=wire, device="cpu")
    jmeta = jex.export_forward(jcfg, variables, str(tmp_path / "j.mlax"), batch=2,
                               seconds=2.0, platforms=("cpu",), input_dtype=wire)
    assert meta["format"] == "mla_tpu_torch.export.v1" and meta["platforms"] == ["cpu"]
    assert {k: v for k, v in meta.items() if k not in ("format", "platforms")} == \
        {k: v for k, v in jmeta.items() if k not in ("format", "platforms")}
    fn, jfn = ex.load_exported(str(tmp_path / "p.mlxt"), device="cpu"), \
        jex.load_exported(str(tmp_path / "j.mlax"))
    wav = (np.random.default_rng(0).standard_normal((2, meta["n_samples"])) * 0.3
           ).astype(np.float32)
    x = _encode(wav, wire)
    launches = ops.LAUNCHES
    got, want = fn(x), jfn(x)
    assert ops.LAUNCHES == launches  # a CPU tensor launches no kernel
    assert got.shape == (2, tcfg.model.n_classes) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    if wire.startswith("adpcm"):
        bits = int(wire[-1])
        dec = jadpcm.adpcm4_decode if bits == 4 else jadpcm.adpcm2_decode
        ours = torch.ops.mla_tpu_torch.adpcm_decode(torch.from_numpy(x), meta["n_samples"],
                                                    adpcm.SERVE_BLOCK, bits, "serial")
        ref = np.asarray(dec(jnp.asarray(x), n=meta["n_samples"], block=adpcm.SERVE_BLOCK,
                             xp=jnp))
        np.testing.assert_array_equal(ours.numpy(), ref)


def _silence(wire: str, units: int, rows: int, dtype) -> np.ndarray:
    """[rows, units] of wire silence (adpcm: encoded zero blocks)."""
    if wire.startswith("adpcm"):
        block = _encode(np.zeros(adpcm.SERVE_BLOCK, np.float32), wire)
        return np.tile(block, (rows, units // len(block)))
    return np.full((rows, units), 128 if wire == "uint8" else 0, dtype)


def _chunks(wire_arr: np.ndarray, meta: dict, wire: str, fcfg):
    """The artifact's chunk calls over [S, units] of wire: whole chunks at
    the hop (they overlap), then the tail padded with wire silence, its
    whole patches counted in n_valid."""
    cu = meta.get("wire_length") or meta["chunk_samples"]
    hu = _units(meta["hop_samples"], wire)
    off, out = 0, []
    while off + cu <= wire_arr.shape[1]:
        out.append((wire_arr[:, off:off + cu], None))
        off += hu
    tail = wire_arr[:, off:]
    rows, units = tail.shape
    samples = units * adpcm.SERVE_BLOCK // _units(adpcm.SERVE_BLOCK, wire)
    n_valid = np.full(rows, _whole_patches(fcfg, samples), np.int32)
    out.append((np.concatenate([tail, _silence(wire, cu - units, rows, tail.dtype)], axis=1),
                n_valid))
    return out


@pytest.mark.parametrize("wire,cap", [(w, CAP) for w in WIRES]
                         + [("float32", 0), ("adpcm4", 0)])
def test_streaming_pair_matches_jax_and_live_server(setup, tmp_path, wire, cap):
    """Two streams of 5 patches through 2-patch chunks (two whole chunks and
    a padded final one, n_valid 1): the port's streaming pair against JAX's
    artifact fed the same calls and against the port's live server fed the
    same bytes; scores and, with the ring, timelines within 1e-4."""
    jcfg, tcfg, variables, sd = setup
    meta = ex.export_streaming(tcfg, sd, str(tmp_path / "s.mlxt"), streams=STREAMS,
                               chunk_patches=CHUNK, input_dtype=wire, timeline_cap=cap,
                               device="cpu")
    jex.export_streaming(jcfg, variables, str(tmp_path / "s.mlax"), streams=STREAMS,
                         chunk_patches=CHUNK, platforms=("cpu",), input_dtype=wire,
                         timeline_cap=cap)
    art = ex.load_exported_streaming(str(tmp_path / "s.mlxt"), device="cpu")
    jart = jex.load_exported_streaming(str(tmp_path / "s.mlax"))
    assert art.meta["format"] == "mla_tpu_torch.export.stream.v1"
    n = _samples_per_patches(tcfg.frontend, 5)
    wav = (np.random.default_rng(3).standard_normal((STREAMS, n)) * 0.3).astype(np.float32)
    x = _encode(wav, wire)
    state, jstate = art.init_state(), jart.init_state()
    calls = _chunks(x, meta, wire, tcfg.frontend)
    assert len(calls) == 3 and calls[-1][1].tolist() == [1] * STREAMS
    for chunk, n_valid in calls:
        state = art.chunk(state, chunk, n_valid)
        jstate = jart.chunk(jstate, chunk, n_valid)
    scores = art.finalize(state)
    np.testing.assert_allclose(scores, jart.finalize(jstate), **TOL)

    srv = BatchedStreamingServer(tcfg, sd, max_streams=STREAMS, chunk_patches=CHUNK,
                                 transfer_dtype=wire, timeline_cap=cap, device="cpu")
    sids = [srv.open() for _ in range(STREAMS)]
    for sid in sids:
        srv.feed(sid, x[sid])
    srv.drain()
    for sid in sids:
        srv.flush(sid)
        np.testing.assert_allclose(scores[sid], srv.scores(sid), **TOL)
    if not cap:
        assert state[1] is None
        with pytest.raises(RuntimeError, match="timeline"):
            art.timeline(state)
        return
    for sid in sids:
        start, levels = art.timeline(state, sid)
        for want_start, want_levels in (jart.timeline(jstate, sid), srv.timeline(sid)):
            assert start == want_start and len(levels) == len(want_levels)
            for (w, f), (ww, wf) in zip(levels, want_levels):
                np.testing.assert_allclose(w, ww, **TOL)
                np.testing.assert_allclose(f, wf, **TOL)
    evs, jevs = art.events(state, 0, threshold=0.0), jart.events(jstate, 0, threshold=0.0)
    assert len(evs) == tcfg.model.n_classes  # threshold 0: one event per class
    assert [(e["class_idx"], e["t_start"], e["t_end"]) for e in evs] == \
        [(e["class_idx"], e["t_start"], e["t_end"]) for e in jevs]


def test_wrong_shapes_non_exports_and_the_other_package_are_refused(setup, tmp_path):
    jcfg, tcfg, variables, sd = setup
    one, stream = str(tmp_path / "one.mlxt"), str(tmp_path / "stream.mlxt")
    ex.export_forward(tcfg, sd, one, batch=2, seconds=2.0, device="cpu")
    ex.export_streaming(tcfg, sd, stream, streams=1, chunk_patches=CHUNK, device="cpu")
    fn = ex.load_exported(one, device="cpu")
    with pytest.raises(ValueError, match="static-shaped"):
        fn(np.zeros((1, fn.meta["n_samples"]), np.float32))
    art = ex.load_exported_streaming(stream, device="cpu")
    with pytest.raises(ValueError, match="static-shaped"):
        art.chunk(art.init_state(), np.zeros((1, art.meta["chunk_samples"] - 1), np.float32))
    with pytest.raises(ValueError, match="streaming artifact"):
        ex.load_exported(stream, device="cpu")
    with pytest.raises(ValueError, match="one-shot"):
        ex.load_exported_streaming(one, device="cpu")
    junk = tmp_path / "junk.mlxt"
    junk.write_bytes(b"not an export")
    with pytest.raises(ValueError, match="magic"):
        ex.load_exported(str(junk), device="cpu")
    with pytest.raises(ValueError, match="input_dtype"):
        ex.export_forward(tcfg, sd, str(tmp_path / "x.mlxt"), input_dtype="int8", device="cpu")
    # JAX's artifacts here, and the port's at JAX's loaders
    jpath = str(tmp_path / "j.mlax")
    jex.export_forward(jcfg, variables, jpath, batch=2, seconds=2.0, platforms=("cpu",))
    with pytest.raises(ValueError, match="JAX package"):
        ex.load_exported(jpath, device="cpu")
    with pytest.raises(ValueError, match="JAX package"):
        ex.load_exported_streaming(jpath, device="cpu")
    for loader, path in ((jex.load_exported, one), (jex.load_exported_streaming, stream)):
        with pytest.raises(ValueError, match="magic"):
            loader(path)
    if not torch.cuda.is_available():  # device=None means the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ex.load_exported(one)


def test_export_verb(tmp_path):
    """``python -m mla_tpu_torch export`` on the CPU, one-shot and streaming,
    from seeded random weights; the artifacts load and run."""
    from mla_tpu_torch.__main__ import main

    small = ["--set", "model.conv_channels=8,16", "model.convs_per_stage=1",
             "model.hidden_units=32", "model.embed_dim=16", "model.n_classes=5"]
    out = str(tmp_path / "cli.mlxt")
    assert main(["export", "--config=esc50_single_attention", "--checkpoint=random",
                 f"--out={out}", "--batch=1", "--seconds=2", "--input_dtype=int16",
                 "--device=cpu", f"--workspace={tmp_path}", *small]) == 0
    fn = ex.load_exported(out, device="cpu")
    assert fn.meta["input_dtype"] == "int16" and fn.meta["variant"] == "single_attention"
    probs = fn(np.zeros((1, fn.meta["n_samples"]), np.int16))
    assert probs.shape == (1, 5) and np.isfinite(probs).all()
    sout = str(tmp_path / "cli_stream.mlxt")
    assert main(["export", "--streaming", "--checkpoint=random", f"--out={sout}", "--batch=2",
                 "--chunk_patches=2", "--timeline_cap=4", "--input_dtype=adpcm4",
                 "--device=cpu", f"--workspace={tmp_path}", *small]) == 0
    art = ex.load_exported_streaming(sout, device="cpu")
    assert art.meta["timeline_cap"] == 4 and art.meta["streams"] == 2
    state = art.chunk(art.init_state(),
                      np.zeros((2, art.meta["wire_length"]), np.uint8))
    assert np.isfinite(art.finalize(state)).all()


def test_loader_process_imports_no_model_code(setup, tmp_path):
    """A process that loads and runs both kinds of artifact, the ring's
    readout and events included, imports no mla_tpu_torch.models module and
    nothing of JAX: the artifact carries the program and its weights."""
    _, tcfg, _, sd = setup
    one, stream = str(tmp_path / "one.mlxt"), str(tmp_path / "edge.mlxt")
    meta1 = ex.export_forward(tcfg, sd, one, batch=1, seconds=2.0, input_dtype="adpcm4",
                              device="cpu")
    meta = ex.export_streaming(tcfg, sd, stream, streams=1, chunk_patches=CHUNK,
                               timeline_cap=CAP, device="cpu")
    code = f"""
import sys
import numpy as np
from mla_tpu_torch.serve.export import load_exported, load_exported_streaming
fn = load_exported({one!r}, device="cpu")
probs = fn(np.zeros((1, {meta1["wire_length"]}), np.uint8))
art = load_exported_streaming({stream!r}, device="cpu")
state = art.chunk(art.init_state(), np.zeros((1, {meta["chunk_samples"]}), np.float32))
scores = art.finalize(state)
start, levels = art.timeline(state)
evs = art.events(state, threshold=0.0)
assert probs.shape == (1, {meta["n_classes"]}) and scores.shape == (1, {meta["n_classes"]})
assert len(evs) == {meta["n_classes"]}
bad = sorted(m for m in sys.modules
             if m.startswith(("mla_tpu_torch.models", "jax", "flax", "mla_tpu.")))
assert not bad, bad
print("EDGE_OK")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=root)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "EDGE_OK" in r.stdout


def test_registered_op_is_bit_exact_on_golden_wires_and_passes_opcheck():
    """torch.ops.mla_tpu_torch.adpcm_decode on the CPU: the golden wires of
    both widths at both block sizes bit-exact, and torch.library.opcheck
    (schema, fake tensor, dispatch) passes; adpcm_decode goes through it."""
    for bits, golden in ((4, "adpcm_wire.npz"), (2, "adpcm2_wire.npz")):
        g = np.load(f"tests/golden/{golden}")
        for block in (64, 256):
            wire = torch.from_numpy(g[f"wire{block}"])
            for variant in ("serial", "scan"):
                out = torch.ops.mla_tpu_torch.adpcm_decode(wire, int(g["x"].size), block, bits,
                                                           variant)
                np.testing.assert_array_equal(out.numpy(), g[f"dec{block}"])
            wire2 = torch.from_numpy(np.stack([g[f"wire{block}"]] * 2))
            result = torch.library.opcheck(
                torch.ops.mla_tpu_torch.adpcm_decode.default,
                (wire2, int(g["x"].size), block, bits, ops.decode_variant(bits, block)))
            assert set(result.values()) == {"SUCCESS"}, result
    ep = torch.export.export(_DecodeOnly(), (torch.zeros(2, 70, dtype=torch.uint8),))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets == ["mla_tpu_torch.adpcm_decode.default"], targets


class _DecodeOnly(torch.nn.Module):
    def forward(self, wire):
        return ops.adpcm_decode(wire, 128, 64, 4)
