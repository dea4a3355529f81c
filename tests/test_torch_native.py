"""The port's native ingest library (mla_tpu_torch/data/native.py over the
unedited native/audio_ingest.cpp, built into build/mla_tpu_torch/) against
``mla_tpu.data.native``: the wav decoder (four sample formats, stereo),
the resampler, mu-law and both ADPCM encoders bit-equal to the reference's
library, within 1e-6 of scipy and bit-equal to the port's numpy codecs;
the ring's pop sequence equal; and the port's ``audio_io`` / ``adpcm`` take
the library where the reference does, with the numpy and scipy paths
behind ``available()``. Both libraries are built before the first test,
and a failed build fails every test with g++'s output: the port's through
its own builder, the reference's through ``reference_native`` (never the
in-place build under native/ that the test processes race for at
collection)."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import io  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from scipy.io import wavfile  # noqa: E402
from scipy.signal import resample_poly  # noqa: E402

from mla_tpu.data import native as jnative  # noqa: E402
from mla_tpu_torch.data import adpcm, audio_io, native  # noqa: E402
from mla_tpu_torch.ops import _build  # noqa: E402
from tests.torch_port_common import reference_native_libraries  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def libraries(reference_native_libraries):
    _build.load_native("audio_ingest")
    assert native.available() and jnative.available()
    return reference_native_libraries


def _wav_bytes(x, sr, dtype):
    if dtype == np.int16:
        data = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    elif dtype == np.int32:
        data = (np.clip(x, -1, 1) * 2147483647).astype(np.int32)
    elif dtype == np.uint8:
        data = (np.clip(x, -1, 1) * 127 + 128).astype(np.uint8)
    else:
        data = x.astype(dtype)
    bio = io.BytesIO()
    wavfile.write(bio, sr, data)
    return bio.getvalue()


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32, np.uint8])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_decode(dtype, channels):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((5000, channels) if channels > 1 else 5000) * 0.3)
    raw = _wav_bytes(x.astype(np.float32), 22050, dtype)
    got, sr = native.wav_decode(raw)
    want, sr_j = jnative.wav_decode(raw)
    assert sr == sr_j == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    sr_s, data = wavfile.read(io.BytesIO(raw))
    np.testing.assert_allclose(got, audio_io._pcm_to_float_mono(data), rtol=0, atol=1e-6)


def test_wav_decode_rejects_garbage():
    with pytest.raises(ValueError, match="not a parseable RIFF/WAVE file"):
        native.wav_decode(b"not a wav file at all" * 10)


@pytest.mark.parametrize("sr_in", [8000, 22050, 44100, 48000])
def test_resample(sr_in):
    x = (np.random.default_rng(2).standard_normal(sr_in) * 0.3).astype(np.float32)
    got = native.resample(x, sr_in, 16000)
    np.testing.assert_array_equal(got, jnative.resample(x, sr_in, 16000))
    from fractions import Fraction

    frac = Fraction(16000, sr_in)
    want = resample_poly(x, frac.numerator, frac.denominator).astype(np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mulaw():
    x = np.random.default_rng(3).uniform(-1.2, 1.2, 20000).astype(np.float32)
    q = native.mulaw_encode(x)
    np.testing.assert_array_equal(q, jnative.mulaw_encode(x))
    np.testing.assert_array_equal(q, audio_io.mulaw_encode(x))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(native.mulaw_decode(codes), jnative.mulaw_decode(codes))
    np.testing.assert_allclose(native.mulaw_decode(codes), audio_io.mulaw_decode(codes),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("rows,n,block", [(1, 4096, 256), (8, 77120, 64), (5, 2560, 256)])
def test_adpcm_encoders(bits, rows, n, block):
    x = np.clip(np.random.default_rng(4).standard_normal((rows, n)) * 0.2, -1, 1)
    pcm = audio_io.pcm16_quantize(x.astype(np.float32))
    enc, jenc = ((native.adpcm4_encode, jnative.adpcm4_encode) if bits == 4
                 else (native.adpcm2_encode, jnative.adpcm2_encode))
    got = enc(pcm, block)
    np.testing.assert_array_equal(got, jenc(pcm, block))
    np.testing.assert_array_equal(got, adpcm.numpy_encode(pcm, block, bits))
    assert got.shape == (rows, adpcm.wire_length(n, block, bits=bits))


def test_adpcm_refuses_a_ragged_row():
    pcm = np.zeros((2, 100), np.int16)
    with pytest.raises(ValueError, match="must be a multiple of block=64"):
        native.adpcm4_encode(pcm, 64)


def test_ring_pop_sequence():
    rng = np.random.default_rng(5)
    rings = native.NativeRingBuffer(), jnative.NativeRingBuffer()
    pops = ([], [])
    for step in range(12):
        chunk = rng.standard_normal(int(rng.integers(0, 900))).astype(np.float32)
        for ring, out in zip(rings, pops):
            ring.push(chunk)
            out.append(len(ring))
            got = ring.pop_chunk(1024, 512)
            out.append(None if got is None else got.copy())
    assert [p is None for p in pops[0]] == [p is None for p in pops[1]]
    assert any(isinstance(p, np.ndarray) for p in pops[0])
    for a, b in zip(*pops):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_audio_io_and_adpcm_take_the_library(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(44100) * 0.3).astype(np.float32)
    path = str(tmp_path / "a.wav")
    audio_io.write_wav(path, x, sr=44100)
    before = dict(native.CALLS)
    got = audio_io.load_wav_16k(path)
    got_b, _ = audio_io.read_wav_bytes(open(path, "rb").read())
    wire4 = adpcm.adpcm4_encode(x[:4096])
    wire2 = adpcm.adpcm2_encode(x[:4096], block=64)
    moved = {k: native.CALLS[k] - before[k] for k in before}
    assert moved == {"wav_decode": 2, "resample": 1, "mulaw_encode": 0, "mulaw_decode": 0,
                     "adpcm4_encode": 1, "adpcm2_encode": 1}
    # the fallbacks: scipy and numpy, when the library is not there
    monkeypatch.setattr(native, "_LIB", False)
    assert not native.available()
    before = dict(native.CALLS)
    np.testing.assert_allclose(got, audio_io.load_wav_16k(path), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_b, audio_io.read_wav_bytes(open(path, "rb").read())[0])
    np.testing.assert_array_equal(wire4, adpcm.adpcm4_encode(x[:4096]))
    np.testing.assert_array_equal(wire2, adpcm.adpcm2_encode(x[:4096], block=64))
    assert native.CALLS == before
    with pytest.raises(RuntimeError, match="native audio_ingest unavailable"):
        native.wav_decode(b"")


def test_the_library_builds_under_build_not_native():
    path = _build.native_library_path("audio_ingest")
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path.parent.parts[-2:] == ("build", "mla_tpu_torch")
