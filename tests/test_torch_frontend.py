"""Front-end of the PyTorch port against the JAX package: the numpy
builders, the torch-ops path, and the fused kernel's plain version against
the Pallas kernel run in interpret mode. The tensor-core kernel's numerics
(3xTF32 emulated in torch), its packed operands and its tile rule are held
here on the CPU. The CUDA kernel itself, both variants, is held against its
plain version on the card (chip_smoke.py and the last test here, which
skips without a card)."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.config import FrontendConfig as JaxFrontendConfig  # noqa: E402
from mla_tpu.ops import frontend as jfe  # noqa: E402
from mla_tpu.ops import pallas_frontend as jpf  # noqa: E402
from mla_tpu_torch.config import FrontendConfig  # noqa: E402
from mla_tpu_torch.ops import fused_frontend as ff  # noqa: E402
from mla_tpu_torch.ops import frontend as fe  # noqa: E402

# (port config, JAX config) pairs: the VGGish default and a non-default
# geometry (0.5 s patches; 7 patches = 350 frames, not a multiple of 3)
GEOMETRIES = {
    "default": {},
    "half_second_patches": {"example_window_seconds": 0.5, "example_hop_seconds": 0.5},
}


def _cfgs(**kw):
    return FrontendConfig(**kw), JaxFrontendConfig(**kw)


def _wav(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


def _fused_jax(wav, cfg, precision):
    return np.asarray(jpf.fused_log_mel_patches(jnp.asarray(wav), cfg, precision=precision,
                                                interpret=True))


@pytest.mark.parametrize("args", [(), (40, 129, 8000, 60.0, 3800.0), (64, 513, 22050)])
def test_mel_filterbank_equals_reference(args):
    np.testing.assert_array_equal(fe.mel_filterbank(*args), jfe.mel_filterbank(*args))


def test_hann_hertz_and_dft_bases_equal_reference():
    np.testing.assert_array_equal(fe.periodic_hann(400), jfe.periodic_hann(400))
    np.testing.assert_array_equal(fe.hertz_to_mel([0.0, 700.0, 7500.0]),
                                  jfe.hertz_to_mel([0.0, 700.0, 7500.0]))
    for ours, ref in zip(fe.dft_bases(400, 512), jfe.dft_bases(400, 512)):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("kw", [{}, {"mel_max_hz": 6000.0, "num_mel_bins": 40},
                                {"sample_rate": 22050}])
def test_trimmed_bases_equal_reference(kw):
    tcfg, jcfg = _cfgs(**kw)
    ours, ref = fe.trimmed_spectral_bases(tcfg), jfe.trimmed_spectral_bases(jcfg)
    assert ours[3] == ref[3]
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)


def _oracle_patches(wav, tcfg):
    """float64 log-mel patches from freshly built bases (the port's builders,
    equal to the reference's: test_trimmed_bases_equal_reference)."""
    fresh = fe.trimmed_spectral_bases.__wrapped__(tcfg)
    cos_b, sin_b, mel = (np.asarray(b, np.float64) for b in fresh[:3])
    w, n = tcfg.window_length, tcfg.hop_length
    t = 1 + (wav.shape[-1] - w) // n
    frames = wav.astype(np.float64)[..., np.arange(t)[:, None] * n + np.arange(w)]
    log_mel = np.log(np.hypot(frames @ cos_b, frames @ sin_b) @ mel + tcfg.log_offset)
    k = tcfg.example_window_frames
    t = t // k * k
    return log_mel[..., :t, :].reshape(*wav.shape[:-1], t // k, k, -1)


def _which_side_moved(wav, tcfg, jcfg, ours, ref, tol):
    """For a failed parity check: each side's distance from the float64
    oracle on the failing call and on a second call, and where the
    violations lie, so a failure says which side moved and whether it
    stays moved."""
    oracle = _oracle_patches(wav, tcfg)
    again = {"port": fe.waveform_to_patches(torch.from_numpy(wav), tcfg).numpy(),
             "jax": np.asarray(jfe.waveform_to_patches(jnp.asarray(wav), jcfg))}
    lines = [f"{side}: max |x - f64 oracle| {np.abs(x - oracle).max():.3e} on the failing call, "
             f"{np.abs(again[side] - oracle).max():.3e} on a second call "
             f"({'equal' if np.array_equal(x, again[side]) else 'not equal'} to the first)"
             for side, x in (("port", ours), ("jax", ref))]
    fresh = fe.trimmed_spectral_bases.__wrapped__(tcfg)[:3]
    cached = {"port numpy": fe.trimmed_spectral_bases(tcfg)[:3],
              "port tensors": [t.numpy() for t in fe.device_bases(tcfg, "cpu")],
              "jax numpy": jfe.trimmed_spectral_bases(jcfg)[:3]}
    lines.append("cached bases equal to fresh ones: " + ", ".join(
        f"{k} {all(np.array_equal(a, b) for a, b in zip(v, fresh))}" for k, v in cached.items()))
    bad = np.argwhere(np.abs(ours - ref) > tol)
    lines.append(f"violations at (clip, patch, frame, bin): {bad[:12].tolist()}; "
                 f"torch threads {torch.get_num_threads()}")
    return "\n".join(lines)


@pytest.mark.parametrize("precision,tol", [("highest", 2e-4), ("high", 2e-4), ("bf16x3", 5e-4)])
def test_waveform_to_patches_matches_jax(precision, tol):
    tcfg, jcfg = _cfgs(precision=precision)
    wav = _wav(0, (2, 16000 * 3))
    ours = fe.waveform_to_patches(torch.from_numpy(wav), tcfg).numpy()
    ref = np.asarray(jfe.waveform_to_patches(jnp.asarray(wav), jcfg))
    assert ours.shape == ref.shape == (2, 3, 96, 64)
    try:
        np.testing.assert_allclose(ours, ref, atol=tol)
    except AssertionError as e:
        raise AssertionError(f"{e}\n{_which_side_moved(wav, tcfg, jcfg, ours, ref, tol)}") from None


def test_log_mel_spectrogram_matches_jax():
    tcfg, jcfg = _cfgs()
    wav = _wav(1, 16000 * 2 + 123)
    ours = fe.log_mel_spectrogram(torch.from_numpy(wav), tcfg).numpy()
    ref = np.asarray(jfe.log_mel_spectrogram(jnp.asarray(wav), jcfg))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=2e-4)


@pytest.mark.parametrize("path", ["xla", "fused_plain", "fft"])
def test_frontend_matches_golden(path):
    g = np.load("tests/golden/frontend_golden.npz")
    wav = torch.from_numpy(g["wav"])
    if path == "xla":
        ours = fe.waveform_to_patches(wav, FrontendConfig())
    elif path == "fft":
        ours = fe.waveform_to_patches(wav, FrontendConfig(), method="fft")
    else:
        ours = ff.fused_log_mel_patches(wav, FrontendConfig(), "highest")
    np.testing.assert_allclose(ours.numpy(), g["patches"], atol=2e-4)


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_fft_log_mel_matches_jax(precision):
    """torch.fft.rfft of the Hann-windowed frames, |.|, the full filterbank
    and the log, against JAX's jnp.fft path, at a length that is no whole
    number of hops. (The mel product takes "highest" under bf16x3; JAX's
    "default" is f32 on the CPU, where the port rounds to bf16, so it is not
    compared here.)"""
    tcfg, jcfg = _cfgs(precision=precision)
    wav = _wav(11, (2, 16000 * 2 + 321))
    ours = fe.log_mel_spectrogram(torch.from_numpy(wav), tcfg, method="fft").numpy()
    ref = np.asarray(jfe.log_mel_spectrogram(jnp.asarray(wav), jcfg, method="fft"))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=2e-4)
    with pytest.raises(ValueError, match="unknown stft method"):
        fe.log_mel_spectrogram(torch.from_numpy(wav), tcfg, method="dct")


def test_overlapping_patches_match_jax():
    tcfg, jcfg = _cfgs(example_hop_seconds=0.48)
    wav = _wav(2, (2, 16000 * 3))
    ours = fe.waveform_to_patches(torch.from_numpy(wav), tcfg).numpy()
    ref = np.asarray(jfe.waveform_to_patches(jnp.asarray(wav), jcfg))
    assert ours.shape == ref.shape == (2, 5, 96, 64)
    np.testing.assert_allclose(ours, ref, atol=2e-4)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("precision,tol", [("highest", 2e-4), ("bf16x3", 5e-4)])
def test_fused_plain_version_matches_pallas_kernel(geometry, precision, tol):
    tcfg, jcfg = _cfgs(**GEOMETRIES[geometry])
    wav = _wav(3, (2, 16000 * 4))
    ours = ff.fused_log_mel_patches(torch.from_numpy(wav), tcfg, precision).numpy()
    ref = _fused_jax(wav, jcfg, precision)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=tol)


def test_fused_plain_version_default_precision_rounds_to_bf16():
    """JAX on the CPU computes "default" in f32, so this holds the port's
    one-pass bf16 operand rounding against f32: the measured max difference
    on this input was 4.1e-2, near the log floor; the stated budget is
    5e-2 (the ~4e-2 of mla_tpu/config.py:41). The rounding must be real:
    "default" differs from "highest"."""
    tcfg, jcfg = _cfgs()
    wav = _wav(0, (2, 16000 * 3))
    ours = ff.fused_log_mel_patches(torch.from_numpy(wav), tcfg, "default").numpy()
    ref = _fused_jax(wav, jcfg, "default")
    np.testing.assert_allclose(ours, ref, atol=5e-2)
    highest = ff.fused_log_mel_patches(torch.from_numpy(wav), tcfg, "highest").numpy()
    assert np.abs(ours - highest).max() > 1e-3


def test_fused_1d_input():
    tcfg, jcfg = _cfgs()
    wav = _wav(4, 16000 * 3)
    ours = ff.fused_log_mel_patches(torch.from_numpy(wav), tcfg).numpy()
    assert ours.shape == (3, 96, 64)
    np.testing.assert_allclose(ours, _fused_jax(wav, jcfg, "highest"), atol=2e-4)


def test_fused_rejects_overlap_and_short_clips_like_jax():
    tcfg, jcfg = _cfgs(example_hop_seconds=0.48)
    wav = np.zeros((1, 16000 * 2), np.float32)
    with pytest.raises(NotImplementedError) as ours:
        ff.fused_log_mel_patches(torch.from_numpy(wav), tcfg)
    with pytest.raises(NotImplementedError) as ref:
        jpf.fused_log_mel_patches(jnp.asarray(wav), jcfg, interpret=True)
    assert str(ours.value) == str(ref.value)
    tcfg, jcfg = _cfgs()
    short = np.zeros((1, 1000), np.float32)
    with pytest.raises(ValueError, match="short") as ours:
        ff.fused_log_mel_patches(torch.from_numpy(short), tcfg)
    with pytest.raises(ValueError) as ref:
        jpf.fused_log_mel_patches(jnp.asarray(short), jcfg, interpret=True)
    assert str(ours.value) == str(ref.value)


def test_fused_wrapper_checks_its_input():
    wav = torch.zeros(2, 16000 * 2)
    with pytest.raises(TypeError):
        ff.fused_log_mel_patches(wav.double())
    with pytest.raises(ValueError, match="contiguous"):
        ff.fused_log_mel_patches(torch.zeros(16000 * 2, 2).t())
    with pytest.raises(ValueError, match="precision"):
        ff.fused_log_mel_patches(wav, FrontendConfig(), "tf32")
    with pytest.raises(ValueError, match="shape"):
        ff.fused_log_mel_patches(wav[None])
    assert ff.LAUNCHES == 0  # the CPU path never counts a launch


def test_apply_frontend_dispatch():
    wav = torch.from_numpy(_wav(5, (2, 16000 * 2)))
    cfg = FrontendConfig()
    fused = fe.apply_frontend(wav, dataclasses.replace(cfg, impl="pallas"))
    xla = fe.apply_frontend(wav, cfg)
    np.testing.assert_allclose(fused.numpy(), xla.numpy(), atol=2e-4)
    with pytest.raises(ValueError, match="impl"):
        fe.apply_frontend(wav, dataclasses.replace(cfg, impl="nope"))


@pytest.mark.parametrize("n", [16000, 48000, 77120, 160000])
def test_shape_planning_matches_jax(n):
    tcfg, jcfg = _cfgs()
    assert fe.patches_per_clip(n, tcfg) == jfe.patches_per_clip(n, jcfg)
    assert fe.patch_hop_seconds(tcfg) == jfe.patch_hop_seconds(jcfg) == pytest.approx(0.96)


def test_bytes_moved_counts_the_waveform_once():
    # 960 frames of a 10 s clip cover (960 - 1) * 160 + 400 samples, read
    # within the 3-hop-block plan's (960 - 1 + 3) * 160; 960 x 64 out
    assert ff.frontend_bytes_moved(4, 160000) == 4 * (962 * 160 * 4 + 960 * 64 * 4)
    assert ff.frontend_bytes_moved(4, 160000) < jpf.frontend_bytes_moved(4, 160000, JaxFrontendConfig())


GEOMETRY_22K = {"sample_rate": 22050}  # window 551, hop 220, 349 mel-active bins


def test_3xtf32_emulation_matches_golden_and_f32():
    """The tensor-core kernel's "highest" arithmetic, emulated: both operands
    split by ``split_tf32`` (cvt.rna.tf32.f32), small*big + big*small +
    big*big as f32 matmuls. It must hold the front-end gate against the
    golden (2e-4) and stay within 1e-5 of the f32 path (a bf16 hi/lo split
    lands near 9e-5)."""
    g = np.load("tests/golden/frontend_golden.npz")
    cfg = FrontendConfig()
    wav = torch.from_numpy(g["wav"])[None]
    _, _, used, n_patches, _, _ = ff._framing_plan(cfg, wav.shape[1])
    frames = fe.frame_signal(wav, cfg.window_length, cfg.hop_length)[:, :used]
    cos_b, sin_b, mel_t = fe.device_bases(cfg, torch.device("cpu"))

    def dot3(a, b):
        a_big, a_small = ff.split_tf32(a)
        b_big, b_small = ff.split_tf32(b)
        return a_small @ b_big + a_big @ b_small + a_big @ b_big

    re, im = dot3(frames, cos_b), dot3(frames, sin_b)
    emulated = torch.log(torch.sqrt(re * re + im * im) @ mel_t + cfg.log_offset)
    emulated = emulated.reshape(n_patches, 96, 64).numpy()
    f32 = ff.fused_log_mel_patches_reference(wav, cfg, "highest")[0].numpy()
    assert np.abs(emulated - g["patches"]).max() <= 2e-4
    assert np.abs(emulated - f32).max() <= 1e-5
    # the split is real: TF32 alone is far coarser than 3xTF32
    big = ff.round_tf32(frames) @ ff.round_tf32(cos_b)
    assert (big - frames @ cos_b).abs().max() > 100 * (dot3(frames, cos_b) - frames @ cos_b).abs().max()


def test_round_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -20,
                      one + 3 * ulp / 2, 3.0e-3])
    got = ff.round_tf32(x)
    assert got[:4].tolist() == [one + ulp, -(one + ulp), one, one + 2 * ulp]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(float(got[4]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


def _unpack(words, kp, np_, precision):
    """Scatter the packed B operand back to dense [kp, np] planes: cos and
    sin, each (hi, lo) or (big, small), or (bf16,) for "default"."""
    k, n = ff.fragment_coords(kp, np_, precision)
    if precision in ("highest", "high"):
        vals = words.view(torch.float32)
    else:
        vals = words.contiguous().view(torch.bfloat16).float()
    per = vals.shape[-1] // (2 if precision == "default" else 4)
    planes = []
    for i in range(vals.shape[-1] // per):
        dense = torch.full((kp, np_), float("nan"))
        dense[k, n] = vals[..., i * per:(i + 1) * per]
        planes.append(dense)
    return planes


@pytest.mark.parametrize("geometry", ["16k", "22k"])
@pytest.mark.parametrize("precision", ["default", "bf16x3", "highest"])
def test_packed_bases_reconstruct_the_bases(geometry, precision):
    cfg = FrontendConfig(**(GEOMETRY_22K if geometry == "22k" else {}))
    cos_b, sin_b, mel_t, n_bins = fe.trimmed_spectral_bases(cfg)
    kp, np_ = ff.padded_sizes(cfg)
    assert kp % 16 == 0 and np_ % 16 == 0
    assert (kp, np_) == ((400, 240) if geometry == "16k" else (560, 352))
    words, mel = ff.pack_dft_bases(cfg, precision)
    ks = 8 if precision == "highest" else 16
    assert words.dtype == torch.int32
    assert words.shape == (kp // ks, np_ // 8, 32, 4 if precision == "default" else 8)
    planes = _unpack(words, kp, np_, precision)
    n_planes = 1 if precision == "default" else 2
    for basis, parts in zip((cos_b, sin_b), (planes[:n_planes], planes[n_planes:])):
        for p in parts:  # every element written once; the padding is zero
            assert not torch.isnan(p).any()
            assert not p[cos_b.shape[0]:].any() and not p[:, n_bins:].any()
        ref = torch.zeros(kp, np_)
        ref[:basis.shape[0], :n_bins] = torch.from_numpy(basis)
        hi = parts[0]
        if precision == "default":
            assert torch.equal(hi, fe.round_bf16(ref))
            continue
        if precision == "bf16x3":
            assert torch.equal(hi, fe.round_bf16(ref))
            assert torch.equal(parts[1], fe.round_bf16(ref - hi))
            err_bound = 2.0 ** -16  # hi + lo keeps ~16 bits of a basis value <= 1
        else:
            assert torch.equal(hi, ff.round_tf32(ref))
            assert torch.equal(parts[1], ff.round_tf32(ref - hi))
            err_bound = 2.0 ** -21
        assert float((hi + parts[1] - ref).abs().max()) <= err_bound
    assert mel.shape == (np_, mel_t.shape[1])
    np.testing.assert_array_equal(mel[:n_bins].numpy(), mel_t)
    assert not mel[n_bins:].any()


@pytest.mark.parametrize("batch,n_samples,geometry", [
    (8, 77120, "16k"), (64, 64000, "16k"), (1, 160000, "16k"), (2, 64000, "16k"),
    (2, 88200, "22k"), (64, 88200, "22k"), (1, 16000, "16k")])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_tile_rule_covers_each_clip_exactly(batch, n_samples, geometry, precision):
    cfg = FrontendConfig(**(GEOMETRY_22K if geometry == "22k" else {}))
    _, _, used, _, _, _ = ff._framing_plan(cfg, n_samples)
    kp, np_ = ff.padded_sizes(cfg)
    bm = ff.tile_frames(batch, used, kp, np_, precision, n_sm=132)
    assert bm in ff.TILE_FRAMES
    assert ff.mma_smem_bytes(bm, kp, np_, precision) <= ff.SMEM_BYTES
    gx, gy = ff.tile_grid(batch, used, bm)
    assert gy == batch
    covered = np.zeros(used, np.int64)
    for x in range(gx):  # each block: frames [x * bm, min(...)) of one clip
        lo, hi = x * bm, min((x + 1) * bm, used)
        assert 0 <= lo < hi <= used
        covered[lo:hi] += 1
    assert (covered == 1).all()  # the grid covers used_frames exactly, once
    # a larger tile only where the grid still fills the card
    bigger = [t for t in ff.TILE_FRAMES if t > bm]
    for t in bigger:
        fits = ff.mma_smem_bytes(t, kp, np_, precision) <= ff.SMEM_BYTES
        assert not fits or 8 * np.prod(ff.tile_grid(batch, used, t)) < 7 * 132


def test_tile_rule_at_the_main_path_shapes():
    cfg = FrontendConfig()
    kp, np_ = ff.padded_sizes(cfg)
    assert ff.tile_frames(8, 480, kp, np_, "default", 132) == 32  # serving: 120 blocks
    assert ff.tile_frames(64, 384, kp, np_, "highest", 132) == 64  # training: 384 blocks
    kp22, np22 = ff.padded_sizes(FrontendConfig(**GEOMETRY_22K))
    assert ff.mma_smem_bytes(64, kp22, np22, "default") > ff.SMEM_BYTES  # 22.05 kHz: <= 32


def test_fused_wrapper_on_cpu_launches_nothing():
    wav = torch.from_numpy(_wav(5, (2, 16000 * 2)))
    before = ff.LAUNCHES
    out = ff.fused_log_mel_patches(wav, FrontendConfig(), "default")
    assert ff.LAUNCHES == before  # a CPU tensor takes the plain version
    assert torch.equal(out, ff.fused_log_mel_patches_reference(wav, FrontendConfig(), "default"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("precision,tol", [("highest", 2e-4), ("bf16x3", 5e-4), ("default", 1e-3)])
def test_kernel_matches_plain_version_on_the_card(cuda, precision, tol):
    for shape, cfg in (((8, 77120), FrontendConfig()),
                       ((2, 88200), FrontendConfig(**GEOMETRY_22K))):
        wav = torch.from_numpy(_wav(6, shape)).to(cuda)
        before = ff.LAUNCHES
        out = ff.fused_log_mel_patches(wav, cfg, precision)
        torch.cuda.synchronize()
        assert ff.LAUNCHES == before + 1
        ref = ff.fused_log_mel_patches_reference(wav, cfg, precision)
        assert out.shape == ref.shape
        assert float((out - ref).abs().max()) <= tol
    # every tile that fits, at the serving shape
    wav = torch.from_numpy(_wav(7, (8, 77120))).to(cuda)
    ref = ff.fused_log_mel_patches_reference(wav, FrontendConfig(), precision)
    for bm in ff.TILE_FRAMES:
        before = ff.LAUNCHES
        out = ff.fused_log_mel_patches(wav, FrontendConfig(), precision, _bm=bm)
        assert ff.LAUNCHES == before + 1
        assert float((out - ref).abs().max()) <= tol
