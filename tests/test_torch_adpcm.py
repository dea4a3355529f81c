"""ADPCM wire codecs of the PyTorch port against the JAX package: the
port's numpy encoders and host decoders bit-identical to
``mla_tpu.data.adpcm``'s numpy path, and the device decode's plain torch
version bit-exact against the golden wires and the JAX decoders' ``lax.scan``
(``xp=jnp``) on the CPU. The scan kernel's algebra is held on the CPU by a
scan-form model of it, in torch int32 ops, against the JAX decoders and the
golden wires. Both CUDA kernels (``scan`` and ``serial``) are held against
the plain version on the card (the tests skip without one)."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import os  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.data import adpcm as ref  # noqa: E402
from mla_tpu.data import native  # noqa: E402
from mla_tpu_torch.data import adpcm  # noqa: E402
from mla_tpu_torch.ops import adpcm as ops  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CODECS = {4: (adpcm.adpcm4_encode, adpcm.adpcm4_decode, ref.adpcm4_encode, ref.adpcm4_decode),
          2: (adpcm.adpcm2_encode, adpcm.adpcm2_decode, ref.adpcm2_encode, ref.adpcm2_decode)}
# ragged lengths: one sample, sub-block, whole blocks, a partial last block
LENGTHS = [1, 63, 256, 1000, 4097]


@pytest.fixture
def numpy_reference(monkeypatch):
    """The JAX package's encoders on their numpy path (its C++ encoder,
    when built, is bit-identical to it and is not what the port copies)."""
    monkeypatch.setattr(native, "available", lambda: False)


def _audio(seed, shape):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * 440 * t) * np.linspace(0.1, 1.0, shape[-1])
    return (tone + 0.05 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("bits", [4, 2])
def test_codec_is_bit_identical_to_reference(numpy_reference, bits, block, n):
    enc, dec, ref_enc, ref_dec = CODECS[bits]
    x = _audio(n + block + bits, (3, n))
    wire = enc(x, block=block)
    assert wire.shape == (3, adpcm.wire_length(n, block, bits)) and wire.dtype == np.uint8
    np.testing.assert_array_equal(wire, ref_enc(x, block=block))
    np.testing.assert_array_equal(dec(wire, n=n, block=block), ref_dec(wire, n=n, block=block))
    # int16 input and leading dimensions pass through the same way
    xi = adpcm.pcm16_quantize(x).reshape(3, 1, n)
    np.testing.assert_array_equal(enc(xi, block=block), ref_enc(xi, block=block))


def test_wire_geometry_equals_reference():
    assert (adpcm.SERVE_BLOCK, adpcm.DEFAULT_BLOCK) == (ref.SERVE_BLOCK, ref.DEFAULT_BLOCK)
    np.testing.assert_array_equal(adpcm.STEP_TABLE, ref.STEP_TABLE)
    for bits in (4, 2):
        for block in (64, 256, 12):
            assert adpcm.wire_block_bytes(block, bits) == ref.wire_block_bytes(block, bits)
            assert adpcm.wire_bytes_per_sample(block, bits) == ref.wire_bytes_per_sample(block,
                                                                                          bits)
            for n in (1, 64, 1000):
                assert adpcm.wire_length(n, block, bits) == ref.wire_length(n, block, bits)
                w = adpcm.wire_length(n, block, bits)
                assert adpcm.padded_samples(w, block, bits) == -(-n // block) * block
    with pytest.raises(ValueError, match="whole number"):
        adpcm.padded_samples(36, 64, 4)


@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("bits", [4, 2])
def test_plain_decode_matches_golden_wire(bits, block):
    g = np.load(os.path.join(GOLDEN, "adpcm_wire.npz" if bits == 4 else "adpcm2_wire.npz"))
    enc = CODECS[bits][0]
    np.testing.assert_array_equal(enc(g["x"], block=block), g[f"wire{block}"])
    out = ops.adpcm_decode(torch.from_numpy(g[f"wire{block}"]), g["x"].size, block, bits)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), g[f"dec{block}"])


@pytest.mark.parametrize("n", [63, 1000, 4097])
@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("bits", [4, 2])
def test_plain_decode_matches_jax_scan(bits, block, n):
    """Against the reference's device decoder (lax.scan, one-hot step
    lookup) on the CPU, with the block padding cut and without."""
    enc, _, _, ref_dec = CODECS[bits]
    wire = enc(_audio(n * bits + block, (2, 3, n)), block=block)
    for cut in (n, None):
        ours = ops.adpcm_decode(torch.from_numpy(wire), cut, block, bits).numpy()
        np.testing.assert_array_equal(ours, np.asarray(ref_dec(wire, n=cut, block=block,
                                                               xp=jnp)))


@pytest.mark.parametrize("bits", [4, 2])
def test_plain_decode_of_any_bytes_matches_jax_scan(bits):
    """Random bytes: predictors of both signs at the int16 edges, and header
    indices past 88, which the reference's one-hot lookup reads as step 0."""
    block = 64
    w = adpcm.wire_length(640, block, bits)
    wire = np.random.default_rng(bits).integers(0, 256, (4, w)).astype(np.uint8)
    ours = ops.adpcm_decode(torch.from_numpy(wire), None, block, bits).numpy()
    np.testing.assert_array_equal(ours, np.asarray(CODECS[bits][3](wire, block=block, xp=jnp)))
    assert ours.min() >= -1.0 and ours.max() < 1.0


def test_cpu_tensor_launches_no_kernel():
    wire = torch.from_numpy(adpcm.adpcm4_encode(_audio(0, (2, 640)), block=64))
    before = ops.LAUNCHES
    out = ops.adpcm_decode(wire, 640, 64, 4)
    assert ops.LAUNCHES == before and out.shape == (2, 640)
    assert torch.equal(out, ops.adpcm_decode_reference(wire, 640, 64, 4))


@pytest.mark.parametrize("variant", ["scan", "serial"])
def test_cpu_tensor_launches_no_kernel_under_either_variant(variant):
    wire = torch.from_numpy(adpcm.adpcm2_encode(_audio(1, (3, 500)), block=64))
    before, by_variant = ops.LAUNCHES, dict(ops.LAUNCHES_BY_VARIANT)
    out = ops.adpcm_decode(wire, 500, 64, 2, _variant=variant)
    assert ops.LAUNCHES == before and ops.LAUNCHES_BY_VARIANT == by_variant
    assert torch.equal(out, ops.adpcm_decode_reference(wire, 500, 64, 2))


def test_decode_refuses_an_unknown_variant():
    wire = torch.zeros(35, dtype=torch.uint8)
    with pytest.raises(ValueError, match="unknown variant"):
        ops.adpcm_decode(wire, 64, 64, 4, _variant="mma")


@pytest.mark.parametrize("bits,block,variant", [(4, 256, "scan"), (4, 1024, "scan"),
                                                (4, 64, "serial"), (2, 64, "serial"),
                                                (2, 256, "serial"), (4, 12, "serial")])
def test_decode_variant_is_picked_from_width_and_block(bits, block, variant):
    """scan where it measured faster (4-bit codes, the training staging's
    blocks of 256), serial for the serving wires and 2-bit codes."""
    assert ops.decode_variant(bits, block) == variant


# ---- the scan kernel's algebra, modelled in torch int32 ops ----
# A clamped-add map x -> min(max(x + a, lo), hi) is a triple (a, lo, hi) of
# int32 tensors; the kernel's identity has finite bounds.
UNBOUNDED = 1 << 30


def _identity(shape):
    return (torch.zeros(shape, dtype=torch.int32), torch.full(shape, -UNBOUNDED, dtype=torch.int32),
            torch.full(shape, UNBOUNDED, dtype=torch.int32))


def _then(f, g):
    """f, then g."""
    (a1, l1, h1), (a2, l2, h2) = f, g
    return (a1 + a2, torch.minimum(torch.maximum(l1 + a2, l2), h2),
            torch.minimum(torch.maximum(h1 + a2, l2), h2))


def _apply(f, x):
    a, lo, hi = f
    return torch.minimum(torch.maximum(x + a, lo), hi)


def _where(mask, f, g):
    return tuple(torch.where(mask, u, v) for u, v in zip(f, g))


def _segment_scan(f, width):
    """Hillis-Steele inclusive scan over the lane axis (the last), as the
    kernel's __shfl_up rounds: lane i ends with the maps of lanes 0..i."""
    lane = torch.arange(width)
    d = 1
    while d < width:
        g = tuple(torch.cat([x[..., :d], x[..., :-d]], dim=-1) for x in f)  # lane - d
        f = _where(lane >= d, _then(g, f), f)
        d *= 2
    return f


def scan_model_decode(wire: np.ndarray, block: int, bits: int, k: int) -> np.ndarray:
    """The scan kernel's decode on the CPU: each block cut into lanes of k
    samples (width, a power of two, at most 32 lanes a pass; longer blocks
    in passes of 32 k samples with the state carried), each lane's maps
    composed in order, a Hillis-Steele scan over the lanes, and each lane
    walking its samples from its left neighbour's end state: the index scan,
    then the steps and deltas, then the predictor scan."""
    n_pad = adpcm.padded_samples(wire.shape[-1], block, bits)
    cb, nb = block * bits // 8, n_pad // block
    u = torch.from_numpy(wire).reshape(-1, nb, cb + 3).to(torch.int32)
    pred = u[..., cb] + (u[..., cb + 1] << 8)
    pred = (pred - (pred >= 32768).to(torch.int32) * 65536).reshape(-1)
    index = u[..., cb + 2].reshape(-1)
    packed = u[..., :cb].reshape(-1, cb)
    codes = torch.stack([(packed >> (bits * i)) & ((1 << bits) - 1) for i in range(8 // bits)],
                        dim=-1).reshape(-1, block)
    table = torch.zeros(256, dtype=torch.int32)
    table[:89] = torch.from_numpy(adpcm.STEP_TABLE)
    width = 1
    while width < -(-block // k) and width < 32:
        width *= 2
    units, out = codes.shape[0], []
    for c0 in range(0, block, width * k):
        m = min(width * k, block - c0)
        valid = (torch.arange(width * k) < m).reshape(width, k)
        c = torch.zeros((units, width * k), dtype=torch.int32)
        c[:, :m] = codes[:, c0:c0 + m]
        c = c.reshape(units, width, k)
        if bits == 4:
            adapt = torch.where((c & 7) < 4, -1, 2 * (c & 7) - 6)
        else:
            adapt = torch.where((c & 1) > 0, 2, -1)
        f = _identity((units, width))
        for t in range(k):
            f = _where(valid[:, t], _then(f, (adapt[..., t], torch.tensor(0), torch.tensor(88))), f)
        f = _segment_scan(f, width)
        end = _apply(f, index[:, None])
        x = torch.cat([index[:, None], end[:, :-1]], dim=1)
        deltas = []
        g = _identity((units, width))
        for t in range(k):
            st, ct = table[x], c[..., t]
            x = torch.where(valid[:, t], torch.clamp(x + adapt[..., t], 0, 88), x)
            if bits == 4:
                d = ((st >> 3) + ((ct >> 2) & 1) * st + ((ct >> 1) & 1) * (st >> 1)
                     + (ct & 1) * (st >> 2))
                d = torch.where((ct & 8) != 0, -d, d)
            else:
                d = (st >> 1) + (ct & 1) * st
                d = torch.where((ct & 2) != 0, -d, d)
            deltas.append(d)
            g = _where(valid[:, t], _then(g, (d, torch.tensor(-32768), torch.tensor(32767))), g)
        g = _segment_scan(g, width)
        pend = _apply(g, pred[:, None])
        p = torch.cat([pred[:, None], pend[:, :-1]], dim=1)
        samples = []
        for d in deltas:
            p = torch.clamp(p + d, -32768, 32767)
            samples.append(p)
        out.append(torch.stack(samples, dim=-1).reshape(units, width * k)[:, :m])
        index, pred = end[:, -1], pend[:, -1]  # the last lane ends in the block's state
    out = torch.cat(out, dim=1).reshape(wire.shape[:-1] + (n_pad,))
    return (out.to(torch.float32) / 32768.0).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clamped_add_maps_compose(seed):
    """(a1, l1, h1) then (a2, l2, h2) is (a1 + a2, clamp(l1 + a2, l2, h2),
    clamp(h1 + a2, l2, h2)) exactly, the finite identity included, and the
    composition is associative."""
    rng = np.random.default_rng(seed)

    def maps(size):
        a = rng.integers(-70000, 70000, size)
        lo, hi = np.sort(rng.integers(-40000, 40000, (2, size)), axis=0)
        return tuple(torch.from_numpy(v.astype(np.int32)) for v in (a, lo, hi))

    size = 4096
    f, g, h = maps(size), maps(size), maps(size)
    x = torch.from_numpy(rng.integers(-100000, 100000, size).astype(np.int32))
    assert torch.equal(_apply(_then(f, g), x), _apply(g, _apply(f, x)))
    assert torch.equal(_apply(_then(_then(f, g), h), x), _apply(_then(f, _then(g, h)), x))
    e = _identity((size,))
    for composed in (_then(e, f), _then(f, e)):
        assert all(torch.equal(u, v) for u, v in zip(composed, f))
    assert torch.equal(_apply(e, x), x)


def _any_bytes_wire(bits, block, seed):
    """Random bytes in 4 rows of 640 samples, with header indices 89..255
    in half the units and predictors at -32768 / 32767 in a quarter each."""
    rng = np.random.default_rng(seed)
    wb = adpcm.wire_block_bytes(block, bits)
    wire = rng.integers(0, 256, (4, adpcm.wire_length(640, block, bits))).astype(np.uint8)
    units = wire.reshape(4, -1, wb)
    pick = rng.random(units.shape[:2])
    units[..., wb - 1] = np.where(pick < 0.5, rng.integers(89, 256, pick.shape), units[..., wb - 1])
    units[pick < 0.25, wb - 3:wb - 1] = (0x00, 0x80)
    units[(pick >= 0.25) & (pick < 0.5), wb - 3:wb - 1] = (0xff, 0x7f)
    return wire


# (block, k): the kernel's k 16 at both main-path blocks and at 12 (one
# lane, partly empty); smaller k, where (256, 2) takes 4 passes
SCAN_CASES = [(64, 16), (256, 16), (12, 16), (64, 2), (64, 4), (256, 8), (12, 4), (256, 2)]


@pytest.mark.parametrize("block,k", SCAN_CASES)
@pytest.mark.parametrize("bits", [4, 2])
def test_scan_model_matches_jax_decoders(bits, block, k):
    """The scan form against the reference's lax.scan decoders (xp=jnp, on
    the CPU), on an encoded tone and on any bytes."""
    enc, _, _, ref_dec = CODECS[bits]
    for wire in (enc(_audio(block + k, (2, 3, 777)), block=block),
                 _any_bytes_wire(bits, block, block * k + bits)):
        np.testing.assert_array_equal(scan_model_decode(wire, block, bits, k),
                                      np.asarray(ref_dec(wire, block=block, xp=jnp)))


@pytest.mark.parametrize("block,k", [c for c in SCAN_CASES if c[0] in (64, 256)])
@pytest.mark.parametrize("bits", [4, 2])
def test_scan_model_matches_golden_wire(bits, block, k):
    g = np.load(os.path.join(GOLDEN, "adpcm_wire.npz" if bits == 4 else "adpcm2_wire.npz"))
    got = scan_model_decode(g[f"wire{block}"], block, bits, k)[..., :g["x"].size]
    np.testing.assert_array_equal(got, g[f"dec{block}"])


@pytest.mark.parametrize("args,err,match", [
    ((torch.zeros(35, dtype=torch.int16), 64, 64, 4), TypeError, "uint8"),
    ((torch.zeros(35, dtype=torch.uint8), 64, 64, 3), ValueError, "bits"),
    ((torch.zeros(35, dtype=torch.uint8), 64, 66, 2), ValueError, "block"),
    ((torch.zeros(36, dtype=torch.uint8), 64, 64, 4), ValueError, "whole number"),
    ((torch.zeros(35, dtype=torch.uint8), 65, 64, 4), ValueError, "n=65"),
    ((torch.zeros(35, dtype=torch.uint8), 0, 64, 4), ValueError, "n=0"),
    ((torch.zeros(0, dtype=torch.uint8), 1, 64, 4), ValueError, "empty"),
])
def test_decode_refuses_what_it_does_not_take(args, err, match):
    with pytest.raises(err, match=match):
        ops.adpcm_decode(*args)


def test_decode_bytes_moved():
    wire = torch.zeros((8, adpcm.wire_length(77120, 64, 4)), dtype=torch.uint8)
    assert ops.decode_bytes_moved(wire, 77120) == 337_400 + 2_467_840


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the ADPCM decode kernel has no CPU mode")
    return torch.device("cuda")


# (shape, block) on the card: the two main-path shapes, leading dimensions, a
# partial last block, fewer blocks than a warp holds, a block of 12 samples
# (not a multiple of 32, nor of a lane's 16 samples), n not a
# multiple of 4, a block of 4 samples (one lane), and a block of 1024 (the
# scan kernel's passes)
CARD_CASES = [((8, 77120), 64), ((64, 64000), 256), ((2, 3, 4097), 64), ((1, 640), 64),
              ((5, 1000), 12), ((3, 33 * 256 + 5), 256), ((2, 998), 4), ((3, 5000), 1024)]


@pytest.mark.parametrize("variant", ["scan", "serial", None])
def test_kernel_is_bit_exact_on_the_card(cuda, variant):
    """Every case of both widths against the plain version on the card,
    random bytes included, with one launch counted per call on the variant
    (None: the one decode_variant picks)."""
    for bits in (4, 2):
        enc = CODECS[bits][0]
        for shape, block in CARD_CASES:
            wire = torch.from_numpy(enc(_audio(1, shape), block=block)).to(cuda)
            n = shape[-1]
            launched = variant or ops.decode_variant(bits, block)
            before = dict(ops.LAUNCHES_BY_VARIANT)
            got = ops.adpcm_decode(wire, n, block, bits, _variant=variant)
            torch.cuda.synchronize()
            assert ops.LAUNCHES_BY_VARIANT == {**before, launched: before[launched] + 1}
            assert torch.equal(got, ops.adpcm_decode_reference(wire, n, block, bits)), \
                (launched, bits, shape, block)
        for block in (64, 256):
            junk = torch.from_numpy(_any_bytes_wire(bits, block, 7)).to(cuda)
            assert torch.equal(ops.adpcm_decode(junk, None, block, bits, _variant=variant),
                               ops.adpcm_decode_reference(junk, None, block, bits)), \
                (variant, bits, block)
