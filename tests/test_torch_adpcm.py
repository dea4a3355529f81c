"""ADPCM wire codecs of the PyTorch port against the JAX package: the
port's numpy encoders and host decoders bit-identical to
``mla_tpu.data.adpcm``'s numpy path, and the device decode's plain torch
version bit-exact against the golden wires and the JAX decoders' ``lax.scan``
(``xp=jnp``) on the CPU. The CUDA kernel is held against its plain version
on the card (the test skips without one)."""

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


def test_kernel_is_bit_exact_on_the_card(cuda):
    """Every case of both widths against the plain version on the card: the
    two main-path shapes, leading dimensions, a partial last block, fewer
    than a warp's 32 blocks, a block that is not a multiple of 32 samples,
    and random bytes."""
    cases = [((8, 77120), 64), ((64, 64000), 256), ((2, 3, 4097), 64), ((1, 640), 64),
             ((5, 1000), 12), ((3, 33 * 256 + 5), 256)]
    for bits in (4, 2):
        enc = CODECS[bits][0]
        for shape, block in cases:
            wire = torch.from_numpy(enc(_audio(1, shape), block=block)).to(cuda)
            n = shape[-1]
            before = ops.LAUNCHES
            got = ops.adpcm_decode(wire, n, block, bits)
            torch.cuda.synchronize()
            assert ops.LAUNCHES == before + 1
            assert torch.equal(got, ops.adpcm_decode_reference(wire, n, block, bits)), \
                (bits, shape, block)
        w = adpcm.wire_length(640, 64, bits)
        junk = torch.randint(0, 256, (4, w), dtype=torch.uint8, device=cuda)
        assert torch.equal(ops.adpcm_decode(junk, None, 64, bits),
                           ops.adpcm_decode_reference(junk, None, 64, bits))
