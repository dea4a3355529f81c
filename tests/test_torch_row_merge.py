"""The row-merge probe of the PyTorch port against the Pallas kernels of
scripts/probe_mosaic_reshape.py, run in interpret mode: the plain versions
bit-exact, the wrappers' checks, the choice between the two row-merge
kernels, and the probe entry point's device rule. The CUDA kernels
themselves are held against their plain versions on the card (chip_smoke.py
and the last test here, which skips without a card)."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from mla_tpu_torch import probe_row_merge  # noqa: E402
from mla_tpu_torch.ops import row_merge as rm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (shape, rows): the probe's own, a wider one, and an odd one
CASES = [((960, 160), 3), ((64, 48), 4), ((33, 7), 3)]
# (shape, rows, offset in floats of x into its buffer) for the card: CASES,
# a bulk case whose output rows (64 KB) each take several ring stages, two
# whose units hold several output rows and end ragged (the second with
# several units per block, so the ring turns), and a view that starts
# inside a 16-byte word (the generic kernel, scale2's scalar head)
CARD_CASES = [(s, r, 0) for s, r in CASES] + [((64, 8192), 2, 0), ((4096, 64), 2, 0),
                                              ((64996, 64), 2, 0), ((960, 160), 3, 1)]


@pytest.fixture(scope="module")
def probe_script():
    """scripts/probe_mosaic_reshape.py, loaded by path (scripts/ is no package)."""
    path = os.path.join(ROOT, "scripts", "probe_mosaic_reshape.py")
    spec = importlib.util.spec_from_file_location("probe_mosaic_reshape", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape,rows", CASES)
def test_scale2_reference_equals_control_kernel(probe_script, shape, rows):
    x = _x(shape)
    ref = pl.pallas_call(probe_script.control_kernel, interpret=True,
                         out_shape=jax.ShapeDtypeStruct(shape, jnp.float32))(jnp.asarray(x))
    ours = rm.scale2_reference(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(ref))
    np.testing.assert_array_equal(rm.scale2(torch.from_numpy(x)).numpy(), np.asarray(ref))


def _row_merge_pallas(rows, out_shape):
    def kernel(x_ref, o_ref):  # probe_mosaic_reshape.kernel, for any merge factor
        o_ref[...] = x_ref[...].reshape(out_shape)
    return kernel


@pytest.mark.parametrize("shape,rows", CASES)
def test_row_merge_reference_equals_reshape_kernel(probe_script, shape, rows):
    x = _x(shape, seed=1)
    out_shape = (shape[0] // rows, rows * shape[1])
    # the probe's own kernel at its own shape, the same body elsewhere
    body = (probe_script.kernel if (shape, rows) == CASES[0]
            else _row_merge_pallas(rows, out_shape))
    ref = pl.pallas_call(body, interpret=True,
                         out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32))(jnp.asarray(x))
    ours = rm.row_merge_reference(torch.from_numpy(x), rows)
    assert tuple(ours.shape) == out_shape
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(rm.row_merge(torch.from_numpy(x), rows).numpy(),
                                  np.asarray(ref))
    # the kernel's index rule: out[r, j * C + c] = x[rows * r + j, c]
    r, j, c = out_shape[0] - 1, rows - 1, shape[1] - 1
    assert ours[r, j * shape[1] + c] == x[rows * r + j, c]


def test_wrappers_check_their_input():
    x = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="multiple of rows"):
        rm.row_merge(x, 3)
    with pytest.raises(ValueError, match=r"\[R, C\]"):
        rm.row_merge(torch.zeros(12), 3)
    with pytest.raises(TypeError):
        rm.scale2(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        rm.row_merge(torch.zeros((4, 6)).t(), 2)
    before = dict(rm.LAUNCHES)
    rm.scale2(x), rm.row_merge(x, 2)
    assert rm.LAUNCHES == before  # the plain versions launch nothing
    assert rm.bytes_moved(torch.zeros((960, 160))) == 1_228_800


@pytest.mark.parametrize("shape,rows,x_ptr,out_ptr,variant", [
    ((960, 160), 3, 0, 0, "bulk"),             # the probe's shape
    ((4096, 1024), 4, 1 << 20, 512, "bulk"),
    ((16384, 4096), 4, 4096, 1 << 30, "bulk"),
    ((33, 7), 3, 0, 0, "generic"),             # a source row of 28 bytes
    ((960, 162), 3, 0, 0, "generic"),          # 648 bytes: 8- but not 16-byte rows
    ((960, 160), 3, 4, 0, "generic"),          # x starts 4 bytes into a 16-byte word
    ((960, 160), 3, 0, 8, "generic"),          # out does not start on 16 bytes
    ((960, 160), 3, 0, 1, "generic"),          # an odd output pointer
])
def test_row_merge_variant(shape, rows, x_ptr, out_ptr, variant):
    assert rm.row_merge_variant(shape, rows, x_ptr, out_ptr) == variant


def _view(shape, offset, seed=3, device="cpu"):
    """A contiguous [R, C] view that starts ``offset`` floats into its buffer."""
    buf = torch.from_numpy(_x((shape[0] * shape[1] + offset,), seed)).to(device)
    return buf[offset:].view(shape)


@pytest.mark.parametrize("shape,rows,offset", CARD_CASES)
def test_cpu_path_launches_no_kernel(shape, rows, offset):
    x = _view(shape, offset)
    assert x.is_contiguous() and x.storage_offset() == offset
    before = dict(rm.LAUNCHES)
    a, b = rm.scale2(x), rm.row_merge(x, rows)
    assert rm.LAUNCHES == before
    assert torch.equal(a, x * 2) and a.device.type == "cpu"
    np.testing.assert_array_equal(b.numpy(), x.numpy().reshape(shape[0] // rows, -1))


def test_probe_needs_a_card_unless_cpu_is_named(capsys):
    out = probe_row_merge.probe("cpu")
    assert out == {"row_merge_reshape_supported": True, "control_kernel_ok": True,
                   "verdict": "supported", "platform": "cpu", "error": None,
                   "control_error": None}
    assert probe_row_merge.main("cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_row_merge.main()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,rows,offset", CARD_CASES)
def test_kernels_match_plain_versions_on_the_card(cuda, shape, rows, offset):
    x = _view(shape, offset, seed=2, device=cuda)
    before = dict(rm.LAUNCHES)
    a, b = rm.scale2(x), rm.row_merge(x, rows)
    torch.cuda.synchronize()
    variant = rm.row_merge_variant(shape, rows, x.data_ptr(), b.data_ptr())
    assert variant == ("generic" if offset or (4 * shape[1]) % 16 else "bulk")
    assert {k: rm.LAUNCHES[k] - before[k] for k in before} == {
        "scale2": 1, "row_merge_bulk": variant == "bulk", "row_merge_generic": variant == "generic"}
    assert torch.equal(a, rm.scale2_reference(x))
    assert torch.equal(b, rm.row_merge_reference(x, rows))
