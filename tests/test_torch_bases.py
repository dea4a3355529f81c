"""The front-end's cached spectral bases (mla_tpu_torch/ops/frontend.py::
device_bases) cannot be changed from outside: the tensors share no memory
with the cached numpy arrays, a write into a returned CPU tensor does not
reach a later call, and a trace (torch.export) caches nothing, so the
front-end's numbers after an export equal those before it."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu_torch.config import FrontendConfig  # noqa: E402
from mla_tpu_torch.ops import frontend as fe  # noqa: E402
from mla_tpu_torch.ops import fused_frontend as ff  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.parametrize("precision", ["highest", "high", "default", "bf16x3"])
def test_a_write_into_returned_bases_does_not_reach_a_later_call(precision):
    cfg = FrontendConfig(precision=precision)
    want = [a.copy() for a in fe.trimmed_spectral_bases(cfg)[:3]]
    golden = np.load("tests/golden/frontend_golden.npz")
    wav = torch.from_numpy(golden["wav"])
    before = fe.waveform_to_patches(wav, cfg)
    got = fe.device_bases(cfg, CPU)
    for t, arr in zip(got, fe.trimmed_spectral_bases(cfg)[:3]):
        assert not np.shares_memory(t.numpy(), arr)
        t.mul_(0.5).add_(1.0)  # a caller that scribbles on what it was given
    for t, w in zip(fe.device_bases(cfg, CPU), want):
        np.testing.assert_array_equal(t.numpy(), w)
    for a, w in zip(fe.trimmed_spectral_bases(cfg)[:3], want):
        np.testing.assert_array_equal(a, w)
    assert torch.equal(fe.waveform_to_patches(wav, cfg), before)
    # the fused kernel's plain version reads the same bases
    np.testing.assert_allclose(
        ff.fused_log_mel_patches_reference(wav, FrontendConfig(), "highest").numpy(),
        golden["patches"], atol=2e-4)


class _FrontEnd(torch.nn.Module):
    def forward(self, wav):
        return fe.waveform_to_patches(wav, FrontendConfig())


def test_a_trace_caches_nothing():
    """torch.export runs the front-end on fake tensors: the bases it makes
    there become the program's constants and stay out of the cache, so an
    eager call after the export computes on real bases, as before it."""
    golden = np.load("tests/golden/frontend_golden.npz")
    wav = torch.from_numpy(golden["wav"])[None]
    fe._cached_bases.cache_clear()
    ep = torch.export.export(_FrontEnd(), (wav,), strict=False)
    assert fe._cached_bases.cache_info().currsize == 0
    eager = fe.waveform_to_patches(wav, FrontendConfig())
    assert type(eager) is torch.Tensor
    np.testing.assert_allclose(eager[0].numpy(), golden["patches"], atol=2e-4)
    assert torch.equal(ep.module()(wav), eager)
