"""The reference agrees with mla_tpu_torch at a tiny size on the CPU (f32
throughout, so both agree to rounding): every cell run through its own
traffic driver, and the pieces one by one."""

import numpy as np
import pytest
import torch

from benchmark import core, inputs
from benchmark.reference import model as ref
from conftest import failing, tiny_run

CELLS = [w["name"] for w in core.manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_agrees_with_the_reference(cell):
    # the 4.8 s hop's window has to reach a piece of each of 3 streams' phases
    run, traffic = tiny_run(cell, seconds=2.5 if cell.endswith("c5") else 0.6)
    out = traffic.run(run)
    assert failing(out) == [] and out["attempted"] > 0
    assert all(v <= 1e-4 for v, _ in out["checks"].values()), out["checks"]
    assert run.setup_s > 0


def test_front_end_trunk_and_heads_one_by_one():
    from mla_tpu_torch.config import FrontendConfig
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.ops.frontend import waveform_to_patches

    run, _ = tiny_run("audioset-tag-b128")
    m, fe = run.config["model"], run.config["frontend"]
    wav = inputs.make_clips(3, 32000, 16000, 5, "test", "cpu")
    got = waveform_to_patches(wav, FrontendConfig(precision="highest"))
    want = ref.log_mel_patches(wav, fe)
    assert got.shape == want.shape and float((got - want).abs().max()) < 2e-4
    weights = inputs.make_weights(m, 5, "cpu")
    model = build_model(run.cfg.model, device="cpu")
    model.load_state_dict(inputs.program_state_dict(weights))
    with torch.no_grad():
        probs = model(want)
    with ref.exact_f32(), torch.no_grad():
        ref_probs = ref.forward(want, weights, m)
    np.testing.assert_allclose(probs.numpy(), ref_probs.numpy(), atol=1e-6)
    assert set(model.state_dict()) == set(inputs.program_state_dict(weights))


def test_control_and_planted_faults_read_far_from_a_sound_run():
    """The control and the planted half batch, at the tiny size: each reads
    well above the sound run's rounding."""
    for cell in ("audioset-train-b256", "audioset-tag-b128"):
        run, traffic = tiny_run(cell, seconds=0.6)
        readings = traffic.control(run)
        for kind, numbers in readings.items():
            top = max(v for k, v in numbers.items() if k.endswith("_gap"))
            assert top > 1e-3, (cell, kind, numbers)
