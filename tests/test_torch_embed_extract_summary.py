"""The port's ``embed``, ``extract``, ``summary`` and ``configs`` verbs
against the reference's (both CLIs in process): ``embed`` of one clip
through weights both packages loaded from one flat .npz, under the fused
front-end (its plain version here, the Pallas kernel interpreted on JAX's
side) and the torch-ops one at ``frontend.precision="highest"``, within
1e-4 (at "default" the port rounds the DFT's operands to bf16, as the TPU
did, where JAX on the CPU multiplies in f32); ``extract`` within 2e-4 at two
sample rates; ``configs`` equal; and ``summary``'s whole table equal for
four configurations, one with the VGGish trunk. The reference reads wavs
through its native library (``mla_tpu.data.native``), pinned for the whole
module by ``reference_native_libraries``, never through its numpy / scipy
fallback."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import contextlib  # noqa: E402
import io  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.__main__ import main as jmain  # noqa: E402
from mla_tpu_torch.__main__ import main as tmain  # noqa: E402
from mla_tpu_torch.data.audio_io import write_wav  # noqa: E402
from mla_tpu_torch.models import convert  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    SMALL,
    configs,
    jax_weights,
    reference_native_libraries,
)

pytestmark = pytest.mark.usefixtures("reference_native_libraries")

SETS = ["--set"] + [f"{k}={v}" for k, v in SMALL.items()]


def _call(main, argv, device=True):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv + (["--device", "cpu"] if main is tmain and device else []))
    return buf.getvalue()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("embed")
    jcfg, _ = configs()
    _, flat = jax_weights(jcfg.model, seed=9)
    np.savez(d / "w.npz", **flat)
    rng = np.random.default_rng(9)
    write_wav(str(d / "a.wav"), (0.2 * rng.standard_normal(16000 * 4)).astype(np.float32))
    write_wav(str(d / "b22.wav"), (0.2 * rng.standard_normal(22050 * 3)).astype(np.float32),
              sr=22050)
    ws = {}
    for tag, main in (("t", tmain), ("j", jmain)):
        ws[tag] = str(d / f"ws_{tag}")
        _call(main, ["weights", "--workspace", ws[tag], "--load", str(d / "w.npz"), *SETS],
              device=False)
    return d, ws


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_embed_matches(setup, impl):
    d, ws = setup
    outs = []
    for tag, main in (("t", tmain), ("j", jmain)):
        out = d / f"{tag}_{impl}.npy"
        text = _call(main, ["embed", "--wav", str(d / "a.wav"), "--out", str(out),
                            "--workspace", ws[tag], *SETS, f"frontend.impl={impl}",
                            "frontend.precision=highest"])
        outs.append(np.load(out))
        assert text.strip() == f"{d / 'a.wav'}: embeddings (4, 16) -> {out}"
    assert outs[0].dtype == np.float32 and outs[0].shape == outs[1].shape == (4, 16)
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-4)


def test_embed_reads_the_loaded_weights(setup):
    """The port's embed equals the trunk of the model built from the npz."""
    d, ws = setup
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.data.audio_io import load_wav_16k
    from mla_tpu_torch.ops.frontend import apply_frontend
    from tests.torch_port_common import torch_model

    cfg = get_config("streaming_inference", {**SMALL, "frontend.impl": "pallas",
                                              "frontend.precision": "highest"})
    model = torch_model(cfg.model, convert.load_flat_npz(str(d / "w.npz")))
    with torch.inference_mode():
        want = model.embed(apply_frontend(torch.from_numpy(load_wav_16k(str(d / "a.wav")))[None],
                                          cfg.frontend))[0].numpy()
    np.testing.assert_array_equal(np.load(d / "t_pallas.npy"), want)


@pytest.mark.parametrize("wav", ["a.wav", "b22.wav"])
def test_extract_matches(setup, wav):
    d, _ = setup
    outs = []
    for tag, main in (("t", tmain), ("j", jmain)):
        out = d / f"x_{tag}_{wav}.npy"
        text = _call(main, ["extract", "--wav", str(d / wav), "--out", str(out)])
        outs.append(np.load(out))
        assert text.strip().endswith(f"patches {outs[-1].shape} -> {out}")
    assert outs[0].shape == outs[1].shape and outs[0].shape[1:] == (96, 64)
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=2e-4)


def test_configs_equal():
    assert _call(tmain, ["configs"], device=False) == _call(jmain, ["configs"])


@pytest.mark.parametrize("config,sets", [
    ("streaming_inference", []), ("us8k_fused_frontend", []),
    ("audioset_multi_level", []), ("streaming_inference", ["model.trunk=vggish"])],
    ids=["streaming", "us8k", "multi_level", "vggish"])
def test_summary_text_equal(config, sets):
    argv = ["summary", "--config", config] + (["--set", *sets] if sets else [])
    text = _call(tmain, argv, device=False)
    assert text == _call(jmain, argv)
    assert "TOTAL params" in text and "MB f32" in text
