"""Parity harness (counterpart of ``mla_tpu/parity.py``): an executable check
that the port reproduces the reference semantics on this device: the
front-end against the frozen VGGish golden, the model forward against the
golden outputs and the torch oracle, the metrics against sklearn.

    python -m mla_tpu_torch parity [--device cpu]   # one JSON line per check

The check names and bounds are the reference's, so the two outputs read side
by side. The goldens (``tests/golden/*.npz``) are only read here; a missing
one raises with its path. The checks run with TF32 off (the counterpart of
the reference pinning ``Precision.HIGHEST``) and restore the caller's flags.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

import numpy as np
import torch

from mla_tpu_torch._device import resolve_device, tf32_off

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
ORACLE_PATH = os.path.join(ROOT, "tests", "oracle", "model_oracle.py")
FRONTEND_BOUND = 2e-4
MODEL_BOUND = 1e-5
METRICS_BOUND = 1e-10


def golden_path(name: str) -> str:
    """Path of ``tests/golden/<name>``; raises if it is missing (the port
    never writes a golden)."""
    path = os.path.join(GOLDEN_DIR, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"golden file missing: {path} (the parity harness reads the "
                                "reference's goldens and does not regenerate them)")
    return path


def _result(check: str, err: float, bound: float) -> Dict:
    return {"check": check, "max_abs_err": err, "pass": err < bound}


def _frontend_golden(dev: torch.device):
    g = np.load(golden_path("frontend_golden.npz"))
    return torch.from_numpy(g["wav"]).to(dev), g["patches"]


def check_frontend(method: str = "matmul", device=None) -> Dict:
    """The torch-ops front-end (``method`` "matmul" or "fft") against the
    golden patches."""
    from mla_tpu_torch.config import FrontendConfig
    from mla_tpu_torch.ops.frontend import waveform_to_patches

    wav, want = _frontend_golden(resolve_device(device))
    with tf32_off():
        ours = waveform_to_patches(wav, FrontendConfig(), method=method).cpu().numpy()
    return _result(f"frontend_{method}", float(np.abs(ours - want).max()), FRONTEND_BOUND)


def check_frontend_pallas(device=None) -> Dict:
    """The fused front-end at "highest" against the golden patches: the
    hand-written kernel on the card, its plain version on the CPU."""
    from mla_tpu_torch.config import FrontendConfig
    from mla_tpu_torch.ops.fused_frontend import fused_log_mel_patches

    wav, want = _frontend_golden(resolve_device(device))
    with tf32_off():
        ours = fused_log_mel_patches(wav, FrontendConfig(), precision="highest").cpu().numpy()
    return _result("frontend_pallas", float(np.abs(ours - want).max()), FRONTEND_BOUND)


def _head_model(dev, variant: str, n_classes: int, n_blocks: int, layers: int, hidden: int,
                d: int, heads: int = 4):
    from mla_tpu_torch.config import ModelConfig
    from mla_tpu_torch.models.zoo import build_model

    cfg = ModelConfig(variant=variant, trunk="none", n_classes=n_classes, n_blocks=n_blocks,
                      layers_per_block=layers, hidden_units=hidden, embed_dim=d,
                      n_attention_heads=heads, compute_dtype="float32")
    return build_model(cfg, device=dev)


def _forward(model, x: np.ndarray, dev) -> np.ndarray:
    with tf32_off(), torch.no_grad():
        return model(torch.from_numpy(x).to(dev)).cpu().numpy()


def check_model(device=None) -> Dict:
    """The multi-level-attention forward against the golden outputs, with
    the golden's weights loaded by their flat names."""
    from mla_tpu_torch.models.convert import flat_to_state_dict

    dev = resolve_device(device)
    g = np.load(golden_path("model_golden.npz"))
    n_blocks, layers, hidden, d, c = (int(v) for v in g["meta"])
    model = _head_model(dev, "multi_level_attention", c, n_blocks, layers, hidden, d)
    flat = {f"params/{k}": g[k] for k in g.files
            if k not in ("x", "probs", "meta", "wav", "patches")}
    model.load_state_dict(flat_to_state_dict(flat, model))
    err = float(np.abs(_forward(model, g["x"], dev) - g["probs"]).max())
    return _result("model_multi_level_attention", err, MODEL_BOUND)


def _oracle():
    spec = importlib.util.spec_from_file_location("model_oracle", ORACLE_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_model_variant(variant: str, device=None) -> Dict:
    """A head variant against the torch oracle (``tests/oracle``), both from
    one weight tree: weights drawn from ``np.random.default_rng(7)`` in the
    oracle's layout (Dense kernels [in, out]), loaded into the port's model."""
    from mla_tpu_torch.models.convert import (flat_to_params, flat_to_state_dict,
                                              state_dict_to_flat)

    oracle = _oracle()
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    c, d, hidden, n_blocks, heads = 9, 64, 32, 2, 3
    model = _head_model(dev, variant, c, n_blocks, 1, hidden, d, heads)
    x = rng.standard_normal((2, 10, d)).astype(np.float32)
    shapes = state_dict_to_flat(model.state_dict())
    # kernels [in, out] at 1 / sqrt(in), biases at 0.1
    flat = {k: (rng.standard_normal(shapes[k].shape)
                / (np.sqrt(shapes[k].shape[0]) if shapes[k].ndim == 2 else 10.0)
                ).astype(np.float32) for k in sorted(shapes)}
    model.load_state_dict(flat_to_state_dict(flat, model))
    params = flat_to_params(flat)["params"]
    ours = _forward(model, x, dev)
    if variant == "single_attention":
        ref = oracle.single_attention_forward(params, x, n_blocks, 1)
    elif variant == "multi_attention":
        ref = oracle.multi_attention_forward(params, x, n_blocks, 1, heads)
    elif variant in ("avg_pool", "max_pool"):
        ref = oracle.avg_max_pool_forward(params, x, n_blocks, 1, variant[:3])
    else:
        raise ValueError(f"no oracle dispatch for {variant!r}")
    return _result(f"model_{variant}", float(np.abs(ours - ref).max()), MODEL_BOUND)


def check_metrics() -> Dict:
    """Per-class AP and AUC against sklearn's; skipped (pass null) where
    sklearn does not import."""
    try:
        from sklearn.metrics import average_precision_score, roc_auc_score
    except ImportError:
        return {"check": "metrics_vs_sklearn", "max_abs_err": None, "pass": None,
                "skipped": "sklearn not importable"}
    from mla_tpu_torch.utils.metrics import average_precision, roc_auc

    rng = np.random.default_rng(0)
    t = (rng.random((300, 8)) < 0.2).astype(np.float32)
    s = 0.6 * rng.random((300, 8)) + 0.4 * t
    ap_err = max(abs(average_precision(s, t)[j] - average_precision_score(t[:, j], s[:, j]))
                 for j in range(8) if t[:, j].sum())
    auc_err = max(abs(roc_auc(s, t)[j] - roc_auc_score(t[:, j], s[:, j])) for j in range(8))
    return _result("metrics_vs_sklearn", float(max(ap_err, auc_err)), METRICS_BOUND)


def run_all(device=None) -> List[Dict]:
    """Every check on ``device`` (None = the card; raises without one
    unless device="cpu")."""
    resolve_device(device)
    return [
        check_frontend("matmul", device),
        check_frontend("fft", device),
        check_frontend_pallas(device),
        check_model(device),
        *(check_model_variant(v, device)
          for v in ("single_attention", "multi_attention", "avg_pool", "max_pool")),
        check_metrics(),
    ]


def main(device=None) -> int:
    """Print one JSON line per check, then the skipped checks; 0 when every
    check that ran passed, else 1."""
    ok, skipped = True, []
    for r in run_all(device):
        print(json.dumps(r))
        if r["pass"] is None:
            skipped.append(f"{r['check']} ({r['skipped']})")
        else:
            ok &= r["pass"]
    if skipped:
        print(f"# skipped: {', '.join(skipped)}")
    return 0 if ok else 1
