"""Timeline figure (own copy of ``mla_tpu/utils/plot.py``): the attention-curve
analysis of arXiv:1803.02353 Fig. 2 (per-class attention weights over clip
time) as ``infer --wav a.wav --plot out.png``.

Stacked panels share a seconds axis: an optional log-mel spectrogram
(sequential colormap), the per-class probabilities f(h_t), and the
attention gate weights v(h_t) that pool them. Matplotlib (Agg, headless) is
imported inside ``plot_timeline``: nothing else in the package needs it,
and a host without it fails only when --plot is used.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# Okabe & Ito (2008) colorblind-safe palette in a fixed assignment order
# (identity follows the rank-ordered class list; the order never cycles)
CATEGORICAL = ("#0072B2", "#D55E00", "#009E73", "#CC79A7", "#E69F00")
_INK = "#333333"       # text/axes wear neutral ink, never a series color
_GRID = dict(alpha=0.25, linewidth=0.5)


def _style_axis(ax):
    ax.grid(True, **_GRID)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_INK)
    ax.tick_params(colors=_INK, labelsize=8)


def plot_timeline(
    out_path: str,
    hop_s: float,
    names: Sequence[str],
    probs: np.ndarray,
    gates: np.ndarray,
    start_patch: int = 0,
    mel: Optional[np.ndarray] = None,
    mel_hop_s: Optional[float] = None,
    title: Optional[str] = None,
) -> str:
    """Write the figure; returns ``out_path``.

    probs/gates: [T, C] per-patch classifier outputs f and attention
    weights v for the C plotted classes (already selected/top-k by the
    caller; at most ``len(CATEGORICAL)`` series are drawn — identity must
    stay resolvable without color vision tricks). gates follow the
    streaming-ring convention: weights sum to <= 1 over patches (< 1 when
    the ring dropped mass). mel: optional [frames, bins] log-mel to draw
    under the curves, with ``mel_hop_s`` seconds per frame.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    probs = np.asarray(probs)
    gates = np.asarray(gates)
    if probs.ndim != 2 or probs.shape != gates.shape:
        raise ValueError(f"probs/gates must both be [T, C], got "
                         f"{probs.shape} vs {gates.shape}")
    k = min(probs.shape[1], len(CATEGORICAL))
    names = list(names)[:k]
    probs, gates = probs[:, :k], gates[:, :k]

    n_panels = 2 + (mel is not None)
    fig, axes = plt.subplots(
        n_panels, 1, sharex=True, figsize=(10, 2.1 * n_panels), dpi=150)
    axes = np.atleast_1d(axes)
    t = (start_patch + np.arange(probs.shape[0]) + 0.5) * hop_s

    row = 0
    if mel is not None:
        if mel_hop_s is None:
            raise ValueError("mel requires mel_hop_s")
        ax = axes[row]
        row += 1
        # sequential job -> one perceptually-uniform ramp, light->dark
        ax.imshow(np.asarray(mel).T, origin="lower", aspect="auto",
                  cmap="magma",
                  extent=(0.0, mel.shape[0] * mel_hop_s, 0, mel.shape[1]))
        ax.set_ylabel("mel bin", color=_INK, fontsize=9)
        ax.grid(False)
        ax.tick_params(colors=_INK, labelsize=8)

    for ax, data, ylab in ((axes[row], probs, "P(class | patch)"),
                           (axes[row + 1], gates, "attention weight")):
        for i in range(k):
            ax.plot(t, data[:, i], color=CATEGORICAL[i], linewidth=1.8,
                    label=names[i])
        ax.set_ylabel(ylab, color=_INK, fontsize=9)
        ax.set_ylim(bottom=0.0)
        _style_axis(ax)
    # legend always present (it also names a single series)
    axes[row].legend(loc="upper right", fontsize=8, frameon=False,
                     labelcolor=_INK)
    axes[-1].set_xlabel("seconds", color=_INK, fontsize=9)
    axes[-1].set_xlim(left=0.0 if mel is not None else float(t[0] - hop_s))
    if title:
        fig.suptitle(title, fontsize=10, color=_INK)
    fig.tight_layout()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def continuous_mel(patches: np.ndarray, frontend_cfg) -> Optional[np.ndarray]:
    """[T, frames, bins] patches -> one [T*frames, bins] spectrogram, valid
    only when patches tile the clip without overlap (the VGGish default:
    example_hop == example_window). Returns None when they don't — a
    concatenation of overlapping patches would repeat time slices."""
    if abs(frontend_cfg.example_hop_seconds
           - frontend_cfg.example_window_seconds) > 1e-9:
        return None
    p = np.asarray(patches)
    return p.reshape(p.shape[0] * p.shape[1], p.shape[2])
