"""Attention pooling over time and its O(1) streaming state, in torch
(counterpart of ``mla_tpu/ops/attention_pool.py``; arXiv:1803.02353 §2).

Clip scores from per-segment gate logits a and classifier logits z:

    y_c = sum_t act(a_t)_c * cla(z_t)_c / sum_t act(a_t)_c

With act = exp this is softmax-over-time attention. Streaming keeps the
ratio's two sums as running accumulators, renormalized online-softmax style
for the exp gate, so any length of audio folds into O(1) state. Masked
segments carry gate logits of -inf and add nothing under every gate. The
``max`` mode is the max-pool baseline's running maximum.

The timeline ring and the cross-device merge are not ported yet
(ROADMAP.md queue A).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

_EPS = 1e-7


def gate_activation(logits: torch.Tensor, kind: str) -> torch.Tensor:
    """Non-negative gate activation act(a). For ``exp`` the caller subtracts
    a per-clip max first (as :func:`attention_pool` does)."""
    if kind == "exp":
        return torch.exp(logits)
    if kind == "sigmoid":
        return torch.sigmoid(logits)
    if kind == "relu":
        return torch.relu(logits)
    if kind == "softplus":
        return F.softplus(logits)
    raise ValueError(f"unknown att_activation {kind!r}")


def cla_activation(logits: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "sigmoid":
        return torch.sigmoid(logits)
    if kind == "linear":
        return logits
    raise ValueError(f"unknown cla_activation {kind!r}")


def attention_pool(
    gate_logits: torch.Tensor,
    cla_logits: torch.Tensor,
    att_activation: str = "exp",
    cla_act: str = "sigmoid",
    time_axis: int = -2,
) -> torch.Tensor:
    """Pool [..., T, C] gate/classifier logits into [..., C] clip scores
    (per-clip max subtracted for the exp gate: the ratio is shift-invariant)."""
    if att_activation == "exp":
        m = torch.amax(gate_logits, dim=time_axis, keepdim=True).detach()
        att = torch.exp(gate_logits - m)
    else:
        att = gate_activation(gate_logits, att_activation)
    f = cla_activation(cla_logits, cla_act)
    num = torch.sum(att * f, dim=time_axis)
    den = torch.sum(att, dim=time_axis)
    return num / torch.clamp(den, min=_EPS)


def attention_timeline(
    gate_logits: torch.Tensor,
    cla_logits: torch.Tensor,
    att_activation: str = "exp",
    cla_act: str = "sigmoid",
    time_axis: int = -2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment readout ``(weights, seg_probs)``, both [..., T, C]:
    weights normalized over T per class (the argmax indicator, split across
    ties, for the ``max`` gate), so sum_t weights * seg_probs equals
    :func:`attention_pool`."""
    f = cla_activation(cla_logits, cla_act)
    if att_activation == "max":
        valid = torch.isfinite(gate_logits)
        fv = torch.where(valid, f, -torch.inf)
        m = torch.amax(fv, dim=time_axis, keepdim=True)
        att = ((fv >= m) & valid).to(f.dtype)
    elif att_activation == "exp":
        m = torch.amax(gate_logits, dim=time_axis, keepdim=True)
        att = torch.exp(gate_logits - torch.where(torch.isfinite(m), m, 0.0))
    else:
        att = gate_activation(gate_logits, att_activation)
    w = att / torch.clamp(torch.sum(att, dim=time_axis, keepdim=True), min=_EPS)
    return w, f


class StreamState(NamedTuple):
    """O(1) per-clip streaming state. With m the running max of gate logits,
    num = sum_t exp(a_t - m) f_t and den = sum_t exp(a_t - m); for the other
    gates m stays -inf and the accumulators are plain sums."""

    num: torch.Tensor  # [..., C]
    den: torch.Tensor  # [..., C]
    m: torch.Tensor  # [..., C] running gate-logit max (exp gate only)


def init_stream_state(shape: Tuple[int, ...], dtype=torch.float32, device=None) -> StreamState:
    return StreamState(
        num=torch.zeros(shape, dtype=dtype, device=device),
        den=torch.zeros(shape, dtype=dtype, device=device),
        m=torch.full(shape, -torch.inf, dtype=dtype, device=device),
    )


def update_stream_state(
    state: StreamState,
    gate_logits: torch.Tensor,
    cla_logits: torch.Tensor,
    att_activation: str = "exp",
    cla_act: str = "sigmoid",
    time_axis: int = -2,
) -> StreamState:
    """Fold one chunk of [..., T_chunk, C] logits into the running state."""
    f = cla_activation(cla_logits, cla_act)
    if att_activation == "max":
        # gate logits only mark validity (-inf = masked)
        valid = torch.isfinite(gate_logits)
        chunk_max = torch.amax(torch.where(valid, f, -torch.inf), dim=time_axis)
        seen = torch.any(valid, dim=time_axis).to(state.den.dtype)
        return StreamState(
            num=torch.maximum(state.num, torch.where(torch.isfinite(chunk_max),
                                                     chunk_max, state.num)),
            den=torch.maximum(state.den, seen),
            m=state.m,
        )
    if att_activation == "exp":
        new_m = torch.maximum(state.m, torch.amax(gate_logits, dim=time_axis))
        # an all-masked chunk leaves new_m = -inf: subtract 0 there so
        # exp(-inf - 0) = 0 instead of exp(-inf + inf) = nan
        safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
        att = torch.exp(gate_logits - safe_m.unsqueeze(time_axis))
        scale = torch.where(torch.isfinite(state.m), torch.exp(state.m - safe_m), 0.0)
        return StreamState(
            num=state.num * scale + torch.sum(att * f, dim=time_axis),
            den=state.den * scale + torch.sum(att, dim=time_axis),
            m=new_m,
        )
    att = gate_activation(gate_logits, att_activation)
    return StreamState(
        num=state.num + torch.sum(att * f, dim=time_axis),
        den=state.den + torch.sum(att, dim=time_axis),
        m=state.m,
    )


def merge_stream_states(a: StreamState, b: StreamState, att_activation: str = "exp") -> StreamState:
    """Associatively merge two partial states (chunk tree)."""
    if att_activation == "max":
        return StreamState(torch.maximum(a.num, b.num), torch.maximum(a.den, b.den), a.m)
    if att_activation == "exp":
        new_m = torch.maximum(a.m, b.m)
        sa = torch.where(torch.isfinite(a.m), torch.exp(a.m - new_m), 0.0)
        sb = torch.where(torch.isfinite(b.m), torch.exp(b.m - new_m), 0.0)
        return StreamState(a.num * sa + b.num * sb, a.den * sa + b.den * sb, new_m)
    return StreamState(a.num + b.num, a.den + b.den, a.m)


def stream_finalize(state: StreamState) -> torch.Tensor:
    """Running state -> clip scores; equal to whole-clip attention_pool."""
    return state.num / torch.clamp(state.den, min=_EPS)
