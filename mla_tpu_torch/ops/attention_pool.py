"""Attention pooling over time and its O(1) streaming state, in torch
(counterpart of ``mla_tpu/ops/attention_pool.py``; arXiv:1803.02353 §2).

Clip scores from per-segment gate logits a and classifier logits z:

    y_c = sum_t act(a_t)_c * cla(z_t)_c / sum_t act(a_t)_c

With act = exp this is softmax-over-time attention. Streaming keeps the
ratio's two sums as running accumulators, renormalized online-softmax style
for the exp gate, so any length of audio folds into O(1) state. Masked
segments carry gate logits of -inf and add nothing under every gate. The
``max`` mode is the max-pool baseline's running maximum.

The timeline ring (``TimelineState``) keeps the last ``cap`` patches' gate
logits and segment probabilities per stream on the device, written beside
the fold; ``read_timeline`` turns one stream's window into per-patch
weights with one device-to-host copy. Partial states of one clip's time
shards combine exactly: ``combine_stream_states`` over a single-process
mesh's list of shard states, ``psum_stream_state`` over a process group
(the global maximum first, then the rescaled sums).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist
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
    """Associatively merge two partial states (chunk tree or time shards)."""
    if att_activation == "max":
        return StreamState(torch.maximum(a.num, b.num), torch.maximum(a.den, b.den), a.m)
    if att_activation == "exp":
        new_m = torch.maximum(a.m, b.m)
        sa = torch.where(torch.isfinite(a.m), torch.exp(a.m - new_m), 0.0)
        sb = torch.where(torch.isfinite(b.m), torch.exp(b.m - new_m), 0.0)
        return StreamState(a.num * sa + b.num * sb, a.den * sa + b.den * sb, new_m)
    return StreamState(a.num + b.num, a.den + b.den, a.m)


def combine_stream_states(states, att_activation: str = "exp", device=None) -> StreamState:
    """Combine the partial states of one clip's time shards, each a
    ``StreamState`` on its own device (a single-process mesh), into one on
    ``device`` (None: the first state's): the arithmetic of
    :func:`psum_stream_state` (for the exp gate the global maximum first,
    then each shard's sums rescaled to it and added)."""
    dev = states[0].num.device if device is None else torch.device(device)
    parts = [StreamState(*(t.to(dev) for t in st)) for st in states]

    def stack(i):
        return torch.stack([st[i] for st in parts])

    num, den, m = stack(0), stack(1), stack(2)
    if att_activation == "max":
        return StreamState(num.amax(0), den.amax(0), parts[0].m)
    if att_activation == "exp":
        global_m = m.amax(0)
        scale = torch.where(torch.isfinite(m), torch.exp(m - global_m), 0.0)
        return StreamState((num * scale).sum(0), (den * scale).sum(0), global_m)
    return StreamState(num.sum(0), den.sum(0), parts[0].m)


def psum_stream_state(state: StreamState, group=None, att_activation: str = "exp") -> StreamState:
    """Combine time-sharded partial states across the ranks of ``group``
    (None: the default process group): the reference's pmax / psum as
    ``all_reduce`` MAX / SUM. Every rank gets the same combined state."""
    def reduce(t, op):
        t = t.clone()
        dist.all_reduce(t, op=op, group=group)
        return t

    if att_activation == "max":
        return StreamState(reduce(state.num, dist.ReduceOp.MAX),
                           reduce(state.den, dist.ReduceOp.MAX), state.m)
    if att_activation == "exp":
        global_m = reduce(state.m, dist.ReduceOp.MAX)
        scale = torch.where(torch.isfinite(state.m), torch.exp(state.m - global_m), 0.0)
        return StreamState(reduce(state.num * scale, dist.ReduceOp.SUM),
                           reduce(state.den * scale, dist.ReduceOp.SUM), global_m)
    return StreamState(reduce(state.num, dist.ReduceOp.SUM),
                       reduce(state.den, dist.ReduceOp.SUM), state.m)


def stream_finalize(state: StreamState) -> torch.Tensor:
    """Running state -> clip scores; equal to whole-clip attention_pool."""
    return state.num / torch.clamp(state.den, min=_EPS)


class TimelineState(NamedTuple):
    """O(cap) per-stream localization ring: the last ``cap`` patches' raw
    gate logits and segment probabilities per level, on the device. The
    update returns new tensors, so a (states, tl) pair read out later is a
    snapshot that no later tick overwrites."""

    g: torch.Tensor  # [S, cap, L, C] raw gate logits of the last cap patches
    f: torch.Tensor  # [S, cap, L, C] segment probabilities (post-activation)
    cursor: torch.Tensor  # [S] int32 next ring slot to write
    count: torch.Tensor  # [S] int32 valid patches ever folded


def init_timeline_state(n_streams: int, cap: int, n_levels: int, n_classes: int,
                        dtype=torch.float32, device=None) -> TimelineState:
    ring = (n_streams, cap, n_levels, n_classes)
    return TimelineState(
        g=torch.zeros(ring, dtype=dtype, device=device),
        f=torch.zeros(ring, dtype=dtype, device=device),
        cursor=torch.zeros(n_streams, dtype=torch.int32, device=device),
        count=torch.zeros(n_streams, dtype=torch.int32, device=device),
    )


def update_timeline_state(
    tl: TimelineState,
    gate_stack: torch.Tensor,  # [S, P, L, C] raw gate logits of this chunk
    prob_stack: torch.Tensor,  # [S, P, L, C] segment probabilities
    active: torch.Tensor,  # [S] bool
    n_valid: torch.Tensor,  # [S] int valid patches (<= P; a flush pads)
) -> TimelineState:
    """Fold one chunk's per-patch readout into the ring. The write is masked
    per (stream, patch): an inactive row or a padded flush patch keeps the
    slot's old content (an unconditional write would clobber good entries
    once the ring has wrapped). Needs P <= cap, so a chunk's slots are
    distinct."""
    s, p = gate_stack.shape[:2]
    cap = tl.g.shape[1]
    dev = gate_stack.device
    s_idx = torch.arange(s, device=dev)[:, None]  # [S, 1]
    p_idx = torch.arange(p, device=dev)[None, :]  # [1, P]
    idx = (tl.cursor[:, None] + p_idx) % cap  # [S, P]
    valid = (active[:, None] & (p_idx < n_valid[:, None]))[..., None, None]
    g = tl.g.index_put((s_idx, idx), torch.where(valid, gate_stack, tl.g[s_idx, idx]))
    f = tl.f.index_put((s_idx, idx), torch.where(valid, prob_stack, tl.f[s_idx, idx]))
    adv = torch.where(active, n_valid, 0).to(torch.int32)
    return TimelineState(g=g, f=f, cursor=(tl.cursor + adv) % cap, count=tl.count + adv)


def window_timeline(gate_window, prob_window, num, den, m, att_activation: str = "exp"):
    """Final per-patch weights for a recorded window of gate logits,
    normalized against the stream's final ``StreamState`` row (num, den, m),
    in host numpy. For the exp gate the weights are globally exact,
    w_t = exp(g_t - m) / den: once the ring has dropped old patches they sum
    to the share of attention mass the window covers. For the max gate they
    mark the window's copies of the global maximum, split across ties.
    Returns ``(weights, prob_window)``, both [T, C] float32."""
    g = np.asarray(gate_window, np.float32)
    f = np.asarray(prob_window, np.float32)
    num = np.asarray(num, np.float32)
    den = np.asarray(den, np.float32)
    m = np.asarray(m, np.float32)
    if att_activation == "max":
        winners = (f >= num) & np.isfinite(g)
        w = winners / np.maximum(winners.sum(axis=0, keepdims=True), 1)
        return w.astype(np.float32), f
    if att_activation == "exp":
        att = np.exp(g - np.where(np.isfinite(m), m, 0.0)[None, :])
    elif att_activation == "sigmoid":
        att = 1.0 / (1.0 + np.exp(-g))
    elif att_activation == "relu":
        att = np.maximum(g, 0.0)
    elif att_activation == "softplus":
        att = np.logaddexp(g, 0.0)
    else:
        raise ValueError(f"unknown att_activation {att_activation!r}")
    return (att / np.maximum(den[None, :], _EPS)).astype(np.float32), f


def _pack_timeline(tl: TimelineState, states, sid: int, extra=None) -> torch.Tensor:
    """Everything one stream's readout needs, gathered on the device into
    one f32 tensor: the optional ``extra`` row first, the ring rows, each
    level's (num, den, m), and last (cursor, count) as int32 bits in two
    f32 lanes."""
    parts = [] if extra is None else [extra.to(torch.float32).reshape(-1)]
    parts += [tl.g[sid].to(torch.float32).reshape(-1), tl.f[sid].to(torch.float32).reshape(-1)]
    parts += [torch.stack([st.num[sid], st.den[sid], st.m[sid]]).to(torch.float32).reshape(-1)
              for st in states]
    ints = torch.stack([tl.cursor[sid], tl.count[sid]]).to(torch.int32)
    parts.append(ints.view(torch.float32))
    return torch.cat(parts)


def read_timeline(states, tl, sid: int, att_activation: str, extra=None):
    """One stream's window against its final accumulator state:
    ``(start_patch, [(weights [T, C], probs [T, C]) per level])``, oldest
    patch first, weights by :func:`window_timeline`, in one device-to-host
    copy. ``extra``, a 1-D tensor on the same device (the clip scores),
    rides the same copy; then the result is ``(start_patch, levels,
    extra_values)``."""
    if tl is None:
        raise RuntimeError("timeline disabled; construct with timeline_cap > 0")
    blob = _pack_timeline(tl, states, sid, extra).cpu().numpy()
    k = 0 if extra is None else int(extra.shape[-1])
    cur, cnt = (int(v) for v in blob[-2:].view(np.int32))
    cap, n_levels, c = tl.g.shape[1:]
    ring = cap * n_levels * c
    g = blob[k: k + ring].reshape(cap, n_levels, c)
    f = blob[k + ring: k + 2 * ring].reshape(cap, n_levels, c)
    st = blob[k + 2 * ring: -2].reshape(n_levels, 3, c)  # [L, (num, den, m), C]
    n = min(cnt, cap)
    idx = (cur - n + np.arange(n)) % cap  # oldest -> newest
    levels = [window_timeline(g[idx, li], f[idx, li], st[li, 0], st[li, 1], st[li, 2],
                              att_activation)
              for li in range(n_levels)]
    if extra is None:
        return cnt - n, levels
    return cnt - n, levels, blob[:k].copy()
