"""Plain PyTorch reference of the model the benchmark's configurations
describe (Yu et al., arXiv:1803.02353 §2, with the CompactCNN trunk over
VGGish log-mel patches): the log-mel front-end, the convolutional trunk with
batch norm, the embedded mapping blocks, multi-level attention pooling, the
clip tail, the binary cross-entropy loss and Adam.

It is written from the configuration's numbers and the published
definitions, in float32 with TF32 off, with no kernel, cache or batching of
the program's. It imports torch and numpy only. Weights and inputs come
from the benchmark, which hands the same to the program.

``prec="fp8"`` is the control: every convolution's and product's operands
rounded to float8 e4m3 (per-tensor scale) and every gradient that flows into
them to e5m2, the precision below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5  # batch norm's epsilon
POOL_EPS = 1e-7  # floor of the attention pool's denominator
BCE_CLIP = 1e-7  # the loss clips probabilities to [1e-7, 1 - 1e-7]
ADAM = {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8}
_RUNNING = ("running_mean", "running_var")


# --- layout ---------------------------------------------------------------

def param_shapes(m: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every weight and batch-norm statistic, under the
    model's flat layout names."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    cin = 1
    for s, ch in enumerate(m["conv_channels"]):
        for i in range(m["convs_per_stage"]):
            shapes[f"trunk_module.conv{s}_{i}.weight"] = (ch, cin, 3, 3)
            for k in ("weight", "bias") + _RUNNING:
                shapes[f"trunk_module.bn{s}_{i}.{k}"] = (ch,)
            cin = ch
    shapes["trunk_module.embed.weight"] = (m["embed_dim"], cin)
    shapes["trunk_module.embed.bias"] = (m["embed_dim"],)
    d, h, c = m["embed_dim"], m["hidden_units"], m["n_classes"]
    for b in range(m["n_blocks"]):
        for j in range(m["layers_per_block"]):
            shapes[f"block{b}.fc{j}.weight"] = (h, d if b == 0 and j == 0 else h)
            shapes[f"block{b}.fc{j}.bias"] = (h,)
    for b in range(m["n_blocks"]):
        for k in ("gate", "cla"):
            shapes[f"att{b}.{k}.weight"] = (c, h)
            shapes[f"att{b}.{k}.bias"] = (c,)
    shapes["out.weight"] = (c, m["n_blocks"] * c)
    shapes["out.bias"] = (c,)
    return shapes


def is_trainable(name: str) -> bool:
    return not name.endswith(_RUNNING)


@contextlib.contextmanager
def exact_f32():
    """f32 products and convolutions in full f32 (no TF32) inside."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


# --- the control's rounding ------------------------------------------------

def _round_fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """t rounded to ``dtype`` (a float8 type) under one per-tensor scale that
    maps its largest magnitude to the type's largest, back in f32."""
    top = torch.finfo(dtype).max
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (t.float() * scale).to(dtype).float() / scale


class _GradFp8(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


def _operand(t: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return t
    q = _round_fp8(t, torch.float8_e4m3fn)
    return t + (q - t).detach()  # the rounded value, the gradient passed straight on


def _product_out(y: torch.Tensor, prec: str) -> torch.Tensor:
    return y if prec == "f32" or not y.requires_grad else _GradFp8.apply(y)


def conv3x3(x, w, prec: str):
    return _product_out(F.conv2d(_operand(x, prec), _operand(w, prec), padding=1), prec)


def linear(x, w, b, prec: str):
    return _product_out(F.linear(_operand(x, prec), _operand(w, prec), b), prec)


# --- front-end -------------------------------------------------------------

def _hz_to_mel(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz, np.float64) / 700.0)


def geometry(fe: Mapping) -> dict:
    sr = fe["sample_rate"]
    window = int(round(sr * fe["stft_window_seconds"]))
    fft = 1 << (window - 1).bit_length()
    return {"window": window, "hop": int(round(sr * fe["stft_hop_seconds"])), "fft": fft,
            "patch": int(round(fe["example_window_seconds"] / fe["stft_hop_seconds"]))}


def mel_matrix(fe: Mapping) -> np.ndarray:
    """[fft/2 + 1, n_mel] HTK triangular filters from mel_min_hz to
    mel_max_hz, the DC row zero (VGGish's ``spectrogram_to_mel_matrix``)."""
    g = geometry(fe)
    n_spec = g["fft"] // 2 + 1
    bins = _hz_to_mel(np.linspace(0.0, fe["sample_rate"] / 2.0, n_spec))
    edges = np.linspace(_hz_to_mel(fe["mel_min_hz"]), _hz_to_mel(fe["mel_max_hz"]),
                        fe["num_mel_bins"] + 2)
    w = np.empty((n_spec, fe["num_mel_bins"]))
    for i in range(fe["num_mel_bins"]):
        lo, mid, hi = edges[i: i + 3]
        w[:, i] = np.maximum(0.0, np.minimum((bins - lo) / (mid - lo), (hi - bins) / (hi - mid)))
    w[0] = 0.0
    return w.astype(np.float32)


def log_mel_patches(wav: torch.Tensor, fe: Mapping, prec: str = "f32") -> torch.Tensor:
    """Waveform [B, n] -> log-mel patches [B, N, frames, n_mel]: periodic
    Hann frames, |rfft| at the next power of two, mel filters, log(mel +
    log_offset), whole non-overlapping patches. The control takes the DFT
    as products of e4m3-rounded frames and bases."""
    g = geometry(fe)
    frames = wav.float().unfold(-1, g["window"], g["hop"])  # [B, F, window]
    n = torch.arange(g["window"], dtype=torch.float64, device=wav.device)
    hann = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / g["window"])
    mel = torch.from_numpy(mel_matrix(fe)).to(wav.device)
    if prec == "f32":
        mag = torch.fft.rfft(frames * hann.float(), n=g["fft"], dim=-1).abs()
        spec = mag @ mel
    else:
        k = torch.arange(g["fft"] // 2 + 1, dtype=torch.float64, device=wav.device)
        ang = 2.0 * math.pi * n[:, None] * k[None, :] / g["fft"]
        cos_b = (torch.cos(ang) * hann[:, None]).float()
        sin_b = (-torch.sin(ang) * hann[:, None]).float()
        fq = _operand(frames, prec)
        re, im = fq @ _operand(cos_b, prec), fq @ _operand(sin_b, prec)
        spec = _operand(torch.sqrt(re * re + im * im), prec) @ _operand(mel, prec)
    log_mel = torch.log(spec + fe["log_offset"])
    p = g["patch"]
    n_patch = (log_mel.shape[-2] - p) // p + 1
    lm = log_mel[:, : n_patch * p]
    return lm.reshape(lm.shape[0], n_patch, p, lm.shape[-1])


# --- model -----------------------------------------------------------------

def _batch_norm(x, p, key: str, train: bool):
    if train:  # the batch's mean and biased variance over (N, H, W)
        return F.batch_norm(x, None, None, p[f"{key}.weight"], p[f"{key}.bias"], training=True,
                            eps=BN_EPS)
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(p[f"{key}.running_var"] + BN_EPS) * p[f"{key}.weight"]
    mean, bias = p[f"{key}.running_mean"].view(shape), p[f"{key}.bias"].view(shape)
    return (x - mean) * inv.view(shape) + bias


def trunk(patches: torch.Tensor, p: Mapping, m: Mapping, train: bool, prec: str = "f32"):
    """[P, frames, n_mel] patches -> [P, embed_dim] segment embeddings."""
    x = patches[:, None].float()
    for s in range(len(m["conv_channels"])):
        for i in range(m["convs_per_stage"]):
            x = conv3x3(x, p[f"trunk_module.conv{s}_{i}.weight"], prec)
            x = torch.relu(_batch_norm(x, p, f"trunk_module.bn{s}_{i}", train))
        if min(x.shape[2], x.shape[3]) >= 2:
            x = F.max_pool2d(x, 2, 2)
    x = x.mean(dim=(2, 3))
    return torch.relu(linear(x, p["trunk_module.embed.weight"], p["trunk_module.embed.bias"], prec))


def attention_pool(gate: torch.Tensor, cla: torch.Tensor) -> torch.Tensor:
    """[..., T, C] gate and classifier logits -> [..., C]: sigmoid class
    scores averaged over time under softmax-over-time weights."""
    w = torch.softmax(gate, dim=-2)
    return (w * torch.sigmoid(cla)).sum(-2) / w.sum(-2).clamp_min(POOL_EPS)


def level_logits(emb: torch.Tensor, p: Mapping, m: Mapping, masks=None, prec: str = "f32"):
    """[B, T, D] embeddings -> per level (gate, cla) logits, each [B, T, C].
    ``masks`` (train mode) holds one keep mask per block layer."""
    h, out, k = emb, [], 0
    keep = 1.0 - m["dropout_rate"]
    for b in range(m["n_blocks"]):
        for j in range(m["layers_per_block"]):
            h = torch.relu(linear(h, p[f"block{b}.fc{j}.weight"], p[f"block{b}.fc{j}.bias"], prec))
            if masks is not None:
                h = torch.where(masks[k], h / keep, torch.zeros_like(h))
                k += 1
        out.append((linear(h, p[f"att{b}.gate.weight"], p[f"att{b}.gate.bias"], prec),
                    linear(h, p[f"att{b}.cla.weight"], p[f"att{b}.cla.bias"], prec)))
    return out


def tail(pooled: Sequence[torch.Tensor], p: Mapping, prec: str = "f32") -> torch.Tensor:
    return torch.sigmoid(linear(torch.cat(list(pooled), -1), p["out.weight"], p["out.bias"], prec))


def forward(patches: torch.Tensor, p: Mapping, m: Mapping, train: bool = False, masks=None,
            prec: str = "f32") -> torch.Tensor:
    """[B, T, frames, n_mel] patches -> [B, C] clip probabilities."""
    b, t = patches.shape[:2]
    emb = trunk(patches.reshape(b * t, *patches.shape[2:]), p, m, train, prec).reshape(b, t, -1)
    return tail([attention_pool(g, c) for g, c in level_logits(emb, p, m, masks, prec)], p, prec)


def bce(probs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    q = probs.clamp(BCE_CLIP, 1.0 - BCE_CLIP)
    return -torch.mean(y * torch.log(q) + (1.0 - y) * torch.log1p(-q))


def dropout_masks(train_seed: int, step: int, shape, n: int, rate: float, device) -> List:
    """The configuration's dropout rule: the masks of update ``step`` are
    drawn from a device generator seeded by SeedSequence([train_seed, step]),
    uniform draws in the order of the block layers, kept below 1 - rate."""
    mixed = int(np.random.SeedSequence([train_seed, step]).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=device).manual_seed(mixed)
    return [torch.rand(shape, generator=g, device=device) < 1.0 - rate for _ in range(n)]


# --- what the benchmark compares ---------------------------------------------

@torch.no_grad()
def tag(wav: torch.Tensor, p: Mapping, m: Mapping, fe: Mapping, prec: str = "f32",
        block: int = 32) -> torch.Tensor:
    """[B, n] waveforms -> [B, C] probabilities in eval mode, ``block`` clips
    at a time."""
    with exact_f32():
        return torch.cat([forward(log_mel_patches(wav[i: i + block], fe, prec), p, m, prec=prec)
                          for i in range(0, wav.shape[0], block)])


@torch.no_grad()
def stream_scores(wav: torch.Tensor, n_chunks: int, chunk_patches: int, p: Mapping, m: Mapping,
                  fe: Mapping, prec: str = "f32", block: int = 16) -> torch.Tensor:
    """[S, n] audio of S streams -> [S, n_chunks, C]: the clip scores after
    each stream's first k chunks of ``chunk_patches`` patches (k = 1 ..
    n_chunks), i.e. the attention pool over its first k * chunk_patches
    patches, in eval mode, ``block`` streams at a time."""
    out = []
    with exact_f32():
        for i in range(0, wav.shape[0], block):
            patches = log_mel_patches(wav[i: i + block], fe, prec)[:, : n_chunks * chunk_patches]
            b, t = patches.shape[:2]
            emb = trunk(patches.reshape(b * t, *patches.shape[2:]), p, m, False, prec)
            levels = level_logits(emb.reshape(b, t, -1), p, m, prec=prec)
            out.append(torch.stack([
                tail([attention_pool(g[:, : k * chunk_patches], c[:, : k * chunk_patches])
                      for g, c in levels], p, prec) for k in range(1, n_chunks + 1)], 1))
    return torch.cat(out)


def train_steps(params0: Mapping[str, torch.Tensor], batches, m: Mapping, fe: Mapping,
                train_cfg: Mapping, train_seed: int, prec: str = "f32",
                half: bool = False) -> dict:
    """Adam updates from ``params0`` over ``batches`` [(wav [B, n], y [B, C])]:
    the front-end at the step's precision outside autograd, the train-mode
    forward with dropout, the loss, its gradients and the update. ``half``
    plants a fault: each step sees only the first half of its batch. Returns
    each step's loss, every trainable leaf's first gradient norm and its
    change after the last step."""
    names = [k for k in params0 if is_trainable(k)]
    p = {k: v.detach().clone() for k, v in params0.items()}
    for k in names:
        p[k].requires_grad_(True)
    mom = {k: torch.zeros_like(p[k]) for k in names}
    vel = {k: torch.zeros_like(p[k]) for k in names}
    b1, b2, eps, lr = ADAM["beta1"], ADAM["beta2"], ADAM["eps"], train_cfg["learning_rate"]
    losses, grad_norms = [], {}
    with exact_f32():
        for t, (x, y) in enumerate(batches):
            if half:
                x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
            with torch.no_grad():
                patches = log_mel_patches(x, fe, prec)
            masks = dropout_masks(train_seed, t, (x.shape[0], patches.shape[1], m["hidden_units"]),
                                  m["n_blocks"] * m["layers_per_block"], m["dropout_rate"],
                                  x.device)
            loss = bce(forward(patches, p, m, True, masks, prec), y.float())
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            del patches
            with torch.no_grad():
                for k, g in zip(names, grads):
                    if t == 0:
                        grad_norms[k] = float(g.norm())
                    mom[k].mul_(b1).add_(g, alpha=1 - b1)
                    vel[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = mom[k] / (1 - b1 ** (t + 1))
                    vhat = vel[k] / (1 - b2 ** (t + 1))
                    p[k].sub_(lr * mhat / (vhat.sqrt() + eps))
            losses.append(float(loss.detach()))
            del grads, loss
    change = {k: float((p[k].detach() - params0[k]).norm()) for k in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
