"""Train state and the train / eval step functions (counterpart of
``mla_tpu/train/state.py``).

One train step: decode the staged wire form -> front-end (outside autograd;
``impl="pallas"`` launches the fused kernel) -> mixup, then SpecAugment on
waveform or patch input (``ops/augment.py``), when the config asks ->
train-mode forward (batch statistics, dropout) -> BCE -> backward -> global-norm clip -> Adam at the
scheduled learning rate -> EMA. PyTorch updates in place, so the step
mutates the ``TrainState`` it is given and returns it with the loss. While
tracing, the step is a ``mla.train.step`` span (``step``) over its phases
``mla.train.frontend``, ``.forward``, ``.backward`` (data parallel, with
the gradients' mean over the ranks) and ``.optimizer``, each with the
card's time.

The optimizer reproduces the reference's optax chain: Adam with beta
0.9 / 0.999 and eps 1e-8 computes lr * m_hat / (sqrt(v_hat) + eps) with the
same bias corrections in both libraries; the learning-rate schedules and the
clipping rule are own copies of optax's, since ``torch.optim.lr_scheduler``
and ``clip_grad_norm_`` (which adds 1e-6 to the norm) differ from them.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mla_tpu_torch.config import Config
from mla_tpu_torch.data.adpcm import DEFAULT_BLOCK
from mla_tpu_torch.data.audio_io import mulaw_decode
from mla_tpu_torch.models.heads import GlobalRows
from mla_tpu_torch.models.trunk import global_statistics
from mla_tpu_torch.models.zoo import AudioTagger
from mla_tpu_torch.ops import augment
from mla_tpu_torch.ops import frontend as fe
from mla_tpu_torch.ops.adpcm import adpcm_decode
from mla_tpu_torch.parallel import tensor
from mla_tpu_torch.parallel.distributed import gather_rows
from mla_tpu_torch.utils import profiling

_EPS = 1e-7
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    step: int  # updates done so far
    model: AudioTagger
    optimizer: torch.optim.Adam
    # Polyak/EMA shadow of the parameters by name (None when
    # train.ema_decay == 0); eval reads it when train.ema_eval is set
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def bce_loss(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Multi-label binary cross-entropy over probabilities, clipped to
    [1e-7, 1 - 1e-7] in f32, mean over all elements."""
    p = probs.float().clamp(_EPS, 1.0 - _EPS)
    t = targets.float()
    return -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """The learning rate at 0-based update count t, as optax's schedules
    give it: constant; cosine lr * 0.5 * (1 + cos(pi * min(t, T) / T)) with
    T = num_steps; exponential lr * rate ** (t / 1000), not staircase; a
    linear warmup from 0 over ``warmup_steps``, after which the main
    schedule runs at t - warmup_steps."""
    t_cfg = cfg.train
    lr = t_cfg.learning_rate
    if t_cfg.lr_schedule == "constant":
        def main(t):
            return lr
    elif t_cfg.lr_schedule == "cosine":
        decay = float(max(t_cfg.num_steps, 1))

        def main(t):
            return lr * 0.5 * (1.0 + math.cos(math.pi * min(t, decay) / decay))
    elif t_cfg.lr_schedule == "exponential":
        def main(t):
            return lr if t <= 0 else lr * t_cfg.lr_decay_rate ** (t / 1000.0)
    else:
        raise ValueError(f"unknown lr_schedule {t_cfg.lr_schedule!r}")
    warm = t_cfg.warmup_steps
    if warm <= 0:
        return main

    def joined(t):
        if t < warm:
            return -lr * (1.0 - min(max(t, 0), warm) / warm) + lr
        return main(t - warm)

    return joined


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    """Adam over ``params``; the train step sets each update's learning
    rate from :func:`lr_schedule` before it steps."""
    return torch.optim.Adam(params, lr=lr_schedule(cfg)(0), betas=ADAM_BETAS, eps=ADAM_EPS)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Optional[List[bool]] = None, group=None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: scale every gradient by
    max_norm / ||g|| only when ||g|| >= max_norm. Returns ||g||. Decided on
    the device, so the host does not wait for the norm.

    Under tensor parallelism over a process ``group`` the gradients marked
    ``sharded`` are this rank's shards: their squares are summed over the
    group, and the replicated ones (equal on every rank) counted once."""
    dev = grads[0].device
    sq = [torch.sum(g.float() * g.float()).to(dev) for g in grads]
    if sharded is not None and group is not None:
        shard_sq = torch.stack([q for q, s in zip(sq, sharded) if s] or [sq[0] * 0]).sum()
        dist.all_reduce(shard_sq, op=dist.ReduceOp.SUM, group=group)
        total = torch.stack([q for q, s in zip(sq, sharded) if not s] or [sq[0] * 0]).sum()
        g_norm = torch.sqrt(total + shard_sq)
    else:
        g_norm = torch.sqrt(torch.stack(sq).sum())
    keep = g_norm < max_norm
    for g in grads:
        k, n = keep.to(g.device), g_norm.to(g.device)
        g.copy_(torch.where(k, g, g / n * max_norm))
    return g_norm


def create_train_state(cfg: Config, model: AudioTagger) -> TrainState:
    """Step 0, a fresh optimizer over ``model``'s parameters (initialized
    by the caller, e.g. ``build_model(..., seed=cfg.train.seed)``) and the
    EMA shadow when enabled."""
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if cfg.train.ema_decay > 0 else None)
    return TrainState(step=0, model=model, optimizer=make_optimizer(cfg, model.parameters()),
                      ema_params=ema)


def decode_staged(x: torch.Tensor, stage: str,
                  clip_samples: Optional[int] = None) -> torch.Tensor:
    """Device-side decode of a staged waveform batch (DataConfig.staging_dtype
    wire form) -> float32 [-1, 1]. A float32 input passes through whatever
    ``stage`` says: floats are never wire form. ``clip_samples`` cuts the
    adpcm4 block padding (None: keep every decoded sample)."""
    if x.dtype == torch.float32:
        return x
    if stage == "int16":
        return x.to(torch.float32) / 32768.0
    if stage == "uint8":
        return mulaw_decode(x)
    if stage == "adpcm4":
        return adpcm_decode(x, clip_samples, DEFAULT_BLOCK, bits=4)
    return x


def dropout_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator a train step draws its dropout masks from: a pure
    function of (train.seed, step), so a resumed run draws the same masks."""
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(mixed)


def augment_generator(seed: int, step: int, stream: int, device: torch.device) -> torch.Generator:
    """The generator a train step draws one augmentation from (stream 1
    SpecAugment, 2 mixup, the reference's ``fold_in`` salts): a pure function
    of (train.seed, step, stream), apart from the dropout generator's."""
    mixed = int(np.random.SeedSequence([seed, step, stream]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(mixed)


@dataclass(frozen=True)
class DataParallel:
    """One rank's part of a parallel train step: ``size`` ranks on the data
    axis in ``group`` (None = the default group), this rank at data index
    ``index`` holding ``rows`` of a ``global_batch``-row batch, and, under
    tensor parallelism, ``model`` (a ``parallel.tensor.ModelAxis`` over the
    rank's "model" group; None without)."""

    group: Any
    size: int
    rows: slice
    global_batch: int
    index: int = 0
    model: Any = None


def make_train_step(
    cfg: Config, model: AudioTagger, input_kind: str, clip_samples: Optional[int] = None,
    dp: Optional[DataParallel] = None,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """(state, x, y) -> (state, loss), updating ``state`` in place. x is a
    waveform [B, n] (float32 or the staged wire form) or a feature sequence
    [B, T, D] per ``input_kind``; the loss stays on the device.

    With ``dp`` the step is one rank's part of the step at the global batch,
    and every rank ends it with the same state: x and y are this rank's
    rows; batch norm takes the global batch's moments (when more than one
    rank); mixup, SpecAugment and dropout draw for the global batch and
    take this rank's rows (mixup's partners come from an all-reduce of the
    zero-padded global batch); the gradients and the loss are averaged over
    the ranks in one all-reduce, so the returned loss is the global one.

    A tensor-parallel ``model`` (``parallel.tensor.tensor_parallel``) needs
    nothing more: its layers carry their own collectives, every rank of a
    model group computes the same loss, the data axis averages the shards'
    gradients (every rank the replicated ones, see ``_average_over_ranks``),
    and the global-norm clip adds the shards' squares over the model group
    (a process group) or over every shard (a device list)."""
    t_cfg = cfg.train
    spec = t_cfg.spec_augment and input_kind in ("waveform", "patches")
    front_cfg = cfg.frontend
    if t_cfg.frontend_precision is not None:
        front_cfg = dataclasses.replace(front_cfg, precision=t_cfg.frontend_precision)
    sched = lr_schedule(cfg)
    params = [p for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    shard_ids = tensor.sharded_parameters(model)
    lay = tensor.layout_of(model)
    model_group = None if lay is None or lay.axis.local else lay.axis.group

    def forward(state: TrainState, x_in: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Augmentation, the train-mode forward and the loss."""
        dev = x_in.device
        if t_cfg.mixup_alpha > 0:
            gen = augment_generator(t_cfg.seed, state.step, 2, dev)
            if dp is None:
                x_in, y = augment.mixup(x_in, y, gen, t_cfg.mixup_alpha)
            else:
                xg = gather_rows(x_in, dp.rows, dp.global_batch, dp.group)
                yg = gather_rows(y, dp.rows, dp.global_batch, dp.group)
                perm, lam = augment.mixup_draws(dp.global_batch, gen, t_cfg.mixup_alpha)
                partner = perm[dp.rows]
                x_in, y = augment.mix_pairs(xg[dp.rows], yg[dp.rows], xg[partner],
                                            yg[partner], lam[dp.rows])
        if spec:
            gen = augment_generator(t_cfg.seed, state.step, 1, dev)
            draws = augment.spec_augment_draws(
                x_in.shape[0] if dp is None else dp.global_batch, *x_in.shape[-2:], gen,
                time_mask_width=t_cfg.time_mask_width, freq_mask_width=t_cfg.freq_mask_width)
            if dp is not None:
                draws = augment.SpanDraws(*(d[dp.rows] for d in draws))
            x_in = augment.apply_spec_augment(x_in, draws)
        gen = dropout_generator(t_cfg.seed, state.step, dev)
        if dp is not None:
            gen = GlobalRows(gen, dp.global_batch, dp.rows)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        return bce_loss(model(x_in, gen), y)

    def update(state: TrainState):
        """Clipping, the learning rate, Adam and the EMA."""
        if t_cfg.gradient_clip_norm > 0:
            with_grad = [p for p in params if p.grad is not None]
            clip_by_global_norm_([p.grad for p in with_grad], t_cfg.gradient_clip_norm,
                                 [id(p) in shard_ids for p in with_grad], model_group)
        opt = state.optimizer
        for group in opt.param_groups:
            group["lr"] = sched(state.step)
        opt.step()
        if state.ema_params is not None:
            d = t_cfg.ema_decay
            with torch.no_grad():
                for n, p in zip(names, params):
                    e = state.ema_params[n]
                    e.copy_(d * e + (1.0 - d) * p)

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        # one span with device time, its phases back to back on the card
        with profiling.annotate("mla.train.step", x.device, step=state.step) as span:
            if input_kind == "waveform":
                # data transform: no gradient reaches the front-end
                with span.phase("mla.train.frontend"), torch.no_grad():
                    x_in = fe.apply_frontend(
                        decode_staged(x, cfg.data.staging_dtype, clip_samples), front_cfg)
            else:
                x_in = x
            # the backward too: a checkpointed trunk re-runs its forward there
            with global_statistics(model, dp.group if dp is not None and dp.size > 1 else None):
                with span.phase("mla.train.forward"):
                    loss = forward(state, x_in, y)
                with span.phase("mla.train.backward"):
                    loss.backward()
                    if dp is not None:
                        with_grad = [p for p in params if p.grad is not None]
                        loss = _average_over_ranks([p.grad for p in with_grad], loss, dp,
                                                   [id(p) in shard_ids for p in with_grad])
            with span.phase("mla.train.optimizer"):
                update(state)
            state.step += 1
        return state, loss.detach()

    return step


@torch.no_grad()
def _mean_in_place(grads: List[torch.Tensor], extra: Optional[torch.Tensor], group,
                   size: int) -> Optional[torch.Tensor]:
    """Replace each gradient by its mean over ``group`` (``size`` ranks), in
    place, through one all-reduce of one flat buffer; ``extra`` (the loss)
    rides along and its mean is returned."""
    tail = [] if extra is None else [extra.detach().float().reshape(1)]
    if not grads and not tail:
        return None
    flat = torch.cat([g.reshape(-1) for g in grads] + tail)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= size
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return flat[-1] if tail else None


def _average_over_ranks(grads: List[torch.Tensor], loss: torch.Tensor, dp: DataParallel,
                        sharded: List[bool]) -> torch.Tensor:
    """Replace each gradient by its mean over the ranks, in place, and
    return the ranks' mean loss: one all-reduce of one flat buffer over the
    data axis. Over one rank the sum and the division by 1 are exact.

    Tensor parallel, the ``sharded`` gradients are averaged over the data
    axis (the ranks holding the same shard) and the replicated ones, with
    the loss, over every rank: the model axis' copies are equal in exact
    arithmetic, and the mean keeps them bit-equal where a kernel's backward
    is not deterministic (cuDNN's), so the ranks' replicated weights never
    drift apart."""
    if dp.model is None:
        return _mean_in_place(grads, loss, dp.group, dp.size)
    _mean_in_place([g for g, s in zip(grads, sharded) if s], None, dp.group, dp.size)
    return _mean_in_place([g for g, s in zip(grads, sharded) if not s], loss, None,
                          dp.size * dp.model.size)


def eval_params(cfg: Config, state: TrainState) -> Optional[Dict[str, torch.Tensor]]:
    """The parameters eval should read in place of the online ones: the EMA
    shadow when enabled (train.ema_decay > 0 and train.ema_eval), else None
    (the online parameters)."""
    if cfg.train.ema_decay > 0 and cfg.train.ema_eval and state.ema_params is not None:
        return state.ema_params
    return None


def _local_variables(state: TrainState, params: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
    """This process's ``state_dict`` with ``params`` (by this process's
    parameter names) in place of the online parameters."""
    variables = dict(state.model.state_dict())
    if params is not None:
        variables.update(params)
    return variables


def variables_from_state(state: TrainState, params: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Dict[str, torch.Tensor]:
    """The whole model's ``state_dict`` (parameters and batch-norm
    statistics) with ``params`` (e.g. the EMA shadow) in place of the online
    parameters. A tensor-parallel model's shards are gathered (on a process
    group a collective every rank of the model axis joins), so the caller
    never sees them."""
    return tensor.gather_named(state.model, _local_variables(state, params))


def make_eval_step(cfg: Config, model: AudioTagger, input_kind: str):
    """(state, x) -> f32 probs in eval mode (running batch-norm statistics,
    no dropout; the EMA parameters when enabled)."""

    @torch.no_grad()
    def step(state: TrainState, x: torch.Tensor) -> torch.Tensor:
        if input_kind == "waveform":
            x = fe.apply_frontend(x, cfg.frontend)
        model.eval()
        variables = _local_variables(state, eval_params(cfg, state))
        return torch.func.functional_call(model, variables, (x,)).float()

    return step
