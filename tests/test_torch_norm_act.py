"""The trunk's batch norm + ReLU (``mla_tpu_torch/ops/norm_act.py``,
``csrc/norm_act.cu``). On the CPU: the module (the registered ops' plain
versions under the hand-derived backward of ``_TrainNormAct``, the same
formula the CUDA kernels compute) against autograd of the torch ops the
module ran before the fused kernels, which the JAX package's batch norm
matches; the running statistics, ``frozen_statistics``, eval mode's lack of
a gradient, the checks on layout and type, the ops' fake implementations and
an export of the eval op; the pooled block (a stage's last, with its 2x2 max
pool) against autograd of the unpooled block then ``F.max_pool2d``, and which
trunks take it. On the card (skipped without one): the kernels against the
plain version, the pooled kernels against the unpooled ones then the
library's max pool, bit-for-bit repeats, a one-rank group, the launches of a
flagship forward and train step and their kernels, and an exported eval
model. No JAX here: the card's machine runs this file too."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from mla_tpu_torch.models.trunk import (  # noqa: E402
    _BN_MOMENTUM, CompactCNN, _BatchNormReLU, frozen_statistics)
from mla_tpu_torch.ops import norm_act as na  # noqa: E402

WIDTHS = [64, 128, 256, 512]
DTYPES = [torch.float32, torch.bfloat16]
# (h, w) of a pooled block's map: even, and odd in both (floor mode leaves
# the last row and column unpooled)
POOL_MAPS = [(8, 4), (7, 5)]
POOL_KINDS = ("apply_pool", "backward_reduce_pool", "backward_dx_pool")
# dx in the working type: f32 to rounding of a sum of a few hundred terms;
# bf16 to one unit in its last place (2^-8 of the value) plus that
DX_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _input(c, dtype, channels_last, n=4, h=8, w=4, seed=0, exact=True):
    """[n, c, h, w] with channel 0 constant (var = 0: the clamp). With
    ``exact`` the values are multiples of 1/16 below 4 and n*h*w a power of
    two, so every sum is exact in f32 and the module and the fused op take
    the same moments bit for bit."""
    rng = np.random.default_rng(seed)
    if exact:
        v = rng.integers(-64, 64, (n, c, h, w)) / 16.0
    else:
        v = rng.standard_normal((n, c, h, w)) * 1.5 + 0.3
    v[:, 0] = 0.75
    x = torch.from_numpy(v.astype(np.float32)).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def _plant_ties(x):
    """x with the top row of windows made of positive-leaning ties: in
    channels 1.. (channel 0 stays constant) each window's top right equals
    its top left and its bottom row lies 1 below, so the top two tie for
    the max and the first must take the gradient."""
    x = x.clone()
    wp = x.shape[3] // 2 * 2
    x[:, 1:, 0, 1:wp:2] = x[:, 1:, 0, 0:wp:2]
    x[:, 1:, 1, :wp] = x[:, 1:, 0, :wp] - 1
    return x


def _module(c, seed=1):
    bn = _BatchNormReLU(c, eps=1e-5)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))
    return bn


def _close(got, want, rtol):
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rtol * max(scale, 1e-6), (
        float((got - want).abs().max()), scale)


def _autograd_batch_norm_relu(x, weight, bias, eps):
    """The torch ops the module ran before the fused kernels (flax's
    arithmetic, autograd's backward): train-mode batch norm in f32 with the
    fast variance, cast back to x's type, then the ReLU."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps) * weight
    y = (x.float() - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    return torch.relu(y.to(x.dtype))


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_hand_derived_backward_matches_autograd_of_the_torch_ops(dtype, channels_last, c):
    """The module on CPU tensors (the plain version of each kernel, the
    hand-derived backward) against autograd of the torch ops it ran before
    the fused kernels: the output bit for bit, dx, dgamma and dbeta, and the
    moments; no launch."""
    x = _input(c, dtype, channels_last)
    cot = torch.from_numpy(np.random.default_rng(2).standard_normal(x.shape).astype(np.float32))
    bn = _module(c)
    bn.train()
    before = dict(na.LAUNCHES)
    xa = x.clone().requires_grad_(True)
    wa = bn.weight.detach().clone().requires_grad_(True)
    ba = bn.bias.detach().clone().requires_grad_(True)
    ya = _autograd_batch_norm_relu(xa, wa, ba, bn.eps)
    (ya.float() * cot).sum().backward()
    xb = x.clone().requires_grad_(True)
    yb = bn(xb)
    (yb.float() * cot).sum().backward()
    assert torch.equal(ya, yb) and yb.dtype == dtype
    _close(xb.grad, xa.grad, DX_RTOL[dtype])
    _close(bn.weight.grad, wa.grad, 1e-5)
    _close(bn.bias.grad, ba.grad, 1e-5)
    xc = x.clone().requires_grad_(True)
    y, mean, var = na.norm_relu_train(xc, wa.detach(), ba.detach(), bn.eps)
    assert torch.equal(y, yb) and not mean.requires_grad and not var.requires_grad
    assert float(var[0]) == 0.0  # the constant channel
    xf = x.float()
    torch.testing.assert_close(mean, xf.mean(dim=(0, 2, 3)), rtol=0, atol=0)
    torch.testing.assert_close(var, xf.var(dim=(0, 2, 3), unbiased=False), rtol=1e-6, atol=1e-6)
    assert na.LAUNCHES == before  # CPU tensors: the plain versions, no launch


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_mode_is_flax_batch_norm_then_relu(dtype, channels_last):
    """The module in eval mode (the registered apply op's plain version on
    the CPU) is flax's formula with the running statistics, cast back, then
    the ReLU, and moves no counter."""
    x = _input(64, dtype, channels_last, exact=False)
    bn = _module(64).eval()
    before = dict(na.LAUNCHES)
    with torch.no_grad():
        got = bn(x)
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        want = ((x.float() - bn.running_mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
                + bn.bias.view(1, -1, 1, 1)).to(dtype)
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        flax = ((x.float() - bn.running_mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1)
                + bn.bias.view(1, -1, 1, 1)).to(dtype)
    assert torch.equal(got, torch.relu(want))
    _close(got, torch.relu(flax), 1e-6 if dtype == torch.float32 else 2 ** -7)
    assert na.LAUNCHES == before


def test_eval_mode_takes_no_gradient():
    """Eval mode runs without no_grad, but a backward through it raises (no
    consumer trains with the running statistics)."""
    bn = _module(64).eval()
    x = _input(64, torch.float32, True, exact=False).requires_grad_(True)
    y = bn(x)
    assert torch.equal(y.detach(), bn(x.detach()).detach())
    with pytest.raises(RuntimeError, match="eval mode"):
        y.sum().backward()


def test_running_statistics_and_frozen_statistics():
    """Train mode moves the running statistics by momentum 0.99 toward the
    batch mean and biased variance; under frozen_statistics they stay put
    while the output is the same; eval reads them. No launch on the CPU."""
    x = _input(64, torch.bfloat16, True, exact=False)
    bn = _module(64).train()
    rm0, rv0 = bn.running_mean.clone(), bn.running_var.clone()
    before = dict(na.LAUNCHES)
    with frozen_statistics(bn):
        y_frozen = bn(x)
    assert torch.equal(bn.running_mean, rm0) and torch.equal(bn.running_var, rv0)
    y = bn(x)
    assert torch.equal(y, y_frozen)
    xf = x.float()
    count = xf.numel() // xf.shape[1]
    mean = xf.sum(dim=(0, 2, 3)) / count  # the op's: its [2, C] sums over the count
    var = torch.clamp_min((xf * xf).sum(dim=(0, 2, 3)) / count - mean * mean, 0.0)
    torch.testing.assert_close(mean, xf.mean(dim=(0, 2, 3)), rtol=1e-6, atol=1e-7)
    m = _BN_MOMENTUM
    torch.testing.assert_close(bn.running_mean, m * rm0 + (1 - m) * mean, rtol=0, atol=0)
    torch.testing.assert_close(bn.running_var, m * rv0 + (1 - m) * var, rtol=0, atol=0)
    assert bn.num_batches_tracked.item() == 0
    bn.eval()
    assert torch.equal(bn(x), na.apply_reference(
        x, bn.running_mean, torch.rsqrt(bn.running_var + bn.eps) * bn.weight, bn.bias))
    assert na.LAUNCHES == before


def test_layout_type_and_operand_checks():
    """What the kernels take is decided on the host, before any launch: a
    channels-last or contiguous NCHW activation of bf16 or f32 (anything
    else raises, no hidden copy), f32 [C] vectors, dy in x's layout, and 16
    bytes a load only where every pointer is aligned and no load crosses a
    row or a plane."""
    x = _input(64, torch.bfloat16, True)
    assert na._layout(x) is False and na._layout(x.contiguous()) is True
    with pytest.raises(ValueError, match="channels-last or contiguous NCHW"):
        na._layout(x.permute(0, 1, 3, 2))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        na._layout(x.half())
    with pytest.raises(ValueError, match="non-empty"):
        na._layout(x[:, :, 0])
    v = torch.zeros(64)
    with pytest.raises(ValueError, match="layout"):
        na._operands(x, x.contiguous(), v, v, v, v)
    with pytest.raises(ValueError, match="per-channel"):
        na._operands(x, None, torch.zeros(63), v)
    with pytest.raises(ValueError, match="per-channel"):
        na._operands(x, None, v.double(), v)
    assert na._vec(x, False) == 8 and na._vec(x.float(), False) == 4
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    assert na._vec(buf[1:].view(x.shape), False) == 1  # 2 bytes off 16-byte alignment
    odd = _input(64, torch.bfloat16, False, h=3, w=2)  # NCHW, planes of 6
    assert na._vec(odd, True) == 1 and na._vec(_input(12, torch.float32, True), False) == 4
    assert na.bytes_moved(x, "apply") == 2 * x.numel() * 2
    assert na.bytes_moved(x.float(), "backward_dx") == 3 * x.numel() * 4


@pytest.mark.parametrize("channels_last", [False, True])
def test_registered_ops_and_their_fake_implementations(channels_last):
    """Each registered op's schema, CPU implementation and fake
    implementation agree (``torch.library.opcheck``)."""
    x = _input(64, torch.bfloat16, channels_last)
    dy = _input(64, torch.bfloat16, channels_last, seed=5)
    v = [torch.rand(64) + 0.5 for _ in range(6)]
    ops = torch.ops.mla_tpu_torch
    torch.library.opcheck(ops.norm_act_apply, (x, v[0], v[1], v[2]))
    torch.library.opcheck(ops.norm_act_stats, (x,))
    torch.library.opcheck(ops.norm_act_backward_reduce, (dy, x, *v[:4]))
    torch.library.opcheck(ops.norm_act_backward_dx, (dy, x, *v))
    for h, w in POOL_MAPS:
        xp = _input(64, torch.bfloat16, channels_last, h=h, w=w)
        dyp = _input(64, torch.bfloat16, channels_last, h=h // 2, w=w // 2, seed=5)
        torch.library.opcheck(ops.norm_act_apply_pool, (xp, v[0], v[1], v[2]))
        torch.library.opcheck(ops.norm_act_backward_reduce_pool, (dyp, xp, *v[:4]))
        torch.library.opcheck(ops.norm_act_backward_dx_pool, (dyp, xp, *v))
        # the fake implementations give the pooled shapes in x's layout
        xm, dym, vm = xp.to("meta"), dyp.to("meta"), [t.to("meta") for t in v]
        y = ops.norm_act_apply_pool(xm, vm[0], vm[1], vm[2])
        assert y.shape == (4, 64, h // 2, w // 2)
        assert y.is_contiguous(memory_format=torch.channels_last) == channels_last
        assert ops.norm_act_backward_reduce_pool(dym, xm, *vm[:4]).shape == (2, 64)
        assert ops.norm_act_backward_dx_pool(dym, xm, *vm).shape == xp.shape


@pytest.mark.parametrize("pool", [False, True])
def test_exported_eval_op_is_one_node_and_runs(pool):
    """torch.export records the eval block as the registered op (pooled: the
    pooled op, and no max pool), and the exported program gives the eager
    result."""

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bn = _module(64).eval()

        def forward(self, x):
            b = self.bn
            return na.norm_relu_eval(x, b.running_mean, b.running_var, b.weight, b.bias, b.eps,
                                     pool)

    block, x = Block(), _input(64, torch.float32, True, h=7, exact=False)
    op = "norm_act_apply_pool" if pool else "norm_act_apply"
    with torch.no_grad():
        prog = torch.export.export(block, (x,))
        targets = [str(n.target).split(".")[-2 if "." in str(n.target) else -1]
                   for n in prog.graph.nodes if n.op == "call_function"]
        assert targets.count(op) == 1 and not any("max_pool" in t for t in targets)
        got = prog.module()(x)
        assert got.shape == ((4, 64, 3, 2) if pool else x.shape)
        assert torch.equal(got, block(x))


@pytest.mark.parametrize("shape", POOL_MAPS)
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pooled_block_matches_autograd_of_block_then_max_pool(dtype, channels_last, shape):
    """A stage's last block with its max pool (the pooled ops' plain versions
    under the hand-derived backward) against autograd of the torch ops then
    F.max_pool2d: eval and train outputs bit for bit, dx, dgamma and dbeta,
    with an odd map and with planted ties, whose gradient goes to the first
    maximum of the window; the pooled ops equal their composition; no
    launch."""
    h, w = shape
    x = _plant_ties(_input(64, dtype, channels_last, h=h, w=w))
    bn = _module(64)
    before = dict(na.LAUNCHES)
    ops = torch.ops.mla_tpu_torch
    v = [torch.rand(64, generator=torch.Generator().manual_seed(k)) + 0.5 for k in range(6)]
    y = ops.norm_act_apply_pool(x, v[0], v[1], v[2])
    assert torch.equal(y, F.max_pool2d(na.apply_reference(x, v[0], v[1], v[2]), 2, 2))
    assert y.shape == (4, 64, h // 2, w // 2) and y.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last) == channels_last
    with torch.no_grad():
        assert torch.equal(bn.eval()(x, True), F.max_pool2d(bn(x), 2, 2))

    bn.train()
    cot = torch.from_numpy(np.random.default_rng(2).standard_normal(y.shape).astype(np.float32))
    xa = x.clone().requires_grad_(True)
    wa = bn.weight.detach().clone().requires_grad_(True)
    ba = bn.bias.detach().clone().requires_grad_(True)
    ya = F.max_pool2d(_autograd_batch_norm_relu(xa, wa, ba, bn.eps), 2, 2)
    (ya.float() * cot).sum().backward()
    xb = x.clone().requires_grad_(True)
    yb = bn(xb, True)
    (yb.float() * cot).sum().backward()
    assert torch.equal(ya, yb) and yb.dtype == dtype
    _close(xb.grad, xa.grad, DX_RTOL[dtype])
    _close(bn.weight.grad, wa.grad, 1e-5)
    _close(bn.bias.grad, ba.grad, 1e-5)
    # the routed gradient of the planted ties goes to the first of each tied
    # pair, never the second; some pairs are positive, so [y > 0] passes it on
    y_full, mean, var = na.norm_relu_train(x, wa.detach(), ba.detach(), bn.eps)
    rstd = torch.rsqrt(var + bn.eps)
    scale = rstd * wa.detach()
    dy = cot.to(dtype).contiguous(memory_format=na._format(not channels_last))
    routed = na._route(dy, x, mean, scale, ba.detach())
    wp = w // 2 * 2
    first, second = routed[:, 1:, 0, 0:wp:2], routed[:, 1:, 0, 1:wp:2]
    positive = y_full[:, 1:, 0, 0:wp:2] > 0
    assert bool(positive.any())
    assert torch.equal(first, dy[:, 1:, 0])
    assert not bool(second.any())
    assert na.LAUNCHES == before


class _Ops(TorchDispatchMode):
    """The names of the ops a block of code dispatches."""

    def __enter__(self):
        self.names = []
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("norm, pool, fused", [("batch", "max", 2), ("batch", "avg", 0),
                                               ("group", "max", 0), ("none", "max", 0)])
def test_trunk_takes_the_pooled_block_only_for_batch_norm_and_max_pools(norm, pool, fused):
    """CompactCNN gives each stage's last batch norm + ReLU the stage's max
    pool (eval and train, forward and backward) where its map is at least
    2 x 2; average pools, group norm and no norm keep their own pool."""
    trunk = CompactCNN(conv_channels=(8, 16, 16), convs_per_stage=2, embed_dim=8, norm=norm,
                       pool=pool, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 6)).astype(np.float32))
    with torch.no_grad(), _Ops() as seen:
        trunk.eval()(x)
    names = seen.names
    # maps 8 x 6 -> 4 x 3 -> 2 x 1: the last stage's map is too small to pool
    assert names.count("norm_act_apply_pool") == fused
    assert names.count("max_pool2d") + names.count("max_pool2d_with_indices") == (
        2 if pool == "max" and not fused else 0)
    trunk.train()
    with _Ops() as seen:
        trunk(x).sum().backward()
    names = seen.names
    assert names.count("norm_act_apply_pool") == fused
    assert names.count("norm_act_backward_reduce_pool") == fused
    assert names.count("norm_act_backward_dx_pool") == fused
    assert names.count("norm_act_apply") == (6 - fused if norm == "batch" else 0)


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_match_plain_version_on_the_card(cuda, dtype, channels_last, c):
    """Eval, the train forward, its backward and the running statistics on
    the card against the same module on the CPU (the plain version), in the
    working type; the apply kernel bit-exact against the plain version on
    the card given the same vectors (the card's rsqrt is not the CPU's);
    each kernel launched once."""
    x = _input(c, dtype, channels_last, n=8, h=16, w=8)
    cot = torch.from_numpy(np.random.default_rng(3).standard_normal(x.shape).astype(np.float32))
    cpu, card = _module(c), _module(c).to(cuda)
    xc = x.to(cuda)  # keeps the layout
    assert xc.is_contiguous(memory_format=torch.channels_last) == channels_last
    before = dict(na.LAUNCHES)
    with torch.no_grad():
        got = card.eval()(xc)
        assert na.LAUNCHES["apply"] == before["apply"] + 1
        scale = torch.rsqrt(card.running_var + card.eps) * card.weight
        assert torch.equal(got, na.apply_reference(xc, card.running_mean, scale, card.bias))
        _close(got.cpu(), cpu.eval()(x), 1e-6 if dtype == torch.float32 else 2 ** -7)
    cpu.train(), card.train()
    xa, xb = x.clone().requires_grad_(True), xc.clone().requires_grad_(True)
    ya, yb = cpu(xa), card(xb)
    (ya.float() * cot).sum().backward()
    (yb.float() * cot.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    after = {k: na.LAUNCHES[k] - before[k] for k in na.LAUNCHES}  # eval's apply too
    assert after == {**dict.fromkeys(na.LAUNCHES, 0), "apply": 2, "stats": 1,
                     "backward_reduce": 1, "backward_dx": 1}
    _close(yb.cpu(), ya.detach(), 1e-5 if dtype == torch.float32 else 2 ** -7)
    _close(xb.grad.cpu(), xa.grad, 1e-4 if dtype == torch.float32 else 2 ** -6)
    _close(card.weight.grad.cpu(), cpu.weight.grad, 1e-4)
    _close(card.bias.grad.cpu(), cpu.bias.grad, 1e-4)
    torch.testing.assert_close(card.running_mean.cpu(), cpu.running_mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(card.running_var.cpu(), cpu.running_var, rtol=1e-5, atol=1e-6)


def _offset_channels_last(x):
    """x's values in a channels-last view that starts one element into its
    buffer: no pointer 16-byte aligned, so the kernels load one element."""
    n, c, h, w = x.shape
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    view.copy_(x)
    return view


@pytest.mark.parametrize("case", ["unaligned", "nchw-plane-6", "f32-c12", "bf16-c4096"])
def test_other_shapes_on_the_card(cuda, case):
    """The kernels' other paths against the module on the CPU: one element a
    load (an unaligned view; NCHW planes of 6), a row of 3 threads (the
    grid rounded to whole rows), and a row wider than a block (the
    statistics in two windows of channels)."""
    dtype, c, h, w, cl = {"unaligned": (torch.bfloat16, 64, 8, 4, True),
                          "nchw-plane-6": (torch.bfloat16, 64, 3, 2, False),
                          "f32-c12": (torch.float32, 12, 8, 4, True),
                          "bf16-c4096": (torch.bfloat16, 4096, 4, 2, True)}[case]
    x = _input(c, dtype, cl, n=8, h=h, w=w, exact=False)
    xc = _offset_channels_last(x.to(cuda)) if case == "unaligned" else x.to(cuda)
    assert (na._vec(xc, not cl) == 1) == (case in ("unaligned", "nchw-plane-6"))
    cot = torch.from_numpy(np.random.default_rng(8).standard_normal(x.shape).astype(np.float32))
    cpu, card = _module(c).train(), _module(c).to(cuda).train()
    xa, xb = x.clone().requires_grad_(True), xc.detach().requires_grad_(True)
    ya, yb = cpu(xa), card(xb)
    (ya.float() * cot).sum().backward()
    (yb.float() * cot.to(cuda)).sum().backward()
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -6
    _close(yb.detach().cpu(), ya.detach(), rtol)
    _close(xb.grad.cpu(), xa.grad, rtol)
    _close(card.weight.grad.cpu(), cpu.weight.grad, 1e-4)
    _close(card.bias.grad.cpu(), cpu.bias.grad, 1e-4)
    torch.testing.assert_close(card.running_mean.cpu(), cpu.running_mean, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        _close(card.eval()(xc).cpu(), cpu.eval()(x), 1e-6 if dtype == torch.float32 else 2 ** -7)


# (dtype, channels-last, (h, w), C, unaligned): 16-byte loads in both layouts
# and both types; odd maps (one element a load in NCHW); NCHW rows of 12
# (not 2V columns: one element a load); a row of 3 threads; a row wider than
# a block; a view one element into its buffer
BF, F32 = torch.bfloat16, torch.float32
POOL_CASES = [(BF, True, (16, 8), 64, False), (BF, False, (16, 16), 64, False),
              (F32, True, (16, 8), 64, False), (F32, False, (16, 8), 64, False),
              (BF, True, (15, 9), 64, False), (BF, False, (15, 9), 64, False),
              (BF, False, (8, 12), 64, False), (F32, True, (7, 5), 12, False),
              (BF, True, (6, 4), 4096, False), (BF, True, (8, 4), 64, True)]


def _plant_nans(x):
    """x with NaN in the second and fourth element of a few windows (the
    last NaN of a window is the one F.max_pool2d picks)."""
    x = x.clone()
    x[0, 1, 0, 1] = x[0, 1, 1, 1] = x[1, 2, 2, 3] = float("nan")
    return x


@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: "-".join(map(str, c)))
def test_pooled_kernels_match_plain_version_on_the_card(cuda, case):
    """The pooled kernels against the unpooled ones then the library's
    F.max_pool2d on the card: eval and the train forward bit for bit (NaN
    too), dx, dgamma and dbeta within the unpooled kernels' tolerances; and
    each kernel against its plain version given the same vectors: apply_pool
    and dx_pool bit-exact (ties and NaN planted), reduce_pool within f32
    summation-order error; one launch of each."""
    dtype, cl, (h, w), c, unaligned = case
    x = _plant_ties(_input(c, dtype, cl, n=8, h=h, w=w, exact=False)).to(cuda)
    if unaligned:
        x = _offset_channels_last(x)
    two_loads = 32 // x.element_size()  # NCHW: the columns of a window pair's loads
    assert (na._vec(x, not cl, pool=True) == 1) == (unaligned or (not cl and w % two_loads != 0))
    bn = _module(c).to(cuda)
    ops = torch.ops.mla_tpu_torch
    before = dict(na.LAUNCHES)
    with torch.no_grad():
        bn.eval()
        got = bn(x, True)
        assert {k: na.LAUNCHES[k] - before[k] for k in na.LAUNCHES} == {
            **dict.fromkeys(na.LAUNCHES, 0), "apply_pool": 1}
        assert torch.equal(got, F.max_pool2d(bn(x), 2, 2))
        assert got.is_contiguous(memory_format=torch.channels_last) == cl
        xn = _plant_nans(x)
        torch.testing.assert_close(bn(xn, True), F.max_pool2d(bn(xn), 2, 2), rtol=0, atol=0,
                                   equal_nan=True)
    bn.train()
    cot = torch.randn((8, c, h // 2, w // 2), device=cuda)
    xa, xb = x.detach().clone().requires_grad_(True), x.detach().clone().requires_grad_(True)
    wa = bn.weight.detach().clone().requires_grad_(True)
    ba = bn.bias.detach().clone().requires_grad_(True)
    wb = bn.weight.detach().clone().requires_grad_(True)
    bb = bn.bias.detach().clone().requires_grad_(True)
    before = dict(na.LAUNCHES)
    yb, mean_b, var_b = na.norm_relu_train(xb, wb, bb, bn.eps, pool=True)
    (yb.float() * cot).sum().backward()
    torch.cuda.synchronize()
    assert {k: na.LAUNCHES[k] - before[k] for k in na.LAUNCHES} == {
        **dict.fromkeys(na.LAUNCHES, 0), "stats": 1, "apply_pool": 1, "backward_reduce_pool": 1,
        "backward_dx_pool": 1}
    yf, mean, var = na.norm_relu_train(xa, wa, ba, bn.eps)
    ya = F.max_pool2d(yf, 2, 2)
    assert torch.equal(ya, yb) and torch.equal(mean, mean_b) and torch.equal(var, var_b)
    (ya.float() * cot).sum().backward()
    _close(xb.grad, xa.grad, 1e-4 if dtype == torch.float32 else 2 ** -6)
    _close(wb.grad, wa.grad, 1e-4)
    _close(bb.grad, ba.grad, 1e-4)

    # each kernel against its plain version on the card, given the same vectors
    gen = torch.Generator(device=cuda).manual_seed(7)
    mean = torch.randn(c, generator=gen, device=cuda) * 0.1
    rstd = torch.rand(c, generator=gen, device=cuda) + 0.5
    scale = rstd * (torch.rand(c, generator=gen, device=cuda) + 0.5)
    shift = torch.randn(c, generator=gen, device=cuda) * 0.5
    cb, cc = torch.randn(c, generator=gen, device=cuda), torch.randn(c, generator=gen, device=cuda)
    xn = _plant_nans(x)
    dy = cot.to(dtype).contiguous(memory_format=na._format(not cl))
    torch.testing.assert_close(ops.norm_act_apply_pool(xn, mean, scale, shift),
                               na.apply_pool_reference(xn, mean, scale, shift), rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(ops.norm_act_backward_dx_pool(dy, xn, mean, rstd, scale, shift,
                                                             cb, cc),
                               na.backward_dx_pool_reference(dy, xn, mean, rstd, scale, shift,
                                                             cb, cc),
                               rtol=0, atol=0, equal_nan=True)
    routed = na._route(dy, x, mean, scale, shift)
    g, xhat = na._gate_and_xhat(routed, x, mean, rstd, scale, shift)
    mag = torch.stack([g.abs().sum(dim=(0, 2, 3)), (g * xhat).abs().sum(dim=(0, 2, 3))])
    got = ops.norm_act_backward_reduce_pool(dy, x, mean, rstd, scale, shift)
    want = na.backward_reduce_reference(routed, x, mean, rstd, scale, shift)
    assert bool(((got - want).abs() <= 1e-5 * mag + 1e-30).all()), float((got - want).abs().max())


def test_eval_mode_takes_no_gradient_on_the_card(cuda):
    """On the card too, a backward through eval mode raises, after the one
    apply launch of its forward."""
    bn = _module(256).to(cuda).eval()
    x = _input(256, torch.bfloat16, True, n=8, h=16, w=8).to(cuda).requires_grad_(True)
    before = dict(na.LAUNCHES)
    y = bn(x)
    assert {k: na.LAUNCHES[k] - before[k] for k in na.LAUNCHES} == {
        **dict.fromkeys(na.LAUNCHES, 0), "apply": 1}
    with pytest.raises(RuntimeError, match="eval mode"):
        y.float().sum().backward()


@pytest.mark.parametrize("pool", [False, True])
def test_kernels_repeat_bit_for_bit_on_the_card(cuda, pool):
    """Two runs of the train forward and backward (pooled: the pooled
    kernels) give the same bits (no float atomics), on an activation large
    enough for many blocks."""
    x = _input(64, torch.bfloat16, True, n=64, h=96, w=64, exact=False).to(cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(x.shape[:2] + ((48, 32) if pool else x.shape[2:]), device=cuda)
    dy = dy.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bn = _module(64).to(cuda)
    runs = []
    for _ in range(2):
        xg = x.clone().requires_grad_(True)
        w, b = bn.weight.detach().clone().requires_grad_(True), bn.bias.detach().clone()
        b.requires_grad_(True)
        y, mean, var = na.norm_relu_train(xg, w, b, 1e-5, pool=pool)
        y.backward(dy)
        runs.append([y, mean, var, xg.grad, w.grad, b.grad])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_one_rank_group_agrees_with_no_group_on_the_card(cuda, tmp_path):
    """With a one-rank process group the fused op all-reduces its sums over
    it and gives what it gives without one."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        x = _input(128, torch.bfloat16, True, n=8, h=16, w=8, exact=False).to(cuda)
        x = x.contiguous(memory_format=torch.channels_last)
        dy = torch.randn(x.shape, device=cuda).to(torch.bfloat16)
        dy = dy.contiguous(memory_format=torch.channels_last)
        bn = _module(128).to(cuda)
        outs = []
        for group in (None, dist.group.WORLD):
            xg = x.clone().requires_grad_(True)
            w = bn.weight.detach().clone().requires_grad_(True)
            b = bn.bias.detach().clone().requires_grad_(True)
            y, mean, var = na.norm_relu_train(xg, w, b, 1e-5, group)
            y.backward(dy)
            outs.append([y, mean, var, xg.grad, w.grad, b.grad])
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_flagship_launches_on_the_card(cuda):
    """A flagship forward launches apply once in each stage's first block
    and apply_pool in its last (4 + 4); a train step stats once a block (8),
    and apply, backward_reduce and backward_dx in the first blocks, their
    pooled versions in the last (4 each)."""
    from mla_tpu_torch.entry import flagship_config, flagship_forward
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.train.state import create_train_state, make_train_step

    cfg = flagship_config()
    model = build_model(cfg.model, device=cuda, seed=0)
    wav = torch.randn((2, 160000), device=cuda) * 0.1
    labels = (torch.rand((2, cfg.model.n_classes), device=cuda) < 0.05).float()
    before = dict(na.LAUNCHES)
    model.eval()
    flagship_forward(cfg)(model, wav)
    fwd = {k: na.LAUNCHES[k] - before[k] for k in na.LAUNCHES}
    assert fwd == {**dict.fromkeys(na.LAUNCHES, 0), "apply": 4, "apply_pool": 4}
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, "waveform")
    before = dict(na.LAUNCHES)
    loss = float(step(state, wav, labels)[1])
    train = {k: na.LAUNCHES[k] - before[k] for k in na.LAUNCHES}
    assert np.isfinite(loss)
    assert train == {"apply": 4, "stats": 8, "backward_reduce": 4, "backward_dx": 4,
                     "apply_pool": 4, "backward_reduce_pool": 4, "backward_dx_pool": 4}


def test_flagship_kernels_hold_no_max_pool_on_the_card(cuda):
    """A profile of one flagship forward and one train step (two clips)
    shows the pooled kernels and no max-pool kernel of the library."""
    from torch.profiler import ProfilerActivity, profile

    from mla_tpu_torch.entry import flagship_config, flagship_forward
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.train.state import create_train_state, make_train_step

    cfg = flagship_config()
    model = build_model(cfg.model, device=cuda, seed=0)
    wav = torch.randn((2, 160000), device=cuda) * 0.1
    labels = (torch.rand((2, cfg.model.n_classes), device=cuda) < 0.05).float()
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, "waveform")
    model.eval()
    flagship_forward(cfg)(model, wav)  # builds and warms up outside the profile
    step(state, wav, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.eval()
        flagship_forward(cfg)(model, wav)
        step(state, wav, labels)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("norm_act_pool_elementwise" in k for k in names), names
    assert not [k for k in names if "max_pool" in k], names


def test_card_export_round_trip_of_the_eval_model(cuda, tmp_path):
    """The one-shot artifact exported on the card (f32 model, as the export
    path traces it) holds the apply ops, loads, and matches the eager forward."""
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.ops import frontend as fe
    from mla_tpu_torch.serve import export as ex

    cfg = get_config("audioset_full_dp", {"model.conv_channels": "64,128",
                                          "model.compute_dtype": "float32",
                                          "model.n_classes": "12"})
    sd = build_model(cfg.model, device="cpu", seed=0).state_dict()
    path = str(tmp_path / "m.mlxt")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ex.export_forward(cfg, sd, path, batch=2, seconds=2.0, device=cuda)
        fn = ex.load_exported(path, device=cuda)
        wav = (np.random.default_rng(4).standard_normal((2, 32000)) * 0.1).astype(np.float32)
        before = dict(na.LAUNCHES)
        got = fn(wav)
        # the loaded program ran a kernel a block: each stage's last pooled
        assert {k: na.LAUNCHES[k] - before[k] for k in ("apply", "apply_pool")} == {
            "apply": 2, "apply_pool": 2}
        model = build_model(cfg.model, device=cuda, seed=0)
        model.load_state_dict(sd)
        with torch.no_grad():
            want = model.eval()(fe.waveform_to_patches(torch.from_numpy(wav).to(cuda),
                                                       cfg.frontend)).float().cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
