"""The trunk's batch norm + ReLU (``mla_tpu_torch/ops/norm_act.py``,
``csrc/norm_act.cu``). On the CPU: the module (the registered ops' plain
versions under the hand-derived backward of ``_TrainNormAct``, the same
formula the CUDA kernels compute) against autograd of the torch ops the
module ran before the fused kernels, which the JAX package's batch norm
matches; the running statistics, ``frozen_statistics``, eval mode's lack of
a gradient, the checks on layout and type, the ops' fake implementations and
an export of the eval op. On the card (skipped without one): the kernels
against the plain version, bit-for-bit repeats, a one-rank group, the
launches of a flagship forward and train step, and an exported eval model.
No JAX here: the card's machine runs this file too."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu_torch.models.trunk import (  # noqa: E402
    _BN_MOMENTUM, _BatchNormReLU, frozen_statistics)
from mla_tpu_torch.ops import norm_act as na  # noqa: E402

WIDTHS = [64, 128, 256, 512]
DTYPES = [torch.float32, torch.bfloat16]
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


def test_exported_eval_op_is_one_node_and_runs():
    """torch.export records the eval block as the registered op, and the
    exported program gives the eager result."""

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bn = _module(64).eval()

        def forward(self, x):
            b = self.bn
            return na.norm_relu_eval(x, b.running_mean, b.running_var, b.weight, b.bias, b.eps)

    block, x = Block(), _input(64, torch.float32, True, exact=False)
    with torch.no_grad():
        prog = torch.export.export(block, (x,))
        targets = [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
        assert sum("norm_act_apply" in t for t in targets) == 1
        assert torch.equal(prog.module()(x), block(x))


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
    assert after == {"apply": 2, "stats": 1, "backward_reduce": 1, "backward_dx": 1}
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


def test_eval_mode_takes_no_gradient_on_the_card(cuda):
    """On the card too, a backward through eval mode raises, after the one
    apply launch of its forward."""
    bn = _module(256).to(cuda).eval()
    x = _input(256, torch.bfloat16, True, n=8, h=16, w=8).to(cuda).requires_grad_(True)
    before = dict(na.LAUNCHES)
    y = bn(x)
    assert {k: na.LAUNCHES[k] - before[k] for k in na.LAUNCHES} == {
        "apply": 1, "stats": 0, "backward_reduce": 0, "backward_dx": 0}
    with pytest.raises(RuntimeError, match="eval mode"):
        y.float().sum().backward()


def test_kernels_repeat_bit_for_bit_on_the_card(cuda):
    """Two runs of the train forward and backward give the same bits (no
    float atomics), on an activation large enough for many blocks."""
    x = _input(64, torch.bfloat16, True, n=64, h=96, w=64, exact=False).to(cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(x.shape, device=cuda).to(torch.bfloat16)
    dy = dy.contiguous(memory_format=torch.channels_last)
    bn = _module(64).to(cuda)
    runs = []
    for _ in range(2):
        xg = x.clone().requires_grad_(True)
        w, b = bn.weight.detach().clone().requires_grad_(True), bn.bias.detach().clone()
        b.requires_grad_(True)
        y, mean, var = na.norm_relu_train(xg, w, b, 1e-5)
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
    """A flagship forward launches apply once a block (8); a train step
    stats, apply, backward_reduce and backward_dx once a block each."""
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
    assert fwd == {"apply": 8, "stats": 0, "backward_reduce": 0, "backward_dx": 0}
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, "waveform")
    before = dict(na.LAUNCHES)
    loss = float(step(state, wav, labels)[1])
    train = {k: na.LAUNCHES[k] - before[k] for k in na.LAUNCHES}
    assert np.isfinite(loss)
    assert train == {"apply": 8, "stats": 8, "backward_reduce": 8, "backward_dx": 8}


def test_card_export_round_trip_of_the_eval_model(cuda, tmp_path):
    """The one-shot artifact exported on the card (f32 model, as the export
    path traces it) holds the apply op, loads, and matches the eager forward."""
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
        before = na.LAUNCHES["apply"]
        ex.export_forward(cfg, sd, path, batch=2, seconds=2.0, device=cuda)
        fn = ex.load_exported(path, device=cuda)
        wav = (np.random.default_rng(4).standard_normal((2, 32000)) * 0.1).astype(np.float32)
        got = fn(wav)
        assert na.LAUNCHES["apply"] - before == 4  # the loaded program ran the kernel a block
        model = build_model(cfg.model, device=cuda, seed=0)
        model.load_state_dict(sd)
        with torch.no_grad():
            want = model.eval()(fe.waveform_to_patches(torch.from_numpy(wav).to(cuda),
                                                       cfg.frontend)).float().cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
