"""Attention pooling and its streaming state in the PyTorch port, against
the JAX package on the same inputs, for every gate kind."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.ops import attention_pool as jap  # noqa: E402
from mla_tpu_torch.ops import attention_pool as ap  # noqa: E402

GATES = ["exp", "sigmoid", "relu", "softplus"]
# 1e-6, absolute for scores and weights in [0, 1] and relative for the
# unnormalized accumulators, which grow to ~30 here (one f32 ulp is 2e-6)
TOL = 1e-6


def _logits(seed, shape=(3, 7, 6), masked_rows=()):
    rng = np.random.default_rng(seed)
    gate = (rng.standard_normal(shape) * 2).astype(np.float32)
    cla = rng.standard_normal(shape).astype(np.float32)
    for b, t in masked_rows:
        gate[b, t] = -np.inf
    return gate, cla


def _close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cla_act", ["sigmoid", "linear"])
@pytest.mark.parametrize("gate", GATES)
def test_attention_pool_matches_jax(gate, cla_act):
    g, c = _logits(0)
    ours = ap.attention_pool(torch.from_numpy(g), torch.from_numpy(c), gate, cla_act)
    _close(ours, jap.attention_pool(jnp.asarray(g), jnp.asarray(c), gate, cla_act))


@pytest.mark.parametrize("gate", GATES + ["max"])
def test_attention_timeline_matches_jax(gate):
    g, c = _logits(1, masked_rows=[(0, 2), (1, 0), (1, 6)])
    ours = ap.attention_timeline(torch.from_numpy(g), torch.from_numpy(c), gate)
    ref = jap.attention_timeline(jnp.asarray(g), jnp.asarray(c), gate)
    for a, b in zip(ours, ref):
        _close(a, b)


@pytest.mark.parametrize("gate", GATES + ["max"])
def test_stream_update_merge_finalize_match_jax(gate):
    """Three chunks fold into one state and two more into another; chunk 2
    masks some rows and chunk 3 is masked entirely for every clip."""
    chunks = [_logits(2), _logits(3, masked_rows=[(0, 1), (2, 3), (2, 4)]),
              _logits(4, masked_rows=[(b, t) for b in range(3) for t in range(7)]),
              _logits(5), _logits(6, masked_rows=[(1, 5)])]
    ours = [ap.init_stream_state((3, 6)), ap.init_stream_state((3, 6))]
    ref = [jap.init_stream_state((3, 6)), jap.init_stream_state((3, 6))]
    for i, (g, c) in enumerate(chunks):
        k = 0 if i < 3 else 1
        ours[k] = ap.update_stream_state(ours[k], torch.from_numpy(g), torch.from_numpy(c), gate)
        ref[k] = jap.update_stream_state(ref[k], jnp.asarray(g), jnp.asarray(c), gate)
        for a, b in zip(ours[k], ref[k]):
            _close(a, b)
    merged = ap.merge_stream_states(ours[0], ours[1], gate)
    merged_ref = jap.merge_stream_states(ref[0], ref[1], gate)
    for a, b in zip(merged, merged_ref):
        _close(a, b)
    _close(ap.stream_finalize(merged), jap.stream_finalize(merged_ref))


def test_streamed_state_equals_whole_clip_pool():
    g, c = _logits(7, shape=(2, 12, 4))
    st = ap.init_stream_state((2, 4))
    for lo in range(0, 12, 5):
        st = ap.update_stream_state(st, torch.from_numpy(g[:, lo:lo + 5]),
                                    torch.from_numpy(c[:, lo:lo + 5]))
    whole = ap.attention_pool(torch.from_numpy(g), torch.from_numpy(c))
    torch.testing.assert_close(ap.stream_finalize(st), whole, atol=TOL, rtol=0)


def test_unknown_activations_raise():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="att_activation"):
        ap.gate_activation(x, "tanh")
    with pytest.raises(ValueError, match="cla_activation"):
        ap.cla_activation(x, "softmax")
