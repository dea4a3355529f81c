"""A run whose timed path is broken underneath comes out not correct: each
fault a cell can have, planted in the program at the tiny size on the CPU,
with the run driven as on the card past the look for a card. (One card per
cell: no cell has an exchange between chips to leave out.)"""

import pytest
import torch

from conftest import failing, tiny_run


def _train_step_fault(kind):
    import mla_tpu_torch.train.state as st

    make = st.make_train_step

    def make_broken(cfg, model, input_kind, *a, **k):
        step = make(cfg, model, input_kind, *a, **k)

        def broken(state, x, y):
            if kind == "unchanged":  # the step returns its state as it found it
                before = [p.detach().clone() for p in model.parameters()]
                state, loss = step(state, x, y)
                with torch.no_grad():
                    for p, b in zip(model.parameters(), before):
                        p.copy_(b)
                return state, loss
            if kind == "half_batch":  # half of the batch left out, the mean over the rest
                return step(state, x[: x.shape[0] // 2], y[: y.shape[0] // 2])
            state, loss = step(state, x, y)
            return state, loss * 1.01  # the answer altered where it is produced

        return broken

    return make_broken


def _tag_fault(kind):
    import mla_tpu_torch.entry as entry

    make = entry.flagship_forward

    def make_broken(cfg):
        fn = make(cfg)

        def broken(model, wav):
            probs = fn(model, wav)
            if kind == "half_batch":
                half = fn(model, wav[: wav.shape[0] // 2])
                return torch.cat([half, half.mean(0, keepdim=True).expand_as(half)])[: len(wav)]
            probs = probs.clone()
            probs[0, 0] = 1.0 - probs[0, 0]  # the answer altered
            return probs

        return broken

    return make_broken


def _stream_fault(kind):
    import mla_tpu_torch.serve.server as server

    srv_cls = server.BatchedStreamingServer
    packed_step = srv_cls._packed_step

    def broken_step(self, states, tl, packed):
        if kind == "unchanged":  # the step returns its state unchanged
            return states, tl
        packed = packed.clone()  # half of the batch left out
        packed[self._wav_bytes + self.S // 2:] = 0
        return packed_step(self, states, tl, packed)

    return broken_step


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "answer"])
def test_train_faults_fail(kind, monkeypatch):
    import mla_tpu_torch.train.state as st

    monkeypatch.setattr(st, "make_train_step", _train_step_fault(kind))
    run, traffic = tiny_run("audioset-train-b256", seconds=0.3)
    assert failing(traffic.run(run))


@pytest.mark.parametrize("kind", ["half_batch", "answer"])
def test_tag_faults_fail(kind, monkeypatch):
    import mla_tpu_torch.entry as entry

    monkeypatch.setattr(entry, "flagship_forward", _tag_fault(kind))
    run, traffic = tiny_run("audioset-tag-b128", seconds=0.3, params={"batch": 4})
    assert failing(traffic.run(run))


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "answer"])
def test_stream_faults_fail(kind, monkeypatch):
    import mla_tpu_torch.serve.server as server
    import mla_tpu_torch.serve.ticker as ticker

    if kind == "answer":
        scores = ticker.TickLoop.scores

        def altered(self, sid):  # one stream's answer altered where it is produced
            s = scores(self, sid).copy()
            if sid == 0:
                s[0] = 1.0 - s[0]
            return s

        monkeypatch.setattr(ticker.TickLoop, "scores", altered)
    else:
        monkeypatch.setattr(server.BatchedStreamingServer, "_packed_step", _stream_fault(kind))
    # one-patch chunks: a 0.96 s period, so a short window holds answers
    run, traffic = tiny_run("stream-int16-s256-c5", seconds=0.6,
                            params={"streams": 4, "chunk_patches": 1})
    assert failing(traffic.run(run))
