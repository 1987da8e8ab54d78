"""A whole run of each cell on the CPU at a small size, past the harness's
look for a card: sound, it comes out correct; with the timed path broken
underneath (a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced), not correct."""

import pytest
import torch

from portbench import manifest, run
from portbench.tests.helpers import small_traffic

MAN = manifest.Manifest()
STREAM = ["f32.stream512"]
TRAIN = ["f32.train256", "bf16.train256"]
SEED = 2 ** 31 + 77


def _run(cell):
    return run.run_cell(cell, SEED, 0.3, False, "cpu", manifest=MAN,
                        traffic=small_traffic(MAN, cell))


@pytest.mark.parametrize("cell", STREAM + TRAIN)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in
                                 MAN.metrics("end_to_end", cell)}


def _stream_fault(monkeypatch, fault):
    from mobileposer_tpu_torch.models.net import MobilePoserNet
    real = MobilePoserNet.forward_online_batched

    def broken(self, params, state, frames):
        if fault == "half_batch":
            h = frames.shape[0] // 2
            frames = torch.cat([frames[:h], frames[:h]])
        outs, new = real(self, params, state, frames)
        if fault == "state_unchanged":
            new = state
        if fault == "answer_altered":
            joints = outs[1].clone()
            joints[0, 0, 0] += 0.1
            outs = (outs[0], joints) + tuple(outs[2:])
        return outs, new
    monkeypatch.setattr(MobilePoserNet, "forward_online_batched", broken)


def _train_fault(monkeypatch, fault):
    from mobileposer_tpu_torch.models import modules as M
    if fault == "state_unchanged":
        for opt in (torch.optim.Adam, torch.optim.AdamW):
            monkeypatch.setattr(opt, "step", lambda self, closure=None: None)
        monkeypatch.setattr("mobileposer_tpu_torch.train.trainer.OptaxAdam."
                            "step", lambda self, closure=None: None)
        return
    for name, loss in list(M.LOSSES.items()):
        def broken(params, batch, draws, *a, _loss=loss, **kw):
            if fault == "half_batch":
                h = batch["imu"].shape[0] // 2
                batch = {k: v[:h] for k, v in batch.items()}
                draws = M.Draws(*(None if d is None else d[:h]
                                  for d in draws))
                return _loss(params, batch, draws, *a, **kw)
            return _loss(params, batch, draws, *a, **kw) * 1.01
        monkeypatch.setitem(M.LOSSES, name, broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", STREAM + TRAIN)
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    if cell in STREAM:
        _stream_fault(monkeypatch, fault)
    else:
        _train_fault(monkeypatch, fault)
    r = _run(cell)
    assert not r["correct"], r["checks"]
