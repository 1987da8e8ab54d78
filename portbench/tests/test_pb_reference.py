"""The frozen reference against the port's CPU path at a small size (a
stream of a few ticks, one train step), and the control's loop LSTM
against `torch.lstm` with its rounding taken out."""

import pytest
import torch

from portbench import controls, manifest, run
from portbench.tests.helpers import small_traffic

MAN = manifest.Manifest()


def test_stream_matches_the_port():
    tr = small_traffic(MAN, "f32.stream512", warmup_ticks=6)
    r = run.run_cell("f32.stream512", 31, 0.3, False, "cpu", manifest=MAN,
                     traffic=tr)
    for k, v in r["checks"].items():
        assert v["value"] < 1e-5, (k, v)


@pytest.mark.parametrize("cell", ["f32.train256", "bf16.train256"])
def test_one_train_step_matches_the_port(cell):
    tr = small_traffic(MAN, cell, checked_steps=1, warmup_steps=0)
    r = run.run_cell(cell, 32, 0.1, False, "cpu", manifest=MAN, traffic=tr)
    bound = 1e-5 if cell.startswith("f32") else 1e-2
    for k, v in r["checks"].items():
        assert v["value"] < bound, (k, v)


def test_the_controls_loop_lstm_is_torch_lstm():
    g = torch.Generator().manual_seed(0)
    T, B, D, H, L = 7, 3, 5, 4, 2
    flat = []
    for layer in range(L):
        n_in = D if layer == 0 else 2 * H
        for _ in range(2):
            flat += [torch.randn(4 * H, n_in, generator=g),
                     torch.randn(4 * H, H, generator=g),
                     torch.randn(4 * H, generator=g),
                     torch.randn(4 * H, generator=g)]
    x = torch.randn(T, B, D, generator=g)
    hx = (torch.randn(2 * L, B, H, generator=g),
          torch.randn(2 * L, B, H, generator=g))
    want = torch.lstm(x, hx, flat, True, L, 0.0, False, True, False)
    got = controls._lstm_loop(x, hx, flat, True, L, 0.0, False, True, False)
    for w, gt in zip(want, got):
        assert torch.allclose(w, gt, atol=1e-5)
