"""On the card, at a size a test run can hold: a sound run of each cell is
correct, and each cell's control, put in the program's place, is not
(`portbench.controls`). Run on a machine with a card:
`python -m pytest portbench/tests -q -m chip`."""

import pytest
import torch

from portbench import check, controls, manifest, run
from portbench.tests.helpers import small_traffic

MAN = manifest.Manifest()


def _cfg_tr(cell, **over):
    c = MAN.cell(cell)
    tr = MAN.traffic(c["traffic"])
    tr.update(over)
    return MAN.config(c["config"]), tr


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in MAN.data["workloads"]])
def test_a_sound_run_on_the_card_is_correct(cell, cuda_device):
    tr = small_traffic(MAN, cell)
    if tr["kind"] == "stream":
        tr.update(streams=64, period_ticks=64, warmup_ticks=8,
                  check_streams=8)
    else:
        tr.update(batch=32, window=125)
    r = run.run_cell(cell, 2 ** 31 + 5, 1.0, True, cuda_device, manifest=MAN,
                     traffic=tr)
    assert r["correct"], r["checks"]
    for m in r["metrics"].values():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100


@pytest.mark.chip
def test_stream_control_is_not_correct(cuda_device):
    cell = "f32.stream512"
    cfg, tr = _cfg_tr(cell, streams=64, check_streams=8)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = controls.stream_tf32(cfg, tr, 2 ** 31 + 9, 200, cuda_device)
    assert not check.verdict(r, MAN.limits(cell)), r


@pytest.mark.chip
@pytest.mark.parametrize("cell,variant", [("f32.train256", "tf32"),
                                          ("bf16.train256", "fp8")])
def test_train_controls_are_not_correct(cell, variant, cuda_device):
    cfg, tr = _cfg_tr(cell, batch=32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = controls.train_readings(cfg, tr, 2 ** 31 + 11, cuda_device, variant)
    assert not check.verdict(r, MAN.limits(cell)), r
