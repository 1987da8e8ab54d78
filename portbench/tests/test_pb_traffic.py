"""The generator of inputs: the same seed gives the same inputs, another
seed others, and seeds past 32 bits work."""

import pytest
import torch

from portbench import manifest, motion, weights

MAN = manifest.Manifest()
SEEDS = (0, 7, 2 ** 31 + 12345, 3 * 2 ** 32 + 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_table_is_seeded(seed):
    tr = MAN.traffic("stream512")
    tr.update(streams=8, period_ticks=32)
    a = motion.stream_table(tr, seed, "cpu")
    b = motion.stream_table(tr, seed, "cpu")
    c = motion.stream_table(tr, seed + 1, "cpu")
    assert a.shape == (32, 8, 60) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_stream_frames_wear_a_combination():
    tr = MAN.traffic("stream512")
    tr.update(streams=64, period_ticks=8)
    f = motion.stream_table(tr, 11, "cpu")
    acc = f[..., :15].reshape(8, 64, 5, 3)
    ori = f[..., 15:].reshape(8, 64, 5, 3, 3)
    worn = ori.abs().amax(dim=(0, 3, 4)) > 0                   # [64, 5]
    combos = {tuple(c) for c in tr["combos"]}
    for s in range(64):
        slots = tuple(int(i) for i in torch.nonzero(worn[s]).flatten())
        assert slots in combos
        assert (acc[:, s, ~worn[s]] == 0).all()
    # worn devices hold rotations
    r = ori[:, worn]
    eye = torch.eye(3).expand_as(r @ r.transpose(-1, -2))
    assert torch.allclose(r @ r.transpose(-1, -2), eye, atol=1e-5)


def test_frames_are_smooth():
    tr = MAN.traffic("stream512")
    tr.update(streams=4, period_ticks=64)
    f = motion.stream_table(tr, 5, "cpu")
    assert (f[1:] - f[:-1]).abs().max() < 0.5


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_train_pool_is_seeded(seed):
    tr = MAN.traffic("train256")
    tr.update(batch=3, window=10, pool=3)
    a = motion.train_pool(tr, seed, "cpu")
    b = motion.train_pool(tr, seed, "cpu")
    c = motion.train_pool(tr, seed + 1, "cpu")
    assert len(a) == 3
    for x, y, z in zip(a, b, c):
        assert x["imu"].shape == (3, 10, 60)
        assert x["pose_r6d"].shape == (3, 10, 24, 6)
        assert (x["lengths"] == 10).all()
        for k in x:
            assert torch.equal(x[k], y[k])
        assert not torch.equal(x["joints"], z["joints"])
    assert not torch.equal(a[0]["imu"], a[1]["imu"])


@pytest.mark.parametrize("config", ["mobileposer-f32", "mobileposer-bf16"])
def test_weights_are_seeded(config):
    cfg = MAN.config(config)
    a = weights.make_flat(cfg, 3, "cpu")
    assert a.numel() == cfg["parameters"] == 6674994
    assert a.dtype == weights.DTYPES[cfg["dtype"]]
    assert torch.equal(a, weights.make_flat(cfg, 3, "cpu"))
    assert not torch.equal(a, weights.make_flat(cfg, 4, "cpu"))
    v = weights.views(cfg, a)
    # uniform in +-1/sqrt(fan)
    assert float(v["joints"]["linear1.weight"].abs().max()) <= 60 ** -0.5
    assert float(v["poser"]["lstm.1.bwd.w_hh"].abs().max()) <= 256 ** -0.5
