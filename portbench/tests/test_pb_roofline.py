"""The roofline counts reproduce the bound column of PERF.md's kernel
table, and the model's FLOPs per frame the port's bench figure."""

import numpy as np
import pytest

from portbench import manifest, roofline

MAN = manifest.Manifest()


@pytest.mark.parametrize("n_dir,H,elem,want", [
    (2, 256, 4, 0.180),      # #1 at (45, 256, 256)
    (2, 64, 4, 0.0113),      # #1 at (45, 256, 64)
    (1, 256, 4, 0.090),      # #2 at (45, 256, 256)
    (2, 256, 2, 0.0182),     # #1's bf16 entry
    (2, 64, 2, 0.0045),      # #1's bf16 entry at H = 64
    (1, 256, 2, 0.0091),     # #2's bf16 entry
])
def test_scan_bounds(n_dir, H, elem, want):
    ms, by, _, _ = roofline.layer_bound(n_dir, 45, 256, H, elem_bytes=elem)
    assert ms == pytest.approx(want, rel=0.02)
    assert by == ("operations" if elem == 4 and H == 256 else
                  "bytes" if elem == 2 else by)


def _table_lengths(T=125, B=256, H=256):
    # the ragged lengths the kernel table's training rows were measured on
    rng = np.random.RandomState(7 + H + B)
    rng.randn(T, B, 4 * H)
    rng.uniform(size=(H, 4 * H))
    rng.randn(B, H)
    rng.randn(B, H)
    lengths = rng.randint(1, T, size=B)
    lengths[0], lengths[1] = 0, T
    return int(lengths.sum())


def test_train_bounds_of_the_table():
    b = roofline.train_bounds(125, 256, 256, _table_lengths())
    assert b["fwd"][0] == pytest.approx(0.119, rel=0.02)
    assert b["bwd"][0] == pytest.approx(0.238, rel=0.02)


def test_train_bounds_at_the_cells_full_windows():
    b = roofline.train_bounds(125, 256, 256, 125 * 256)
    assert b["fwd"][0] == pytest.approx(0.2504, rel=1e-3)
    assert b["bwd"][0] == pytest.approx(0.5008, rel=1e-3)
    cfg = MAN.config("mobileposer-f32")
    # ten layer-directions at H = 256 and four at 64, every frame valid
    assert roofline.train_bound_ms(cfg, 256, 125, "fwd") > 10 * 0.2504


def test_model_flops_per_frame():
    cfg = MAN.config("mobileposer-f32")
    assert roofline.model_flops_per_frame(cfg) == 13302784
    assert roofline.stream_scan_bound_ms(cfg, 256) == pytest.approx(
        2 * (0.180 + 0.180 + 0.0113 + 0.090), rel=0.02)
