"""The bf16-I/O entries of the float scans (`ops/csrc/lstm_scan.cu`'s
`*_bf16`, #1 to #3, and `ops/csrc/multicell_scan.cu`'s
`multicell_scan_bf16`, #9) built with g++ against the CPU stand-in of the
CUDA runtime (`tests/cuda_emu/`, with `cuda_bf16.h`: bf16 as its raw
bits, rounding to nearest even) and run on the CPU, as
`tests/test_torch_cuda_emulation.py` runs their float32 entries.

Checked here: each bf16 entry against its bf16 plain version (float32
carry and sums, h rounded to bf16 for the product, outputs rounded once);
the masked entries' hold of the float32 h through a mask with gaps (and
fractional values), with exact zeros at masked steps, and their bits under an all-ones mask equal to the full-length
entries'; the multicell entry equal to the per-module layer entries bit
for bit in both h layouts ('fused' equals 'auto' in bf16); and the
wrappers' choice of the bf16 entries, with the mask in the I/O dtype.

Bounds, in bf16 ulps of the largest magnitude of the output compared
(2^(floor(log2 max|x|) - 7)): the two sides compute the same float32
products (a product of two bf16 values is exact in float32) and differ
only in the order of the float32 sums and in the last bits of expf/tanhf
against torch's; an output that lands on the other side of a bf16
rounding boundary moves by one ulp, so one step is held to 1 ulp. Over a
few steps such a flip of h moves the next gates by one ulp of h times a
weight (|w| <= 1/sqrt(H)), far below an ulp, and the cell forgets it:
2 ulps.
"""

import contextlib
import ctypes
import math
import types

import numpy as np
import pytest
import torch

from mobileposer_tpu_torch.models.fused import _ROW_H
from mobileposer_tpu_torch.ops import lstm_cuda, multicell_cuda
from test_torch_cuda_emulation import _call, _emu_build

BF16 = torch.bfloat16
STEP_ULPS = 1
SCAN_ULPS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scan_lib(tmp_path_factory):
    """lstm_scan.cu built for the CPU stand-in, its bf16 entries
    declared."""
    lib = _emu_build(tmp_path_factory, "lstm_scan.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lstm_scan_bf16.argtypes = [P] * 7 + [I] * 4 + [P]
    lib.bilstm_scan_bf16.argtypes = [P] * 14 + [I] * 4 + [P]
    lib.lstm_scan_masked_bf16.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.bilstm_scan_masked_bf16.argtypes = [P] * 15 + [I] * 4 + [P]
    return lib


@pytest.fixture(scope="module")
def multicell_lib(tmp_path_factory):
    """multicell_scan.cu built for the CPU stand-in, its bf16 entry
    declared."""
    lib = _emu_build(tmp_path_factory, "multicell_scan.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.multicell_scan_bf16.argtypes = [P] * 8 + [I] * 5 + [P]
    return lib


def _inputs(rng, T, B, H, n_dir):
    """Seeded bf16 inputs of one layer scan, per direction (x_proj, w_hh,
    h0, c0): w_hh drawn as torch.nn.LSTM draws it, h0 in (-1, 1)."""
    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)

    bound = 1.0 / math.sqrt(H)
    return [(bf(rng.randn(T, B, 4 * H)),
             bf(rng.uniform(-bound, bound, (H, 4 * H))),
             bf(np.tanh(rng.randn(B, H))), bf(rng.randn(B, H) * 0.5))
            for _ in range(n_dir)]


def _emu_scan(lib, dirs, rows, mask=None):
    """One bf16 scan on the stand-in: the full-length entry, or with
    `mask` (bf16) the masked one; both directions in one launch
    when `dirs` holds two. Returns [ys, h_T, c_T] per direction."""
    T, B, H4 = dirs[0][0].shape
    H = H4 // 4
    ys = [torch.full((T, B, H), float("nan"), dtype=BF16) for _ in dirs]
    hc = [torch.full((B, H), float("nan"), dtype=BF16)
          for _ in range(2 * len(dirs))]
    ints = (T, B, H, rows)
    m = ()
    kind = "bf16"
    if mask is not None:
        m, kind = (mask,), "masked_bf16"
    if len(dirs) == 1:
        (x, w, h0, c0), = dirs
        _call(getattr(lib, f"lstm_scan_{kind}"), x, w, h0, c0, *m, *ys, *hc,
              *ints)
    else:
        (xf, wf, h0f, c0f), (xb, wb, h0b, c0b) = dirs
        _call(getattr(lib, f"bilstm_scan_{kind}"), xf, xb, wf, wb, h0f, c0f,
              h0b, c0b, *m, *ys, *hc, *ints)
    return [[ys[i], hc[2 * i], hc[2 * i + 1]] for i in range(len(dirs))]


def _ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the largest magnitude of x."""
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


def _assert_ulps(got, want, ulps, what):
    assert got.dtype == want.dtype == BF16, what
    err = float((got.float() - want.float()).abs().max())
    assert err <= ulps * _ulp(want), f"{what}: {err} > {ulps} ulps"


def _plain(dirs, mask=None):
    out = []
    for x, w, h0, c0 in dirs:
        ys, (h_t, c_t) = (lstm_cuda.lstm_layer_plain(x, w, h0, c0)
                          if mask is None else
                          lstm_cuda.lstm_layer_masked_plain(x, w, h0, c0,
                                                            mask))
        out.append([ys, h_t, c_t])
    return out


# one step (1 ulp), then every few rows-per-lane templates over a few
# steps: one column a lane (rows <= 2), clusters of one to eight CTAs,
# partial batch tiles, both entries; from nine rows a lane (rows 33 on)
# the bf16 body's own product addressing
@pytest.mark.parametrize("n_dir,T,B,H,rows", [
    (2, 1, 9, 64, 4), (1, 1, 37, 256, 37), (1, 3, 1, 32, 1),
    (2, 3, 11, 64, 6), (1, 3, 20, 96, 9), (2, 2, 30, 160, 17),
    (1, 2, 29, 224, 29), (1, 2, 34, 128, 34), (2, 2, 39, 256, 39)])
def test_bf16_scans_match_plain_versions(scan_lib, n_dir, T, B, H, rows):
    rng = np.random.RandomState(n_dir + T + B + H + rows)
    dirs = _inputs(rng, T, B, H, n_dir)
    ulps = STEP_ULPS if T == 1 else SCAN_ULPS
    for d, g, w in zip(("fwd", "bwd"), _emu_scan(scan_lib, dirs, rows),
                       _plain(dirs)):
        for name, a, b in zip(("ys", "h_T", "c_T"), g, w):
            _assert_ulps(a, b, ulps, f"{d} {name}")


def _gapped_mask(rng, T, B, fractions):
    """A bf16 [T, B] mask with gaps (zeros between valid frames), with
    `fractions` also fractional values (a masked step's blend then reads
    the held float32 h), an empty row, a full row and a row whose last
    frames are masked."""
    mask = (rng.rand(T, B) < 0.6).astype(np.float32)
    if fractions:
        mask[rng.rand(T, B) < 0.2] = 0.5
    mask[:, 0] = 0.0
    if B > 1:
        mask[:, 1] = 1.0
    if B > 2:
        mask[T // 2:, 2] = 0.0
    return torch.from_numpy(mask).to(BF16)


@pytest.mark.parametrize("fractions", [True, False],
                         ids=["bf16_mask", "bf16_binary_mask"])
@pytest.mark.parametrize("n_dir,T,B,H,rows", [
    (1, 6, 5, 64, 2), (2, 5, 13, 96, 7), (1, 5, 23, 160, 23),
    (1, 4, 34, 96, 34), (2, 4, 40, 128, 37)])
def test_bf16_masked_scans_hold_the_f32_h(scan_lib, n_dir, T, B, H, rows,
                                          fractions):
    """The masked bf16 entries against the masked plain version through a
    mask with gaps, with and without fractional values, and masked steps
    emitting exactly zero. The blend of a fractional step reads the float32 h each
    cell item holds. A body that blended the bf16-rounded h of the
    exchange buffer instead stays within the ulp bound (the two h differ
    by half an ulp at most) but moves 4 to 10% of h_T off the plain
    version's bits on these inputs, so at least 99% of each output must
    equal the plain version's bits (the order of the float32 sums and
    expf/tanhf move at most 0.3% here)."""
    rng = np.random.RandomState(200 + n_dir + T + B + H + rows)
    dirs = _inputs(rng, T, B, H, n_dir)
    mask = _gapped_mask(rng, T, B, fractions)
    got = _emu_scan(scan_lib, dirs, rows, mask)
    for d, g, w in zip(("fwd", "bwd"), got, _plain(dirs, mask)):
        for name, a, b in zip(("ys", "h_T", "c_T"), g, w):
            _assert_ulps(a, b, SCAN_ULPS, f"{d} {name}")
            off = float((a != b).float().mean())
            assert off <= 0.01, f"{d} {name}: {off:.2%} off the plain bits"
        assert bool((g[0][mask == 0] == 0).all()), f"{d}: masked ys"


@pytest.mark.parametrize("n_dir,T,B,H,rows", [
    (2, 3, 7, 64, 2), (1, 3, 21, 256, 11), (2, 2, 45, 128, 40)])
def test_bf16_masked_equals_full_length_under_all_ones(scan_lib, n_dir, T,
                                                       B, H, rows):
    """Under an all-ones mask the masked bf16 body gives the full-length
    bf16 entries' bits (blend(1, a, b) = a, 1 * h = h)."""
    rng = np.random.RandomState(300 + n_dir + B + H)
    dirs = _inputs(rng, T, B, H, n_dir)
    full = _emu_scan(scan_lib, dirs, rows)
    masked = _emu_scan(scan_lib, dirs, rows, torch.ones(T, B, dtype=BF16))
    for g, w in zip(masked, full):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


def _emu_multicell(lib, cells, rows, h_buffers):
    T, B, _ = cells[0][0].shape
    hs = [c[1].shape[0] for c in cells]
    x = torch.cat([c[0] for c in cells], dim=-1).contiguous()
    outs = [[torch.full((T, B, H), float("nan"), dtype=BF16) for H in hs],
            [torch.full((B, H), float("nan"), dtype=BF16) for H in hs],
            [torch.full((B, H), float("nan"), dtype=BF16) for H in hs]]

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))

    assert lib.multicell_scan_bf16(
        x.data_ptr(), *(ptrs([c[i] for c in cells]) for i in (1, 2, 3)),
        *(ptrs(o) for o in outs), (ctypes.c_int * len(hs))(*hs), len(hs), T,
        B, rows, h_buffers, None) == 0
    return [[outs[0][i], outs[1][i], outs[2][i]] for i in range(len(hs))]


# the trio's five cells at one row a group (one column a lane), three and
# twenty rows (four columns in sixteen row groups), in both h layouts
@pytest.mark.parametrize("h_buffers", [2, 1])
@pytest.mark.parametrize("B,rows", [(3, 1), (5, 3), (21, 20)])
def test_bf16_fused_equals_auto_bit_for_bit(scan_lib, multicell_lib, B,
                                            rows, h_buffers):
    """The bf16 multicell entry gives each cell the bits of the
    per-module bf16 layer entry at its own rows: one body, one order of
    summation, the same rounding of h (forward(backend='fused') equals
    'auto' in bf16)."""
    T = 2
    rng = np.random.RandomState(19 + B + rows)
    cells = [_inputs(rng, T, B, H, 1)[0] for H in _ROW_H]
    got = _emu_multicell(multicell_lib, cells, rows, h_buffers)
    per_module = []
    for pair in ((0, 1), (2, 3), (4,)):
        dirs = [cells[i] for i in pair]
        geo = lstm_cuda._scan_geometry(len(dirs), B, dirs[0][1].shape[0],
                                       lambda r: 15)
        per_module += _emu_scan(scan_lib, dirs, geo.rows)
    for i, (g, w) in enumerate(zip(got, per_module)):
        for name, a, b in zip(("ys", "h_T", "c_T"), g, w):
            assert torch.equal(a, b), f"cell {i} (H = {_ROW_H[i]}) {name}"


def test_bf16_multicell_matches_plain_version(multicell_lib):
    """The bf16 multicell entry against `multicell_lstm_plain` on the
    trio's cells over four steps, a partial batch tile in every cell."""
    T, B = 4, 19
    rng = np.random.RandomState(22)
    cells = [_inputs(rng, T, B, H, 1)[0] for H in _ROW_H]
    got = _emu_multicell(multicell_lib, cells, 17, 1)
    want = multicell_cuda.multicell_lstm_plain(
        torch.cat([c[0] for c in cells], dim=-1), [c[1] for c in cells],
        [c[2] for c in cells], [c[3] for c in cells], _ROW_H)
    for i, g in enumerate(got):
        for name, a, b in zip(("ys", "h_T", "c_T"), g,
                              (want[0][i], want[1][i], want[2][i])):
            _assert_ulps(a, b, SCAN_ULPS, f"cell {i} {name}")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    kernel route."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_bf16_wrappers_launch_the_bf16_entries(monkeypatch):
    """bf16 inputs take the *_bf16 entries (float32 ones the *_f32), with
    the mask as it is, in the I/O dtype."""
    calls = []

    def launch(name, inputs, n_dir, T, B, H):
        calls.append((name, inputs))
        return ([torch.zeros(T, B, H)] * n_dir,
                [torch.zeros(B, H)] * (2 * n_dir))

    monkeypatch.setattr(lstm_cuda, "_launch", launch)
    T, B, H = 2, 3, 64
    rng = np.random.RandomState(0)
    for dtype, suffix in ((BF16, "bf16"), (torch.float32, "f32")):
        (x, w, h0, c0), (xb, wb, h0b, c0b) = [
            [t.to(dtype).as_subclass(_OnCard) for t in d]
            for d in _inputs(rng, T, B, H, 2)]
        mask = torch.ones(T, B, dtype=dtype).as_subclass(_OnCard)
        calls.clear()
        lstm_cuda.lstm_layer(x, w, h0, c0)
        lstm_cuda.bilstm_layer(x, xb, w, wb, h0, c0, h0b, c0b)
        lstm_cuda.lstm_layer_masked(x, w, h0, c0, mask)
        lstm_cuda.bilstm_layer_masked(x, xb, w, wb, h0, c0, h0b, c0b, mask)
        names = [c[0] for c in calls]
        assert names == [f"lstm_scan_{suffix}", f"bilstm_scan_{suffix}",
                         f"lstm_scan_masked_{suffix}",
                         f"bilstm_scan_masked_{suffix}"]
        for _, inputs in calls[2:]:
            assert inputs[-1] is mask


@pytest.mark.parametrize("name,n_ptr", [
    ("lstm_scan_bf16", 7), ("bilstm_scan_bf16", 14),
    ("lstm_scan_masked_bf16", 8), ("bilstm_scan_masked_bf16", 15)])
def test_launch_passes_the_bf16_arguments(monkeypatch, name, n_ptr):
    """`_launch` allocates the outputs in bf16 and gives a bf16 entry the
    float geometry's rows after (T, B, H), then the stream; the launch
    counts under the bf16 entry's name."""
    seen, geo_args, allocated = [], [], []

    def entry(*args):
        seen.append(args)
        return 0

    def geometry(n_dir, B, H, device, masked=False, int8=False):
        geo_args.append((masked, int8))
        return types.SimpleNamespace(rows=29)

    def empty(shape, dtype=None, device=None):
        allocated.append(dtype)
        return torch.zeros(shape, dtype=dtype)

    monkeypatch.setattr(lstm_cuda, "_lib",
                        lambda source: types.SimpleNamespace(**{name: entry}))
    monkeypatch.setattr(lstm_cuda, "scan_geometry", geometry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch, "empty", empty)
    n_dir = 2 if name.startswith("bi") else 1
    n_in = n_ptr - 3 * n_dir
    inputs = [torch.zeros(1, dtype=BF16) for _ in range(n_in)]
    monkeypatch.setitem(lstm_cuda.launches, name, 0)  # restored afterwards
    lstm_cuda._launch(name, inputs, n_dir, 4, 5, 64)
    (args,) = seen
    assert args[:n_in] == tuple(t.data_ptr() for t in inputs)
    assert args[n_ptr:] == (4, 5, 64, 29, 7)
    assert geo_args == [("masked" in name, False)]
    assert allocated == [BF16] * (3 * n_dir)
    assert lstm_cuda.launches[name] == 1


def test_wrappers_refuse_mixed_dtypes():
    """One I/O dtype per call: a bf16 x_proj beside a float32 w_hh (or
    state, or the other direction, or the mask) is refused, as is a
    float16 one."""
    rng = np.random.RandomState(1)
    (x, w, h0, c0), (xb, wb, h0b, c0b) = _inputs(rng, 2, 3, 32, 2)
    with pytest.raises(ValueError, match="w_hh"):
        lstm_cuda.lstm_layer(x, w.float(), h0, c0)
    with pytest.raises(ValueError, match="c0"):
        lstm_cuda.lstm_layer(x, w, h0, c0.float())
    with pytest.raises(ValueError, match="backward"):
        lstm_cuda.bilstm_layer(x, xb.float(), w, wb.float(), h0, c0,
                               h0b.float(), c0b.float())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lstm_cuda.lstm_layer(x.half(), w.half(), h0.half(), c0.half())
    with pytest.raises(ValueError, match="mask must be float32"):
        lstm_cuda.lstm_layer_masked(x.float(), w.float(), h0.float(),
                                    c0.float(), torch.ones(2, 3, dtype=BF16))
    with pytest.raises(ValueError, match="mask must be bfloat16"):
        lstm_cuda.lstm_layer_masked(x, w, h0, c0, torch.ones(2, 3))
    ys, _ = lstm_cuda.lstm_layer_masked(x, w, h0, c0,
                                        torch.ones(2, 3, dtype=BF16))
    assert ys.dtype == BF16
    with pytest.raises(ValueError, match="w_hh"):
        multicell_cuda.multicell_lstm(
            torch.cat([x, x], -1), [w, w.float()], [h0, h0], [c0, c0],
            (32, 32))


@pytest.mark.parametrize("kernel,group", [
    ("void (anonymous namespace)::lstm_scan_kernel<10, 4, __nv_bfloat16>("
     "(anonymous namespace)::Dir<__nv_bfloat16>, (anonymous namespace)::"
     "Dir<__nv_bfloat16>, int, int, int, int)",
     "lstm_scan (ops/csrc/lstm_scan.cu) bf16"),
    ("_ZN12_GLOBAL__N_123lstm_scan_masked_kernelILi3ELi4E13__nv_bfloat16EE"
     "vNS_3DirIT1_EES4_PKS3_iiii",
     "lstm_scan masked (ops/csrc/lstm_scan.cu) bf16"),
    ("void (anonymous namespace)::multicell_scan_kernel<4, 4, 16, true, "
     "__nv_bfloat16>((anonymous namespace)::Cells<__nv_bfloat16>, int, int,"
     " int)", "#9 multicell_scan (ops/csrc/multicell_scan.cu) bf16"),
    ("void (anonymous namespace)::lstm_scan_kernel<10, 4, float>((anonymous "
     "namespace)::Dir<float>, (anonymous namespace)::Dir<float>, int, int, "
     "int, int)", "lstm_scan (ops/csrc/lstm_scan.cu)")])
def test_bf16_kernel_group(kernel, group):
    """The profiler groups of `bench` tell the bf16 entries' kernels from
    the float32 ones'."""
    from mobileposer_tpu_torch import bench
    assert bench._kernel_group(kernel) == group
