"""The int8 layer scans' CUDA source (`ops/csrc/lstm_scan_int8.cu`) built
with g++ against the CPU stand-in of the CUDA runtime (`tests/cuda_emu/`,
the warps' exchanges and the int8 tensor-core product `mma.m16n8k32`
emulated lane by lane) and run on the CPU.

The full-length entries (#4 `lstm_scan_int8`, #6 `bilstm_scan_int8`: a
thread-block cluster of H / 32 CTAs, w_hh in registers, the products on
the tensor cores) and the masked ones (#5 `lstm_scan_masked_int8`,
`bilstm_scan_masked_int8`: the masked variant of the same body) compute
the same exact int32 sums with the same roundings: under an all-ones mask
the two give the same bits. They are checked so at every M-tile count
(1 to 4), clusters of one to eight CTAs, B = 1, partial batch tiles,
nonzero h0 and a zero h0 row; and against the plain versions, the masked
ones under a ragged mask (an empty row, a full row, a batch tile whose
rows all end early) with exact zeros at masked steps. Also here: the int8
rows-per-cluster choice and the residency each entry asks, the wrappers'
arguments (int8 w_hh as it is, with the geometry's rows), and the
profiler groups of both kernels' names.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from mobileposer_tpu_torch import bench
from mobileposer_tpu_torch.ops import lstm_cuda
from mobileposer_tpu_torch.ops.quant import quantize_weight_int8
from test_torch_cuda_emulation import _call, _emu_build, _ragged_mask

# One step from h0: both sides quantize the same h0, so the recurrent term
# is the same exact product dequantized in the same order; only glibc's
# expf/tanhf against torch's CPU sigmoid/tanh can differ, in a last bit
# of values in [-1, 1] (chip_smoke.INT8_STEP_TOL).
STEP_TOL = 1e-6
# Over several steps such a last bit can move an h/scale across a rounding
# boundary and one int8 value by a level: a gate moves by <= max|w| *
# scale (5e-4 at H = 256), and the row carries it on; ten flips' worth
# (chip_smoke.INT8_KERNEL_TOL).
FULL_TOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def int8_lib(tmp_path_factory):
    """lstm_scan_int8.cu built for the CPU stand-in, its entries declared."""
    lib = _emu_build(tmp_path_factory, "lstm_scan_int8.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lstm_scan_int8.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.bilstm_scan_int8.argtypes = [P] * 16 + [I] * 4 + [P]
    lib.lstm_scan_masked_int8.argtypes = [P] * 9 + [I] * 4 + [P]
    lib.bilstm_scan_masked_int8.argtypes = [P] * 17 + [I] * 4 + [P]
    lib.lstm_scan_int8_max_clusters.argtypes = [I, I, ctypes.POINTER(I)]
    lib.lstm_scan_masked_int8_max_clusters.argtypes = [
        I, I, ctypes.POINTER(I)]
    return lib


def _inputs(rng, T, B, H, n_dir, zero_row=None):
    """Seeded inputs of one int8 layer scan, per direction (x_proj, int8
    w_hh, w_scale, h0, c0): w_hh drawn as torch.nn.LSTM draws it and
    quantized per column, h0 in (-1, 1) as a hidden state is; with
    `zero_row`, that row of h0 is zero (scale 1e-12 at t = 0)."""
    bound = 1.0 / np.sqrt(H)
    dirs = []
    for _ in range(n_dir):
        w_q, w_s = quantize_weight_int8(rng.uniform(-bound, bound,
                                                    (H, 4 * H)))
        h0 = np.tanh(rng.randn(B, H)).astype(np.float32)
        if zero_row is not None:
            h0[zero_row] = 0.0
        dirs.append((torch.from_numpy(rng.randn(T, B, 4 * H).astype(
                         np.float32)),
                     torch.from_numpy(w_q), torch.from_numpy(w_s),
                     torch.from_numpy(h0),
                     torch.from_numpy((rng.randn(B, H) * 0.5).astype(
                         np.float32))))
    return dirs


def _emu_scan(lib, dirs, rows, mask=None):
    """One int8 scan on the stand-in at `rows` rows per cluster: the
    full-length entry, or with `mask` the masked one; both directions in
    one launch when `dirs` holds two. Returns [ys, h_T, c_T] per
    direction."""
    T, B, H4 = dirs[0][0].shape
    H = H4 // 4
    ys = [torch.full((T, B, H), float("nan")) for _ in dirs]
    hc = [torch.full((B, H), float("nan")) for _ in range(2 * len(dirs))]
    xs = [d[0][:T].contiguous() for d in dirs]
    ws = [d[1] for d in dirs]
    scales = [d[2] for d in dirs]
    state = [v for d in dirs for v in d[3:]]
    m = () if mask is None else (mask,)
    ints = (T, B, H, rows)
    kind = "int8" if mask is None else "masked_int8"
    if len(dirs) == 1:
        _call(getattr(lib, f"lstm_scan_{kind}"), xs[0], ws[0], scales[0],
              *state, *m, *ys, *hc, *ints)
    else:
        _call(getattr(lib, f"bilstm_scan_{kind}"), *xs, *ws, *scales, *state,
              *m, *ys, *hc, *ints)
    return [[ys[i], hc[2 * i], hc[2 * i + 1]] for i in range(len(dirs))]


def _plain(dirs):
    """The plain version of each direction: [ys, h_T, c_T]."""
    out = []
    for x, w, s, h0, c0 in dirs:
        ys, (h_t, c_t) = lstm_cuda.lstm_layer_int8_plain(x, w, s, h0, c0)
        out.append([ys, h_t, c_t])
    return out


# every M-tile count (rows 1 to 64: MT = ceil(rows / 16) from 1 to 4),
# clusters of one to eight CTAs (H = 32 .. 256, one case at H = 256),
# B = 1, partial batch tiles (B % rows != 0), both entries, a zero h0 row
@pytest.mark.parametrize("n_dir,T,B,H,rows,zero_row", [
    (1, 3, 1, 32, 1, None), (2, 3, 7, 64, 3, 0), (1, 2, 20, 96, 17, 5),
    (2, 2, 33, 128, 32, None), (1, 2, 50, 160, 49, 49),
    (2, 2, 64, 192, 64, 1), (1, 2, 30, 224, 14, None),
    (2, 2, 37, 256, 37, 36)])
def test_full_length_equals_masked_under_all_ones(int8_lib, n_dir, T, B, H,
                                                  rows, zero_row):
    """The full-length entries against the masked variant of their body
    under an all-ones mask: the same exact int32 sums, the same roundings,
    the same bits."""
    rng = np.random.RandomState(n_dir + T + B + H + rows)
    dirs = _inputs(rng, T, B, H, n_dir, zero_row)
    full = _emu_scan(int8_lib, dirs, rows)
    masked = _emu_scan(int8_lib, dirs, rows, mask=torch.ones(T, B))
    for d, f, m in zip(("fwd", "bwd"), full, masked):
        for name, a, b in zip(("ys", "h_T", "c_T"), f, m):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f"{d} {name}")


@pytest.mark.parametrize("n_dir,B,H,rows", [
    (1, 1, 32, 1), (2, 21, 64, 21), (1, 40, 160, 40), (2, 37, 256, 37)])
def test_full_length_matches_plain_versions(int8_lib, n_dir, B, H, rows):
    """One step from a nonzero h0 within STEP_TOL, three steps within
    FULL_TOL of the plain versions."""
    rng = np.random.RandomState(300 + n_dir + B + H)
    dirs = _inputs(rng, 3, B, H, n_dir, zero_row=0)
    for T, tol in ((1, STEP_TOL), (3, FULL_TOL)):
        cut = [(x[:T].contiguous(), *rest) for x, *rest in dirs]
        got = _emu_scan(int8_lib, cut, rows)
        for d, g, w in zip(("fwd", "bwd"), got, _plain(cut)):
            for name, a, b in zip(("ys", "h_T", "c_T"), g, w):
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol,
                                           rtol=0, err_msg=f"T={T} {d} {name}")


# every M-tile count (rows 1 to 64), clusters of one to eight CTAs, B = 1
# (an empty row: no step at all), partial batch tiles, a zero h0 row; the
# ragged mask holds an empty row, a full row, a last batch tile whose rows
# all end early and one fractional value
@pytest.mark.parametrize("n_dir,T,B,H,rows,zero_row", [
    (1, 3, 1, 32, 1, None), (2, 4, 7, 64, 2, 3), (1, 4, 23, 96, 9, None),
    (2, 3, 37, 128, 17, 20), (1, 3, 50, 160, 33, None),
    (2, 3, 70, 192, 49, 1), (1, 4, 30, 224, 14, None),
    (2, 3, 75, 256, 64, 70)])
def test_masked_matches_plain_versions(int8_lib, n_dir, T, B, H, rows,
                                       zero_row):
    """The masked entries against the masked plain version, within
    FULL_TOL (STEP_TOL for one step's worth of flips is not promised over
    several steps), with exact zeros at masked steps and the state held
    through them."""
    rng = np.random.RandomState(400 + n_dir + T + B + H + rows)
    dirs = _inputs(rng, T, B, H, n_dir, zero_row)
    mask, _ = _ragged_mask(rng, T, B, rows)
    got = _emu_scan(int8_lib, dirs, rows, mask=mask)
    for d, (x, w, s, h0, c0), g in zip(("fwd", "bwd"), dirs, got):
        ys, (h_t, c_t) = lstm_cuda.lstm_layer_masked_int8_plain(x, w, s, h0,
                                                                c0, mask)
        for name, a, b in zip(("ys", "h_T", "c_T"), g, (ys, h_t, c_t)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=FULL_TOL,
                                       rtol=0, err_msg=f"{d} {name}")
        assert bool((g[0][mask == 0] == 0).all()), f"{d}: masked ys not 0"


def test_masked_tile_that_ends_early_holds_its_state(int8_lib):
    """A batch tile whose rows all end at step 1 of 4: its clusters stop
    there, write zeros from then on and return each row's state at its
    last valid frame, the same bits as the masked entry over just that
    frame; a row of length 0 returns h0 and c0 as they are."""
    T, B, H, rows = 4, 6, 64, 3
    dirs = _inputs(np.random.RandomState(7), T, B, H, 2)
    lengths = torch.tensor([4, 2, 3, 1, 1, 0])
    mask = (torch.arange(T)[:, None] < lengths[None]).float().contiguous()
    got = _emu_scan(int8_lib, dirs, rows, mask=mask)
    one = _emu_scan(int8_lib, [(x[:1].contiguous(), *rest)
                               for x, *rest in dirs],
                    rows, mask=mask[:1].contiguous())
    for (ys, h_t, c_t), (ys1, h1, c1), (_, _, _, h0, c0) in zip(got, one,
                                                                dirs):
        assert bool((ys[1:, 3:] == 0).all())
        assert torch.equal(ys[:1, 3:], ys1[:, 3:])
        assert torch.equal(h_t[3:5], h1[3:5]) and torch.equal(c_t[3:5],
                                                              c1[3:5])
        assert torch.equal(h_t[5], h0[5]) and torch.equal(c_t[5], c0[5])


def test_rows_outside_templates_are_refused(int8_lib):
    """rows outside [1, 64] return an error and launch nothing; the
    occupancy query takes the same rows."""
    for rows in (0, -1, 65, 100):
        for kind, n_uni, n_bi in (("", 8, 16), ("_masked", 9, 17)):
            assert getattr(int8_lib, f"lstm_scan{kind}_int8")(
                *([None] * n_uni), 2, 2, 64, rows, None) != 0
            assert getattr(int8_lib, f"bilstm_scan{kind}_int8")(
                *([None] * n_bi), 2, 2, 64, rows, None) != 0
            out = ctypes.c_int(-1)
            assert getattr(int8_lib, f"lstm_scan{kind}_int8_max_clusters")(
                64, rows, ctypes.byref(out)) != 0
    for kind in ("", "_masked"):
        out = ctypes.c_int(0)
        assert getattr(int8_lib, f"lstm_scan{kind}_int8_max_clusters")(
            256, 64, ctypes.byref(out)) == 0
        assert out.value == 132 // 8   # the stand-in's card


@pytest.mark.parametrize("n_dir,B,H,max_clusters,rows,clusters", [
    # the streaming shapes on a card that holds 15 clusters of 8 and 66 of
    # 2: bi B = 256 in 14 clusters of 37 rows (three M-tiles), the velocity
    # layer in 15 of 18, the unfolded chunk B = 200 in 14 of 29, its
    # velocity layer at B = 8 one row a cluster, H = 64 in 64 of 8 and 58
    # of 7
    (2, 256, 256, 15, 37, 14), (1, 256, 256, 15, 18, 15),
    (2, 200, 256, 15, 29, 14), (1, 8, 256, 15, 1, 8),
    (2, 256, 64, 66, 8, 64), (2, 200, 64, 66, 7, 58),
    # more clusters than ever fit: the most rows (64, four M-tiles), waves
    (2, 4096, 256, 15, 64, 128), (1, 8192, 64, 66, 64, 128)])
def test_int8_scan_geometry(n_dir, B, H, max_clusters, rows, clusters):
    geo = lstm_cuda._scan_geometry(n_dir, B, H, lambda r: max_clusters,
                                   int8=True)
    assert (geo.rows, geo.clusters, geo.cluster) == (rows, clusters, H // 32)
    assert geo.m_tiles == -(-rows // 16)
    assert geo.lane_rows is None and geo.lane_cols is None
    assert geo.smem == lstm_cuda.int8_scan_smem(H, rows)
    assert geo.smem <= lstm_cuda._SMEM_LIMIT


def test_int8_scan_smem():
    """The cluster body's shared memory at the main path's tile and at the
    largest: q padded to whole M-tiles with a conflict-free row stride, the
    sums, the partial maxima."""
    assert lstm_cuda.int8_scan_smem(256, 37) == 48 * 288 + 4 * 37 * (136 + 8)
    assert lstm_cuda.int8_scan_smem(160, 1) == 16 * 160 + 4 * (136 + 8)
    assert lstm_cuda.int8_scan_smem(256, 64) <= lstm_cuda._SMEM_LIMIT


def test_int8_scan_geometry_reads_residency_at_each_rows():
    """Residency is taken at each rows' own shared memory: a card whose
    cluster count falls as the tile grows gets the first rows that fits."""
    seen = []

    def max_clusters(rows):
        seen.append(rows)
        return 20 if rows < 20 else 14

    geo = lstm_cuda._scan_geometry(2, 256, 256, max_clusters, int8=True)
    assert geo.rows == 37 and seen == list(range(1, 38))


def test_int8_scan_geometry_asks_the_int8_kernel(monkeypatch):
    """The int8 entries' rows come from the residency of the int8 cluster
    kernel, the float ones' from their own."""
    asked = []

    def fake(H, rows, device_index, masked=False, int8=False):
        asked.append((masked, int8))
        return 15 if int8 else 1

    monkeypatch.setattr(lstm_cuda, "max_active_clusters", fake)
    lstm_cuda._scan_geometry_on.cache_clear()
    try:
        dev = torch.device("cuda", 0)
        assert lstm_cuda.scan_geometry(2, 256, 256, dev, int8=True).rows == 37
        assert set(asked) == {(False, True)}
        asked.clear()
        assert lstm_cuda.scan_geometry(2, 256, 256, dev).rows == 39
        assert set(asked) == {(False, False)}
    finally:
        lstm_cuda._scan_geometry_on.cache_clear()


def test_masked_int8_scans_have_no_residency_query(monkeypatch):
    """The masked int8 geometry asks the masked int8 kernel: at
    evaluation's shapes on a card that holds 15 clusters of 8 and 66 of 2,
    bi B = 64 at H = 256 takes 14 clusters of 10 rows (one M-tile), the
    velocity layer 13 of 5, footcontact (H = 64) 64 of 2, the 1024-frame
    bucket's B = 37 14 of 6."""
    asked = []

    def fake(H, rows, device_index, masked=False, int8=False):
        asked.append((masked, int8))
        return 66 if H == 64 else 15

    monkeypatch.setattr(lstm_cuda, "max_active_clusters", fake)
    lstm_cuda._scan_geometry_on.cache_clear()
    try:
        dev = torch.device("cuda", 0)
        for n_dir, B, H, rows, clusters in ((2, 64, 256, 10, 14),
                                            (1, 64, 256, 5, 13),
                                            (2, 64, 64, 2, 64),
                                            (2, 37, 256, 6, 14)):
            geo = lstm_cuda.scan_geometry(n_dir, B, H, dev, masked=True,
                                          int8=True)
            assert (geo.rows, geo.clusters, geo.m_tiles) == (rows, clusters,
                                                             1)
            assert geo.smem == lstm_cuda.int8_scan_smem(H, rows)
        assert set(asked) == {(True, True)}
    finally:
        lstm_cuda._scan_geometry_on.cache_clear()


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    kernel route (into a recording `_launch`)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' launches: (entry, inputs) each."""
    calls = []

    def launch(name, inputs, n_dir, T, B, H):
        calls.append((name, inputs))
        return ([torch.zeros(T, B, H)] * n_dir,
                [torch.zeros(B, H)] * (2 * n_dir))

    monkeypatch.setattr(lstm_cuda, "_launch", launch)
    return calls


def test_wrappers_pass_int8_w_hh_as_it_is(recorded):
    """Every int8 route, full-length and masked, hands the module's int8
    w_hh itself to the kernel."""
    T, B, H = 2, 3, 64
    rng = np.random.RandomState(0)
    (x, w, s, h0, c0), (xb, wb, sb, h0b, c0b) = [
        [t.as_subclass(_OnCard) for t in d]
        for d in _inputs(rng, T, B, H, 2)]
    mask = torch.ones(T, B).as_subclass(_OnCard)
    lstm_cuda.lstm_layer_int8(x, w, s, h0, c0)
    lstm_cuda.bilstm_layer_int8(x, xb, w, wb, s, sb, h0, c0, h0b, c0b)
    lstm_cuda.lstm_layer_masked_int8(x, w, s, h0, c0, mask)
    lstm_cuda.bilstm_layer_masked_int8(x, xb, w, wb, s, sb, h0, c0, h0b,
                                       c0b, mask)
    (uni, uni_in), (bi, bi_in), (muni, muni_in), (mbi, mbi_in) = recorded
    assert (uni, bi) == ("lstm_scan_int8", "bilstm_scan_int8")
    assert uni_in[1] is w
    assert bi_in[2] is w and bi_in[3] is wb
    assert (muni, mbi) == ("lstm_scan_masked_int8", "bilstm_scan_masked_int8")
    assert muni_in[1] is w
    assert mbi_in[2] is w and mbi_in[3] is wb
    assert muni_in[5] is mask and mbi_in[10] is mask


@pytest.mark.parametrize("name,n_ptr", [
    ("lstm_scan_int8", 8), ("bilstm_scan_int8", 16),
    ("lstm_scan_masked_int8", 9), ("bilstm_scan_masked_int8", 17)])
def test_launch_passes_the_int8_geometry_rows(monkeypatch, name, n_ptr):
    """`_launch` gives every int8 entry the rows of the int8 geometry after
    (T, B, H): the full-length one's, or the masked one's."""
    seen, geo_args = [], []

    def entry(*args):
        seen.append(args)
        return 0

    def geometry(n_dir, B, H, device, masked=False, int8=False):
        geo_args.append((masked, int8))
        return types.SimpleNamespace(rows=29)

    monkeypatch.setattr(lstm_cuda, "_lib",
                        lambda source: types.SimpleNamespace(**{name: entry}))
    monkeypatch.setattr(lstm_cuda, "scan_geometry", geometry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    n_dir = 2 if name.startswith("bi") else 1
    n_in = n_ptr - 3 * n_dir
    inputs = [torch.zeros(1) for _ in range(n_in)]
    monkeypatch.setitem(lstm_cuda.launches, name, 0)  # restored afterwards
    lstm_cuda._launch(name, inputs, n_dir, 4, 5, 64)
    (args,) = seen
    assert args[:n_in] == tuple(t.data_ptr() for t in inputs)
    assert args[n_ptr:] == (4, 5, 64, 29, 7)
    assert geo_args == [("masked" in name, True)]
    assert lstm_cuda.launches[name] == 1


@pytest.mark.parametrize("kernel,group", [
    ("void (anonymous namespace)::lstm_scan_int8_kernel<3>((anonymous "
     "namespace)::ClusterDir, (anonymous namespace)::ClusterDir, int, int, "
     "int, int)", "lstm_scan int8 (ops/csrc/lstm_scan_int8.cu)"),
    ("_ZN12_GLOBAL__N_121lstm_scan_int8_kernelILi3EEEvNS_10ClusterDirES1_"
     "iiii", "lstm_scan int8 (ops/csrc/lstm_scan_int8.cu)"),
    ("void (anonymous namespace)::lstm_scan_masked_int8_kernel<1>((anonymous "
     "namespace)::ClusterDir, (anonymous namespace)::ClusterDir, float "
     "const*, int, int, int, int)",
     "lstm_scan int8 masked (ops/csrc/lstm_scan_int8.cu)"),
    ("_ZN12_GLOBAL__N_128lstm_scan_masked_int8_kernelILi1EEEvNS_10ClusterDir"
     "ES1_PKfiiii", "lstm_scan int8 masked (ops/csrc/lstm_scan_int8.cu)"),
    ("void (anonymous namespace)::lstm_scan_kernel<10, 4>((anonymous "
     "namespace)::Dir, (anonymous namespace)::Dir, int, int, int, int)",
     "lstm_scan (ops/csrc/lstm_scan.cu)")])
def test_kernel_group(kernel, group):
    """The profiler's kernel names (demangled, or mangled) fall into their
    own groups: the int8 cluster scan, the masked int8 scan, the float
    scan."""
    assert bench._kernel_group(kernel) == group
