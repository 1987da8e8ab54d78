"""The cluster kernels' CUDA sources (`ops/csrc/lstm_train.cu`, the
training scans and the dW reduction; `ops/csrc/lstm_scan.cu`, the
full-length and masked layer scans; `ops/csrc/multicell_scan.cu`, the
multicell scan on the same body) built with g++ against a CPU stand-in
for the CUDA runtime (`tests/cuda_emu/`) and run on the CPU: every CUDA
thread an OS thread, the block and cluster barriers real barriers,
distributed shared memory mapped between the blocks' buffers, cp.async a
plain copy. This checks the kernels' indexing, their thread-block cluster
exchange and their barriers (not the card's memory model, nor what nvcc
accepts) against the plain versions, at small shapes that cover every
rows-per-cluster template, partial batch tiles, clusters of one to eight
CTAs and, for training and the masked scans, a ragged mask with an empty
and a full row. The multicell scan is held to the layer scans bit for
bit, in both of its h layouts.

The stand-in does not contract a*b + c into FMAs as nvcc does, so values
differ from the plain versions by float32 rounding over a few steps: 1e-5
(the chip check's TRAIN_TOL and KERNEL_TOL).
"""

import contextlib
import ctypes
import math
import re
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from mobileposer_tpu_torch.models.fused import _ROW_H
from mobileposer_tpu_torch.ops import _build, lstm_cuda, multicell_cuda
from mobileposer_tpu_torch.ops import lstm_train_cuda as train_cuda

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _emu_source(src: str) -> str:
    """A source's dynamic shared memory and `<<<...>>>` launches rewritten
    for the stand-in."""
    src = src.replace("extern __shared__ float4 smem[];",
                      "float4* smem = emu_smem();")
    return re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),.*?>>>\(",
                  r"emu_launch(\2, \3, \4, \1, ", src, flags=re.S)


def _emu_build(tmp_path_factory, source: str, edits=()) -> ctypes.CDLL:
    """`csrc/<source>` built for the CPU stand-in: it and the shared
    headers the stand-in has no copy of rewritten (`_emu_source`), after
    each (old, new) of `edits` is applied to the source."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the CPU stand-in")
    src = (_build.CSRC_DIR / source).read_text()
    for old, new in edits:
        assert old in src, old
        src = src.replace(old, new)
    d = tmp_path_factory.mktemp("cuda_emu")
    for header in _build.CSRC_DIR.glob("*.cuh"):
        if not (EMU_DIR / header.name).exists():
            (d / header.name).write_text(_emu_source(header.read_text()))
    stem = Path(source).stem
    (d / f"{stem}_emu.cpp").write_text(_emu_source(src))
    out = d / f"lib{stem}_emu.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(EMU_DIR), "-I", str(_build.CSRC_DIR), "-include",
         "cuda_runtime.h", "-o", str(out), str(d / f"{stem}_emu.cpp"),
         "-lpthread"],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    """lstm_train.cu built for the CPU stand-in, its entries declared."""
    lib = _emu_build(tmp_path_factory, "lstm_train.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lstm_train_fwd_f32.argtypes = [P] * 11 + [I] * 4 + [P]
    lib.lstm_train_bwd_f32.argtypes = [P] * 11 + [I] * 4 + [P]
    lib.lstm_train_dw_f32.argtypes = [P] * 3 + [I] * 4 + [P]
    return lib


def _call(fn, *args) -> None:
    assert fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args), None) == 0


@pytest.mark.parametrize("T,B,H,rows", [
    (4, 3, 32, 1), (4, 5, 64, 2), (5, 37, 96, 4), (4, 9, 160, 8),
    (3, 30, 64, 12), (3, 20, 64, 16), (3, 37, 96, 18), (3, 41, 128, 20),
    (3, 50, 64, 24), (3, 33, 256, 32)])
def test_cluster_kernels_match_plain_versions(emu_lib, T, B, H, rows):
    rng = np.random.RandomState(T + B + H + rows)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32))

    bound = 1.0 / math.sqrt(H)
    x_proj = t(T, B, 4 * H)
    w_hh = torch.from_numpy(rng.uniform(-bound, bound, (H, 4 * H)).astype(
        np.float32))
    h0, c0 = t(B, H, scale=0.5), t(B, H, scale=0.5)
    lengths = rng.randint(1, T, size=B)
    lengths[0] = 0
    if B > 1:
        lengths[1] = T
    mask = (torch.arange(T)[:, None] < torch.from_numpy(lengths)[None]
            ).float().contiguous()

    fwd = [torch.full((T, B, n), float("nan")) for n in (H, 4 * H, H, H)]
    fwd += [torch.full((B, H), float("nan")) for _ in range(2)]
    _call(emu_lib.lstm_train_fwd_f32, x_proj, w_hh, h0, c0, mask, *fwd,
          T, B, H, rows)
    want = train_cuda.lstm_train_fwd_plain(x_proj, w_hh, h0, c0, mask)
    for name, g, w in zip(("ys", "acts", "hseq", "cseq", "h_T", "c_T"),
                          fwd, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL,
                                   err_msg=name)
    assert bool((fwd[0][mask == 0] == 0).all())     # exactly zero

    _, acts, hseq, cseq, _, _ = fwd
    dy, dh_t, dc_t = t(T, B, H), t(B, H), t(B, H)
    h_prev = torch.cat([h0[None], hseq[:-1]]).contiguous()
    c_prev = torch.cat([c0[None], cseq[:-1]]).contiguous()
    bwd = [torch.full((T, B, 4 * H), float("nan"))]
    bwd += [torch.full((B, H), float("nan")) for _ in range(2)]
    _call(emu_lib.lstm_train_bwd_f32, dy, dh_t, dc_t, acts, cseq, c_prev,
          w_hh, mask, *bwd, T, B, H, rows)
    dx, dw, dh0, dc0 = train_cuda.lstm_train_bwd_plain(
        dy, dh_t, dc_t, acts, cseq, h_prev, c_prev, w_hh, mask)
    for name, g, w in zip(("dx_proj", "dh0", "dc0"), bwd, (dx, dh0, dc0)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL,
                                   err_msg=name)

    # the dW reduction on the scan's dgates, in the wrapper's slabs
    n_slabs, per_slab = train_cuda._dw_slabs(T * B, H)
    slabs = torch.full((n_slabs, H, 4 * H), float("nan"))
    _call(emu_lib.lstm_train_dw_f32, h_prev, bwd[0], slabs, T * B, H,
          n_slabs, per_slab)
    np.testing.assert_allclose(slabs.sum(0).numpy(), dw.numpy(),
                               atol=TOL * float(dw.abs().max()))


def test_unsupported_rows_are_refused(emu_lib):
    """A rows value the kernels are not built for returns an error (the
    wrapper raises on it) and launches nothing."""
    for rows in (0, 3, 17, 64):
        assert emu_lib.lstm_train_fwd_f32(*([None] * 11), 2, 2, 64, rows,
                                          None) != 0
        assert emu_lib.lstm_train_bwd_f32(*([None] * 11), 2, 2, 64, rows,
                                          None) != 0


@pytest.fixture(scope="module")
def scan_lib(tmp_path_factory):
    """lstm_scan.cu built for the CPU stand-in, its entries declared."""
    lib = _emu_build(tmp_path_factory, "lstm_scan.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lstm_scan_f32.argtypes = [P] * 7 + [I] * 4 + [P]
    lib.bilstm_scan_f32.argtypes = [P] * 14 + [I] * 4 + [P]
    lib.lstm_scan_masked_f32.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.bilstm_scan_masked_f32.argtypes = [P] * 15 + [I] * 4 + [P]
    lib.lstm_scan_max_clusters.argtypes = [I, I, ctypes.POINTER(I)]
    lib.lstm_scan_masked_max_clusters.argtypes = [I, I, ctypes.POINTER(I)]
    return lib


@pytest.fixture(scope="module")
def multicell_lib(tmp_path_factory):
    """multicell_scan.cu built for the CPU stand-in, its entries
    declared."""
    lib = _emu_build(tmp_path_factory, "multicell_scan.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.multicell_scan_f32.argtypes = [P] * 8 + [I] * 5 + [P]
    lib.multicell_scan_max_clusters.argtypes = [P, I, I, I,
                                                ctypes.POINTER(I)]
    return lib


def _scan_inputs(rng, T, B, H, n_dir):
    """Seeded inputs of one layer scan: per direction (x_proj, w_hh, h0,
    c0), w_hh drawn as torch.nn.LSTM draws it."""
    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32))

    bound = 1.0 / math.sqrt(H)
    return [(t(T, B, 4 * H),
             torch.from_numpy(rng.uniform(-bound, bound, (H, 4 * H)).astype(
                 np.float32)),
             t(B, H, scale=0.5), t(B, H, scale=0.5)) for _ in range(n_dir)]


def _emu_scan(lib, dirs, rows, mask=None):
    """One full-length scan (with `mask`, a masked one) on the stand-in,
    both directions in one launch when `dirs` holds two; returns [ys, h_T,
    c_T] per direction."""
    T, B, H4 = dirs[0][0].shape
    H = H4 // 4
    ys = [torch.full((T, B, H), float("nan")) for _ in dirs]
    hc = [torch.full((B, H), float("nan")) for _ in range(2 * len(dirs))]
    m = () if mask is None else (mask,)
    kind = "f32" if mask is None else "masked_f32"
    if len(dirs) == 1:
        (x, w, h0, c0), = dirs
        _call(getattr(lib, f"lstm_scan_{kind}"), x, w, h0, c0, *m, *ys, *hc,
              T, B, H, rows)
    else:
        (xf, wf, h0f, c0f), (xb, wb, h0b, c0b) = dirs
        _call(getattr(lib, f"bilstm_scan_{kind}"), xf, xb, wf, wb, h0f, c0f,
              h0b, c0b, *m, *ys, *hc, T, B, H, rows)
    return [[ys[i], hc[2 * i], hc[2 * i + 1]] for i in range(len(dirs))]


# every rows-per-thread template (rows 1 to 39: RT = ceil(rows / 4) from 1
# to 10), clusters of one to eight CTAs (H = 32 .. 256, H = 160 among them),
# B = 1 and partial batch tiles (B % rows != 0), both entries
@pytest.mark.parametrize("n_dir,T,B,H,rows", [
    (1, 3, 1, 32, 1), (2, 3, 11, 64, 6), (1, 3, 20, 96, 9),
    (2, 3, 13, 128, 13), (1, 3, 30, 160, 17), (2, 2, 22, 192, 22),
    (1, 3, 37, 160, 25), (2, 2, 29, 224, 29), (1, 3, 50, 64, 34),
    (2, 2, 39, 256, 39), (2, 2, 1, 256, 1), (2, 3, 37, 160, 3)])
def test_layer_scans_match_plain_versions(scan_lib, n_dir, T, B, H, rows):
    rng = np.random.RandomState(n_dir + T + B + H + rows)
    dirs = _scan_inputs(rng, T, B, H, n_dir)
    got = _emu_scan(scan_lib, dirs, rows)
    for d, (x, w, h0, c0), g in zip(("fwd", "bwd"), dirs, got):
        ys, (h_t, c_t) = lstm_cuda.lstm_layer_plain(x, w, h0, c0)
        for name, a, b in zip(("ys", "h_T", "c_T"), g, (ys, h_t, c_t)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL,
                                       err_msg=f"{d} {name}")


def _emu_multicell(lib, cells, rows, h_buffers=2):
    """One multicell scan on the stand-in over `cells` (per cell x_proj,
    w_hh, h0, c0) at `rows` rows a group in the h layout `h_buffers`;
    returns [ys, h_T, c_T] per cell."""
    T, B, _ = cells[0][0].shape
    hs = [c[1].shape[0] for c in cells]
    x = torch.cat([c[0] for c in cells], dim=-1).contiguous()
    outs = [[torch.full((T, B, H), float("nan")) for H in hs],
            [torch.full((B, H), float("nan")) for H in hs],
            [torch.full((B, H), float("nan")) for H in hs]]

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))

    assert lib.multicell_scan_f32(
        x.data_ptr(), *(ptrs([c[i] for c in cells]) for i in (1, 2, 3)),
        *(ptrs(o) for o in outs), (ctypes.c_int * len(hs))(*hs), len(hs), T,
        B, rows, h_buffers, None) == 0
    return [[outs[0][i], outs[1][i], outs[2][i]] for i in range(len(hs))]


# the trio's five cells (clusters of 8: one group at H = 256, four of 2
# CTAs at H = 64, the last ones past B) at one row a group (one column a
# lane in four row groups), three and twenty (four columns in sixteen row
# groups, one and two rows a lane); two H = 64 cells alone (clusters of
# 2); H = 96 beside 256 (two groups of 3 CTAs and two spare CTAs a
# cluster); each in both h layouts (double- and single-buffered)
@pytest.mark.parametrize("h_buffers", [2, 1])
@pytest.mark.parametrize("hs,B,rows", [
    (_ROW_H, 3, 1), (_ROW_H, 5, 3), (_ROW_H, 21, 20), ((64, 64), 7, 2),
    ((96, 256), 6, 2)])
def test_layer_scans_equal_multicell_bit_for_bit(scan_lib, multicell_lib,
                                                 hs, B, rows, h_buffers):
    """The multicell kernel runs the layer scans' body: each gate summed in
    one order (x_proj, then k ascending) and the cell update rounded
    alike, so each cell gives the same bits as the per-module launch at
    its own rows (the trio: poser bi at H = 256, footcontact bi at H = 64,
    velocity uni at H = 256; `forward(backend='fused')` equals 'auto')."""
    T = 2
    rng = np.random.RandomState(9 + B + rows)
    cells = [_scan_inputs(rng, T, B, H, 1)[0] for H in hs]
    got = _emu_multicell(multicell_lib, cells, rows, h_buffers)
    pairs = ((0, 1), (2, 3), (4,)) if hs == _ROW_H else [(i,) for i in
                                                         range(len(hs))]
    per_module = []
    for pair in pairs:
        dirs = [cells[i] for i in pair]
        geo = lstm_cuda._scan_geometry(len(dirs), B, dirs[0][1].shape[0],
                                       lambda r: 15)
        per_module += _emu_scan(scan_lib, dirs, geo.rows)
    for i, (g, w) in enumerate(zip(got, per_module)):
        for name, a, b in zip(("ys", "h_T", "c_T"), g, w):
            assert torch.equal(a, b), f"cell {i} (H = {hs[i]}) {name}"


def test_multicell_matches_plain_version(multicell_lib):
    """The multicell kernel against `multicell_lstm_plain` on the trio's
    cells, a partial batch tile in every cell."""
    T, B, hs = 4, 19, _ROW_H
    rng = np.random.RandomState(12)
    cells = [_scan_inputs(rng, T, B, H, 1)[0] for H in hs]
    got = _emu_multicell(multicell_lib, cells, 17)
    x = torch.cat([c[0] for c in cells], dim=-1)
    want = multicell_cuda.multicell_lstm_plain(
        x, [c[1] for c in cells], [c[2] for c in cells],
        [c[3] for c in cells], hs)
    for i, g in enumerate(got):
        for name, a, b in zip(("ys", "h_T", "c_T"), g,
                              (want[0][i], want[1][i], want[2][i])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL,
                                       err_msg=f"cell {i} {name}")


def test_multicell_rows_outside_templates_are_refused(multicell_lib):
    """rows outside [1, 64] (double-buffered [1, 48]), h layouts other than
    2 and 1 and hidden sizes the kernel does not take return an error and
    launch nothing; the occupancy query takes the same and is the stand-in
    card's for clusters of the widest cell."""
    hidden = (ctypes.c_int * 5)(*_ROW_H)
    for rows, h_buffers in ((0, 2), (-1, 1), (49, 2), (65, 1), (100, 1),
                            (4, 0), (4, 3)):
        assert multicell_lib.multicell_scan_f32(
            *([None] * 7), hidden, 5, 2, 2, rows, h_buffers, None) != 0
        out = ctypes.c_int(-1)
        assert multicell_lib.multicell_scan_max_clusters(
            hidden, 5, rows, h_buffers, ctypes.byref(out)) != 0
    bad = (ctypes.c_int * 2)(64, 48)
    assert multicell_lib.multicell_scan_f32(*([None] * 7), bad, 2, 2, 2, 4,
                                            2, None) != 0
    for h_buffers in (2, 1):
        out = ctypes.c_int(0)
        assert multicell_lib.multicell_scan_max_clusters(
            hidden, 5, 2, h_buffers, ctypes.byref(out)) == 0
        assert out.value == 132 // 8   # the stand-in's card


@pytest.mark.parametrize("B,hs,max_clusters,force,h_buffers,rows,clusters", [
    # the fused path on a card that holds 15 clusters of 8: double
    # buffered R <= 39 at H = 256, so B = 256 would take 3 x 7 + 2 x 2 = 25
    # clusters (two waves); single-buffered R = 64 fits one wave of
    # 3 x 4 + 2 x 1, and is taken; B = 8 one wave of 3 x 4 + 2 x 1 at R = 2
    # double-buffered; either layout forced
    (256, _ROW_H, 15, None, 1, 64, 14), (256, _ROW_H, 15, 2, 2, 39, 25),
    (256, _ROW_H, 15, 1, 1, 64, 14), (8, _ROW_H, 15, None, 2, 2, 14),
    (8, _ROW_H, 15, 1, 1, 2, 14),
    # more than one wave holds either way: single-buffered at 64 rows
    (4096, _ROW_H, 15, None, 1, 64, 224),
    # two H = 64 cells, clusters of 2 (66 of them): 2 x 32 at R = 8;
    # at B = 2048 double-buffered would need 63 rows, over its 48: single
    (256, (64, 64), 66, None, 2, 8, 64),
    (2048, (64, 64), 66, None, 1, 63, 66),
    # H = 96 beside 256: two groups a cluster at H = 96, 5 + 10 at R = 4
    (37, (96, 256), 15, None, 2, 4, 15)])
def test_multicell_geometry(B, hs, max_clusters, force, h_buffers, rows,
                            clusters):
    geo = multicell_cuda._multicell_geometry(
        B, hs, lambda r, h: max_clusters, force)
    assert (geo.rows, geo.clusters, geo.h_buffers) == (rows, clusters,
                                                       h_buffers)
    assert geo.cluster == max(hs) // 32
    assert geo.groups == tuple(geo.cluster // (H // 32) for H in hs)
    assert geo.row_groups == (4 if rows <= 2 else 16)
    assert geo.lane_rows == math.ceil(rows / geo.row_groups) <= 4
    assert geo.lane_cols == (1 if rows <= 2 else 4)
    assert geo.smem == max(lstm_cuda.scan_smem(H, rows, h_buffers)
                           for H in hs) <= lstm_cuda._SMEM_LIMIT


def test_multicell_geometry_reads_residency_at_each_rows():
    """Residency is taken at each rows' own shared memory in each layout,
    and the rows stop where the widest cell's shared memory stops
    fitting: double-buffered up to 39 rows, then single-buffered up to
    64."""
    seen = []

    def max_clusters(rows, h_buffers):
        seen.append((rows, h_buffers))
        return 10

    geo = multicell_cuda._multicell_geometry(256, _ROW_H, max_clusters)
    assert seen == ([(r, 2) for r in range(1, 40)]
                    + [(r, 1) for r in range(1, 65)])
    assert (geo.rows, geo.h_buffers) == (64, 1)
    assert multicell_cuda.multicell_smem(_ROW_H, 40, 2) > lstm_cuda._SMEM_LIMIT
    assert multicell_cuda.multicell_smem(_ROW_H, 64, 1) <= \
        lstm_cuda._SMEM_LIMIT


def test_multicell_wrapper_launches_with_the_geometry_rows(monkeypatch):
    """On a tensor that reports a CUDA device the wrapper launches the
    kernel with the rows and h layout of `multicell_geometry` after
    (n, T, B), and counts the launch."""
    import contextlib
    import types

    seen = []

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    def entry(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(multicell_cuda, "_lib", lambda: types.SimpleNamespace(
        multicell_scan_f32=entry))
    monkeypatch.setattr(multicell_cuda, "multicell_geometry",
                        lambda B, hs, dev: types.SimpleNamespace(
                            rows=29, h_buffers=1))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch, "empty", lambda shape, **kw: torch.zeros(
        shape))
    monkeypatch.setitem(multicell_cuda.launches, "multicell_scan_f32", 0)
    hs, T, B = (64, 32), 2, 3
    x = torch.zeros(T, B, 4 * sum(hs)).as_subclass(OnCard)
    ws = [torch.zeros(H, 4 * H).as_subclass(OnCard) for H in hs]
    st = [torch.zeros(B, H).as_subclass(OnCard) for H in hs]
    multicell_cuda.multicell_lstm(x, ws, st, st, hs)
    (args,) = seen
    assert args[0] == x.data_ptr() and args[-6:] == (2, T, B, 29, 1, 7)
    assert multicell_cuda.launches["multicell_scan_f32"] == 1


def test_layer_scan_rows_outside_templates_are_refused(scan_lib):
    """rows outside [1, 40] return an error and launch nothing; the
    occupancy query takes the same rows."""
    for rows in (0, -1, 41, 64):
        assert scan_lib.lstm_scan_f32(*([None] * 7), 2, 2, 64, rows,
                                      None) != 0
        assert scan_lib.bilstm_scan_f32(*([None] * 14), 2, 2, 64, rows,
                                        None) != 0
        out = ctypes.c_int(-1)
        assert scan_lib.lstm_scan_max_clusters(64, rows,
                                               ctypes.byref(out)) != 0
    out = ctypes.c_int(0)
    assert scan_lib.lstm_scan_max_clusters(160, 39, ctypes.byref(out)) == 0
    assert out.value == 132 // 5   # the stand-in's card


@pytest.mark.parametrize("n_dir,B,H,max_clusters,rows,clusters", [
    # the main path's shapes on a card that holds 15 clusters of 8 and 66
    # of 2: bi B = 256 in one wave of 14 (R = 32 would need 16, two waves)
    (2, 256, 256, 15, 37, 14), (1, 256, 256, 15, 18, 15),
    (2, 200, 256, 15, 29, 14), (1, 8, 256, 15, 1, 8),
    (2, 256, 64, 66, 8, 64), (2, 200, 64, 66, 7, 58),
    (1, 1, 160, 26, 1, 1), (2, 37, 160, 26, 3, 26),
    # more clusters than ever fit: the most rows whose shared memory fits
    # (39 at H = 256), in waves
    (2, 4096, 256, 15, 39, 212), (1, 4096, 64, 66, 40, 103)])
def test_scan_geometry(n_dir, B, H, max_clusters, rows, clusters):
    geo = lstm_cuda._scan_geometry(n_dir, B, H, lambda r: max_clusters)
    assert (geo.rows, geo.clusters, geo.cluster) == (rows, clusters, H // 32)
    assert geo.lane_rows == math.ceil(rows / 4)
    assert geo.lane_cols == (1 if rows <= 2 else 4)
    assert geo.smem == lstm_cuda.scan_smem(H, rows)
    assert geo.smem <= lstm_cuda._SMEM_LIMIT


def test_scan_geometry_reads_residency_at_each_rows():
    """Residency is taken at each rows' own shared memory: a card whose
    cluster count falls as the tile grows gets the first rows that fits."""
    seen = []

    def max_clusters(rows):
        seen.append(rows)
        return 20 if rows < 20 else 14

    geo = lstm_cuda._scan_geometry(2, 256, 256, max_clusters)
    assert geo.rows == 37 and seen == list(range(1, 38))
    assert lstm_cuda.scan_smem(256, 39) <= lstm_cuda._SMEM_LIMIT
    assert lstm_cuda.scan_smem(256, 40) > lstm_cuda._SMEM_LIMIT


def _ragged_mask(rng, T, B, rows):
    """A [T, B] mask of seeded lengths: row 0 empty, row 1 (if any) full,
    the rows of the last batch tile (when rows 0 and 1 are not in it) all
    ending before T - 1, and one valid frame of row 2 (or of the last row)
    at 0.5."""
    lengths = rng.randint(1, T + 1, size=B)
    last = (math.ceil(B / rows) - 1) * rows
    if last >= 2:
        lengths[last:] = np.minimum(lengths[last:], T - 2)
    lengths[0] = 0
    if B > 1:
        lengths[1] = T
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    frac = 2 if B > 2 else B - 1
    if lengths[frac] > 0:
        mask[0, frac] = 0.5
    return torch.from_numpy(mask), lengths


# every rows-per-lane template (rows 1 to 40: RT = ceil(rows / 4) from 1 to
# 10, one column a lane at rows <= 2), clusters of one to eight CTAs
# (H = 32 .. 256, H = 160 among them), B = 1 (an empty row: no step at all)
# and partial batch tiles (B % rows != 0), both entries
@pytest.mark.parametrize("n_dir,T,B,H,rows", [
    (1, 3, 1, 32, 1), (2, 4, 7, 64, 2), (1, 4, 11, 96, 4),
    (2, 4, 13, 128, 6), (1, 4, 23, 160, 11), (2, 3, 30, 192, 14),
    (1, 4, 37, 160, 18), (2, 3, 50, 224, 23), (1, 3, 60, 64, 27),
    (2, 3, 40, 256, 31), (1, 3, 70, 96, 35), (2, 3, 45, 128, 40)])
def test_masked_scans_match_plain_versions(scan_lib, n_dir, T, B, H, rows):
    """The masked entries against the masked plain scan: exact zeros at
    masked steps, the state held through them, a fractional mask blending,
    and the tiles whose rows all end early stopping there."""
    rng = np.random.RandomState(100 + n_dir + T + B + H + rows)
    dirs = _scan_inputs(rng, T, B, H, n_dir)
    mask, _ = _ragged_mask(rng, T, B, rows)
    got = _emu_scan(scan_lib, dirs, rows, mask)
    for d, (x, w, h0, c0), g in zip(("fwd", "bwd"), dirs, got):
        ys, (h_t, c_t) = lstm_cuda.lstm_layer_masked_plain(x, w, h0, c0,
                                                           mask)
        for name, a, b in zip(("ys", "h_T", "c_T"), g, (ys, h_t, c_t)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL,
                                       err_msg=f"{d} {name}")
        assert bool((g[0][mask == 0] == 0).all()), f"{d}: masked ys not 0"


@pytest.mark.parametrize("n_dir,T,B,H,rows", [
    (2, 3, 5, 64, 1), (1, 3, 9, 160, 5), (2, 2, 21, 256, 21)])
def test_masked_scans_equal_full_length_under_all_ones(scan_lib, n_dir, T,
                                                       B, H, rows):
    """With every m = 1 the blend keeps the new state and ys = 1 * h, so
    the masked entries give the full-length entries' bits."""
    rng = np.random.RandomState(200 + n_dir + B + H)
    dirs = _scan_inputs(rng, T, B, H, n_dir)
    full = _emu_scan(scan_lib, dirs, rows)
    masked = _emu_scan(scan_lib, dirs, rows, torch.ones(T, B))
    for d, f, m in zip(("fwd", "bwd"), full, masked):
        for name, a, b in zip(("ys", "h_T", "c_T"), m, f):
            assert torch.equal(a, b), f"{d} {name}"


def test_masked_scan_rows_outside_templates_are_refused(scan_lib):
    """The masked entries take the full-length entries' rows, and their
    occupancy query the same."""
    for rows in (0, -1, 41, 64):
        assert scan_lib.lstm_scan_masked_f32(*([None] * 8), 2, 2, 64, rows,
                                             None) != 0
        assert scan_lib.bilstm_scan_masked_f32(*([None] * 15), 2, 2, 64,
                                               rows, None) != 0
        out = ctypes.c_int(-1)
        assert scan_lib.lstm_scan_masked_max_clusters(
            64, rows, ctypes.byref(out)) != 0
    out = ctypes.c_int(0)
    assert scan_lib.lstm_scan_masked_max_clusters(256, 10,
                                                  ctypes.byref(out)) == 0
    assert out.value == 132 // 8   # the stand-in's card


@pytest.mark.parametrize("n_dir,B,H,max_clusters,rows,clusters", [
    # the evaluation shapes on a card that holds 15 clusters of 8 and 66
    # of 2: bi B = 64 at H = 256 in 14 clusters of 10 (9 rows would need
    # 16), the velocity layer in 13 of 5, footcontact in 64 of 2, the
    # 1024-frame bucket's B = 37 in 14 of 6
    (2, 64, 256, 15, 10, 14), (1, 64, 256, 15, 5, 13),
    (2, 64, 64, 66, 2, 64), (2, 37, 256, 15, 6, 14)])
def test_masked_scan_geometry(n_dir, B, H, max_clusters, rows, clusters):
    geo = lstm_cuda._scan_geometry(n_dir, B, H, lambda r: max_clusters)
    assert (geo.rows, geo.clusters) == (rows, clusters)
    assert geo.lane_cols == (1 if rows <= 2 else 4)


def test_masked_scan_geometry_asks_the_masked_kernel(monkeypatch):
    """The masked entries' rows come from the residency of the masked
    instantiation, the full-length ones' from their own."""
    asked = []

    def fake(H, rows, device_index, masked=False, int8=False):
        asked.append(masked)
        return 15 if masked else 1

    monkeypatch.setattr(lstm_cuda, "max_active_clusters", fake)
    lstm_cuda._scan_geometry_on.cache_clear()
    try:
        dev = torch.device("cuda", 0)
        assert lstm_cuda.scan_geometry(2, 64, 256, dev, masked=True).rows == 10
        assert set(asked) == {True}
        asked.clear()
        assert lstm_cuda.scan_geometry(2, 64, 256, dev).rows == 39
        assert set(asked) == {False}
    finally:
        lstm_cuda._scan_geometry_on.cache_clear()


# H = 32 and 64 (64-row tiles), 160 (three 64-row tiles, the last half
# idle), 256 (two 128-row tiles); N never a multiple of the 16-row stage;
# one slab, and many (the last one short)
@pytest.mark.parametrize("N,H,n_slabs", [
    (37, 32, 1), (100, 64, 5), (45, 160, 3), (21, 256, 1), (70, 256, 4)])
def test_dw_kernel_matches_plain_version(emu_lib, N, H, n_slabs):
    """The dW reduction's slabs, summed in order, against the plain
    version, and the same bits from a second run."""
    rng = np.random.RandomState(N + H)
    h_prev = torch.from_numpy(rng.randn(N, H).astype(np.float32))
    dgates = torch.from_numpy(rng.randn(N, 4 * H).astype(np.float32))
    per_slab = math.ceil(N / n_slabs)
    runs = []
    for _ in range(2):
        slabs = torch.full((math.ceil(N / per_slab), H, 4 * H), float("nan"))
        _call(emu_lib.lstm_train_dw_f32, h_prev, dgates, slabs, N, H,
              slabs.shape[0], per_slab)
        runs.append(slabs)
    want = train_cuda.lstm_train_dw_plain(h_prev[:, None], dgates[:, None])
    np.testing.assert_allclose(runs[0].sum(0).numpy(), want.numpy(),
                               atol=TOL * float(want.abs().max()))
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("n_rows,H,want", [
    # the training shape: 16 tiles x 16 slabs of 2,000 rows at H = 256 and
    # 2 tiles x 125 slabs of 256 rows at H = 64, one wave of 264 blocks
    (125 * 256, 256, (16, 2000)), (125 * 256, 64, (125, 256)),
    # B = 37: 15 tiles of 64 rows at H = 160; a short N takes one slab
    (125 * 37, 160, (17, 273)), (100, 256, (1, 100))])
def test_dw_slabs(n_rows, H, want):
    n_slabs, rows = train_cuda._dw_slabs(n_rows, H)
    assert (n_slabs, rows) == want
    assert (n_slabs - 1) * rows < n_rows <= n_slabs * rows
    tiles = (math.ceil(H / train_cuda._dw_tile_rows(H))
             * 4 * H // train_cuda._DW_TILE_N)
    assert n_slabs == 1 or tiles * n_slabs <= train_cuda._DW_TARGET_BLOCKS
