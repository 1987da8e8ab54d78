"""The bf16-I/O entries of the int8 layer scans (`ops/csrc/lstm_scan_int8.cu`,
`*_int8_bf16`) built with g++ against the CPU stand-in of the CUDA runtime
(`tests/cuda_emu/`, its `cuda_bf16.h` included) and run on the CPU.

The bf16 entries are the float32 entries' body with other loads and
stores: x_proj, h0, c0 and the mask widened as they are read, ys, h_T and
c_T rounded to bf16 as they are written, everything between float32 (the
carry that is quantized too). Hence an identity that holds bit for bit:
a bf16 entry's outputs are the float32 entry's on the same inputs
widened, rounded to bf16. It is checked at every M-tile count, clusters
of one to eight CTAs, partial batch tiles and a ragged mask. Also: the
masked bf16 entries under an all-ones mask give the full-length ones'
bits, the four bf16 entries stay within 1 bf16 ulp of the plain versions
with at most 1% of the outputs differing (the plain versions are held to
the Pallas kernels at the same bound in tests/test_torch_int8_bf16.py),
and the wrappers launch the bf16 entries on bf16 arguments and refuse
mixed dtypes and a float32 mask beside bf16 I/O.
"""

import contextlib
import ctypes
import math
import types

import numpy as np
import pytest
import torch

from mobileposer_tpu_torch.ops import lstm_cuda
from mobileposer_tpu_torch.ops.quant import quantize_weight_int8
from test_torch_cuda_emulation import _call, _emu_build, _ragged_mask

BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def int8_lib(tmp_path_factory):
    """lstm_scan_int8.cu built for the CPU stand-in, its float32 and bf16
    entries declared."""
    lib = _emu_build(tmp_path_factory, "lstm_scan_int8.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    for suffix in ("", "_bf16"):
        for name, n_ptr in (("lstm_scan_int8", 8), ("bilstm_scan_int8", 16),
                            ("lstm_scan_masked_int8", 9),
                            ("bilstm_scan_masked_int8", 17)):
            getattr(lib, name + suffix).argtypes = [P] * n_ptr + [I] * 4 + [P]
    lib.lstm_scan_int8_bf16_max_clusters.argtypes = [I, I, I,
                                                     ctypes.POINTER(I)]
    return lib


def _inputs(rng, T, B, H, n_dir):
    """Seeded bf16 inputs of one int8 layer scan, per direction (x_proj,
    int8 w_hh, float32 w_scale, h0, c0)."""
    bound = 1.0 / math.sqrt(H)
    dirs = []
    for _ in range(n_dir):
        w_q, w_s = quantize_weight_int8(rng.uniform(-bound, bound,
                                                    (H, 4 * H)))
        dirs.append((torch.from_numpy(rng.randn(T, B, 4 * H).astype(
                         np.float32)).to(BF16),
                     torch.from_numpy(w_q), torch.from_numpy(w_s),
                     torch.from_numpy(np.tanh(rng.randn(B, H)).astype(
                         np.float32)).to(BF16),
                     torch.from_numpy((rng.randn(B, H) * 0.5).astype(
                         np.float32)).to(BF16)))
    return dirs


def _emu_scan(lib, dirs, rows, mask=None):
    """One int8 scan on the stand-in in the inputs' I/O dtype (the float32
    entry, or the *_bf16 one): full-length, or with `mask` masked; both
    directions in one launch when `dirs` holds two. Returns [ys, h_T,
    c_T] per direction."""
    T, B, H4 = dirs[0][0].shape
    H, io = H4 // 4, dirs[0][0].dtype
    ys = [torch.full((T, B, H), float("nan"), dtype=io) for _ in dirs]
    hc = [torch.full((B, H), float("nan"), dtype=io)
          for _ in range(2 * len(dirs))]
    name = ("bi" if len(dirs) == 2 else "") + (
        "lstm_scan_int8" if mask is None else "lstm_scan_masked_int8") + (
        "_bf16" if io == BF16 else "")
    if len(dirs) == 1:
        x, w, s, h0, c0 = dirs[0]
        ins = [x, w, s, h0, c0]
    else:
        (xf, wf, sf, h0f, c0f), (xb, wb, sb, h0b, c0b) = dirs
        ins = [xf, xb, wf, wb, sf, sb, h0f, c0f, h0b, c0b]
    m = () if mask is None else (mask,)
    _call(getattr(lib, name), *ins, *m, *ys, *hc, T, B, H, rows)
    return [[ys[i], hc[2 * i], hc[2 * i + 1]] for i in range(len(dirs))]


def _widened(dirs):
    return [(x.float(), w, s, h0.float(), c0.float())
            for x, w, s, h0, c0 in dirs]


# every M-tile count (rows 1 to 64: MT = ceil(rows / 16) from 1 to 4),
# clusters of one to eight CTAs, B = 1, partial batch tiles, all four
# entries
@pytest.mark.parametrize("masked,n_dir,T,B,H,rows", [
    (False, 1, 3, 1, 32, 1), (True, 2, 3, 7, 64, 3),
    (False, 1, 2, 20, 96, 17), (True, 1, 3, 20, 96, 17),
    (False, 1, 2, 37, 256, 37), (True, 2, 2, 30, 224, 30),
    (True, 1, 2, 50, 160, 49), (False, 2, 2, 64, 128, 64)])
def test_bf16_entry_is_the_f32_entry_rounded(int8_lib, masked, n_dir, T, B,
                                             H, rows):
    """A bf16 entry's outputs equal the float32 entry's on the widened
    inputs (the bf16 mask widened too), rounded to bf16, bit for bit."""
    rng = np.random.RandomState(n_dir + T + B + H + rows + masked)
    dirs = _inputs(rng, T, B, H, n_dir)
    mask = _ragged_mask(rng, T, B, rows)[0].to(BF16) if masked else None
    got = _emu_scan(int8_lib, dirs, rows, mask)
    want = _emu_scan(int8_lib, _widened(dirs), rows,
                     None if mask is None else mask.float())
    for d, g, w in zip(("fwd", "bwd"), got, want):
        for name, a, b in zip(("ys", "h_T", "c_T"), g, w):
            assert a.dtype == BF16
            assert torch.equal(a.view(torch.int16),
                               b.to(BF16).view(torch.int16)), f"{d} {name}"


@pytest.mark.parametrize("n_dir,T,B,H,rows", [
    (1, 3, 5, 64, 5), (2, 2, 33, 160, 33)])
def test_bf16_masked_equals_full_length_under_all_ones(int8_lib, n_dir, T,
                                                       B, H, rows):
    """The masked bf16 entries under an all-ones bf16 mask give the
    full-length bf16 entries' bits."""
    dirs = _inputs(np.random.RandomState(90 + B), T, B, H, n_dir)
    full = _emu_scan(int8_lib, dirs, rows)
    masked = _emu_scan(int8_lib, dirs, rows,
                       torch.ones(T, B, dtype=BF16))
    for f, m in zip(full, masked):
        for a, b in zip(f, m):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _ulp(x: torch.Tensor) -> float:
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


@pytest.mark.parametrize("n_dir,masked,B,H,rows", [
    (1, False, 6, 64, 6), (2, False, 21, 128, 21), (1, True, 9, 96, 5),
    (2, True, 20, 256, 20)])
def test_bf16_entries_match_plain_versions(int8_lib, n_dir, masked, B, H,
                                           rows):
    """Four steps of each bf16 entry against the plain version: within 1
    bf16 ulp of the output's largest magnitude, at most 1% of the outputs
    differing (glibc's expf/tanhf against torch's sigmoid/tanh move a
    float32 value by a last bit, which moves a bf16 output only on a
    rounding boundary); exact zeros at masked steps."""
    T = 4
    rng = np.random.RandomState(500 + n_dir + B + H)
    dirs = _inputs(rng, T, B, H, n_dir)
    mask = _ragged_mask(rng, T, B, rows)[0].to(BF16) if masked else None
    got = _emu_scan(int8_lib, dirs, rows, mask)
    differ = total = 0
    for g, (x, w, s, h0, c0) in zip(got, dirs):
        if masked:
            ys, (h, c) = lstm_cuda.lstm_layer_masked_int8_plain(
                x, w, s, h0, c0, mask)
            assert bool((g[0][mask == 0] == 0).all())
        else:
            ys, (h, c) = lstm_cuda.lstm_layer_int8_plain(x, w, s, h0, c0)
        for a, b in zip(g, (ys, h, c)):
            diff = (a.float() - b.float()).abs()
            assert float(diff.max()) <= _ulp(b)
            differ += int((diff > 0).sum())
            total += diff.numel()
    assert differ <= 0.01 * total, f"{differ} of {total} differ"


def test_bf16_residency_query(int8_lib):
    """The bf16 instantiations' residency query takes the float32 one's
    rows and answers for the stand-in's card; rows outside [1, 64] are
    refused."""
    for masked in (0, 1):
        out = ctypes.c_int(0)
        assert int8_lib.lstm_scan_int8_bf16_max_clusters(
            256, 37, masked, ctypes.byref(out)) == 0
        assert out.value == 132 // 8
        assert int8_lib.lstm_scan_int8_bf16_max_clusters(
            256, 65, masked, ctypes.byref(out)) != 0


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    kernel route."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_int8_wrappers_launch_the_bf16_entries(monkeypatch):
    """bf16 inputs take the *_int8_bf16 entries (float32 ones the *_int8
    ones), with int8 w_hh, float32 scales and the mask as they are."""
    calls = []

    def launch(name, inputs, n_dir, T, B, H):
        calls.append((name, inputs))
        return ([torch.zeros(T, B, H)] * n_dir,
                [torch.zeros(B, H)] * (2 * n_dir))

    monkeypatch.setattr(lstm_cuda, "_launch", launch)
    T, B, H = 2, 3, 64
    rng = np.random.RandomState(0)
    for dtype, suffix in ((BF16, "_bf16"), (torch.float32, "")):
        (x, w, s, h0, c0), (xb, wb, sb, h0b, c0b) = [
            [t.to(dtype) if t.dtype == BF16 else t for t in d]
            for d in _inputs(rng, T, B, H, 2)]
        x, w, s, h0, c0, xb, wb, sb, h0b, c0b = (
            t.as_subclass(_OnCard)
            for t in (x, w, s, h0, c0, xb, wb, sb, h0b, c0b))
        mask = torch.ones(T, B, dtype=dtype).as_subclass(_OnCard)
        calls.clear()
        lstm_cuda.lstm_layer_int8(x, w, s, h0, c0)
        lstm_cuda.bilstm_layer_int8(x, xb, w, wb, s, sb, h0, c0, h0b, c0b)
        lstm_cuda.lstm_layer_masked_int8(x, w, s, h0, c0, mask)
        lstm_cuda.bilstm_layer_masked_int8(x, xb, w, wb, s, sb, h0, c0, h0b,
                                           c0b, mask)
        assert [c[0] for c in calls] == [
            f"lstm_scan_int8{suffix}", f"bilstm_scan_int8{suffix}",
            f"lstm_scan_masked_int8{suffix}",
            f"bilstm_scan_masked_int8{suffix}"]
        uni, bi = calls[0][1], calls[1][1]
        assert uni[1] is w and uni[2] is s and bi[2] is w and bi[5] is sb
        assert calls[2][1][-1] is mask and calls[3][1][-1] is mask


@pytest.mark.parametrize("name,n_ptr", [
    ("lstm_scan_int8_bf16", 8), ("bilstm_scan_int8_bf16", 16),
    ("lstm_scan_masked_int8_bf16", 9), ("bilstm_scan_masked_int8_bf16", 17)])
def test_launch_passes_the_int8_bf16_arguments(monkeypatch, name, n_ptr):
    """`_launch` allocates a bf16 entry's outputs in bf16 and gives it the
    int8 geometry's rows (the float32 instantiation's) after (T, B, H),
    then the stream; the launch counts under its own name."""
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
    assert geo_args == [("masked" in name, True)]
    assert allocated == [BF16] * (3 * n_dir)
    assert lstm_cuda.launches[name] == 1


def test_int8_wrappers_refuse_mixed_dtypes():
    """One I/O dtype per call: a float32 mask beside bf16 I/O, a float32
    state or backward direction beside a bf16 x_proj, and a bf16 scale are
    refused."""
    rng = np.random.RandomState(1)
    (x, w, s, h0, c0), (xb, wb, sb, h0b, c0b) = _inputs(rng, 2, 3, 32, 2)
    with pytest.raises(ValueError, match="mask must be bfloat16"):
        lstm_cuda.lstm_layer_masked_int8(x, w, s, h0, c0, torch.ones(2, 3))
    with pytest.raises(ValueError, match="mask must be bfloat16"):
        lstm_cuda.bilstm_layer_masked_int8(x, xb, w, wb, s, sb, h0, c0, h0b,
                                           c0b, torch.ones(2, 3))
    with pytest.raises(ValueError, match="mask must be float32"):
        lstm_cuda.lstm_layer_masked_int8(x.float(), w, s, h0.float(),
                                         c0.float(),
                                         torch.ones(2, 3, dtype=BF16))
    with pytest.raises(ValueError, match="c0 must be bfloat16"):
        lstm_cuda.lstm_layer_int8(x, w, s, h0, c0.float())
    with pytest.raises(ValueError, match="w_scale must be float32"):
        lstm_cuda.lstm_layer_int8(x, w, s.to(BF16), h0, c0)
    with pytest.raises(ValueError, match="forward inputs are"):
        lstm_cuda.bilstm_layer_int8(x, xb.float(), w, wb, s, sb, h0, c0,
                                    h0b.float(), c0b.float())


@pytest.mark.parametrize("kernel,group", [
    ("void (anonymous namespace)::lstm_scan_int8_kernel<3, __nv_bfloat16>("
     "(anonymous namespace)::ClusterDir<__nv_bfloat16>, (anonymous "
     "namespace)::ClusterDir<__nv_bfloat16>, int, int, int, int)",
     "lstm_scan int8 (ops/csrc/lstm_scan_int8.cu) bf16"),
    ("void (anonymous namespace)::lstm_scan_masked_int8_kernel<1, "
     "__nv_bfloat16>((anonymous namespace)::ClusterDir<__nv_bfloat16>, "
     "(anonymous namespace)::ClusterDir<__nv_bfloat16>, __nv_bfloat16 "
     "const*, int, int, int, int)",
     "lstm_scan int8 masked (ops/csrc/lstm_scan_int8.cu) bf16"),
    ("void (anonymous namespace)::lstm_scan_int8_kernel<3, float>((anonymous "
     "namespace)::ClusterDir<float>, (anonymous namespace)::ClusterDir<"
     "float>, int, int, int, int)",
     "lstm_scan int8 (ops/csrc/lstm_scan_int8.cu)"),
    ("nvjet_tst_256x128_64x4_4x2_h_bz_coopA_NNT",
     "matmul (cuBLAS: projections, linears)")])
def test_int8_bf16_kernel_group(kernel, group):
    """The profiler groups of `bench` tell the bf16 int8 kernels from the
    float32 int8 ones, and count cuBLAS's bf16 products (its Hopper
    kernels are named nvjet_*, as a bf16 trace on an H100 shows) as
    matmul, not as elementwise work."""
    from mobileposer_tpu_torch import bench
    assert bench._kernel_group(kernel) == group
