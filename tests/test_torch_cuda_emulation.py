"""The training kernels' CUDA source (`ops/csrc/lstm_train.cu`) built with
g++ against a CPU stand-in for the CUDA runtime (`tests/cuda_emu/`) and
run on the CPU: every CUDA thread an OS thread, the block and cluster
barriers real barriers, distributed shared memory mapped between the
blocks' buffers. This checks the kernels' indexing, their thread-block
cluster exchange and their barriers (not the card's memory model, nor
what nvcc accepts) against the plain versions, at small shapes that
cover every rows-per-cluster template, partial batch tiles, clusters of
one to eight CTAs and a ragged mask with an empty and a full row.

The stand-in does not contract a*b + c into FMAs as nvcc does, so values
differ from the plain versions by float32 rounding over a few steps: 1e-5
(the chip check's TRAIN_TOL).
"""

import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from mobileposer_tpu_torch.ops import _build
from mobileposer_tpu_torch.ops import lstm_train_cuda as train_cuda

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    """lstm_train.cu built for the CPU stand-in, its entries declared."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the CPU stand-in")
    src = (_build.CSRC_DIR / "lstm_train.cu").read_text()
    src = src.replace("extern __shared__ float4 smem[];",
                      "float4* smem = emu_smem();")
    src = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),.*?>>>\(",
                 r"emu_launch(\2, \3, \1, ", src)
    d = tmp_path_factory.mktemp("cuda_emu")
    (d / "lstm_train_emu.cpp").write_text(src)
    out = d / "liblstm_train_emu.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(EMU_DIR), "-include", "cuda_runtime.h", "-o", str(out),
         str(d / "lstm_train_emu.cpp"), "-lpthread"],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
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
