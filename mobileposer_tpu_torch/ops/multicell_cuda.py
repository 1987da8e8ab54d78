"""CUDA multicell LSTM scan (counterpart of
`mobileposer_tpu/ops/multicell_pallas.py`).

One float32 kernel entry in `csrc/multicell_scan.cu`:

  * `multicell_lstm` -> `multicell_scan_f32`, ports `multicell_lstm_pallas`:
    n independent LSTM cells of different hidden sizes over the same T
    steps in one launch, one block row per cell (`models/fused.py` runs
    one launch per layer-row of the poser / footcontact / velocity trio).

The wrapper checks device, dtype (float32), shapes and contiguity and
raises on anything else. On a CPU tensor it runs the plain PyTorch version
beside it (`multicell_lstm_plain`, one `nn.lstm._lstm_scan` loop per cell
over its feature slice); on a CUDA tensor it launches the kernel or
raises. Every launch adds one to `launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from mobileposer_tpu_torch.nn.lstm import _lstm_scan
from mobileposer_tpu_torch.ops import _build

SOURCE = "multicell_scan.cu"
#: the kernel's limits on the card: cells per launch, and H
MAX_CELLS = 8
MAX_HIDDEN = 256

#: launches per kernel since the last `reset_launches()`
launches = {"multicell_scan_f32": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use) and load the kernel, declaring its entry."""
    lib = _build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.multicell_scan_f32.argtypes = [P] * 8 + [I] * 3 + [P]
    lib.multicell_scan_f32.restype = I
    lib.multicell_scan_error_string.argtypes = [I]
    lib.multicell_scan_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernel now rather than at first launch."""
    _lib()


def _check(x_proj, w_hhs, h0s, c0s, hidden_sizes) -> Tuple[int, int]:
    """Validate the inputs; returns (T, B)."""
    hs = tuple(int(h) for h in hidden_sizes)
    n = len(hs)
    if not (len(w_hhs) == len(h0s) == len(c0s) == n) or n == 0:
        raise ValueError(f"need one w_hh, h0 and c0 per cell: {n} hidden "
                         f"sizes, {len(w_hhs)} w_hh, {len(h0s)} h0, "
                         f"{len(c0s)} c0")
    if x_proj.dim() != 3:
        raise ValueError(f"x_proj must be [T, B, sum 4H], got "
                         f"{tuple(x_proj.shape)}")
    T, B, width = x_proj.shape
    if width != 4 * sum(hs):
        raise ValueError(f"x_proj is {width} wide, the cells' sum of 4H is "
                         f"{4 * sum(hs)} (hidden sizes {hs})")
    tensors = [("x_proj", x_proj, None)]
    for i, H in enumerate(hs):
        tensors += [(f"w_hh[{i}]", w_hhs[i], (H, 4 * H)),
                    (f"h0[{i}]", h0s[i], (B, H)),
                    (f"c0[{i}]", c0s[i], (B, H))]
    for name, t, shape in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != x_proj.device:
            raise ValueError(f"{name} is on {t.device}, x_proj on "
                             f"{x_proj.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if x_proj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x_proj.device}")
    if x_proj.device.type == "cuda" and not (
            T >= 1 and B >= 1 and 1 <= n <= MAX_CELLS
            and all(h % 32 == 0 and 32 <= h <= MAX_HIDDEN for h in hs)):
        raise ValueError(f"the CUDA kernel takes T >= 1, B >= 1, 1 to "
                         f"{MAX_CELLS} cells and each H a multiple of 32 in "
                         f"[32, {MAX_HIDDEN}]; got T={T}, B={B}, H={hs}")
    return T, B


def multicell_lstm_plain(x_proj, w_hhs, h0s, c0s, hidden_sizes):
    """Plain version of `multicell_lstm`: one `_lstm_scan` loop per cell
    over its feature slice of x_proj."""
    ys, h_ts, c_ts = [], [], []
    off = 0
    for w_hh, h0, c0, H in zip(w_hhs, h0s, c0s, hidden_sizes):
        y, (h_t, c_t) = _lstm_scan(x_proj[..., off:off + 4 * H], w_hh, h0, c0)
        ys.append(y)
        h_ts.append(h_t)
        c_ts.append(c_t)
        off += 4 * H
    return tuple(ys), tuple(h_ts), tuple(c_ts)


def multicell_lstm(x_proj: torch.Tensor, w_hhs: Sequence[torch.Tensor],
                   h0s: Sequence[torch.Tensor], c0s: Sequence[torch.Tensor],
                   hidden_sizes: Sequence[int]):
    """Run `len(hidden_sizes)` independent LSTM cells in one scan.

    x_proj [T, B, sum 4H_i]: the cells' input projections (both biases
    included) concatenated along features in cell order, backward cells
    pre-reversed in time. w_hhs / h0s / c0s: per cell [H_i, 4H_i] and
    [B, H_i]. Returns (ys tuple of [T, B, H_i], h_ts, c_ts), a backward
    cell's ys still reversed.
    """
    T, B = _check(x_proj, w_hhs, h0s, c0s, hidden_sizes)
    if x_proj.device.type == "cpu":
        return multicell_lstm_plain(x_proj, w_hhs, h0s, c0s, hidden_sizes)
    hs = [int(h) for h in hidden_sizes]
    n, dev = len(hs), x_proj.device
    ys = [torch.empty((T, B, H), dtype=torch.float32, device=dev)
          for H in hs]
    h_ts = [torch.empty((B, H), dtype=torch.float32, device=dev) for H in hs]
    c_ts = [torch.empty((B, H), dtype=torch.float32, device=dev) for H in hs]

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.multicell_scan_f32(
            x_proj.data_ptr(), ptrs(w_hhs), ptrs(h0s), ptrs(c0s), ptrs(ys),
            ptrs(h_ts), ptrs(c_ts), (ctypes.c_int * n)(*hs), n, T, B, stream)
    if err != 0:
        msg = lib.multicell_scan_error_string(err).decode()
        raise RuntimeError(f"multicell_scan_f32 launch failed: CUDA error "
                           f"{err} ({msg})")
    launches["multicell_scan_f32"] += 1
    return tuple(ys), tuple(h_ts), tuple(c_ts)
