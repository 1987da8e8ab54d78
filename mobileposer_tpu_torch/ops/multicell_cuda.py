"""CUDA multicell LSTM scan (counterpart of
`mobileposer_tpu/ops/multicell_pallas.py`).

One float32 kernel entry in `csrc/multicell_scan.cu`:

  * `multicell_lstm` -> `multicell_scan_f32`, ports `multicell_lstm_pallas`:
    n independent LSTM cells of different hidden sizes over the same T
    steps in one launch (`models/fused.py` runs one launch per layer-row
    of the poser / footcontact / velocity trio).

The kernel runs thread-block clusters of the widest cell's H / 32 CTAs on
the float cluster body of the layer scans (`csrc/scan_body.cuh`), each
cluster one cell's, a narrower cell's holding several groups of its
H / 32 CTAs; `multicell_geometry` picks the h layout and the batch rows
of a group from the clusters the card holds at once. The wrapper checks device, dtype
(float32), shapes and contiguity and raises on anything else. On a CPU tensor it runs the plain PyTorch version
beside it (`multicell_lstm_plain`, one `nn.lstm._lstm_scan` loop per cell
over its feature slice); on a CUDA tensor it launches the kernel or
raises. Every launch adds one to `launches`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from mobileposer_tpu_torch.nn.lstm import _lstm_scan
from mobileposer_tpu_torch.ops import _build
from mobileposer_tpu_torch.ops.lstm_cuda import _SMEM_LIMIT, _UNITS, scan_smem

SOURCE = "multicell_scan.cu"
#: the kernel's limits on the card: cells per launch, H, and the batch
#: rows of a group by h layout (sixteen row groups of at most 4 rows,
#: double-buffered of at most 3)
MAX_CELLS = 8
MAX_HIDDEN = 256
MAX_ROWS = {2: 48, 1: 64}

#: launches per kernel since the last `reset_launches()`
launches = {"multicell_scan_f32": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class MulticellGeometry(NamedTuple):
    """How one multicell scan is launched."""
    cluster: int                # CTAs per cluster: the widest H / 32
    rows: int                   # batch rows of a group
    clusters: int               # sum over cells of ceil(B / (rows * groups))
    smem: int                   # dynamic shared memory per CTA, bytes
    groups: Tuple[int, ...]     # groups a cluster of each cell holds
    lane_rows: int              # rows a product lane sums (the kernel's RT)
    lane_cols: int              # 1 or 4 (its C)
    row_groups: int             # product row groups (its G): 4, or 16
    h_buffers: int              # 2: h double-buffered; 1: single


def multicell_smem(hidden_sizes, rows: int, h_buffers: int) -> int:
    """Shared memory per CTA: the widest cell's layout of the float
    cluster body."""
    return max(scan_smem(H, rows, h_buffers) for H in hidden_sizes)


def _multicell_geometry(B: int, hidden_sizes,
                        max_clusters: Callable[[int, int], int],
                        h_buffers: int | None = None) -> MulticellGeometry:
    """The rule of `lstm_cuda._scan_geometry` for one launch of all the
    cells, where `max_clusters(rows, h_buffers)` is the clusters the card
    holds at that layout's shared memory: the double-buffered h layout at
    the fewest rows with which every cluster is resident at once (one
    cluster barrier a step; at most 39 rows a group at H = 256), else the
    single-buffered one likewise (up to 64), else the single-buffered one
    at the most rows that fit (waves). `h_buffers` forces a layout (2 or
    1), at its fewest resident rows, else its most that fit."""
    n = max(hidden_sizes) // _UNITS
    groups = tuple(n // (H // _UNITS) for H in hidden_sizes)

    def clusters(rows):
        return sum(math.ceil(B / (rows * g)) for g in groups)

    def fits(h_bufs):
        return [r for r in range(1, MAX_ROWS[h_bufs] + 1)
                if multicell_smem(hidden_sizes, r, h_bufs) <= _SMEM_LIMIT]

    def resident(h_bufs):
        return next((r for r in fits(h_bufs)
                     if clusters(r) <= max_clusters(r, h_bufs)), None)

    rows = None
    for h_bufs in (2, 1) if h_buffers is None else (h_buffers,):
        rows = resident(h_bufs)
        if rows is not None:
            break
    rows = rows or fits(h_bufs)[-1]
    row_groups = 4 if rows <= 2 else 16
    return MulticellGeometry(n, rows, clusters(rows),
                             multicell_smem(hidden_sizes, rows, h_bufs),
                             groups, math.ceil(rows / row_groups),
                             1 if rows <= 2 else 4, row_groups, h_bufs)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use) and load the kernel, declaring its entries."""
    lib = _build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.multicell_scan_f32.argtypes = [P] * 8 + [I] * 5 + [P]
    lib.multicell_scan_f32.restype = I
    lib.multicell_scan_max_clusters.argtypes = [P, I, I, I,
                                                ctypes.POINTER(I)]
    lib.multicell_scan_max_clusters.restype = I
    lib.multicell_scan_error_string.argtypes = [I]
    lib.multicell_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def max_active_clusters(hidden_sizes: Tuple[int, ...], rows: int,
                        h_buffers: int, device_index: int) -> int:
    """Clusters of the multicell scan over cells of `hidden_sizes` at
    `rows` in the h layout `h_buffers` that the card holds at once
    (`cudaOccupancyMaxActiveClusters`)."""
    lib = _lib()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.multicell_scan_max_clusters(
            (ctypes.c_int * len(hidden_sizes))(*hidden_sizes),
            len(hidden_sizes), rows, h_buffers, ctypes.byref(out))
    if err != 0:
        msg = lib.multicell_scan_error_string(err).decode()
        raise RuntimeError(f"multicell_scan_max_clusters failed: CUDA error "
                           f"{err} ({msg})")
    return out.value


@functools.lru_cache(maxsize=None)
def _multicell_geometry_on(B: int, hidden_sizes: Tuple[int, ...],
                           device_index: int,
                           h_buffers: int | None) -> MulticellGeometry:
    return _multicell_geometry(
        B, hidden_sizes,
        lambda rows, h_bufs: max_active_clusters(hidden_sizes, rows, h_bufs,
                                                 device_index), h_buffers)


def multicell_geometry(B: int, hidden_sizes: Sequence[int],
                       device: torch.device,
                       h_buffers: int | None = None) -> MulticellGeometry:
    """`_multicell_geometry` on the card that holds `device`."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _multicell_geometry_on(B, tuple(int(h) for h in hidden_sizes),
                                  index, h_buffers)


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
    geo = multicell_geometry(B, hs, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.multicell_scan_f32(
            x_proj.data_ptr(), ptrs(w_hhs), ptrs(h0s), ptrs(c0s), ptrs(ys),
            ptrs(h_ts), ptrs(c_ts), (ctypes.c_int * n)(*hs), n, T, B,
            geo.rows, geo.h_buffers, stream)
    if err != 0:
        msg = lib.multicell_scan_error_string(err).decode()
        raise RuntimeError(f"multicell_scan_f32 launch failed: CUDA error "
                           f"{err} ({msg})")
    launches["multicell_scan_f32"] += 1
    return tuple(ys), tuple(h_ts), tuple(c_ts)
