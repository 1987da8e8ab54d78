"""CUDA LSTM layer scans (counterpart of `mobileposer_tpu/ops/lstm_pallas.py`).

Four float kernel entries in `csrc/lstm_scan.cu`, each in float32 I/O
(`*_f32`) and bf16 I/O (`*_bf16`: the float32 carry and sums of the TPU
kernels' bf16 variant, `csrc/scan_body.cuh`):

  * `lstm_layer`   -> `lstm_scan_f32`/`_bf16`, ports `lstm_layer_pallas`
    (unidirectional full-length layer; the velocity module);
  * `bilstm_layer` -> `bilstm_scan_f32`/`_bf16`, ports `bilstm_layer_pallas`
    (both directions of a bidirectional layer in one launch; joints,
    poser and footcontact);
  * `lstm_layer_masked` -> `lstm_scan_masked_f32` and `bilstm_layer_masked`
    -> `bilstm_scan_masked_f32` port `lstm_layer_masked_pallas` (a ragged
    batch with a [T, B] validity mask; one direction, or both directions
    of a bidirectional layer in one launch sharing the mask). Every layer
    of a forward with `lengths` runs on them.

and their W8A8 int8 counterparts in `csrc/lstm_scan_int8.cu` (int8 w_hh
with a per-column scale [4H], h re-quantized per row every step, exact
int32 products; `ops/quant.py`), each in float32 I/O and bf16 I/O
(`*_int8_bf16`: the same float32 body and carry, only the loads widened
and the stores rounded):

  * `lstm_layer_int8` -> `lstm_scan_int8`/`_int8_bf16`, ports
    `lstm_layer_pallas_int8`;
  * `bilstm_layer_int8` -> `bilstm_scan_int8`/`_int8_bf16`, ports
    `bilstm_layer_pallas_int8`;
  * `lstm_layer_masked_int8` -> `lstm_scan_masked_int8`/`_int8_bf16` and
    `bilstm_layer_masked_int8` -> `bilstm_scan_masked_int8`/`_int8_bf16`
    port `lstm_layer_masked_pallas_int8`.

The four float scans run as thread-block clusters of H / 32 CTAs that
hold w_hh in shared memory for all T steps, the masked ones as the masked
variant of the full-length body. The four int8 scans run as clusters of
the same shape whose warps hold their int8 w_hh columns in registers and
multiply on the int8 tensor cores (`mma.sync`), the masked ones again as
the masked variant. `scan_geometry` picks the batch rows per cluster from
the clusters the card holds at once.

Each wrapper checks device, dtypes (one float I/O dtype per call, all
float32 or all bfloat16, the mask included; for the int8 entries int8
w_hh and float32 scales whatever the I/O dtype), shapes and contiguity
and raises on anything else; it never copies an input to make it fit
(the int8 wrappers pass the module's int8 w_hh as it is). The I/O dtype
picks the entry, and the outputs come in it. On
a CPU tensor it runs the plain PyTorch version beside it (`*_plain`, a
Python loop of `torch.matmul`, or `int8_recurrent_gates`, plus
`_gate_update`); on a CUDA tensor it launches the kernel or raises: an
int8 layer never falls back to the float kernels. Every launch adds one
to `launches`.

`lstm_forward_cuda` is the multi-layer forward, mirroring
`lstm_forward_pallas` (and `nn/lstm.py` `lstm_forward` of the JAX package
for ragged batches): input projections for all timesteps as one matmul
per direction in the weights' dtype (`int8_matmul` for an int8 layer),
the mask in the activations' dtype, the backward direction
pre-reversed in time (per length, with `lengths`) and its outputs
un-reversed after the kernel. The dtype of w_ih picks the float or the
int8 kernels, layer by layer.

The eight wrappers are also `torch.library` custom ops
(`mobileposer_tpu_torch::lstm_layer`, ...; `OPS`) with fake
implementations, so an exported program (`serving.py`) holds each layer
scan as one node that launches the same kernel. Importing this module
registers them; it builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import torch

from mobileposer_tpu_torch.nn.lstm import (_lstm_scan, _reverse_by_length,
                                           length_mask)
from mobileposer_tpu_torch.ops import _build
from mobileposer_tpu_torch.ops.quant import int8_matmul, is_quantized

#: launches per kernel since the last `reset_launches()`
launches = {"lstm_scan_f32": 0, "bilstm_scan_f32": 0,
            "lstm_scan_masked_f32": 0, "bilstm_scan_masked_f32": 0,
            "lstm_scan_bf16": 0, "bilstm_scan_bf16": 0,
            "lstm_scan_masked_bf16": 0, "bilstm_scan_masked_bf16": 0,
            "lstm_scan_int8": 0, "bilstm_scan_int8": 0,
            "lstm_scan_masked_int8": 0, "bilstm_scan_masked_int8": 0,
            "lstm_scan_int8_bf16": 0, "bilstm_scan_int8_bf16": 0,
            "lstm_scan_masked_int8_bf16": 0,
            "bilstm_scan_masked_int8_bf16": 0}

#: {source: {entry: number of pointer arguments}}; every entry then takes
#: T, B, H, the batch rows per cluster and the stream
_ENTRIES = {
    "lstm_scan.cu": {"lstm_scan_f32": 7, "bilstm_scan_f32": 14,
                     "lstm_scan_masked_f32": 8, "bilstm_scan_masked_f32": 15,
                     "lstm_scan_bf16": 7, "bilstm_scan_bf16": 14,
                     "lstm_scan_masked_bf16": 8,
                     "bilstm_scan_masked_bf16": 15},
    "lstm_scan_int8.cu": {"lstm_scan_int8": 8, "bilstm_scan_int8": 16,
                          "lstm_scan_masked_int8": 9,
                          "bilstm_scan_masked_int8": 17,
                          "lstm_scan_int8_bf16": 8,
                          "bilstm_scan_int8_bf16": 16,
                          "lstm_scan_masked_int8_bf16": 9,
                          "bilstm_scan_masked_int8_bf16": 17},
}
#: the I/O dtypes of the float entries, by their names' suffix
_IO_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: the same for the int8 entries (the float32 ones carry no suffix)
_INT8_IO_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}
#: {source: the residency queries of its cluster scans}
_MAX_CLUSTERS_ENTRIES = {
    "lstm_scan.cu": ("lstm_scan_max_clusters",
                     "lstm_scan_masked_max_clusters"),
    "lstm_scan_int8.cu": ("lstm_scan_int8_max_clusters",
                          "lstm_scan_masked_int8_max_clusters"),
}

# the cluster scans' geometry (csrc/cluster_scan.cuh, csrc/lstm_scan.cu):
# hidden units per CTA, gate columns per CTA, the most batch rows per
# cluster of the layer scans (4 row groups of at most 10), and a CTA's
# shared-memory limit on Hopper (bytes)
_UNITS = 32
_COLS = 4 * _UNITS
_MAX_ROWS = 40
_SMEM_LIMIT = 232_448
# the int8 cluster scan's (csrc/lstm_scan_int8.cu): rows of an mma M-tile,
# the most batch rows per cluster (4 M-tiles), the partial maxima a row
# keeps (one per CTA, at most 8) and the int32 words a row of sums takes
_TILE_ROWS = 16
_INT8_MAX_ROWS = 64
_MAX_CTAS = 8
_SUM_STRIDE = _COLS + 8


class ScanGeometry(NamedTuple):
    """How one layer scan is launched. The float body's products give
    each lane `lane_rows` rows and `lane_cols` gate columns; the int8
    body's run `m_tiles` mma M-tiles of 16 rows (the others None)."""
    cluster: int                 # CTAs per cluster: H / 32
    rows: int                    # batch rows per cluster
    clusters: int                # n_dir * ceil(B / rows)
    smem: int                    # dynamic shared memory per CTA, bytes
    lane_rows: int | None        # float: ceil(rows / 4) (the kernel's RT)
    lane_cols: int | None        # float: 1 or 4 (its C)
    m_tiles: int | None = None   # int8: ceil(rows / 16) (the kernel's MT)


def scan_smem(H: int, rows: int, h_buffers: int = 2) -> int:
    """Shared memory per CTA as the float cluster body (`scan_body.cuh`)
    lays it out: the w_hh slice [H, 128], h [h_buffers, rows, H] (double
    buffered in `lstm_scan.cu`), the gates [rows, 128]."""
    return 4 * (H * _COLS + h_buffers * rows * H + rows * _COLS)


def int8_scan_smem(H: int, rows: int) -> int:
    """Shared memory per CTA as `lstm_scan_int8.cu`'s cluster body lays
    it out: the quantized h, int8 [16 * m_tiles, S] with S = H, or H + 32
    where H / 32 is even; the int32 sums [rows, 136]; the partial maxima
    of |h| [rows, 8] float32."""
    stride = H + 32 if (H // _UNITS) % 2 == 0 else H
    return (_TILE_ROWS * math.ceil(rows / _TILE_ROWS) * stride
            + 4 * rows * (_SUM_STRIDE + _MAX_CTAS))


def _scan_geometry(n_dir: int, B: int, H: int,
                   max_clusters: Callable[[int], int],
                   int8: bool = False) -> ScanGeometry:
    """The fewest batch rows per cluster with which all
    n_dir * ceil(B / rows) clusters are resident at once, where
    `max_clusters(rows)` is the clusters the card holds at that rows'
    shared memory; the most rows that fit when none is (the clusters then
    run in waves). `int8` takes the int8 body's rows and shared memory."""
    smem, max_rows = ((int8_scan_smem, _INT8_MAX_ROWS) if int8
                      else (scan_smem, _MAX_ROWS))
    fits = [r for r in range(1, max_rows + 1) if smem(H, r) <= _SMEM_LIMIT]
    rows = next((r for r in fits
                 if n_dir * math.ceil(B / r) <= max_clusters(r)), fits[-1])
    clusters = n_dir * math.ceil(B / rows)
    if int8:
        return ScanGeometry(H // _UNITS, rows, clusters, smem(H, rows), None,
                            None, math.ceil(rows / _TILE_ROWS))
    return ScanGeometry(H // _UNITS, rows, clusters, smem(H, rows),
                        math.ceil(rows / 4), 1 if rows <= 2 else 4)


@functools.lru_cache(maxsize=None)
def max_active_clusters(H: int, rows: int, device_index: int,
                        masked: bool = False, int8: bool = False) -> int:
    """Clusters of the full-length (or, with `masked`, the masked) float
    scan, or with `int8` of the int8 one, at (H, rows) that the card holds
    at once (`cudaOccupancyMaxActiveClusters`)."""
    lib = _lib("lstm_scan_int8.cu" if int8 else "lstm_scan.cu")
    name = (f"lstm_scan{'_masked' if masked else ''}"
            f"{'_int8' if int8 else ''}_max_clusters")
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = getattr(lib, name)(H, rows, ctypes.byref(out))
    if err != 0:
        msg = lib.lstm_scan_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
    return out.value


def int8_bf16_max_active_clusters(H: int, rows: int, device_index: int,
                                  masked: bool = False) -> int:
    """`max_active_clusters(..., int8=True)` of the bf16-I/O
    instantiations. The wrappers take the float32 ones' rows for both
    dtypes (the same threads and shared memory); `chip_smoke.py` holds the
    two counts equal."""
    lib = _lib("lstm_scan_int8.cu")
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.lstm_scan_int8_bf16_max_clusters(H, rows, int(masked),
                                                   ctypes.byref(out))
    if err != 0:
        msg = lib.lstm_scan_error_string(err).decode()
        raise RuntimeError(f"lstm_scan_int8_bf16_max_clusters failed: CUDA "
                           f"error {err} ({msg})")
    return out.value


@functools.lru_cache(maxsize=None)
def _scan_geometry_on(n_dir: int, B: int, H: int, device_index: int,
                      masked: bool, int8: bool) -> ScanGeometry:
    return _scan_geometry(
        n_dir, B, H,
        lambda rows: max_active_clusters(H, rows, device_index, masked,
                                         int8), int8)


def scan_geometry(n_dir: int, B: int, H: int, device: torch.device,
                  masked: bool = False, int8: bool = False) -> ScanGeometry:
    """`_scan_geometry` on the card that holds `device`, for the
    full-length float scans, the masked ones (`masked`), the int8 ones
    (`int8`) or the masked int8 ones (both)."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _scan_geometry_on(n_dir, B, H, index, masked, int8)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def _lib(source: str) -> ctypes.CDLL:
    """Build (first use) and load one source's kernels, declaring every
    entry."""
    lib = _build.load(source)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, n_ptr in _ENTRIES[source].items():
        getattr(lib, name).argtypes = [P] * n_ptr + [I] * 4 + [P]
        getattr(lib, name).restype = I
    for name in _MAX_CLUSTERS_ENTRIES[source]:
        getattr(lib, name).argtypes = [I, I, ctypes.POINTER(I)]
        getattr(lib, name).restype = I
    if source == "lstm_scan_int8.cu":
        lib.lstm_scan_int8_bf16_max_clusters.argtypes = [
            I, I, I, ctypes.POINTER(I)]
        lib.lstm_scan_int8_bf16_max_clusters.restype = I
    lib.lstm_scan_error_string.argtypes = [I]
    lib.lstm_scan_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernels now rather than at first launch."""
    for source in _ENTRIES:
        _lib(source)


def _check_layer(x_proj, w_hh, h0, c0, w_scale=None):
    """Validate one direction's inputs; returns (T, B, H). The float
    inputs share one I/O dtype, x_proj's: float32 or bfloat16. With
    `w_scale` (an int8 layer), w_hh must be int8 and w_scale float32 [4H]
    whatever the I/O dtype."""
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"x_proj must be [T, B, 4H], got {tuple(x_proj.shape)}")
    T, B, H4 = x_proj.shape
    H = H4 // 4
    io = x_proj.dtype
    if io not in _IO_SUFFIX:
        raise ValueError(f"x_proj must be float32 or bfloat16, got {io}")
    want = {"w_hh": (H, H4), "h0": (B, H), "c0": (B, H), "w_scale": (H4,)}
    tensors = [("x_proj", x_proj), ("w_hh", w_hh), ("h0", h0), ("c0", c0)]
    if w_scale is not None:
        tensors.append(("w_scale", w_scale))
    for name, t in tensors:
        dtype = ({"w_hh": torch.int8, "w_scale": torch.float32}.get(name, io)
                 if w_scale is not None else io)
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {str(dtype)[6:]}, got {t.dtype}")
        if t.device != x_proj.device:
            raise ValueError(f"{name} is on {t.device}, x_proj on "
                             f"{x_proj.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    if x_proj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x_proj.device}")
    if x_proj.device.type == "cuda" and not (
            T >= 1 and B >= 1 and H % 32 == 0 and 32 <= H <= 256):
        raise ValueError(f"the CUDA kernel takes T >= 1, B >= 1 and H a "
                         f"multiple of 32 in [32, 256]; got T={T}, B={B}, "
                         f"H={H}")
    return T, B, H


def _check_mask(mask, T: int, B: int, device, io=torch.float32) -> None:
    """The validity mask: [T, B] in the I/O dtype `io`, contiguous, beside
    x_proj."""
    if mask.dtype != io:
        raise ValueError(f"mask must be {str(io)[6:]}, got {mask.dtype}")
    if tuple(mask.shape) != (T, B):
        raise ValueError(f"mask must be {(T, B)}, got {tuple(mask.shape)}")
    if mask.device != device:
        raise ValueError(f"mask is on {mask.device}, x_proj on {device}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")


def _check_bi(x_proj_f, x_proj_b, w_hh_f, w_hh_b, h0f, c0f, h0b, c0b,
              w_scale_f=None, w_scale_b=None):
    """Validate both directions' inputs (with the scales: an int8 layer);
    returns (T, B, H)."""
    T, B, H = _check_layer(x_proj_f, w_hh_f, h0f, c0f, w_scale_f)
    if _check_layer(x_proj_b, w_hh_b, h0b, c0b, w_scale_b) != (T, B, H):
        raise ValueError("forward and backward shapes differ")
    if x_proj_b.device != x_proj_f.device:
        raise ValueError("forward and backward inputs on different devices")
    if x_proj_b.dtype != x_proj_f.dtype:
        raise ValueError(f"forward inputs are {x_proj_f.dtype}, backward "
                         f"{x_proj_b.dtype}")
    return T, B, H


def _entry(kind: str, x_proj: torch.Tensor) -> str:
    """The float entry `kind` ('lstm_scan', 'bilstm_scan_masked', ...) for
    x_proj's I/O dtype."""
    return f"{kind}_{_IO_SUFFIX[x_proj.dtype]}"


def _int8_entry(kind: str, x_proj: torch.Tensor) -> str:
    """The int8 entry `kind` ('lstm_scan', 'bilstm_scan_masked', ...) for
    x_proj's I/O dtype: `<kind>_int8` or `<kind>_int8_bf16`."""
    return f"{kind}_int8{_INT8_IO_SUFFIX[x_proj.dtype]}"


def _launch(name: str, inputs, n_dir: int, T: int, B: int, H: int):
    """Allocate the outputs in the I/O dtype (x_proj's), launch C entry
    `name` on the current stream and count the launch. The entry takes the
    input pointers, then ys per direction, then (h_T, c_T) per direction,
    then T, B, H, the rows per cluster of `scan_geometry` (the same for
    both I/O dtypes) and the stream. Returns ([ys per direction],
    [h_T, c_T per direction])."""
    dev, io = inputs[0].device, inputs[0].dtype
    ints = (T, B, H, scan_geometry(n_dir, B, H, dev, "masked" in name,
                                   "int8" in name).rows)
    ys = [torch.empty((T, B, H), dtype=io, device=dev)
          for _ in range(n_dir)]
    hc = [torch.empty((B, H), dtype=io, device=dev)
          for _ in range(2 * n_dir)]
    lib = _lib(next(src for src, entries in _ENTRIES.items()
                    if name in entries))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*(t.data_ptr() for t in [*inputs, *ys, *hc]),
                                 *ints, stream)
    if err != 0:
        msg = lib.lstm_scan_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    launches[name] += 1
    return ys, hc


# ---------------------------------------------------------------------------
# Kernel 2: unidirectional layer scan
# ---------------------------------------------------------------------------

def lstm_layer_plain(x_proj, w_hh, h0, c0):
    """Plain version of `lstm_layer` (the `_lstm_scan` loop)."""
    return _lstm_scan(x_proj, w_hh, h0, c0)


def lstm_layer(x_proj: torch.Tensor, w_hh: torch.Tensor,
               h0: torch.Tensor, c0: torch.Tensor):
    """Full-length unidirectional LSTM layer scan.

    x_proj [T, B, 4H] incl. both biases; w_hh [H, 4H]; h0/c0 [B, H].
    Returns (ys [T, B, H], (h_T, c_T)).
    """
    T, B, H = _check_layer(x_proj, w_hh, h0, c0)
    if x_proj.device.type == "cpu":
        return lstm_layer_plain(x_proj, w_hh, h0, c0)
    (ys,), (h_t, c_t) = _launch(_entry("lstm_scan", x_proj),
                                [x_proj, w_hh, h0, c0], 1, T, B, H)
    return ys, (h_t, c_t)


# ---------------------------------------------------------------------------
# Kernel 1: bidirectional layer scan
# ---------------------------------------------------------------------------

def bilstm_layer_plain(x_proj_f, x_proj_b, w_hh_f, w_hh_b, h0f, c0f, h0b, c0b):
    """Plain version of `bilstm_layer`: two `_lstm_scan` loops."""
    ys_f, hc_f = _lstm_scan(x_proj_f, w_hh_f, h0f, c0f)
    ys_b, hc_b = _lstm_scan(x_proj_b, w_hh_b, h0b, c0b)
    return ys_f, ys_b, hc_f, hc_b


def bilstm_layer(x_proj_f: torch.Tensor, x_proj_b: torch.Tensor,
                 w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                 h0f, c0f, h0b, c0b):
    """Bidirectional LSTM layer scan, both directions in one launch.

    x_proj_f / x_proj_b: [T, B, 4H] forward / pre-reversed backward input
    projections. Returns (ys_f [T,B,H], ys_b [T,B,H] (still reversed),
    (h_f, c_f), (h_b, c_b)).
    """
    args = (x_proj_f, x_proj_b, w_hh_f, w_hh_b, h0f, c0f, h0b, c0b)
    T, B, H = _check_bi(*args)
    if x_proj_f.device.type == "cpu":
        return bilstm_layer_plain(*args)
    (ys_f, ys_b), (h_f, c_f, h_b, c_b) = _launch(
        _entry("bilstm_scan", x_proj_f), args, 2, T, B, H)
    return ys_f, ys_b, (h_f, c_f), (h_b, c_b)


# ---------------------------------------------------------------------------
# Kernel 3: masked layer scans (ragged batches)
# ---------------------------------------------------------------------------

def lstm_layer_masked_plain(x_proj, w_hh, h0, c0, mask):
    """Plain version of `lstm_layer_masked` (the masked `_lstm_scan`)."""
    return _lstm_scan(x_proj, w_hh, h0, c0, mask)


def lstm_layer_masked(x_proj: torch.Tensor, w_hh: torch.Tensor,
                      h0: torch.Tensor, c0: torch.Tensor,
                      mask: torch.Tensor):
    """Unidirectional LSTM layer scan over a ragged batch.

    x_proj [T, B, 4H] incl. both biases; w_hh [H, 4H]; h0/c0 [B, H];
    mask [T, B] 1.0 where the frame is valid. Masked steps hold the carry
    and emit zeros. Returns (ys [T, B, H], (h_T, c_T)).
    """
    T, B, H = _check_layer(x_proj, w_hh, h0, c0)
    _check_mask(mask, T, B, x_proj.device, x_proj.dtype)
    if x_proj.device.type == "cpu":
        return lstm_layer_masked_plain(x_proj, w_hh, h0, c0, mask)
    (ys,), (h_t, c_t) = _launch(_entry("lstm_scan_masked", x_proj),
                                [x_proj, w_hh, h0, c0, mask], 1, T, B, H)
    return ys, (h_t, c_t)


def bilstm_layer_masked_plain(x_proj_f, x_proj_b, w_hh_f, w_hh_b,
                              h0f, c0f, h0b, c0b, mask):
    """Plain version of `bilstm_layer_masked`: two masked `_lstm_scan`
    loops sharing the mask."""
    ys_f, hc_f = _lstm_scan(x_proj_f, w_hh_f, h0f, c0f, mask)
    ys_b, hc_b = _lstm_scan(x_proj_b, w_hh_b, h0b, c0b, mask)
    return ys_f, ys_b, hc_f, hc_b


def bilstm_layer_masked(x_proj_f: torch.Tensor, x_proj_b: torch.Tensor,
                        w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                        h0f, c0f, h0b, c0b, mask: torch.Tensor):
    """Bidirectional LSTM layer scan over a ragged batch, both directions
    in one launch.

    x_proj_b is the backward input reversed per length
    (`nn.lstm._reverse_by_length`), so each row's valid frames lead in
    both directions and one mask [T, B] serves both. Returns
    (ys_f [T,B,H], ys_b [T,B,H] (still reversed), (h_f, c_f), (h_b, c_b)).
    """
    args = (x_proj_f, x_proj_b, w_hh_f, w_hh_b, h0f, c0f, h0b, c0b)
    T, B, H = _check_bi(*args)
    _check_mask(mask, T, B, x_proj_f.device, x_proj_f.dtype)
    if x_proj_f.device.type == "cpu":
        return bilstm_layer_masked_plain(*args, mask)
    (ys_f, ys_b), (h_f, c_f, h_b, c_b) = _launch(
        _entry("bilstm_scan_masked", x_proj_f), [*args, mask], 2, T, B, H)
    return ys_f, ys_b, (h_f, c_f), (h_b, c_b)


# ---------------------------------------------------------------------------
# Kernels 4-6: the W8A8 int8 layer scans. Same contracts as kernels 2, 1
# and 3, with int8 w_hh [H, 4H] and its per-column scale [4H] (float32 in
# both I/O dtypes). With bf16 I/O the plain versions keep the float32
# carry and quantize it, as the TPU kernels and the bf16 entries do.
# ---------------------------------------------------------------------------

def lstm_layer_int8_plain(x_proj, w_hh, w_scale, h0, c0):
    """Plain version of `lstm_layer_int8` (the int8 `_lstm_scan`)."""
    return _lstm_scan(x_proj, w_hh, h0, c0, w_hh_scale=w_scale)


def lstm_layer_int8(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    w_scale: torch.Tensor, h0: torch.Tensor,
                    c0: torch.Tensor):
    """Full-length unidirectional int8 LSTM layer scan (kernel #4).

    x_proj [T, B, 4H] incl. the bias; w_hh int8 [H, 4H]; w_scale [4H];
    h0/c0 [B, H]. Returns (ys [T, B, H], (h_T, c_T)).
    """
    T, B, H = _check_layer(x_proj, w_hh, h0, c0, w_scale)
    if x_proj.device.type == "cpu":
        return lstm_layer_int8_plain(x_proj, w_hh, w_scale, h0, c0)
    (ys,), (h_t, c_t) = _launch(_int8_entry("lstm_scan", x_proj),
                                [x_proj, w_hh, w_scale, h0, c0], 1, T, B, H)
    return ys, (h_t, c_t)


def bilstm_layer_int8_plain(x_proj_f, x_proj_b, w_hh_f, w_hh_b,
                            w_scale_f, w_scale_b, h0f, c0f, h0b, c0b):
    """Plain version of `bilstm_layer_int8`: two int8 `_lstm_scan`
    loops."""
    ys_f, hc_f = _lstm_scan(x_proj_f, w_hh_f, h0f, c0f, w_hh_scale=w_scale_f)
    ys_b, hc_b = _lstm_scan(x_proj_b, w_hh_b, h0b, c0b, w_hh_scale=w_scale_b)
    return ys_f, ys_b, hc_f, hc_b


def bilstm_layer_int8(x_proj_f: torch.Tensor, x_proj_b: torch.Tensor,
                      w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                      w_scale_f: torch.Tensor, w_scale_b: torch.Tensor,
                      h0f, c0f, h0b, c0b):
    """Bidirectional int8 LSTM layer scan, both directions in one launch
    (kernel #6); the argument order of `bilstm_layer_pallas_int8`.
    Returns (ys_f, ys_b (still reversed), (h_f, c_f), (h_b, c_b))."""
    args = (x_proj_f, x_proj_b, w_hh_f, w_hh_b, w_scale_f, w_scale_b,
            h0f, c0f, h0b, c0b)
    T, B, H = _check_bi(x_proj_f, x_proj_b, w_hh_f, w_hh_b, h0f, c0f, h0b,
                        c0b, w_scale_f, w_scale_b)
    if x_proj_f.device.type == "cpu":
        return bilstm_layer_int8_plain(*args)
    (ys_f, ys_b), (h_f, c_f, h_b, c_b) = _launch(
        _int8_entry("bilstm_scan", x_proj_f), args, 2, T, B, H)
    return ys_f, ys_b, (h_f, c_f), (h_b, c_b)


def lstm_layer_masked_int8_plain(x_proj, w_hh, w_scale, h0, c0, mask):
    """Plain version of `lstm_layer_masked_int8`."""
    return _lstm_scan(x_proj, w_hh, h0, c0, mask, w_hh_scale=w_scale)


def lstm_layer_masked_int8(x_proj: torch.Tensor, w_hh: torch.Tensor,
                           w_scale: torch.Tensor, h0: torch.Tensor,
                           c0: torch.Tensor, mask: torch.Tensor):
    """Unidirectional int8 LSTM layer scan over a ragged batch (kernel #5;
    the argument order of `lstm_layer_masked_pallas_int8`). Masked steps
    hold the carry and emit zeros. Returns (ys [T, B, H], (h_T, c_T))."""
    T, B, H = _check_layer(x_proj, w_hh, h0, c0, w_scale)
    _check_mask(mask, T, B, x_proj.device, x_proj.dtype)
    if x_proj.device.type == "cpu":
        return lstm_layer_masked_int8_plain(x_proj, w_hh, w_scale, h0, c0,
                                            mask)
    (ys,), (h_t, c_t) = _launch(
        _int8_entry("lstm_scan_masked", x_proj),
        [x_proj, w_hh, w_scale, h0, c0, mask], 1, T, B, H)
    return ys, (h_t, c_t)


def bilstm_layer_masked_int8_plain(x_proj_f, x_proj_b, w_hh_f, w_hh_b,
                                   w_scale_f, w_scale_b, h0f, c0f, h0b, c0b,
                                   mask):
    """Plain version of `bilstm_layer_masked_int8`: two masked int8
    `_lstm_scan` loops sharing the mask."""
    ys_f, hc_f = _lstm_scan(x_proj_f, w_hh_f, h0f, c0f, mask, w_scale_f)
    ys_b, hc_b = _lstm_scan(x_proj_b, w_hh_b, h0b, c0b, mask, w_scale_b)
    return ys_f, ys_b, hc_f, hc_b


def bilstm_layer_masked_int8(x_proj_f: torch.Tensor, x_proj_b: torch.Tensor,
                             w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
                             w_scale_f: torch.Tensor,
                             w_scale_b: torch.Tensor,
                             h0f, c0f, h0b, c0b, mask: torch.Tensor):
    """Bidirectional int8 LSTM layer scan over a ragged batch, both
    directions in one launch sharing the mask (kernel #5 twice); x_proj_b
    reversed per length as for `bilstm_layer_masked`. Returns (ys_f, ys_b
    (still reversed), (h_f, c_f), (h_b, c_b))."""
    args = (x_proj_f, x_proj_b, w_hh_f, w_hh_b, w_scale_f, w_scale_b,
            h0f, c0f, h0b, c0b)
    T, B, H = _check_bi(x_proj_f, x_proj_b, w_hh_f, w_hh_b, h0f, c0f, h0b,
                        c0b, w_scale_f, w_scale_b)
    _check_mask(mask, T, B, x_proj_f.device, x_proj_f.dtype)
    if x_proj_f.device.type == "cpu":
        return bilstm_layer_masked_int8_plain(*args, mask)
    (ys_f, ys_b), (h_f, c_f, h_b, c_b) = _launch(
        _int8_entry("bilstm_scan_masked", x_proj_f), [*args, mask], 2, T, B,
        H)
    return ys_f, ys_b, (h_f, c_f), (h_b, c_b)


# ---------------------------------------------------------------------------
# The eight wrappers as torch.library custom ops, for `torch.export`
# (`serving.py`): a ctypes launch is opaque to tracing, an op is a node of
# the exported graph. Each op calls its wrapper, so it picks the entry by
# the I/O dtype, launches the kernel (counted in `launches`) on CUDA
# tensors and runs the plain version on CPU tensors, as the wrapper does;
# its fake implementation gives the outputs' shapes and dtype. The outputs
# are flat: ys per direction, then h_T and c_T per direction, all in
# x_proj's dtype. Eager code calls the wrappers directly (no dispatcher on
# the per-frame path); `lstm_forward_cuda` takes the ops only while
# tracing.
# ---------------------------------------------------------------------------

_OP_NAMESPACE = "mobileposer_tpu_torch"
Tensor = torch.Tensor


def _fake_outputs(x_proj: Tensor, n_dir: int):
    T, B, H4 = x_proj.shape
    ys = [x_proj.new_empty((T, B, H4 // 4)) for _ in range(n_dir)]
    return (*ys, *(x_proj.new_empty((B, H4 // 4)) for _ in range(2 * n_dir)))


@torch.library.custom_op(f"{_OP_NAMESPACE}::lstm_layer", mutates_args=())
def lstm_layer_op(x_proj: Tensor, w_hh: Tensor, h0: Tensor,
                  c0: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """`lstm_layer` (kernel #2) as an op: (ys, h_T, c_T)."""
    ys, hc = lstm_layer(x_proj, w_hh, h0, c0)
    return ys, *hc


@torch.library.custom_op(f"{_OP_NAMESPACE}::bilstm_layer", mutates_args=())
def bilstm_layer_op(x_proj_f: Tensor, x_proj_b: Tensor, w_hh_f: Tensor,
                    w_hh_b: Tensor, h0f: Tensor, c0f: Tensor, h0b: Tensor,
                    c0b: Tensor
                    ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """`bilstm_layer` (kernel #1) as an op: (ys_f, ys_b, h_f, c_f, h_b,
    c_b)."""
    ys_f, ys_b, hc_f, hc_b = bilstm_layer(x_proj_f, x_proj_b, w_hh_f,
                                          w_hh_b, h0f, c0f, h0b, c0b)
    return ys_f, ys_b, *hc_f, *hc_b


@torch.library.custom_op(f"{_OP_NAMESPACE}::lstm_layer_masked",
                         mutates_args=())
def lstm_layer_masked_op(x_proj: Tensor, w_hh: Tensor, h0: Tensor,
                         c0: Tensor, mask: Tensor
                         ) -> tuple[Tensor, Tensor, Tensor]:
    """`lstm_layer_masked` (kernel #3) as an op."""
    ys, hc = lstm_layer_masked(x_proj, w_hh, h0, c0, mask)
    return ys, *hc


@torch.library.custom_op(f"{_OP_NAMESPACE}::bilstm_layer_masked",
                         mutates_args=())
def bilstm_layer_masked_op(x_proj_f: Tensor, x_proj_b: Tensor,
                           w_hh_f: Tensor, w_hh_b: Tensor, h0f: Tensor,
                           c0f: Tensor, h0b: Tensor, c0b: Tensor,
                           mask: Tensor) -> tuple[Tensor, Tensor, Tensor,
                                                  Tensor, Tensor, Tensor]:
    """`bilstm_layer_masked` (kernel #3, both directions) as an op."""
    ys_f, ys_b, hc_f, hc_b = bilstm_layer_masked(
        x_proj_f, x_proj_b, w_hh_f, w_hh_b, h0f, c0f, h0b, c0b, mask)
    return ys_f, ys_b, *hc_f, *hc_b


@torch.library.custom_op(f"{_OP_NAMESPACE}::lstm_layer_int8",
                         mutates_args=())
def lstm_layer_int8_op(x_proj: Tensor, w_hh: Tensor, w_scale: Tensor,
                       h0: Tensor, c0: Tensor
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """`lstm_layer_int8` (kernel #4) as an op."""
    ys, hc = lstm_layer_int8(x_proj, w_hh, w_scale, h0, c0)
    return ys, *hc


@torch.library.custom_op(f"{_OP_NAMESPACE}::bilstm_layer_int8",
                         mutates_args=())
def bilstm_layer_int8_op(x_proj_f: Tensor, x_proj_b: Tensor, w_hh_f: Tensor,
                         w_hh_b: Tensor, w_scale_f: Tensor, w_scale_b: Tensor,
                         h0f: Tensor, c0f: Tensor, h0b: Tensor, c0b: Tensor
                         ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                    Tensor]:
    """`bilstm_layer_int8` (kernel #6) as an op."""
    ys_f, ys_b, hc_f, hc_b = bilstm_layer_int8(
        x_proj_f, x_proj_b, w_hh_f, w_hh_b, w_scale_f, w_scale_b, h0f, c0f,
        h0b, c0b)
    return ys_f, ys_b, *hc_f, *hc_b


@torch.library.custom_op(f"{_OP_NAMESPACE}::lstm_layer_masked_int8",
                         mutates_args=())
def lstm_layer_masked_int8_op(x_proj: Tensor, w_hh: Tensor, w_scale: Tensor,
                              h0: Tensor, c0: Tensor, mask: Tensor
                              ) -> tuple[Tensor, Tensor, Tensor]:
    """`lstm_layer_masked_int8` (kernel #5) as an op."""
    ys, hc = lstm_layer_masked_int8(x_proj, w_hh, w_scale, h0, c0, mask)
    return ys, *hc


@torch.library.custom_op(f"{_OP_NAMESPACE}::bilstm_layer_masked_int8",
                         mutates_args=())
def bilstm_layer_masked_int8_op(x_proj_f: Tensor, x_proj_b: Tensor,
                                w_hh_f: Tensor, w_hh_b: Tensor,
                                w_scale_f: Tensor, w_scale_b: Tensor,
                                h0f: Tensor, c0f: Tensor, h0b: Tensor,
                                c0b: Tensor, mask: Tensor
                                ) -> tuple[Tensor, Tensor, Tensor, Tensor,
                                           Tensor, Tensor]:
    """`bilstm_layer_masked_int8` (kernel #5, both directions) as an op."""
    ys_f, ys_b, hc_f, hc_b = bilstm_layer_masked_int8(
        x_proj_f, x_proj_b, w_hh_f, w_hh_b, w_scale_f, w_scale_b, h0f, c0f,
        h0b, c0b, mask)
    return ys_f, ys_b, *hc_f, *hc_b


#: every op, with its number of directions
OPS = {lstm_layer_op: 1, bilstm_layer_op: 2, lstm_layer_masked_op: 1,
       bilstm_layer_masked_op: 2, lstm_layer_int8_op: 1,
       bilstm_layer_int8_op: 2, lstm_layer_masked_int8_op: 1,
       bilstm_layer_masked_int8_op: 2}
for _op, _n_dir in OPS.items():
    _op.register_fake(lambda x_proj, *args, _n_dir=_n_dir:
                      _fake_outputs(x_proj, _n_dir))


def _bi_via(op):
    """A bidirectional layer function with the wrappers' return layout
    that calls `op`."""
    def layer(*args):
        ys_f, ys_b, h_f, c_f, h_b, c_b = op(*args)
        return ys_f, ys_b, (h_f, c_f), (h_b, c_b)
    return layer


def _uni_via(op):
    """The same for a unidirectional layer."""
    def layer(*args):
        ys, h_t, c_t = op(*args)
        return ys, (h_t, c_t)
    return layer


#: (bi, uni) layer functions by (masked, int8): the wrappers, eager
_ROUTES = {(False, False): (bilstm_layer, lstm_layer),
           (True, False): (bilstm_layer_masked, lstm_layer_masked),
           (False, True): (bilstm_layer_int8, lstm_layer_int8),
           (True, True): (bilstm_layer_masked_int8, lstm_layer_masked_int8)}
#: the same through the ops, while tracing
_OP_ROUTES = {
    (False, False): (_bi_via(bilstm_layer_op), _uni_via(lstm_layer_op)),
    (True, False): (_bi_via(bilstm_layer_masked_op),
                    _uni_via(lstm_layer_masked_op)),
    (False, True): (_bi_via(bilstm_layer_int8_op),
                    _uni_via(lstm_layer_int8_op)),
    (True, True): (_bi_via(bilstm_layer_masked_int8_op),
                   _uni_via(lstm_layer_masked_int8_op))}


# ---------------------------------------------------------------------------
# Multi-layer forward
# ---------------------------------------------------------------------------

def _project_timesteps(xs: torch.Tensor, p) -> torch.Tensor:
    """Input projection over all timesteps (lstm_pallas.py:571-578): float,
    both biases summed first and added after the product, in the weights'
    dtype (bf16 params give a bf16 x_proj, as in the JAX package); or W8A8
    for an int8 direction, `int8_matmul` plus the pre-summed bias in
    float32, rounded once to the activations' dtype (a bf16 x_proj on bf16
    activations). A float32 input on bf16 weights (training on bf16
    params) is promoted as JAX promotes `x @ w_ih + b`: the product in
    float32 on the widened weights, the bias sum in bf16, added in
    float32."""
    if is_quantized(p):
        return (int8_matmul(xs, p.w_ih, p.w_ih_scale) + p.b).to(xs.dtype)
    w = p.w_ih
    if xs.dtype != w.dtype:
        dt = torch.promote_types(xs.dtype, w.dtype)
        xs, w = xs.to(dt), w.to(dt)
    return torch.matmul(xs, w) + (p.b_ih + p.b_hh)


def lstm_forward_cuda(layers, x: torch.Tensor, h0c0=None,
                      bidirectional: bool = True, time_major: bool = False,
                      lengths=None):
    """Multi-layer (bi)LSTM on the layer kernels.

    Full-length (`lengths=None`) it mirrors `lstm_forward_pallas`
    (lstm_pallas.py:581-644): the full-length kernels, the backward input
    flipped in time. With `lengths` (int64 [B] on x's device, checked by
    `nn.lstm.lstm_forward`) it mirrors the masked route of the JAX
    `lstm_forward` (nn/lstm.py:326-371): every layer on the masked
    kernels, the backward input reversed per length and its outputs
    reversed back. A W8A8 layer (int8 w_ih) takes the int8 counterpart
    of each kernel: #4 and #6 full-length (the JAX package sends its
    unidirectional full-length layers to an XLA scan; #4 computes the
    same), #5 masked. See `nn.lstm.lstm_forward` for the argument layout.
    Under `torch.export` (`torch.compiler.is_compiling()`) each layer
    calls its wrapper's custom op instead, the same computation.
    """
    if time_major:
        T, B, _ = x.shape
    else:
        B, T, _ = x.shape
    n_dir = 2 if bidirectional else 1
    H = layers[0]["fwd"].w_hh.shape[0]

    if h0c0 is None:
        zeros = x.new_zeros((len(layers) * n_dir, B, H))
        h0_all, c0_all = zeros, zeros
    else:
        h0_all, c0_all = (t.contiguous() for t in h0c0)

    xs = x if time_major else x.transpose(0, 1)        # [T, B, D]
    routes = _OP_ROUTES if torch.compiler.is_compiling() else _ROUTES
    extra = () if lengths is None else (length_mask(lengths, T, x.dtype),)
    h_finals, c_finals = [], []
    for li, layer in enumerate(layers):
        int8 = is_quantized(layer["fwd"])
        bi_layer, uni_layer = routes[(lengths is not None, int8)]
        if bidirectional:
            pf, pb = layer["fwd"], layer["bwd"]
            x_proj_f = _project_timesteps(xs, pf).contiguous()
            x_proj_b = _project_timesteps(_reverse_by_length(xs, lengths),
                                          pb).contiguous()
            scales = (pf.w_hh_scale, pb.w_hh_scale) if int8 else ()
            s = li * 2
            ys_f, ys_b, (hf, cf), (hb, cb) = bi_layer(
                x_proj_f, x_proj_b, pf.w_hh, pb.w_hh, *scales,
                h0_all[s], c0_all[s], h0_all[s + 1], c0_all[s + 1], *extra)
            xs = torch.cat([ys_f, _reverse_by_length(ys_b, lengths)], dim=-1)
            h_finals += [hf, hb]
            c_finals += [cf, cb]
        else:
            p = layer["fwd"]
            x_proj = _project_timesteps(xs, p).contiguous()
            scales = (p.w_hh_scale,) if int8 else ()
            xs, (h_t, c_t) = uni_layer(x_proj, p.w_hh, *scales,
                                       h0_all[li], c0_all[li], *extra)
            h_finals.append(h_t)
            c_finals.append(c_t)
    y = xs if time_major else xs.transpose(0, 1)
    return y, (torch.stack(h_finals), torch.stack(c_finals))
