"""CUDA LSTM training kernels (counterpart of
`mobileposer_tpu/ops/lstm_train_pallas.py`).

Kernel entries in one source (`csrc/lstm_train.cu`):

  * `lstm_train_fwd` -> `lstm_train_fwd_f32`, ports `_fwd_call` (#7): one
    layer-direction forward over a [T, B] mask that also stores the
    backward pass's residuals (gate activations, held h and c sequences);
  * `lstm_train_bwd` -> `lstm_train_bwd_f32` + `lstm_train_dw_f32`, port
    `_bwd_call` (#8): BPTT in reversed time, then the dw_hh reduction over
    the T*B rows as a second launch (partial slabs, summed here in a fixed
    order, as `_bwd_call` sums its per-tile slabs);
  * with `residual_dtype=torch.bfloat16` (the JAX package's
    `residual_dtype=jnp.bfloat16`, backend 'auto_train_bf16res') the same
    kernels' `*_bf16res` entries: the forward stores acts, hseq and cseq
    rounded to bf16, the backward scan and the dW reduction read them (and
    h_prev, c_prev) as bf16 and widen them; every other input and output
    stays as it was, and so does the arithmetic. So a bf16res entry gives
    the f32 entry's bits on the widened residuals;
  * on bf16 params, the scans' entries for the dtypes the TPU kernels see
    there (`SCAN_ENTRY`): `*_bf16` (x_proj, w_hh, h0, c0, the mask and
    every output but the residuals bf16: a bf16 input to the layer) and
    the backward's `*_wbf16` (w_hh bf16, the rest float32: a float32
    input, which JAX promotes over bf16 weights), each with float32 or
    bf16 residuals. The forward rounds h to the I/O dtype for the
    recurrent product, so under float32 I/O it rounds nothing and is the
    f32 entry on w_hh widened (`FWD_ENTRY`); the backward rounds dgates to
    w_hh's dtype for the dh product, and the dW reduction (the same two
    dW entries) sums the unrounded float32 dgates, as `_bwd_kernel` does;
    dw_hh comes in w_hh's dtype.

The two scans run as thread-block clusters of H / 32 CTAs that hold w_hh
in shared memory for all T steps; `_train_geometry` picks the batch rows
per cluster from the clusters the card holds at once.

Each wrapper checks device, dtypes (one I/O dtype, float32 or bf16, for
x_proj, h0, c0 and the mask, or dy, dh_T, dc_T and the mask; w_hh float32
or bf16, bf16 under bf16 I/O; the residuals float32 or bf16, all four
alike), shapes and contiguity and raises on anything else. On a CPU
tensor it runs the plain PyTorch version beside it (`*_plain`, a Python
loop that copies the Pallas kernel body formula for formula); on a CUDA
tensor it launches the kernel or raises. Every launch adds one to
`launches`.

`LSTMLayerTrain` is the `torch.autograd.Function` over the two, the
counterpart of the `lstm_layer_train` custom VJP, and `lstm_forward_train`
the multi-layer (bi)LSTM on it (`lstm_forward_train_pallas`): one launch of
each kernel per layer-direction, as on the TPU. The two wrappers are also
`torch.library` custom ops (`mobileposer_tpu_torch::lstm_layer_train`,
whose autograd calls `...::lstm_layer_train_bwd`), so that `torch.compile`
and `torch.export` see each layer-direction as one node that launches the
same kernels; `lstm_forward_train` takes them only while tracing.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from mobileposer_tpu_torch.nn.lstm import _reverse_by_length, length_mask
from mobileposer_tpu_torch.ops import _build
from mobileposer_tpu_torch.ops.lstm_cuda import (_UNITS, _check_mask,
                                                 _project_timesteps)

F32, BF16 = torch.float32, torch.bfloat16

#: the residual dtypes the kernels take, and their entries' suffix
RESIDUAL_ENTRY = {F32: "f32", BF16: "bf16res"}
#: #8's scan's entry suffix by (I/O dtype, w_hh's dtype, residual dtype)
SCAN_ENTRY = {(F32, F32, F32): "f32", (F32, F32, BF16): "bf16res",
              (BF16, BF16, F32): "bf16", (BF16, BF16, BF16): "bf16_bf16res",
              (F32, BF16, F32): "wbf16", (F32, BF16, BF16): "wbf16_bf16res"}
#: #7's entry suffix by (I/O dtype, residual dtype): w_hh in the I/O dtype
#: (bf16 w_hh beside float32 I/O is widened for it)
FWD_ENTRY = {(io, rdt): SCAN_ENTRY[(io, io, rdt)]
             for io in (F32, BF16) for rdt in (F32, BF16)}

#: launches per kernel since the last `reset_launches()`
launches = {**{f"lstm_train_fwd_{suffix}": 0
               for suffix in FWD_ENTRY.values()},
            **{f"lstm_train_bwd_{suffix}": 0
               for suffix in SCAN_ENTRY.values()},
            **{f"lstm_train_dw_{suffix}": 0
               for suffix in RESIDUAL_ENTRY.values()}}

# the dW kernel (csrc/lstm_train.cu): gate columns per block tile
# (kDwTileN), the blocks it aims for (two per SM of an H100's 132: its
# 256 threads take at most 128 registers each), and the fewest rows a slab
# sums (16 stages of kDwK rows, so that filling and draining the copy ring
# stays a small share)
_DW_TILE_N = 128
_DW_TARGET_BLOCKS = 264
_DW_MIN_ROWS = 256

# the batch rows per cluster the scans are built for (csrc/lstm_train.cu)
_ROWS = (1, 2, 4, 8, 12, 16, 18, 20, 24, 32)


class TrainGeometry(NamedTuple):
    """How the scans of one layer-direction are launched."""
    cluster: int    # CTAs per cluster: H / 32
    rows: int       # batch rows per cluster
    fwd_smem: int   # dynamic shared memory per CTA of #7, bytes
    bwd_smem: int   # the same for #8's scan


def _train_geometry(B: int, H: int, max_clusters: int) -> TrainGeometry:
    """The fewest batch rows per cluster (a step's work per CTA) with
    which all ceil(B / rows) clusters are resident at once, given that
    the card holds `max_clusters`; the most rows when none is. Shared
    memory per CTA as `lstm_train.cu` lays it out: the w_hh slice
    [H, 128]; forward h double-buffered [2, rows, H] and the k-split
    partial gates [split, rows, 128]; backward dgates [rows, 128] and the
    partial dh double-buffered [2, rows, H]."""
    rows = next((r for r in _ROWS if math.ceil(B / r) <= max_clusters),
                _ROWS[-1])
    split_k = 2 if rows > 16 else 4
    w_slice = H * 4 * _UNITS
    fwd = 4 * (w_slice + 2 * rows * H + split_k * rows * 4 * _UNITS)
    bwd = 4 * (w_slice + rows * 4 * _UNITS + 2 * rows * H)
    return TrainGeometry(H // _UNITS, rows, fwd, bwd)


@functools.lru_cache(maxsize=None)
def max_active_clusters(H: int, device_index: int,
                        residual_dtype: torch.dtype = F32,
                        io: torch.dtype = F32,
                        w_dtype: torch.dtype = F32) -> int:
    """Clusters of both scans at H that the card holds at once
    (`cudaOccupancyMaxActiveClusters`, the fewer of #7's and #8's), taken
    at the most rows, whose shared memory is the largest, so that a
    smaller tile fits as well; of the instantiation on those dtypes. Every
    instantiation has the f32 one's shared memory, and the wrappers take
    the f32 one's rows; `chip_smoke.py` holds the residencies equal."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().lstm_train_max_clusters(
            H, _ROWS[-1], int(io == BF16), int(w_dtype == BF16),
            int(residual_dtype == BF16), ctypes.byref(out))
    if err != 0:
        msg = _lib().lstm_train_error_string(err).decode()
        raise RuntimeError(f"lstm_train_max_clusters failed: CUDA error "
                           f"{err} ({msg})")
    if out.value < 1:
        raise RuntimeError(f"no cluster of {H // _UNITS} CTAs fits on "
                           f"device {device_index}")
    return out.value


def train_geometry(B: int, H: int, device: torch.device) -> TrainGeometry:
    """`_train_geometry` on the card that holds `device`."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _train_geometry(B, H, max_active_clusters(H, index))


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use) and load the kernels, declaring every entry."""
    lib = _build.load("lstm_train.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    for suffix in FWD_ENTRY.values():
        fn = getattr(lib, f"lstm_train_fwd_{suffix}")
        fn.argtypes, fn.restype = [P] * 11 + [I] * 4 + [P], I
    for suffix in SCAN_ENTRY.values():
        # the bf16-I/O backward also writes the float32 dgates
        n_bwd = 12 if suffix in ("bf16", "bf16_bf16res") else 11
        fn = getattr(lib, f"lstm_train_bwd_{suffix}")
        fn.argtypes, fn.restype = [P] * n_bwd + [I] * 4 + [P], I
    for suffix in RESIDUAL_ENTRY.values():
        fn = getattr(lib, f"lstm_train_dw_{suffix}")
        fn.argtypes, fn.restype = [P] * 3 + [I] * 4 + [P], I
    lib.lstm_train_max_clusters.argtypes = [I] * 5 + [ctypes.POINTER(I)]
    lib.lstm_train_max_clusters.restype = I
    lib.lstm_train_error_string.argtypes = [I]
    lib.lstm_train_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernels now rather than at first launch."""
    _lib()


def _check(name: str, t: torch.Tensor, shape, device,
           dtype: torch.dtype = F32, like: str = "") -> None:
    """One tensor of a call: `dtype` (as tensor `like` is, when named),
    contiguous, `shape`, on `device`."""
    if t.dtype != dtype:
        as_ = f" as {like} is" if like else ""
        raise ValueError(f"{name} must be {dtype}{as_}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _call(name: str, *args) -> None:
    """Launch C entry `name` on the current stream (tensors pass as
    pointers, ints as ints), raise on a non-zero return, count it."""
    lib = _lib()
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), stream)
    if err != 0:
        msg = lib.lstm_train_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    launches[name] += 1


def _scan_suffix(io: torch.dtype, w_dtype: torch.dtype,
                 residual_dtype: torch.dtype, io_name: str) -> str:
    """The scans' entry suffix for these dtypes (`SCAN_ENTRY`), the I/O
    dtype that of tensor `io_name`; raises on a combination no entry
    takes."""
    if residual_dtype not in RESIDUAL_ENTRY:
        raise ValueError(f"residual_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {residual_dtype}")
    if (io, w_dtype, residual_dtype) not in SCAN_ENTRY:
        raise ValueError(f"the training kernels take float32 or bf16 I/O "
                         f"and w_hh float32 or bf16, bf16 under bf16 I/O; "
                         f"got {io_name} {io} and w_hh {w_dtype}")
    return SCAN_ENTRY[(io, w_dtype, residual_dtype)]


def _check_cuda_shape(T: int, B: int, H: int, dev: torch.device) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not (
            T >= 1 and B >= 1 and H % 32 == 0 and 32 <= H <= 256):
        raise ValueError(f"the CUDA kernel takes T >= 1, B >= 1 and H a "
                         f"multiple of 32 in [32, 256]; got T={T}, B={B}, "
                         f"H={H} on {dev}")


# ---------------------------------------------------------------------------
# Kernel 7: training forward
# ---------------------------------------------------------------------------

def lstm_train_fwd_plain(x_proj, w_hh, h0, c0, mask,
                         residual_dtype=F32):
    """Plain version of `lstm_train_fwd`: `_fwd_kernel` step by step, the
    residuals rounded to `residual_dtype` as they are stored. Every input
    is widened to float32 as it is read; the recurrent product takes h
    rounded to the I/O dtype (`h.astype(x_ref.dtype)`: a product of two
    bf16 values is exact in float32), the carry stays float32, and ys,
    h_T and c_T are rounded to the I/O dtype. In float32 every cast is a
    no-op."""
    io = x_proj.dtype
    H = h0.shape[-1]
    w = w_hh.float()
    h, c = h0.float(), c0.float()
    ys, acts, hseq, cseq = [], [], [], []
    for t in range(x_proj.shape[0]):
        gates = x_proj[t].float() + h.to(io).float() @ w
        i = torch.sigmoid(gates[:, 0 * H:1 * H])
        f = torch.sigmoid(gates[:, 1 * H:2 * H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:4 * H])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t][:, None].float()
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ys.append(m * h_new)
        acts.append(torch.cat([i, f, g, o], dim=-1))
        hseq.append(h)
        cseq.append(c)
    rdt = residual_dtype
    return (torch.stack(ys).to(io), torch.stack(acts).to(rdt),
            torch.stack(hseq).to(rdt), torch.stack(cseq).to(rdt), h.to(io),
            c.to(io))


def lstm_train_fwd(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   h0: torch.Tensor, c0: torch.Tensor, mask: torch.Tensor,
                   residual_dtype: torch.dtype = F32):
    """Training forward of one layer-direction.

    x_proj [T, B, 4H] incl. both biases; w_hh [H, 4H]; h0/c0 [B, H];
    mask [T, B] (1.0 = valid; ones for full length). Returns (ys [T,B,H],
    acts [T,B,4H] = (i, f, g, o), hseq [T,B,H], cseq [T,B,H] (the held
    carry after each step), h_T, c_T); acts, hseq and cseq in
    `residual_dtype` (float32, or bfloat16 rounded to nearest even), the
    rest in the I/O dtype, x_proj's (float32 or bfloat16; h0, c0 and the
    mask in it too). w_hh is float32 or bfloat16, bfloat16 under bf16 I/O;
    bf16 w_hh beside float32 I/O is widened for the f32 entry (exact).
    """
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"x_proj must be [T, B, 4H], got "
                         f"{tuple(x_proj.shape)}")
    T, B, H4 = x_proj.shape
    H, io, dev = H4 // 4, x_proj.dtype, x_proj.device
    if io not in RESIDUAL_ENTRY or w_hh.dtype not in RESIDUAL_ENTRY:
        raise ValueError(f"x_proj and w_hh must be float32 or bfloat16, got "
                         f"{io} and {w_hh.dtype}")
    _scan_suffix(io, w_hh.dtype, residual_dtype, "x_proj")
    _check("x_proj", x_proj, (T, B, H4), dev, io)
    _check("w_hh", w_hh, (H, H4), dev, w_hh.dtype)
    for name, t in (("h0", h0), ("c0", c0)):
        _check(name, t, (B, H), dev, io, "x_proj")
    _check_mask(mask, T, B, dev, io)
    _check_cuda_shape(T, B, H, dev)
    if dev.type == "cpu":
        return lstm_train_fwd_plain(x_proj, w_hh, h0, c0, mask,
                                    residual_dtype)
    seq = [torch.empty((T, B, n), dtype=dt, device=dev)
           for n, dt in ((H, io), (H4, residual_dtype),
                         (H, residual_dtype), (H, residual_dtype))]
    hc = [torch.empty((B, H), dtype=io, device=dev) for _ in range(2)]
    _call(f"lstm_train_fwd_{FWD_ENTRY[(io, residual_dtype)]}", x_proj,
          w_hh.to(io), h0, c0, mask, *seq, *hc, T, B, H,
          train_geometry(B, H, dev).rows)
    return (*seq, *hc)


# ---------------------------------------------------------------------------
# Kernel 8: BPTT backward and its dw_hh reduction
# ---------------------------------------------------------------------------

def lstm_train_dw_plain(h_prev_seq, dgates):
    """Plain version of the dW reduction: dw_hh accumulated step by step
    in reversed time, h_prev[t]^T @ dgates[t], as the TPU kernel adds to
    its accumulator; h_prev (float32 or bf16) widened as it is read, the
    sum float32."""
    h_prev_seq = h_prev_seq.float()
    dw = h_prev_seq.new_zeros((h_prev_seq.shape[-1], dgates.shape[-1]))
    for t in reversed(range(dgates.shape[0])):
        dw = dw + h_prev_seq[t].t() @ dgates[t]
    return dw


def lstm_train_bwd_plain(dy, dh_T, dc_T, acts, c_new_seq, h_prev_seq,
                         c_prev_seq, w_hh, mask):
    """Plain version of `lstm_train_bwd`: `_bwd_kernel` step by step in
    reversed time, then the dW reduction (`lstm_train_dw_plain`) on the
    float32 dgates, cast to w_hh's dtype. Every input is widened to float32
    as it is read (the residuals float32 or bf16); the dh product takes
    dgates rounded to w_hh's dtype (`dgates.astype(wT_ref.dtype)`), and
    dx_proj, dh0 and dc0 come in the I/O dtype, dy's. In float32 every cast
    is a no-op."""
    io = dy.dtype
    acts, c_new_seq, c_prev_seq = (a.float() for a in (acts, c_new_seq,
                                                       c_prev_seq))
    T, _, H = dy.shape
    w_t = w_hh.float().t()
    dh, dc = dh_T.float(), dc_T.float()
    dx = [None] * T
    for t in reversed(range(T)):
        m = mask[t][:, None].float()
        i, f, g, o = (acts[t][:, k * H:(k + 1) * H] for k in range(4))
        tanh_c = torch.tanh(c_new_seq[t])
        dh_new = m * (dh + dy[t].float())
        dc_new = m * dc
        do = dh_new * tanh_c
        dc_cur = dc_new + dh_new * o * (1.0 - tanh_c * tanh_c)
        di = dc_cur * g
        dg = dc_cur * i
        df = dc_cur * c_prev_seq[t]
        dc_prev_cell = dc_cur * f
        dgates = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                            dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dx[t] = dgates
        dh = (1.0 - m) * dh + dgates.to(w_hh.dtype).float() @ w_t
        dc = (1.0 - m) * dc + dc_prev_cell
    dx = torch.stack(dx)
    dw = lstm_train_dw_plain(h_prev_seq, dx).to(w_hh.dtype)
    return dx.to(io), dw, dh.to(io), dc.to(io)


def _dw_tile_rows(H: int) -> int:
    """Rows of dw_hh per block tile of the dW kernel: 64 where H % 128 is
    in (0, 64] (H = 64, 160: a 128-row tile would leave more rows idle),
    else 128 (`lstm_train_dw_f32`)."""
    return 64 if 0 < H % 128 <= 64 else 128


def _dw_slabs(n_rows: int, H: int):
    """(number of slabs, rows per slab) of the dW reduction: the most
    slabs with which the tiles of dw_hh times the slabs fit in one wave of
    _DW_TARGET_BLOCKS blocks, none shorter than _DW_MIN_ROWS rows. A
    function of the shapes only, so the slab sum runs in the same order
    every time."""
    tiles = math.ceil(H / _dw_tile_rows(H)) * (4 * H // _DW_TILE_N)
    n = max(1, min(_DW_TARGET_BLOCKS // tiles, n_rows // _DW_MIN_ROWS))
    rows = math.ceil(n_rows / n)
    return math.ceil(n_rows / rows), rows


def _bwd_scan(dy, dh_T, dc_T, acts, c_new_seq, c_prev_seq, w_hh, mask):
    """Launch #8's scan on checked inputs, the entry of their dtypes:
    (dx_proj, dh0, dc0) in the I/O dtype and the float32 dgates the dW
    reduction reads (dx_proj itself unless the I/O is bf16). The kernel
    reads w_hh [H, 4H] as the forward does (each CTA its column slice):
    no transpose."""
    T, B, H = dy.shape
    dev, io = dy.device, dy.dtype
    suffix = SCAN_ENTRY[(io, w_hh.dtype, acts.dtype)]
    dx = torch.empty((T, B, 4 * H), dtype=io, device=dev)
    dgates = (dx if io == F32
              else torch.empty((T, B, 4 * H), dtype=F32, device=dev))
    extra = () if io == F32 else (dgates,)
    dh0 = torch.empty((B, H), dtype=io, device=dev)
    dc0 = torch.empty((B, H), dtype=io, device=dev)
    _call(f"lstm_train_bwd_{suffix}", dy, dh_T, dc_T, acts, c_new_seq,
          c_prev_seq, w_hh, mask, dx, *extra, dh0, dc0, T, B, H,
          train_geometry(B, H, dev).rows)
    return dx, dh0, dc0, dgates


def lstm_train_bwd(dy: torch.Tensor, dh_T: torch.Tensor, dc_T: torch.Tensor,
                   acts: torch.Tensor, c_new_seq: torch.Tensor,
                   h_prev_seq: torch.Tensor, c_prev_seq: torch.Tensor,
                   w_hh: torch.Tensor, mask: torch.Tensor,
                   residual_dtype: torch.dtype = F32):
    """BPTT of one layer-direction (the `_bwd_call` contract).

    dy [T, B, H]; dh_T/dc_T [B, H]; acts [T, B, 4H]; c_new_seq (the
    forward's cseq), h_prev_seq and c_prev_seq (the carry before each
    step) [T, B, H]; w_hh [H, 4H]; mask [T, B]. The four residuals (acts,
    c_new_seq, h_prev_seq, c_prev_seq) are in `residual_dtype` (float32
    or bfloat16); dy, dh_T, dc_T and the mask in the I/O dtype, dy's
    (float32 or bfloat16); w_hh float32 or bfloat16, bfloat16 under bf16
    I/O. Returns (dx_proj [T, B, 4H], dw_hh [H, 4H], dh0 [B, H], dc0
    [B, H]): dw_hh in w_hh's dtype, the rest in the I/O dtype.
    """
    if dy.dim() != 3:
        raise ValueError(f"dy must be [T, B, H], got {tuple(dy.shape)}")
    T, B, H = dy.shape
    dev, io, rdt = dy.device, dy.dtype, residual_dtype
    if io not in RESIDUAL_ENTRY or w_hh.dtype not in RESIDUAL_ENTRY:
        raise ValueError(f"dy and w_hh must be float32 or bfloat16, got "
                         f"{io} and {w_hh.dtype}")
    suffix = _scan_suffix(io, w_hh.dtype, rdt, "dy")
    for name, t, shape, dtype in (
            ("dh_T", dh_T, (B, H), io), ("dc_T", dc_T, (B, H), io),
            ("acts", acts, (T, B, 4 * H), rdt),
            ("c_new_seq", c_new_seq, (T, B, H), rdt),
            ("h_prev_seq", h_prev_seq, (T, B, H), rdt),
            ("c_prev_seq", c_prev_seq, (T, B, H), rdt),
            ("w_hh", w_hh, (H, 4 * H), w_hh.dtype)):
        _check(name, t, shape, dev, dtype, "dy" if dtype == io else "")
    _check("dy", dy, (T, B, H), dev, io)
    _check_mask(mask, T, B, dev, io)
    _check_cuda_shape(T, B, H, dev)
    if dev.type == "cpu":
        return lstm_train_bwd_plain(dy, dh_T, dc_T, acts, c_new_seq,
                                    h_prev_seq, c_prev_seq, w_hh, mask)
    dx, dh0, dc0, dgates = _bwd_scan(dy, dh_T, dc_T, acts, c_new_seq,
                                     c_prev_seq, w_hh, mask)
    n_slabs, rows = _dw_slabs(T * B, H)
    slabs = torch.empty((n_slabs, H, 4 * H), dtype=F32, device=dev)
    _call(f"lstm_train_dw_{RESIDUAL_ENTRY[rdt]}", h_prev_seq, dgates, slabs,
          T * B, H, n_slabs, rows)
    return dx, slabs.sum(dim=0).to(w_hh.dtype), dh0, dc0


# ---------------------------------------------------------------------------
# Autograd over the two kernels
# ---------------------------------------------------------------------------

def _layer_backward(dy, dh_T, dc_T, acts, hseq, cseq, h0, c0, w_hh, mask,
                    bwd=None):
    """The cotangents of (x_proj, w_hh, h0, c0) from those of (ys, h_T,
    c_T) (`_train_bwd`), through `bwd` (the wrapper `lstm_train_bwd` when
    None, or its op).

    Autograd hands the cotangents through the transpose, reversal and cat
    around the layer, so dy may be a strided view; the kernel reads it
    densely. This is the one copy the training path makes to fit a
    kernel. Outputs the loss does not use arrive as zeros (materialized),
    or as None from a caller that turned that off."""
    dy = torch.zeros_like(hseq, dtype=h0.dtype) if dy is None \
        else dy.contiguous()
    dh_T = torch.zeros_like(h0) if dh_T is None else dh_T.contiguous()
    dc_T = torch.zeros_like(c0) if dc_T is None else dc_T.contiguous()
    # the carry BEFORE each step: [h0, hseq[:-1]], h0 and c0 rounded to
    # the residual dtype
    rdt = hseq.dtype
    h_prev = torch.cat([h0.to(rdt)[None], hseq[:-1]])
    c_prev = torch.cat([c0.to(rdt)[None], cseq[:-1]])
    dx, dw, dh0, dc0 = (bwd or lstm_train_bwd)(
        dy, dh_T, dc_T, acts, cseq, h_prev, c_prev, w_hh, mask, rdt)
    return dx, dw, dh0.to(h0.dtype), dc0.to(c0.dtype)


class LSTMLayerTrain(torch.autograd.Function):
    """One LSTM layer-direction with kernel #7 forward and kernel #8
    backward (the `lstm_layer_train` custom VJP). Same contract as the
    masked `_lstm_scan`: forward(x_proj [T,B,4H], w_hh [H,4H], h0, c0
    [B,H], mask [T,B], residual_dtype) -> (ys [T,B,H], h_T, c_T), the
    residuals stored in `residual_dtype` (float32 or bfloat16); dtypes as
    `lstm_train_fwd` takes them, the gradients in their inputs' dtypes.
    The mask and the residual dtype carry no gradient."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, h0, c0, mask, residual_dtype=F32):
        ys, acts, hseq, cseq, h_t, c_t = lstm_train_fwd(
            x_proj, w_hh, h0, c0, mask, residual_dtype)
        ctx.save_for_backward(acts, hseq, cseq, h0, c0, w_hh, mask)
        return ys, h_t, c_t

    @staticmethod
    def backward(ctx, dy, dh_T, dc_T):
        return (*_layer_backward(dy, dh_T, dc_T, *ctx.saved_tensors),
                None, None)


# ---------------------------------------------------------------------------
# The two kernels as torch.library custom ops, for `torch.compile` and
# `torch.export`: a ctypes launch is opaque to tracing, an op is a node of
# the graph. Each op calls its wrapper (so it launches the kernels, counted
# in `launches`, on CUDA tensors and runs the plain versions on CPU
# tensors) and has a fake implementation; the forward op returns the
# residuals as outputs beside (ys, h_T, c_T) and its registered autograd
# calls the backward op. Eager code calls `LSTMLayerTrain` (no dispatcher
# on the eager path); `lstm_forward_train` takes the ops only while
# tracing.
# ---------------------------------------------------------------------------

_OP_NAMESPACE = "mobileposer_tpu_torch"
Tensor = torch.Tensor


@torch.library.custom_op(f"{_OP_NAMESPACE}::lstm_layer_train",
                         mutates_args=())
def lstm_layer_train_op(x_proj: Tensor, w_hh: Tensor, h0: Tensor,
                        c0: Tensor, mask: Tensor,
                        residual_dtype: torch.dtype
                        ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                   Tensor]:
    """`lstm_train_fwd` (kernel #7) as an op: (ys, h_T, c_T, acts, hseq,
    cseq)."""
    ys, acts, hseq, cseq, h_t, c_t = lstm_train_fwd(
        x_proj, w_hh, h0, c0, mask, residual_dtype)
    return ys, h_t, c_t, acts, hseq, cseq


@lstm_layer_train_op.register_fake
def _(x_proj, w_hh, h0, c0, mask, residual_dtype):
    T, B, H4 = x_proj.shape
    H = H4 // 4
    return (x_proj.new_empty((T, B, H)), x_proj.new_empty((B, H)),
            x_proj.new_empty((B, H)),
            x_proj.new_empty((T, B, H4), dtype=residual_dtype),
            x_proj.new_empty((T, B, H), dtype=residual_dtype),
            x_proj.new_empty((T, B, H), dtype=residual_dtype))


@torch.library.custom_op(f"{_OP_NAMESPACE}::lstm_layer_train_bwd",
                         mutates_args=())
def lstm_layer_train_bwd_op(dy: Tensor, dh_T: Tensor, dc_T: Tensor,
                            acts: Tensor, c_new_seq: Tensor,
                            h_prev_seq: Tensor, c_prev_seq: Tensor,
                            w_hh: Tensor, mask: Tensor
                            ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """`lstm_train_bwd` (kernel #8, its scan and dW) as an op: (dx_proj,
    dw_hh, dh0, dc0), the residual dtype acts'."""
    return lstm_train_bwd(dy, dh_T, dc_T, acts, c_new_seq, h_prev_seq,
                          c_prev_seq, w_hh, mask, acts.dtype)


@lstm_layer_train_bwd_op.register_fake
def _(dy, dh_T, dc_T, acts, c_new_seq, h_prev_seq, c_prev_seq, w_hh, mask):
    return (acts.new_empty(acts.shape, dtype=dy.dtype), torch.empty_like(w_hh),
            torch.empty_like(dh_T), torch.empty_like(dc_T))


def _op_bwd(dy, dh_T, dc_T, acts, c_new_seq, h_prev_seq, c_prev_seq, w_hh,
            mask, residual_dtype):
    return lstm_layer_train_bwd_op(dy, dh_T, dc_T, acts, c_new_seq,
                                   h_prev_seq, c_prev_seq, w_hh, mask)


def _setup_context(ctx, inputs, output):
    _, w_hh, h0, c0, mask, _ = inputs
    ctx.save_for_backward(*output[3:], h0, c0, w_hh, mask)


def _op_backward(ctx, dy, dh_T, dc_T, *_residual_grads):
    return (*_layer_backward(dy, dh_T, dc_T, *ctx.saved_tensors,
                             bwd=_op_bwd), None, None)


lstm_layer_train_op.register_autograd(_op_backward,
                                      setup_context=_setup_context)


def _layer_train_via_op(x_proj, w_hh, h0, c0, mask, residual_dtype):
    """`LSTMLayerTrain.apply` through the ops: (ys, h_T, c_T)."""
    return lstm_layer_train_op(x_proj, w_hh, h0, c0, mask,
                               residual_dtype)[:3]


# ---------------------------------------------------------------------------
# Multi-layer forward
# ---------------------------------------------------------------------------

def lstm_forward_train(layers, x: torch.Tensor, lengths=None, h0c0=None,
                       bidirectional: bool = True, time_major: bool = False,
                       residual_dtype: torch.dtype = F32):
    """Multi-layer (bi)LSTM on the training kernels
    (`lstm_forward_train_pallas`), differentiable with respect to the
    layers' parameters, x and h0c0; every layer-direction stores its
    residuals in `residual_dtype` (float32, or bfloat16 for the JAX
    package's `residual_dtype=jnp.bfloat16`).

    A mask of ones when `lengths` is None, else the length mask, in x's
    dtype; the backward direction's input reversed per length and its
    outputs reversed back; the input projection of all steps (incl. both
    biases) as one matmul outside the kernel, so autograd gives dW_ih and
    the biases' gradients from dx_proj. On bf16 params x_proj is bf16 for
    a bf16 x and float32 for a float32 one (JAX's promotion), which picks
    the kernels' bf16 entries, or the f32 forward on the widened w_hh and
    the wbf16 backward. See `nn.lstm.lstm_forward` for the argument
    layout. Under `torch.compile` or `torch.export`
    (`torch.compiler.is_compiling()`) each layer-direction calls the
    custom op `lstm_layer_train` instead, the same computation.
    """
    if time_major:
        T, B, _ = x.shape
    else:
        B, T, _ = x.shape
    n_dir = 2 if bidirectional else 1
    H = layers[0]["fwd"].w_hh.shape[0]

    xs = x if time_major else x.transpose(0, 1)          # [T, B, D]
    mask = (x.new_ones((T, B)) if lengths is None
            else length_mask(lengths, T, x.dtype))
    if h0c0 is None:
        zeros = x.new_zeros((len(layers) * n_dir, B, H))
        h0_all, c0_all = zeros, zeros
    else:
        h0_all, c0_all = (t.contiguous() for t in h0c0)
    layer_fn = (_layer_train_via_op if torch.compiler.is_compiling()
                else LSTMLayerTrain.apply)

    h_finals, c_finals = [], []
    for li, layer in enumerate(layers):
        outs = []
        for di, dname in enumerate(["fwd", "bwd"][:n_dir]):
            p = layer[dname]
            inp = xs if dname == "fwd" else _reverse_by_length(xs, lengths)
            x_proj = _project_timesteps(inp, p).contiguous()
            s = li * n_dir + di
            ys, h_t, c_t = layer_fn(x_proj, p.w_hh, h0_all[s], c0_all[s],
                                    mask, residual_dtype)
            if dname == "bwd":
                ys = _reverse_by_length(ys, lengths)
            outs.append(ys)
            h_finals.append(h_t)
            c_finals.append(c_t)
        xs = outs[0] if n_dir == 1 else torch.cat(outs, dim=-1)
    y = xs if time_major else xs.transpose(0, 1)
    return y, (torch.stack(h_finals), torch.stack(c_finals))
