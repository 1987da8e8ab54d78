"""CUDA LSTM training kernels (counterpart of
`mobileposer_tpu/ops/lstm_train_pallas.py`).

Three kernel entries, one source (`csrc/lstm_train.cu`):

  * `lstm_train_fwd` -> `lstm_train_fwd_f32`, ports `_fwd_call` (#7): one
    layer-direction forward over a [T, B] mask that also stores the
    backward pass's residuals (gate activations, held h and c sequences);
  * `lstm_train_bwd` -> `lstm_train_bwd_f32` + `lstm_train_dw_f32`, port
    `_bwd_call` (#8): BPTT in reversed time, then the dw_hh reduction over
    the T*B rows as a second launch (partial slabs, summed here in a fixed
    order, as `_bwd_call` sums its per-tile slabs).

The two scans run as thread-block clusters of H / 32 CTAs that hold w_hh
in shared memory for all T steps; `_train_geometry` picks the batch rows
per cluster from the clusters the card holds at once.

Each wrapper checks device, dtype (float32), shapes and contiguity and
raises on anything else. On a CPU tensor it runs the plain PyTorch version
beside it (`*_plain`, a Python loop that copies the Pallas kernel body
formula for formula); on a CUDA tensor it launches the kernel or raises.
Every launch adds one to `launches`.

`LSTMLayerTrain` is the `torch.autograd.Function` over the two, the
counterpart of the `lstm_layer_train` custom VJP, and `lstm_forward_train`
the multi-layer (bi)LSTM on it (`lstm_forward_train_pallas`): one launch of
each kernel per layer-direction, as on the TPU.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from mobileposer_tpu_torch.nn.lstm import _reverse_by_length, length_mask
from mobileposer_tpu_torch.ops import _build
from mobileposer_tpu_torch.ops.lstm_cuda import (_UNITS, _check_layer,
                                                 _check_mask,
                                                 _project_timesteps)

#: launches per kernel since the last `reset_launches()`
launches = {"lstm_train_fwd_f32": 0, "lstm_train_bwd_f32": 0,
            "lstm_train_dw_f32": 0}

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
def max_active_clusters(H: int, device_index: int) -> int:
    """Clusters of both scans at H that the card holds at once
    (`cudaOccupancyMaxActiveClusters`, the fewer of #7's and #8's), taken
    at the most rows, whose shared memory is the largest, so that a
    smaller tile fits as well."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().lstm_train_max_clusters(H, _ROWS[-1], ctypes.byref(out))
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
    lib.lstm_train_fwd_f32.argtypes = [P] * 11 + [I] * 4 + [P]
    lib.lstm_train_fwd_f32.restype = I
    lib.lstm_train_bwd_f32.argtypes = [P] * 11 + [I] * 4 + [P]
    lib.lstm_train_bwd_f32.restype = I
    lib.lstm_train_max_clusters.argtypes = [I, I, ctypes.POINTER(I)]
    lib.lstm_train_max_clusters.restype = I
    lib.lstm_train_dw_f32.argtypes = [P] * 3 + [I] * 4 + [P]
    lib.lstm_train_dw_f32.restype = I
    lib.lstm_train_error_string.argtypes = [I]
    lib.lstm_train_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernels now rather than at first launch."""
    _lib()


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    """One tensor of a backward call: float32, contiguous, `shape`, on
    `device`."""
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
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


# ---------------------------------------------------------------------------
# Kernel 7: training forward
# ---------------------------------------------------------------------------

def lstm_train_fwd_plain(x_proj, w_hh, h0, c0, mask):
    """Plain version of `lstm_train_fwd`: `_fwd_kernel` step by step."""
    H = h0.shape[-1]
    h, c = h0, c0
    ys, acts, hseq, cseq = [], [], [], []
    for t in range(x_proj.shape[0]):
        gates = x_proj[t] + h @ w_hh
        i = torch.sigmoid(gates[:, 0 * H:1 * H])
        f = torch.sigmoid(gates[:, 1 * H:2 * H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:4 * H])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ys.append(m * h_new)
        acts.append(torch.cat([i, f, g, o], dim=-1))
        hseq.append(h)
        cseq.append(c)
    return (torch.stack(ys), torch.stack(acts), torch.stack(hseq),
            torch.stack(cseq), h, c)


def lstm_train_fwd(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   h0: torch.Tensor, c0: torch.Tensor, mask: torch.Tensor):
    """Training forward of one layer-direction.

    x_proj [T, B, 4H] incl. both biases; w_hh [H, 4H]; h0/c0 [B, H];
    mask [T, B] (1.0 = valid; ones for full length). Returns (ys [T,B,H],
    acts [T,B,4H] = (i, f, g, o), hseq [T,B,H], cseq [T,B,H] (the held
    carry after each step), h_T, c_T).
    """
    T, B, H = _check_layer(x_proj, w_hh, h0, c0)
    _check_mask(mask, T, B, x_proj.device)
    if x_proj.device.type == "cpu":
        return lstm_train_fwd_plain(x_proj, w_hh, h0, c0, mask)
    seq = [torch.empty((T, B, n), dtype=torch.float32, device=x_proj.device)
           for n in (H, 4 * H, H, H)]
    hc = [torch.empty((B, H), dtype=torch.float32, device=x_proj.device)
          for _ in range(2)]
    _call("lstm_train_fwd_f32", x_proj, w_hh, h0, c0, mask, *seq, *hc,
          T, B, H, train_geometry(B, H, x_proj.device).rows)
    return (*seq, *hc)


# ---------------------------------------------------------------------------
# Kernel 8: BPTT backward and its dw_hh reduction
# ---------------------------------------------------------------------------

def lstm_train_dw_plain(h_prev_seq, dgates):
    """Plain version of the dW reduction: dw_hh accumulated step by step
    in reversed time, h_prev[t]^T @ dgates[t], as the TPU kernel adds to
    its accumulator."""
    dw = h_prev_seq.new_zeros((h_prev_seq.shape[-1], dgates.shape[-1]))
    for t in reversed(range(dgates.shape[0])):
        dw = dw + h_prev_seq[t].t() @ dgates[t]
    return dw


def lstm_train_bwd_plain(dy, dh_T, dc_T, acts, c_new_seq, h_prev_seq,
                         c_prev_seq, w_hh, mask):
    """Plain version of `lstm_train_bwd`: `_bwd_kernel` step by step in
    reversed time, then the dW reduction (`lstm_train_dw_plain`)."""
    T, _, H = dy.shape
    w_t = w_hh.t()
    dh, dc = dh_T, dc_T
    dx = [None] * T
    for t in reversed(range(T)):
        m = mask[t][:, None]
        i, f, g, o = (acts[t][:, k * H:(k + 1) * H] for k in range(4))
        tanh_c = torch.tanh(c_new_seq[t])
        dh_new = m * (dh + dy[t])
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
        dh = (1.0 - m) * dh + dgates @ w_t
        dc = (1.0 - m) * dc + dc_prev_cell
    dx = torch.stack(dx)
    return dx, lstm_train_dw_plain(h_prev_seq, dx), dh, dc


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
    """Launch #8's scan on checked inputs: (dx_proj, dh0, dc0). The kernel
    reads w_hh [H, 4H] as the forward does (each CTA its column slice):
    no transpose."""
    T, B, H = dy.shape
    dev = dy.device
    dx = torch.empty((T, B, 4 * H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    _call("lstm_train_bwd_f32", dy, dh_T, dc_T, acts, c_new_seq, c_prev_seq,
          w_hh, mask, dx, dh0, dc0, T, B, H,
          train_geometry(B, H, dev).rows)
    return dx, dh0, dc0


def lstm_train_bwd(dy: torch.Tensor, dh_T: torch.Tensor, dc_T: torch.Tensor,
                   acts: torch.Tensor, c_new_seq: torch.Tensor,
                   h_prev_seq: torch.Tensor, c_prev_seq: torch.Tensor,
                   w_hh: torch.Tensor, mask: torch.Tensor):
    """BPTT of one layer-direction (the `_bwd_call` contract).

    dy [T, B, H]; dh_T/dc_T [B, H]; acts [T, B, 4H]; c_new_seq (the
    forward's cseq), h_prev_seq and c_prev_seq (the carry before each
    step) [T, B, H]; w_hh [H, 4H]; mask [T, B]. Returns (dx_proj
    [T, B, 4H], dw_hh [H, 4H], dh0 [B, H], dc0 [B, H]).
    """
    if dy.dim() != 3:
        raise ValueError(f"dy must be [T, B, H], got {tuple(dy.shape)}")
    T, B, H = dy.shape
    dev = dy.device
    for name, t, shape in (
            ("dy", dy, (T, B, H)), ("dh_T", dh_T, (B, H)),
            ("dc_T", dc_T, (B, H)), ("acts", acts, (T, B, 4 * H)),
            ("c_new_seq", c_new_seq, (T, B, H)),
            ("h_prev_seq", h_prev_seq, (T, B, H)),
            ("c_prev_seq", c_prev_seq, (T, B, H)),
            ("w_hh", w_hh, (H, 4 * H))):
        _check(name, t, shape, dev)
    _check_mask(mask, T, B, dev)
    if dev.type == "cpu":
        return lstm_train_bwd_plain(dy, dh_T, dc_T, acts, c_new_seq,
                                    h_prev_seq, c_prev_seq, w_hh, mask)
    if dev.type != "cuda" or not (
            T >= 1 and B >= 1 and H % 32 == 0 and 32 <= H <= 256):
        raise ValueError(f"the CUDA kernel takes T >= 1, B >= 1 and H a "
                         f"multiple of 32 in [32, 256]; got T={T}, B={B}, "
                         f"H={H} on {dev}")
    dx, dh0, dc0 = _bwd_scan(dy, dh_T, dc_T, acts, c_new_seq, c_prev_seq,
                             w_hh, mask)
    n_slabs, rows = _dw_slabs(T * B, H)
    slabs = torch.empty((n_slabs, H, 4 * H), dtype=torch.float32, device=dev)
    _call("lstm_train_dw_f32", h_prev_seq, dx, slabs, T * B, H, n_slabs,
          rows)
    return dx, slabs.sum(dim=0).to(w_hh.dtype), dh0, dc0


# ---------------------------------------------------------------------------
# Autograd over the two kernels
# ---------------------------------------------------------------------------

class LSTMLayerTrain(torch.autograd.Function):
    """One LSTM layer-direction with kernel #7 forward and kernel #8
    backward (the `lstm_layer_train` custom VJP). Same contract as the
    masked `_lstm_scan`: forward(x_proj [T,B,4H], w_hh [H,4H], h0, c0
    [B,H], mask [T,B]) -> (ys [T,B,H], h_T, c_T). The mask carries no
    gradient."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, h0, c0, mask):
        ys, acts, hseq, cseq, h_t, c_t = lstm_train_fwd(x_proj, w_hh, h0,
                                                        c0, mask)
        ctx.save_for_backward(acts, hseq, cseq, h0, c0, w_hh, mask)
        return ys, h_t, c_t

    @staticmethod
    def backward(ctx, dy, dh_T, dc_T):
        acts, hseq, cseq, h0, c0, w_hh, mask = ctx.saved_tensors
        # Autograd hands the cotangents through the transpose, reversal
        # and cat around the layer, so dy may be a strided view; the
        # kernel reads it densely. This is the one copy the training path
        # makes to fit a kernel. Outputs the loss does not use arrive as
        # zeros (materialized), or as None from a caller that turned that
        # off.
        dy = dy.contiguous()
        dh_T = torch.zeros_like(h0) if dh_T is None else dh_T.contiguous()
        dc_T = torch.zeros_like(c0) if dc_T is None else dc_T.contiguous()
        # the carry BEFORE each step: [h0, hseq[:-1]] (`_train_bwd`)
        h_prev = torch.cat([h0[None], hseq[:-1]])
        c_prev = torch.cat([c0[None], cseq[:-1]])
        dx, dw, dh0, dc0 = lstm_train_bwd(dy, dh_T, dc_T, acts, cseq,
                                          h_prev, c_prev, w_hh, mask)
        return dx, dw, dh0, dc0, None


def lstm_forward_train(layers, x: torch.Tensor, lengths=None, h0c0=None,
                       bidirectional: bool = True, time_major: bool = False):
    """Multi-layer (bi)LSTM on the training kernels
    (`lstm_forward_train_pallas`), differentiable with respect to the
    layers' parameters, x and h0c0.

    A mask of ones when `lengths` is None, else the length mask; the
    backward direction's input reversed per length and its outputs
    reversed back; the input projection of all steps (incl. both biases)
    as one matmul outside the kernel, so autograd gives dW_ih and the
    biases' gradients from dx_proj. See `nn.lstm.lstm_forward` for the
    argument layout.
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

    h_finals, c_finals = [], []
    for li, layer in enumerate(layers):
        outs = []
        for di, dname in enumerate(["fwd", "bwd"][:n_dir]):
            p = layer[dname]
            inp = xs if dname == "fwd" else _reverse_by_length(xs, lengths)
            x_proj = _project_timesteps(inp, p).contiguous()
            s = li * n_dir + di
            ys, h_t, c_t = LSTMLayerTrain.apply(x_proj, p.w_hh, h0_all[s],
                                                c0_all[s], mask)
            if dname == "bwd":
                ys = _reverse_by_length(ys, lengths)
            outs.append(ys)
            h_finals.append(h_t)
            c_finals.append(c_t)
        xs = outs[0] if n_dir == 1 else torch.cat(outs, dim=-1)
    y = xs if time_major else xs.transpose(0, 1)
    return y, (torch.stack(h_finals), torch.stack(c_finals))
