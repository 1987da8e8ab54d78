"""CUDA LSTM layer scans (counterpart of `mobileposer_tpu/ops/lstm_pallas.py`).

Four float32 kernel entries in `csrc/lstm_scan.cu`:

  * `lstm_layer`   -> `lstm_scan_f32`, ports `lstm_layer_pallas`
    (unidirectional full-length layer; the velocity module);
  * `bilstm_layer` -> `bilstm_scan_f32`, ports `bilstm_layer_pallas`
    (both directions of a bidirectional layer in one launch; joints,
    poser and footcontact);
  * `lstm_layer_masked` -> `lstm_scan_masked_f32` and `bilstm_layer_masked`
    -> `bilstm_scan_masked_f32` port `lstm_layer_masked_pallas` (a ragged
    batch with a [T, B] validity mask; one direction, or both directions
    of a bidirectional layer in one launch sharing the mask). Every layer
    of a forward with `lengths` runs on them.

and their W8A8 int8 counterparts in `csrc/lstm_scan_int8.cu` (int8 w_hh
with a per-column scale [4H], h re-quantized per row every step, exact
int32 products; `ops/quant.py`):

  * `lstm_layer_int8` -> `lstm_scan_int8`, ports `lstm_layer_pallas_int8`;
  * `bilstm_layer_int8` -> `bilstm_scan_int8`, ports
    `bilstm_layer_pallas_int8`;
  * `lstm_layer_masked_int8` -> `lstm_scan_masked_int8` and
    `bilstm_layer_masked_int8` -> `bilstm_scan_masked_int8` port
    `lstm_layer_masked_pallas_int8`.

Each wrapper checks device, dtypes (float32; int8 w_hh and float32
scales for the int8 entries), shapes and contiguity and raises on
anything else; it never copies an input to make it fit (the int8 wrappers
repack w_hh into the kernel's k-packed words, `ops.quant.pack_w_hh`). On
a CPU tensor it runs the plain PyTorch version beside it (`*_plain`, a
Python loop of `torch.matmul`, or `int8_recurrent_gates`, plus
`_gate_update`); on a CUDA tensor it launches the kernel or raises: an
int8 layer never falls back to the float kernels. Every launch adds one
to `launches`.

`lstm_forward_cuda` is the multi-layer forward, mirroring
`lstm_forward_pallas` (and `nn/lstm.py` `lstm_forward` of the JAX package
for ragged batches): input projections for all timesteps as one matmul
per direction (`int8_matmul` for an int8 layer), the backward direction
pre-reversed in time (per length, with `lengths`) and its outputs
un-reversed after the kernel. The dtype of w_ih picks the float or the
int8 kernels, layer by layer.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mobileposer_tpu_torch.nn.lstm import (_lstm_scan, _reverse_by_length,
                                           length_mask)
from mobileposer_tpu_torch.ops import _build
from mobileposer_tpu_torch.ops.quant import (int8_matmul, is_quantized,
                                            pack_w_hh)

#: launches per kernel since the last `reset_launches()`
launches = {"lstm_scan_f32": 0, "bilstm_scan_f32": 0,
            "lstm_scan_masked_f32": 0, "bilstm_scan_masked_f32": 0,
            "lstm_scan_int8": 0, "bilstm_scan_int8": 0,
            "lstm_scan_masked_int8": 0, "bilstm_scan_masked_int8": 0}

#: {source: {entry: number of pointer arguments}}; every entry then takes
#: T, B, H and the stream
_ENTRIES = {
    "lstm_scan.cu": {"lstm_scan_f32": 7, "bilstm_scan_f32": 14,
                     "lstm_scan_masked_f32": 8, "bilstm_scan_masked_f32": 15},
    "lstm_scan_int8.cu": {"lstm_scan_int8": 8, "bilstm_scan_int8": 16,
                          "lstm_scan_masked_int8": 9,
                          "bilstm_scan_masked_int8": 17},
}


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
        getattr(lib, name).argtypes = [P] * n_ptr + [I] * 3 + [P]
        getattr(lib, name).restype = I
    lib.lstm_scan_error_string.argtypes = [I]
    lib.lstm_scan_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernels now rather than at first launch."""
    for source in _ENTRIES:
        _lib(source)


def _check_layer(x_proj, w_hh, h0, c0, w_scale=None):
    """Validate one direction's inputs; returns (T, B, H). With `w_scale`
    (an int8 layer), w_hh must be int8 and w_scale float32 [4H]."""
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"x_proj must be [T, B, 4H], got {tuple(x_proj.shape)}")
    T, B, H4 = x_proj.shape
    H = H4 // 4
    want = {"w_hh": (H, H4), "h0": (B, H), "c0": (B, H), "w_scale": (H4,)}
    tensors = [("x_proj", x_proj), ("w_hh", w_hh), ("h0", h0), ("c0", c0)]
    if w_scale is not None:
        tensors.append(("w_scale", w_scale))
    for name, t in tensors:
        dtype = (torch.int8 if name == "w_hh" and w_scale is not None
                 else torch.float32)
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


def _check_mask(mask, T: int, B: int, device) -> None:
    """The validity mask: [T, B] float32, contiguous, beside x_proj."""
    if mask.dtype != torch.float32:
        raise ValueError(f"mask must be float32, got {mask.dtype}")
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
    return T, B, H


def _launch(name: str, inputs, n_dir: int, T: int, B: int, H: int):
    """Allocate the outputs, launch C entry `name` on the current stream
    and count the launch. The entry takes the input pointers, then ys per
    direction, then (h_T, c_T) per direction, then T, B, H and the stream.
    Returns ([ys per direction], [h_T, c_T per direction])."""
    dev = inputs[0].device
    ys = [torch.empty((T, B, H), dtype=torch.float32, device=dev)
          for _ in range(n_dir)]
    hc = [torch.empty((B, H), dtype=torch.float32, device=dev)
          for _ in range(2 * n_dir)]
    lib = _lib(next(src for src, entries in _ENTRIES.items()
                    if name in entries))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*(t.data_ptr() for t in [*inputs, *ys, *hc]),
                                 T, B, H, stream)
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
    (ys,), (h_t, c_t) = _launch("lstm_scan_f32", [x_proj, w_hh, h0, c0],
                                1, T, B, H)
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
    (ys_f, ys_b), (h_f, c_f, h_b, c_b) = _launch("bilstm_scan_f32", args,
                                                 2, T, B, H)
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
    _check_mask(mask, T, B, x_proj.device)
    if x_proj.device.type == "cpu":
        return lstm_layer_masked_plain(x_proj, w_hh, h0, c0, mask)
    (ys,), (h_t, c_t) = _launch("lstm_scan_masked_f32",
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
    _check_mask(mask, T, B, x_proj_f.device)
    if x_proj_f.device.type == "cpu":
        return bilstm_layer_masked_plain(*args, mask)
    (ys_f, ys_b), (h_f, c_f, h_b, c_b) = _launch(
        "bilstm_scan_masked_f32", [*args, mask], 2, T, B, H)
    return ys_f, ys_b, (h_f, c_f), (h_b, c_b)


# ---------------------------------------------------------------------------
# Kernels 4-6: the W8A8 int8 layer scans. Same contracts as kernels 2, 1
# and 3, with int8 w_hh [H, 4H] and its per-column scale [4H].
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
    (ys,), (h_t, c_t) = _launch(
        "lstm_scan_int8", [x_proj, pack_w_hh(w_hh), w_scale, h0, c0],
        1, T, B, H)
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
        "bilstm_scan_int8", [x_proj_f, x_proj_b, pack_w_hh(w_hh_f),
                             pack_w_hh(w_hh_b), w_scale_f, w_scale_b,
                             h0f, c0f, h0b, c0b], 2, T, B, H)
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
    _check_mask(mask, T, B, x_proj.device)
    if x_proj.device.type == "cpu":
        return lstm_layer_masked_int8_plain(x_proj, w_hh, w_scale, h0, c0,
                                            mask)
    (ys,), (h_t, c_t) = _launch(
        "lstm_scan_masked_int8",
        [x_proj, pack_w_hh(w_hh), w_scale, h0, c0, mask], 1, T, B, H)
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
    _check_mask(mask, T, B, x_proj_f.device)
    if x_proj_f.device.type == "cpu":
        return bilstm_layer_masked_int8_plain(*args, mask)
    (ys_f, ys_b), (h_f, c_f, h_b, c_b) = _launch(
        "bilstm_scan_masked_int8",
        [x_proj_f, x_proj_b, pack_w_hh(w_hh_f), pack_w_hh(w_hh_b), w_scale_f,
         w_scale_b, h0f, c0f, h0b, c0b, mask], 2, T, B, H)
    return ys_f, ys_b, (h_f, c_f), (h_b, c_b)


# ---------------------------------------------------------------------------
# Multi-layer forward
# ---------------------------------------------------------------------------

def _project_timesteps(xs: torch.Tensor, p) -> torch.Tensor:
    """Input projection over all timesteps (lstm_pallas.py:571-578): float,
    both biases summed first and added after the product; or W8A8 for an
    int8 direction, `int8_matmul` plus the pre-summed bias."""
    if is_quantized(p):
        return int8_matmul(xs, p.w_ih, p.w_ih_scale) + p.b
    return torch.matmul(xs, p.w_ih) + (p.b_ih + p.b_hh)


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
    # (bi, uni) layer functions by (masked, int8)
    routes = {(False, False): (bilstm_layer, lstm_layer),
              (True, False): (bilstm_layer_masked, lstm_layer_masked),
              (False, True): (bilstm_layer_int8, lstm_layer_int8),
              (True, True): (bilstm_layer_masked_int8,
                             lstm_layer_masked_int8)}
    extra = () if lengths is None else (length_mask(lengths, T),)
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
