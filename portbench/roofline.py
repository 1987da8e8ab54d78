"""The yardstick's arithmetic: the peaks of one NVIDIA H100 SXM, the least
time the work of one LSTM layer-scan needs (kernels #1 and #2 streaming,
#7 and #8 training), and the model's matmul FLOPs per frame.

The rule is written once, from shapes and dtypes alone, so a kernel's
roofline reads the same work whatever implements it: each input byte is
counted once and each output byte once, the recurrent products at the
peak of their operands' type, and the time is the larger of operations
over that peak and bytes over the HBM bandwidth.
"""

from __future__ import annotations

#: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # bf16 tensor cores

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def float_peak(elem_bytes: int) -> float:
    """Peak rate for products whose operands take `elem_bytes` bytes:
    the bf16 tensor cores' for 2, float32's outside them for 4."""
    return BF16_FLOPS_PER_S if elem_bytes == 2 else F32_FLOPS_PER_S


def _bound(t_ops: float, nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def layer_bound(n_dir: int, T: int, B: int, H: int, valid_steps=None,
                elem_bytes: int = 4):
    """Least time (ms) of one inference layer-scan (#1 with n_dir=2, #2
    with 1): x_proj, w_hh, h0 and c0 read once, ys, h_T and c_T written
    once, the recurrent products at the I/O type's peak. With
    `valid_steps` (the sum of a ragged batch's lengths) only valid steps
    need products and x_proj rows, and the [T, B] mask is read once.
    Returns (ms, bound_by, flops, bytes)."""
    steps = T * B if valid_steps is None else valid_steps
    flops = n_dir * steps * 2.0 * H * 4 * H
    floats = n_dir * (steps * 4 * H      # x_proj
                      + H * 4 * H        # w_hh
                      + 2 * B * H        # h0, c0
                      + T * B * H        # ys
                      + 2 * B * H)       # h_T, c_T
    if valid_steps is not None:
        floats += T * B                  # mask, shared by the directions
    return _bound(flops / float_peak(elem_bytes), elem_bytes * floats, flops)


def train_bounds(T: int, B: int, H: int, valid_steps: int,
                 res_bytes: int = 4, io_bytes: int = 4, w_bytes: int = 4):
    """Least time (ms) of one training layer-direction: "fwd" (#7) and
    "bwd" (#8's scan with its dW reduction). Residuals (acts, hseq, cseq;
    acts, c_new, h_prev, c_prev) take `res_bytes` a value; x_proj, h0,
    c0, the mask, ys, h_T, c_T, dy, dh_T, dc_T, dx_proj, dh0, dc0
    `io_bytes`; w_hh and dw_hh `w_bytes`. #7's recurrent product runs at
    the peak of the wider of the I/O and weight types, #8's dh product at
    the weight type's, dW's float32 products at float32's. Only the
    `valid_steps` need products and x_proj rows. Each value is
    (ms, bound_by, flops, bytes)."""
    H4 = 4 * H
    seq, hc = T * B * H, B * H
    prod = 2.0 * valid_steps * H * H4
    # (I/O values, weight values, residual values)
    fwd_vals = (valid_steps * H4 + 2 * hc + T * B + seq + 2 * hc,
                H * H4,
                2 * seq + T * B * H4)
    bwd_vals = (seq + 2 * hc + T * B + T * B * H4 + 2 * hc,
                2 * H * H4,
                T * B * H4 + 3 * seq)
    out = {}
    for name, t_ops, (ios, ws, res) in (
            ("fwd", prod / float_peak(max(io_bytes, w_bytes)), fwd_vals),
            ("bwd", prod / float_peak(w_bytes) + prod / F32_FLOPS_PER_S,
             bwd_vals)):
        nbytes = io_bytes * ios + w_bytes * ws + res_bytes * res
        out[name] = _bound(t_ops, nbytes, prod * (1 if name == "fwd" else 2))
    return out


def block_flops_per_frame(mod: dict) -> float:
    """Matmul FLOPs of one frame of one stream through one RNN block of
    the configuration: linear1, the (bi)LSTM layers' input and recurrent
    products, linear2."""
    n_dir = 2 if mod["bidirectional"] else 1
    H = mod["n_hidden"]
    f = 2.0 * mod["n_input"] * H
    for layer in range(mod["n_layers"]):
        n_in = H if layer == 0 else H * n_dir
        f += n_dir * 2.0 * (n_in * 4 * H + H * 4 * H)
    return f + 2.0 * H * n_dir * mod["n_output"]


def model_flops_per_frame(cfg: dict) -> float:
    """Matmul FLOPs of one frame through the four modules."""
    return sum(block_flops_per_frame(m) for m in cfg["modules"].values())


def stream_scan_bound_ms(cfg: dict, streams: int) -> float:
    """Least time (ms) of one streaming tick's layer-scans: every layer of
    every module over the whole window at B = streams, in the
    configuration's dtype."""
    T = cfg["window"]["past"] + cfg["window"]["future"]
    eb = DTYPE_BYTES[cfg["dtype"]]
    return sum(layer_bound(2 if m["bidirectional"] else 1, T, streams,
                           m["n_hidden"], elem_bytes=eb)[0] * m["n_layers"]
               for m in cfg["modules"].values())


def train_bound_ms(cfg: dict, batch: int, window: int, part: str) -> float:
    """Least time (ms) of one training step's `part` ("fwd" or "bwd") over
    every layer-direction of every module, full-length windows. The batch
    and residuals are float32; the weights take the configuration's
    dtype."""
    wb = DTYPE_BYTES[cfg["dtype"]]
    total = 0.0
    for m in cfg["modules"].values():
        n = m["n_layers"] * (2 if m["bidirectional"] else 1)
        total += n * train_bounds(window, batch, m["n_hidden"], window * batch,
                                  res_bytes=4, io_bytes=4, w_bytes=wb)[part][0]
    return total
