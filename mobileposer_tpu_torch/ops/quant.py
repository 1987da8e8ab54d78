"""W8A8 int8 quantized inference (counterpart of `mobileposer_tpu/ops/quant.py`).

The scheme is the JAX package's, dynamic-activation symmetric W8A8:

  * WEIGHTS: per-output-column symmetric int8 (`scale_j = amax|w[:, j]| /
    127`), quantized once on the host in numpy from the float32 weights
    (`quantize_weight_int8`, `quantize_lstm_direction`: copies of the JAX
    package's numpy code, so both packages produce the same bytes).
    Biases stay float32 and are pre-summed (`b = b_ih + b_hh`).
  * ACTIVATIONS: per-row dynamic symmetric int8 (`dynamic_quantize`),
    rounded half to even.
  * MATMUL: int8 x int8 -> int32, exact, dequantized by the outer product
    of the row and column scales; biases added in float32.

Only the LSTM matmuls are quantized; linear1/linear2 stay float32.
Quantized directions are `nn.lstm.LSTMDirectionInt8` modules (int8 w_ih /
w_hh buffers), and every inference path dispatches on the dtype of w_ih:
`ops.lstm_cuda._project_timesteps` runs the input projection through
`int8_matmul` (outside any kernel, as in the JAX package), and the layer
scans run the int8 kernels of `ops/csrc/lstm_scan_int8.cu`, whose plain
versions are `nn.lstm._lstm_scan` with `int8_recurrent_gates`.

The int32 products here are float32 matmuls of integer-valued tensors:
every product and partial sum is an integer of magnitude at most
127^2 * D, which float32 holds exactly while it stays below 2^24, i.e. for
contraction depths D <= 1040 (the port's widths are D <= 512). So the
result is the exact int32 product in any summation order, on the CPU and
in cuBLAS alike (TF32 inputs included: an int8 value has 8 significant
bits).

Training rejects quantized params (rounding has no gradient): int8
buffers are not parameters, `nn.lstm` raises for training backends and
`train=True`, and the trainer refuses to build an optimizer over them.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

# Symmetric int8 range. 127 (not 128) keeps the grid symmetric so that
# quantize(-x) == -quantize(x) and no product meets the -128 corner.
_QMAX = 127.0
# XLA folds the JAX package's `amax / 127` into a multiply by the float32
# reciprocal of 127 (a true division gives another float32 in ~5% of rows,
# tests/test_torch_quant.py), so the row scale here is `amax * _INV_QMAX`
# too, and the CUDA kernels compute it the same way.
_INV_QMAX = np.float32(1.0) / np.float32(_QMAX)
# The deepest contraction whose float32 product of int8 values is exact:
# 127^2 * D < 2^24.
MAX_EXACT_DEPTH = ((1 << 24) - 1) // (127 * 127)


# ---------------------------------------------------------------------------
# Host-side weight quantization (numpy, once)
# ---------------------------------------------------------------------------

def quantize_weight_int8(w) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-column symmetric int8. w [D, N] -> (q int8 [D, N],
    scale f32 [N]) with w ~= q * scale."""
    w = np.asarray(w, np.float32)
    scale = np.abs(w).max(axis=0) / _QMAX
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    q = np.clip(np.rint(w / scale), -_QMAX, _QMAX).astype(np.int8)
    return q, scale


def quantize_lstm_direction(p: dict) -> dict:
    """One direction of one layer ({"w_ih", "w_hh", "b_ih", "b_hh"} as
    arrays) -> the quantized layout {"w_ih" int8, "w_ih_scale", "w_hh"
    int8, "w_hh_scale", "b"}, biases pre-summed."""
    w_ih_q, s_ih = quantize_weight_int8(p["w_ih"])
    w_hh_q, s_hh = quantize_weight_int8(p["w_hh"])
    b = (np.asarray(p["b_ih"], np.float32)
         + np.asarray(p["b_hh"], np.float32))
    return {"w_ih": w_ih_q, "w_ih_scale": s_ih,
            "w_hh": w_hh_q, "w_hh_scale": s_hh, "b": b}


def is_quantized(p) -> bool:
    """True if a direction (a module or a dict of arrays) holds int8
    kernels."""
    if isinstance(p, dict):
        return np.asarray(p["w_ih"]).dtype == np.int8
    return p.w_ih.dtype == torch.int8


def quantize_params_int8(params: nn.Module) -> nn.Module:
    """Quantize every LSTM direction of the port's modules: an
    `nn.ModuleDict` of `RNNBlock`s (the four modules) or one `RNNBlock`.
    Returns new modules on the same device; the input is left as it is.
    The weights are quantized on the host from their float32 values;
    linears (and anything else) are copied unchanged. bf16 params are
    refused: the JAX package quantizes a bf16 cast (int8 on bf16 params),
    which is not ported (ROADMAP.md queue A item 14b)."""
    from mobileposer_tpu_torch.nn.lstm import (INT8_BF16_ERROR,
                                               LSTMDirectionInt8, RNNBlock)

    def rec(mod):
        if isinstance(mod, RNNBlock):
            out = copy.deepcopy(mod)
            for layer in out.lstm:
                for dname, d in list(layer.items()):
                    if is_quantized(d):
                        raise ValueError("quantize_params_int8: the params "
                                         "are quantized already")
                    if d.w_ih.dtype != torch.float32:
                        raise NotImplementedError(INT8_BF16_ERROR)
                    arrays = {k: getattr(d, k).detach().cpu().numpy()
                              for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
                    layer[dname] = LSTMDirectionInt8(
                        **quantize_lstm_direction(arrays),
                        device=d.w_ih.device)
            return out, 1
        if isinstance(mod, nn.ModuleDict):
            out, n = nn.ModuleDict(), 0
            for name, m in mod.items():
                out[name], k = rec(m)
                n += k
            return out, n
        return copy.deepcopy(mod), 0

    out, n_stacks = rec(params)
    if n_stacks == 0:
        raise ValueError(
            "quantize_params_int8: no LSTM stack found in the params; a "
            "layout change would otherwise yield a 'quantized' model that "
            "still runs float matmuls")
    return out


# ---------------------------------------------------------------------------
# Dynamic activation quantization and the int8 products (plain PyTorch)
# ---------------------------------------------------------------------------

def dynamic_quantize(x: torch.Tensor):
    """Per-row symmetric int8: x [..., D] -> (q int8, scale f32 [..., 1]).
    `torch.round` rounds half to even, as `jnp.round` does; an all-zero
    row gets scale 1e-12 and zeros."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True) * _INV_QMAX,
                            1e-12)
    q = torch.clamp(torch.round(x32 / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def _int8_dot(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 a_q [..., D] @ int8 w_q [D, N], exactly, as float32 (see the
    module docstring for why a float32 matmul is exact here)."""
    if w_q.shape[0] > MAX_EXACT_DEPTH:
        raise ValueError(f"contraction depth {w_q.shape[0]} > "
                         f"{MAX_EXACT_DEPTH}: a float32 product of int8 "
                         "values would no longer be exact")
    return torch.matmul(a_q.float(), w_q.float())


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """Dynamic-quantized x [..., D] @ int8 w_q [D, N] -> f32 [..., N]:
    acc * (x_scale * w_scale), the scales multiplied first."""
    x_q, x_scale = dynamic_quantize(x)
    return _int8_dot(x_q, w_q) * (x_scale * w_scale)


def int8_recurrent_gates(h: torch.Tensor, w_q: torch.Tensor,
                         w_scale: torch.Tensor) -> torch.Tensor:
    """Quantized recurrent gate contribution: h [B, H] @ int8 w_q [H, 4H]
    -> f32 [B, 4H], re-quantizing h per row each call. The plain version
    of the int8 kernels' recurrent step."""
    h_q, h_scale = dynamic_quantize(h)
    return _int8_dot(h_q, w_q) * (h_scale * w_scale.reshape(1, -1))


def lstm_cell_step_int8(p, x: torch.Tensor, h: torch.Tensor,
                        c: torch.Tensor):
    """One LSTM step on a quantized direction (`nn.lstm.LSTMDirectionInt8`,
    ops/quant.py:177-188 of the JAX package), the route
    `nn.lstm.lstm_cell_step` takes for int8 w_ih: both products through
    `int8_matmul`, then the pre-summed bias, then the gate update.
    x [B, D], h/c [B, H] float32; returns (h', c')."""
    from mobileposer_tpu_torch.nn.lstm import _gate_update
    gates = (int8_matmul(x, p.w_ih, p.w_ih_scale)
             + int8_matmul(h, p.w_hh, p.w_hh_scale) + p.b)
    return _gate_update(gates, c)
