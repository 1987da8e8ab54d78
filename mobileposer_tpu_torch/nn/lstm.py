"""LSTM core on PyTorch (counterpart of `mobileposer_tpu/nn/lstm.py`).

Same split as the JAX package: one large input projection over all
timesteps outside the scan, and only the recurrent product
[B, H] @ [H, 4H] plus the gate math inside it. On the card the scan is a
hand-written CUDA kernel (`ops/lstm_cuda.py`); `_lstm_scan` below is its
plain version, which the CPU path and the parity tests run.

Weights keep the JAX layout, input-major for right-multiplication:
w_ih [D, 4H], w_hh [H, 4H], gate order (i, f, g, o).

Ragged batches take `lengths` [B]: the frames past each row's length are
masked, as in the JAX package (masked steps hold the carry and emit
zeros; the backward direction reverses each row by its own length).

W8A8 int8 directions (`LSTMDirectionInt8`, made by
`ops.quant.quantize_params_int8` or loaded by `nn.convert`) run the same
routes with int8 input projections and the int8 scan kernels; the dtype of
w_ih selects them. Activations are float32, or bf16 on int8-on-bf16 params
(the int8 quantization of a bf16 cast); the scan kernels' carry stays
float32 in both.

Dtypes: float32, or bfloat16 for inference (params cast with
`nn.convert.cast_params`). In bf16 the layer scans and the multicell scan
take bf16 I/O and keep their carry in float32, as the TPU kernels do
(`_lstm_scan` below is their plain version); the carry-mode cell step
(`lstm_cell_step`) runs wholly in bf16, as the JAX package's does, the
int8 cell's gates too. Training takes float32 params; its residuals may
be stored in bf16 ('auto_train_bf16res' below). Training on bf16 params
is not ported (ROADMAP.md queue B.4).

Backends:

  * 'auto' (inference): the scan kernels of `ops/lstm_cuda.py`. They
    write their outputs through ctypes and carry no gradient, so 'auto'
    refuses to run when autograd would need one;
  * 'fused' (inference): in `models/net.py` `forward` without `lengths`,
    the poser / footcontact / velocity trio runs on the multicell kernel
    (`models/fused.py`); everywhere else, here included, it computes and
    launches exactly what 'auto' does, as in the JAX package;
  * 'auto_train' (synonym 'pallas_train'): the training kernels of
    `ops/lstm_train_cuda.py` behind a `torch.autograd.Function`
    (forward #7, BPTT backward #8), for every layer of every module;
  * 'auto_train_bf16res' (synonym 'pallas_train_bf16res'): the same with
    the residuals (gate activations, held h and c) stored in bf16, the
    kernels' `*_bf16res` entries. On the CPU it runs their plain versions
    with the residuals rounded; the JAX package resolves it to its float32
    XLA path off the TPU.

Other backends raise NotImplementedError.
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.ops.quant import int8_recurrent_gates, is_quantized


class LSTMConfig(NamedTuple):
    """Static architecture of one RNN block (reference: rnn.py:9-18)."""
    n_input: int
    n_output: int
    n_hidden: int
    n_layers: int = 2
    bidirectional: bool = True
    dropout: float = 0.4


#: backends that run the inference kernels
INFERENCE_BACKENDS = ("auto", "fused")
#: backends that run the training kernels: float32 residuals, then bf16
TRAIN_BACKENDS = ("auto_train", "pallas_train", "auto_train_bf16res",
                  "pallas_train_bf16res")


def check_backend(backend: str = "auto", allow_train: bool = True) -> None:
    """Reject a backend the port does not run; with allow_train=False (the
    inference entry points of `models/net.py`) also the training
    backends."""
    if backend in TRAIN_BACKENDS and not allow_train:
        raise NotImplementedError(
            f"backend={backend!r} runs the training kernels; this inference "
            "entry point runs backend='auto' or 'fused'")
    if backend not in INFERENCE_BACKENDS + TRAIN_BACKENDS:
        raise NotImplementedError(
            f"backend={backend!r} is not ported (no row: the port runs "
            "'auto' and 'fused' (the inference kernels) and 'auto_train' "
            "and 'auto_train_bf16res' (the training kernels))")


#: the float dtypes the port runs: float32, and bfloat16 for inference
DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype: torch.dtype) -> None:
    """Refuse a dtype other than float32 and bfloat16."""
    if dtype not in DTYPES:
        raise NotImplementedError(
            f"dtype {dtype} is not ported; the port runs float32 and "
            "bfloat16 (no ROADMAP.md row adds another)")


# the int8 dequantization scales stay float32 under `cast_params`, as in
# the JAX package (a bf16 scale would add ~0.4% error to every product)
_SCALE_KEYS = ("w_ih_scale", "w_hh_scale")


def cast_params(params: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of the port's modules (an `nn.ModuleDict` of `RNNBlock`s, or
    one block) with every float parameter and buffer cast to `dtype`
    (float32, or bfloat16 for inference), as the JAX package's
    `cast_params` casts every float leaf: int8 tensors are left alone,
    and so are the int8 dequantization scales, which stay float32. The
    input is left as it is. (`nn.convert` and `nn` export it too.)"""
    check_dtype(dtype)
    out = copy.deepcopy(params)
    for mod in out.modules():
        for name, p in mod.named_parameters(recurse=False):
            if p.dtype.is_floating_point:
                p.data = p.data.to(dtype)
        for name, b in mod.named_buffers(recurse=False):
            if b.dtype.is_floating_point and name not in _SCALE_KEYS:
                mod._buffers[name] = b.to(dtype)
    return out


# ---------------------------------------------------------------------------
# Cell math and the plain scan
# ---------------------------------------------------------------------------

def _gate_update(gates: torch.Tensor, c: torch.Tensor):
    """LSTM gate nonlinearity on precomputed gates [.., 4H], gate order
    (i, f, g, o). Returns (h_new, c_new)."""
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


def lstm_cell_step(p, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One LSTM step from a raw input (nn/lstm.py:109-122 of the JAX
    package): projects x, adds both biases and applies `_gate_update`.
    p is one direction of one layer, an `LSTMDirection` or a W8A8
    `LSTMDirectionInt8`; the dtype of its w_ih picks the route, so the
    carry-mode stack (`models/streaming.py`) runs unchanged on quantized
    params. x [B, D], h/c [B, H]; returns (h', c')."""
    if is_quantized(p):
        from mobileposer_tpu_torch.ops.quant import lstm_cell_step_int8
        return lstm_cell_step_int8(p, x, h, c)
    gates = x @ p.w_ih + (p.b_ih + p.b_hh) + h @ p.w_hh
    return _gate_update(gates, c)


def _lstm_scan(x_proj: torch.Tensor, w_hh: torch.Tensor,
               h0: torch.Tensor, c0: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               w_hh_scale: Optional[torch.Tensor] = None):
    """LSTM scan: a Python loop over T of one matmul plus the gate update.

    x_proj [T, B, 4H] (input projection incl. both biases), w_hh [H, 4H]
    (float32, or int8 with `w_hh_scale` [4H], its per-column scale: then
    the recurrent term is `ops.quant.int8_recurrent_gates`, h re-quantized
    per row every step), h0/c0 [B, H], mask [T, B] 1.0 where the frame is
    valid, or None for full-length. Returns (ys [T, B, H], (h_T, c_T)).
    Masked steps hold the carry (so (h_T, c_T) equals the state at each
    sequence's last valid frame) and emit zeros, blended without a branch
    as the JAX package does: h <- m*h_new + (1-m)*h.

    I/O dtype: float32, or bfloat16 (x_proj, w_hh, h0, c0 and the
    mask). In bf16 it computes what the TPU kernels compute in bf16
    (lstm_pallas.py:51-69): every input widened to float32, the recurrent
    product `h.to(bf16).float() @ w_hh.float()` (products of two bf16
    values are exact in float32, the sum float32), the gates, h and c in
    float32, and only ys, h_T and c_T rounded to bf16. (A bf16 matmul
    would round the product to bf16.) In float32 every cast is a no-op.
    """
    io = x_proj.dtype
    w = w_hh.float() if w_hh_scale is None else w_hh
    h, c = h0.float(), c0.float()
    ys = []
    for t in range(x_proj.shape[0]):
        rec = (h.to(io).float() @ w if w_hh_scale is None
               else int8_recurrent_gates(h, w_hh, w_hh_scale))
        h_new, c_new = _gate_update(x_proj[t].float() + rec, c)
        if mask is None:
            h, c = h_new, c_new
            ys.append(h)
            continue
        m = mask[t][:, None].float()
        c = m * c_new + (1 - m) * c
        ys.append(m * h_new)
        h = m * h_new + (1 - m) * h
    return torch.stack(ys).to(io), (h.to(io), c.to(io))


def _reverse_by_length(x: torch.Tensor, lengths: Optional[torch.Tensor]):
    """Reverse [T, B, ...] along time per sequence length.

    With lengths, frame t of sequence b maps to frame (length[b]-1-t); the
    padded tail stays in place. Applying this twice is the identity, so the
    same function un-reverses the backward scan's outputs.
    """
    if lengths is None:
        return x.flip(0)
    T = x.shape[0]
    t_idx = torch.arange(T, device=x.device)[:, None]           # [T, 1]
    lens = lengths.to(device=x.device, dtype=torch.int64)[None, :]
    src = torch.where(t_idx < lens, lens - 1 - t_idx, t_idx)   # [T, B]
    src = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.gather(x, 0, src)


def length_mask(lengths: torch.Tensor, T: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[T, B] validity mask, 1.0 where t < lengths[b] (nn/lstm.py:329 of
    the JAX package)."""
    t_idx = torch.arange(T, device=lengths.device)[:, None]
    return (t_idx < lengths[None, :]).to(dtype)


def check_lengths(lengths, B: int, T: int, device) -> torch.Tensor:
    """`lengths` as an int64 tensor [B] on `device`.

    Host values (a list, an array, a CPU tensor) must lie in [0, T]. A
    tensor already on the card is taken as it is: reading its values
    would wait for the device at every layer. While `torch.export`
    traces, the values are not known and only the dtype and shape are
    checked: the exported program's caller checks the values
    (`serving.load_bundle`).
    """
    lengths = torch.as_tensor(lengths)
    if lengths.dtype.is_floating_point or lengths.shape != (B,):
        raise ValueError(f"lengths must be integers of shape ({B},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if (lengths.device.type == "cpu" and not torch.compiler.is_compiling()
            and not bool(
            ((lengths >= 0) & (lengths <= T)).all())):
        raise ValueError(f"lengths must lie in [0, {T}], got "
                         f"{lengths.tolist()}")
    return lengths.to(device=device, dtype=torch.int64)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class LSTMDirection(nn.Module):
    """One direction of one LSTM layer, JAX layout: w_ih [n_in, 4H],
    w_hh [H, 4H], b_ih [4H], b_hh [4H]."""

    def __init__(self, n_in: int, n_hidden: int, device=None):
        super().__init__()
        H4 = 4 * n_hidden
        self.w_ih = nn.Parameter(torch.empty(n_in, H4, device=device))
        self.w_hh = nn.Parameter(torch.empty(n_hidden, H4, device=device))
        self.b_ih = nn.Parameter(torch.empty(H4, device=device))
        self.b_hh = nn.Parameter(torch.empty(H4, device=device))


class LSTMDirectionInt8(nn.Module):
    """One W8A8-quantized direction of one LSTM layer, the layout of
    `ops.quant.quantize_lstm_direction`: w_ih int8 [n_in, 4H], w_ih_scale
    f32 [4H], w_hh int8 [H, 4H], w_hh_scale f32 [4H] (per-column scales)
    and b f32 [4H] = b_ih + b_hh. They are buffers, not parameters: no
    gradient can be asked of them. Built from arrays (numpy or tensors)."""

    _DTYPES = {"w_ih": torch.int8, "w_ih_scale": torch.float32,
               "w_hh": torch.int8, "w_hh_scale": torch.float32,
               "b": torch.float32}

    def __init__(self, w_ih, w_ih_scale, w_hh, w_hh_scale, b, device=None):
        super().__init__()
        arrays = dict(w_ih=w_ih, w_ih_scale=w_ih_scale, w_hh=w_hh,
                      w_hh_scale=w_hh_scale, b=b)
        H4 = np.shape(w_hh)[-1]
        want = {"w_ih": (np.shape(w_ih)[0], H4), "w_hh": (H4 // 4, H4),
                "w_ih_scale": (H4,), "w_hh_scale": (H4,), "b": (H4,)}
        for name, arr in arrays.items():
            t = (arr.detach().clone() if isinstance(arr, torch.Tensor)
                 else torch.from_numpy(np.array(arr)))
            if t.dtype != self._DTYPES[name]:
                raise ValueError(f"{name}: expected {self._DTYPES[name]}, "
                                 f"got {t.dtype}")
            if tuple(t.shape) != want[name]:
                raise ValueError(f"{name}: expected shape {want[name]}, got "
                                 f"{tuple(t.shape)}")
            self.register_buffer(name, t.to(device))


class RNNBlock(nn.Module):
    """linear1 -> ReLU (-> dropout when training) -> multi-layer (bi)LSTM
    -> linear2 (reference: rnn.py:9-33). Parameters do not require
    gradients by default, so the inference paths build no graph; the
    trainer turns them on for the modules it trains. Parameters live on
    `device`: the CUDA card unless given.

    Weights are drawn like torch's defaults, U(-1/sqrt(fan), 1/sqrt(fan)),
    from `generator` (a CPU `torch.Generator`) so a seed fixes them; load
    trained weights with `nn.convert.params_from_jax`.
    """

    def __init__(self, cfg: LSTMConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        n_dir = 2 if cfg.bidirectional else 1
        H = cfg.n_hidden
        self.linear1 = nn.utils.skip_init(nn.Linear, cfg.n_input, H,
                                          device=device)
        self.linear2 = nn.utils.skip_init(nn.Linear, H * n_dir,
                                          cfg.n_output, device=device)
        self.lstm = nn.ModuleList()
        for layer in range(cfg.n_layers):
            n_in = H if layer == 0 else H * n_dir
            self.lstm.append(nn.ModuleDict({
                d: LSTMDirection(n_in, H, device=device)
                for d in (["fwd", "bwd"] if cfg.bidirectional else ["fwd"])}))
        self.requires_grad_(False)
        self._init_uniform(generator)

    def _init_uniform(self, generator: Optional[torch.Generator]) -> None:
        def fill(p: torch.Tensor, fan: int) -> None:
            bound = 1.0 / math.sqrt(fan)
            u = torch.rand(p.shape, generator=generator)
            p.copy_(u * (2 * bound) - bound)

        for lin in (self.linear1, self.linear2):
            fill(lin.weight, lin.in_features)
            fill(lin.bias, lin.in_features)
        for layer in self.lstm:
            for d in layer.values():
                for p in (d.w_ih, d.w_hh, d.b_ih, d.b_hh):
                    fill(p, self.cfg.n_hidden)

    def forward(self, x: torch.Tensor, lengths=None, h0c0=None,
                backend: str = "auto", time_major: bool = False,
                train: bool = False, dropout_keep=None):
        return rnn_apply(self, self.cfg, x, lengths, h0c0, backend=backend,
                         time_major=time_major, train=train,
                         dropout_keep=dropout_keep)


# ---------------------------------------------------------------------------
# Multi-layer forward
# ---------------------------------------------------------------------------

def _needs_grad(layers, x: torch.Tensor) -> bool:
    """Whether autograd would need a gradient through these layers."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        p.requires_grad for layer in layers for p in layer.parameters()))


_INT8_TRAIN_ERROR = ("int8-quantized params are inference-only (rounding "
                     "has no gradient); use float params for training")
_BF16_TRAIN_ERROR = ("bf16 params are inference-only here: the training "
                     "kernels #7 and #8 take float32 inputs (their bf16-I/O "
                     "variant is ROADMAP.md queue B.4); train in float32, "
                     "with backend='auto_train_bf16res' for bf16 "
                     "residuals")


def _quantized(layers) -> bool:
    """Whether a layer stack holds W8A8 directions."""
    return any(is_quantized(d) for layer in layers for d in layer.values())


def lstm_forward(layers, x: torch.Tensor,
                 lengths=None,
                 h0c0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 bidirectional: bool = True,
                 backend: str = "auto",
                 time_major: bool = False):
    """Multi-layer (bi)LSTM over the CUDA layer kernels.

    layers:  list of {"fwd": LSTMDirection, ["bwd": LSTMDirection]}
             (or `LSTMDirectionInt8`s: the int8 kernels, inference only)
    x:     [B, T, D] batch-major input ([T, B, D] when time_major=True)
    lengths: [B] valid lengths in [0, T], or None (= all T). With lengths
             every layer, unidirectional ones included, runs the masked
             kernels (nn/lstm.py:256 of the JAX package).
    h0c0:    optional initial state (h0, c0), each [n_layers*n_dir, B, H]
             stacked in torch order (layer0 fwd, layer0 bwd, layer1 fwd, ...)

    backend: 'auto' or 'fused' (the inference kernels, the same for
             both here; raises when autograd would need a gradient
             through them) or 'auto_train' / 'pallas_train' (the
             training kernels, differentiable), or 'auto_train_bf16res' /
             'pallas_train_bf16res' (the same, residuals stored in bf16).

    Returns (y [B, T, H*n_dir] (or [T, B, ...] if time_major),
    (h_T, c_T) stacked like h0c0). On CPU tensors every layer runs the
    kernels' plain versions; on CUDA tensors, the kernels.
    """
    check_backend(backend)
    check_dtype(x.dtype)
    if lengths is not None:
        B, T = (x.shape[1], x.shape[0]) if time_major else x.shape[:2]
        lengths = check_lengths(lengths, B, T, x.device)
    if backend in TRAIN_BACKENDS:
        if _quantized(layers):
            raise ValueError(_INT8_TRAIN_ERROR + " backends")
        if x.dtype != torch.float32:
            raise NotImplementedError(_BF16_TRAIN_ERROR)
        from mobileposer_tpu_torch.ops.lstm_train_cuda import \
            lstm_forward_train
        # the '*_bf16res' backends store bf16 residuals, as the JAX
        # package maps them
        rdt = (torch.bfloat16 if backend.endswith("bf16res")
               else torch.float32)
        return lstm_forward_train(layers, x, lengths, h0c0,
                                  bidirectional=bidirectional,
                                  time_major=time_major, residual_dtype=rdt)
    if _needs_grad(layers, x):
        raise RuntimeError(
            "backend='auto' runs the inference kernels, which carry no "
            "gradient; use backend='auto_train' to differentiate, or run "
            "under torch.no_grad()")
    from mobileposer_tpu_torch.ops.lstm_cuda import lstm_forward_cuda
    return lstm_forward_cuda(layers, x, h0c0, bidirectional=bidirectional,
                             time_major=time_major, lengths=lengths)


def draw_dropout_keep(cfg: LSTMConfig, shape, generator: torch.Generator
                      ) -> torch.Tensor:
    """The dropout keep mask of one RNN block: True with probability
    1 - cfg.dropout, drawn from `generator` on its device. `shape` is the
    hidden activation's, x.shape[:-1] + (cfg.n_hidden,)."""
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device) < (1.0 - cfg.dropout)


def rnn_apply(params: RNNBlock, cfg: LSTMConfig, x: torch.Tensor,
              lengths=None,
              h0c0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              backend: str = "auto",
              time_major: bool = False, train: bool = False,
              dropout_keep: Optional[torch.Tensor] = None):
    """Apply the RNN block (reference: rnn.py:20-33).

    x: [B, T, n_input] ([T, B, n_input] when time_major); lengths: [B]
    or None. Returns (y [B, T, n_output], (h_T, c_T)).
    With train=True, dropout (rate cfg.dropout) follows relu(linear1(x))
    as in the JAX package, where(keep, hidden / keep_prob, 0), with the
    keep mask given as `dropout_keep` (see `draw_dropout_keep`): the
    caller owns the random draw.
    """
    check_backend(backend)
    check_dtype(x.dtype)
    if train and _quantized(params.lstm):
        # caught here whatever the backend, before any work is done
        raise ValueError(_INT8_TRAIN_ERROR)
    hidden = torch.relu(params.linear1(x))
    if train and cfg.dropout > 0.0:
        if dropout_keep is None:
            raise ValueError("train=True requires dropout_keep")
        keep = 1.0 - cfg.dropout
        hidden = torch.where(dropout_keep, hidden / keep,
                             hidden.new_zeros(()))
    y, hc = lstm_forward(params.lstm, hidden, lengths, h0c0,
                         bidirectional=cfg.bidirectional, backend=backend,
                         time_major=time_major)
    return params.linear2(y), hc


def rnn_zero_state(cfg: LSTMConfig, batch: int, dtype=torch.float32,
                   device=None):
    n_dir = 2 if cfg.bidirectional else 1
    z = torch.zeros((cfg.n_layers * n_dir, batch, cfg.n_hidden),
                    dtype=dtype, device=device)
    return (z, z)
