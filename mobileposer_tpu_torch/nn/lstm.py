"""LSTM core on PyTorch (counterpart of `mobileposer_tpu/nn/lstm.py`).

Same split as the JAX package: one large input projection over all
timesteps outside the scan, and only the recurrent product
[B, H] @ [H, 4H] plus the gate math inside it. On the card the scan is a
hand-written CUDA kernel (`ops/lstm_cuda.py`); `_lstm_scan` below is its
plain version, which the CPU path and the parity tests run.

Weights keep the JAX layout, input-major for right-multiplication:
w_ih [D, 4H], w_hh [H, 4H], gate order (i, f, g, o).

Inference only, float32 only, full-length sequences only: `lengths` and
every `backend` other than 'auto' raise NotImplementedError naming the
ROADMAP row that adds them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn


class LSTMConfig(NamedTuple):
    """Static architecture of one RNN block (reference: rnn.py:9-18)."""
    n_input: int
    n_output: int
    n_hidden: int
    n_layers: int = 2
    bidirectional: bool = True
    dropout: float = 0.4


_BACKEND_ROWS = {
    "fused": "the fused multicell kernel, ROADMAP.md queue A item 15",
    "pallas_train": "training, ROADMAP.md queue A item 13",
    "pallas_train_bf16res": "training, ROADMAP.md queue A item 13",
    "auto_train": "training, ROADMAP.md queue A item 13",
    "auto_train_bf16res": "training, ROADMAP.md queue A item 13",
}


def check_slice_scope(lengths=None, backend: str = "auto") -> None:
    """Reject what this slice of the port does not run yet, naming the
    ROADMAP row that adds it."""
    if lengths is not None:
        raise NotImplementedError(
            "lengths (ragged batches) needs the masked LSTM kernel: "
            "ROADMAP.md queue A item 7")
    if backend != "auto":
        row = _BACKEND_ROWS.get(
            backend, "no row: 'auto' (the CUDA kernels) is the port's "
            "only backend")
        raise NotImplementedError(f"backend={backend!r} is not ported "
                                  f"({row})")


def check_float32(dtype: torch.dtype) -> None:
    if dtype != torch.float32:
        raise NotImplementedError(
            f"dtype {dtype} is not ported; the port runs float32 only "
            "(bf16 streaming: ROADMAP.md queue A item 11)")


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


def _lstm_scan(x_proj: torch.Tensor, w_hh: torch.Tensor,
               h0: torch.Tensor, c0: torch.Tensor):
    """Full-length LSTM scan: a Python loop over T of one matmul plus the
    gate update.

    x_proj [T, B, 4H] (input projection incl. both biases), w_hh [H, 4H],
    h0/c0 [B, H]. Returns (ys [T, B, H], (h_T, c_T)).
    """
    h, c = h0, c0
    ys = []
    for t in range(x_proj.shape[0]):
        h, c = _gate_update(x_proj[t] + h @ w_hh, c)
        ys.append(h)
    return torch.stack(ys), (h, c)


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


class RNNBlock(nn.Module):
    """linear1 -> ReLU -> multi-layer (bi)LSTM -> linear2 (reference:
    rnn.py:9-33). Inference only: parameters do not require gradients.

    Weights are drawn like torch's defaults, U(-1/sqrt(fan), 1/sqrt(fan)),
    from `generator` (a CPU `torch.Generator`) so a seed fixes them; load
    trained weights with `nn.convert.params_from_jax`.
    """

    def __init__(self, cfg: LSTMConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
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
                backend: str = "auto", time_major: bool = False):
        return rnn_apply(self, self.cfg, x, lengths, h0c0, backend=backend,
                         time_major=time_major)


# ---------------------------------------------------------------------------
# Multi-layer forward
# ---------------------------------------------------------------------------

def lstm_forward(layers, x: torch.Tensor,
                 lengths=None,
                 h0c0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 bidirectional: bool = True,
                 backend: str = "auto",
                 time_major: bool = False):
    """Multi-layer (bi)LSTM over the CUDA layer kernels.

    layers:  list of {"fwd": LSTMDirection, ["bwd": LSTMDirection]}
    x:       [B, T, D] batch-major input ([T, B, D] when time_major=True)
    h0c0:    optional initial state (h0, c0), each [n_layers*n_dir, B, H]
             stacked in torch order (layer0 fwd, layer0 bwd, layer1 fwd, ...)

    Returns (y [B, T, H*n_dir] (or [T, B, ...] if time_major),
    (h_T, c_T) stacked like h0c0). On CPU tensors every layer runs the
    plain scan; on CUDA tensors, the kernels.
    """
    check_slice_scope(lengths, backend)
    check_float32(x.dtype)
    from mobileposer_tpu_torch.ops.lstm_cuda import lstm_forward_cuda
    return lstm_forward_cuda(layers, x, h0c0, bidirectional=bidirectional,
                             time_major=time_major)


def rnn_apply(params: RNNBlock, cfg: LSTMConfig, x: torch.Tensor,
              lengths=None,
              h0c0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              backend: str = "auto",
              time_major: bool = False):
    """Apply the RNN block (reference: rnn.py:20-33), inference path.

    x: [B, T, n_input] ([T, B, n_input] when time_major). Returns
    (y [B, T, n_output], (h_T, c_T)).
    """
    check_slice_scope(lengths, backend)
    check_float32(x.dtype)
    hidden = torch.relu(params.linear1(x))
    y, hc = lstm_forward(params.lstm, hidden, None, h0c0,
                         bidirectional=cfg.bidirectional,
                         time_major=time_major)
    return params.linear2(y), hc


def rnn_zero_state(cfg: LSTMConfig, batch: int, dtype=torch.float32,
                   device=None):
    n_dir = 2 if cfg.bidirectional else 1
    z = torch.zeros((cfg.n_layers * n_dir, batch, cfg.n_hidden),
                    dtype=dtype, device=device)
    return (z, z)
