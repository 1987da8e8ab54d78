"""RNN with a learned initial hidden state (PIP-style), the counterpart of
`mobileposer_tpu/nn/rnn_with_init.py` (reference
`articulate/utils/torch/rnn.py:62-110`).

A three-layer MLP regresses the LSTM's initial (h, c) of every layer and
direction from a per-sequence init vector (for example the first frame's
joint positions); the sequence then runs through an `RNNBlock` from that
state. The JAX function runs its LSTM on an XLA scan (`backend='xla'`);
the port has no such scan, so its LSTM runs the CUDA kernels, as
`rnn_apply` picks them: #2 (unidirectional) or #1 (bidirectional)
without `lengths`, #3 with them, and #7 / #8 under a training backend,
whose backward gives the init MLP its gradient through the kernels'
dh0 and dc0.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.nn.lstm import (
    LSTMConfig, RNNBlock, TRAIN_BACKENDS, check_backend, check_dtype,
    draw_dropout_keep, linear, rnn_apply)


class RNNWithInitConfig(NamedTuple):
    rnn: LSTMConfig
    n_init: int                      # init-vector dimension

    @property
    def n_state(self) -> int:
        n_dir = 2 if self.rnn.bidirectional else 1
        return 2 * self.rnn.n_layers * n_dir * self.rnn.n_hidden


class RNNWithInit(nn.Module):
    """An `RNNBlock` (`rnn`) and the init MLP `init1` (n_init -> n_state)
    -> ReLU -> `init2` (-> 2 n_state) -> ReLU -> `init3` (-> n_state)
    (reference: rnn.py:86-91), on `device` (the CUDA card unless given).
    Parameters do not require gradients until the caller turns them on,
    as in `RNNBlock`; weights are drawn like torch's defaults from
    `generator`, then cast to `dtype` (float32 or bfloat16; trained on
    bf16 params under 'auto_train', as the JAX package trains them)."""

    def __init__(self, cfg: RNNWithInitConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_dtype(dtype)
        device = resolve_device(device)
        self.cfg = cfg
        self.rnn = RNNBlock(cfg.rnn, device=device, generator=generator)
        hid = cfg.n_state
        self.init1 = nn.utils.skip_init(nn.Linear, cfg.n_init, hid,
                                        device=device)
        self.init2 = nn.utils.skip_init(nn.Linear, hid, 2 * hid,
                                        device=device)
        self.init3 = nn.utils.skip_init(nn.Linear, 2 * hid, hid,
                                        device=device)
        with torch.no_grad():
            for lin in (self.init1, self.init2, self.init3):
                bound = 1.0 / math.sqrt(lin.in_features)
                for p in (lin.weight, lin.bias):
                    u = torch.rand(p.shape, generator=generator)
                    p.copy_(u * (2 * bound) - bound)
        self.requires_grad_(False)
        self.to(dtype)

    def forward(self, x, init_vec, lengths=None, train: bool = False,
                dropout_keep=None, generator=None,
                backend: Optional[str] = None):
        return rnn_with_init_apply(self, self.cfg, x, init_vec, lengths,
                                   train=train, dropout_keep=dropout_keep,
                                   generator=generator, backend=backend)


def init_rnn_with_init(generator: Optional[torch.Generator],
                       cfg: RNNWithInitConfig, device=None,
                       dtype: torch.dtype = torch.float32) -> RNNWithInit:
    """A fresh `RNNWithInit` drawn from `generator` (a CPU
    `torch.Generator`; the JAX function takes a key) in `dtype`."""
    return RNNWithInit(cfg, device=device, generator=generator, dtype=dtype)


def initial_state(params: RNNWithInit, cfg: RNNWithInitConfig,
                  init_vec: torch.Tensor):
    """The init MLP's (h0, c0), each [n_layers * n_dir, B, H] in the
    stacking `lstm_forward` takes (layer 0 fwd, layer 0 bwd, ...)."""
    B = init_vec.shape[0]
    h = torch.relu(linear(params.init1, init_vec))
    h = torch.relu(linear(params.init2, h))
    state = linear(params.init3, h)                          # [B, n_state]
    n_dir = 2 if cfg.rnn.bidirectional else 1
    hc = state.reshape(B, 2, cfg.rnn.n_layers * n_dir, cfg.rnn.n_hidden)
    return hc[:, 0].transpose(0, 1), hc[:, 1].transpose(0, 1)


def rnn_with_init_apply(params: RNNWithInit, cfg: RNNWithInitConfig,
                        x: torch.Tensor, init_vec: torch.Tensor,
                        lengths=None, train: bool = False,
                        dropout_keep: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        backend: Optional[str] = None):
    """x [B, T, n_input], init_vec [B, n_init] -> (y [B, T, n_output],
    (h_T, c_T)), as `rnn_with_init_apply` of the JAX package.

    backend: None takes 'auto_train' when `train` is set, else 'auto'
    (`rnn_apply`'s default); name a training backend to differentiate
    without dropout. The inference kernels carry no gradient, so 'auto'
    refuses to run when autograd would need one through the init state.
    With train=True and cfg.rnn.dropout > 0 the dropout keep mask is
    `dropout_keep`, or drawn from `generator` (`draw_dropout_keep`).
    """
    if backend is None:
        backend = "auto_train" if train else "auto"
    check_backend(backend)
    h0, c0 = initial_state(params, cfg, init_vec)
    if (backend not in TRAIN_BACKENDS and torch.is_grad_enabled()
            and h0.requires_grad):
        raise RuntimeError(
            f"backend={backend!r} runs the inference kernels, which carry "
            "no gradient to the init MLP; use backend='auto_train' to "
            "differentiate, or run under torch.no_grad()")
    if train and cfg.rnn.dropout > 0.0 and dropout_keep is None:
        if generator is None:
            raise ValueError("train=True requires dropout_keep or a "
                             "generator")
        dropout_keep = draw_dropout_keep(
            cfg.rnn, x.shape[:-1] + (cfg.rnn.n_hidden,), generator)
    return rnn_apply(params.rnn, cfg.rnn, x, lengths, (h0, c0),
                     backend=backend, train=train, dropout_keep=dropout_keep)
