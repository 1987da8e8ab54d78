"""Fused multi-module inference path (counterpart of
`mobileposer_tpu/models/fused.py`).

After the joints module, the poser / footcontact / velocity modules all
read the same 132-dim input, so their LSTM cells in one layer-row are
independent. The per-module path runs them as six launches (a
bidirectional layer each for poser and footcontact, a unidirectional
one for velocity, per row x 2 rows); here each row is one launch of the
multicell kernel (`ops/multicell_cuda.py`, CUDA `multicell_scan_f32`)
advancing all five cells, their blocks side by side on the card.

The cells compute what the per-module kernels compute for them, in the
same order of summation, and the projections are the same products, so
the path gives the per-module path's numbers (pinned on the CPU against
the JAX package, and against `backend='auto'` on the card by
`chip_smoke.py`). Inference only: full-length windows, no dropout, float
params. Under `torch.compile` or `torch.export` each launch goes through
the kernel's custom op (`multicell_lstm_traced`), the same computation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mobileposer_tpu_torch.ops.multicell_cuda import (multicell_lstm,
                                                     multicell_lstm_traced)
from mobileposer_tpu_torch.ops.quant import is_quantized

# cell order within each row: poser-fwd, poser-bwd, fc-fwd, fc-bwd, velocity
_ROW_H = (256, 256, 64, 64, 256)


def _row_projections(inputs, layer_params) -> torch.Tensor:
    """Concatenate the five cells' input projections [T, B, sum 4H].

    inputs / layer_params follow the cell order above; backward cells get
    time-reversed inputs (their outputs are un-reversed by the caller).
    Each projection is `ops.lstm_cuda._project_timesteps`' float product.
    """
    projs = []
    for (x, reverse), p in zip(inputs, layer_params):
        xi = x.flip(0) if reverse else x
        projs.append(torch.matmul(xi, p.w_ih) + (p.b_ih + p.b_hh))
    return torch.cat(projs, dim=-1)


def trio_apply(params, x132_tm: torch.Tensor,
               vel_h0c0: Tuple[torch.Tensor, torch.Tensor]):
    """Poser + FootContact + Velocity in two multicell scans.

    x132_tm: [T, B, 132] time-major; vel_h0c0: the velocity carry
    (h, c), each [2, B, 256]. Returns (poser_r6d [T,B,96], contact
    [T,B,2], vel [T,B,72], vel_hc) — matching three
    `module_apply(..., time_major=True)` calls.
    """
    pp, pf, pv = params["poser"], params["footcontact"], params["velocity"]
    if any(is_quantized(m.lstm[0]["fwd"]) for m in (pp, pf, pv)):
        # a quantized direction pre-sums b_ih + b_hh into `b` and holds
        # int8 kernels, which the row projections and the float multicell
        # kernel do not take
        raise ValueError(
            "backend='fused' (trio_apply) does not support int8-quantized "
            "params; use backend='auto'")
    T, B, _ = x132_tm.shape
    zeros = lambda h: x132_tm.new_zeros((B, h))  # noqa: E731
    scan = (multicell_lstm_traced if torch.compiler.is_compiling()
            else multicell_lstm)
    vel_h, vel_c = (t.contiguous() for t in vel_h0c0)

    hidden_p = torch.relu(pp.linear1(x132_tm))
    hidden_f = torch.relu(pf.linear1(x132_tm))
    hidden_v = torch.relu(pv.linear1(x132_tm))

    # ---- row 1: layer 0 of all three modules ----
    row1_inputs = [(hidden_p, False), (hidden_p, True),
                   (hidden_f, False), (hidden_f, True),
                   (hidden_v, False)]
    row1_layers = [pp.lstm[0]["fwd"], pp.lstm[0]["bwd"],
                   pf.lstm[0]["fwd"], pf.lstm[0]["bwd"],
                   pv.lstm[0]["fwd"]]
    x_cat = _row_projections(row1_inputs, row1_layers)
    h0s = (zeros(256), zeros(256), zeros(64), zeros(64), vel_h[0])
    c0s = (zeros(256), zeros(256), zeros(64), zeros(64), vel_c[0])
    ys, hts, cts = scan(
        x_cat, tuple(l.w_hh for l in row1_layers), h0s, c0s, _ROW_H)
    poser_l1 = torch.cat([ys[0], ys[1].flip(0)], dim=-1)         # [T,B,512]
    fc_l1 = torch.cat([ys[2], ys[3].flip(0)], dim=-1)            # [T,B,128]
    vel_l1 = ys[4]
    vel_h1, vel_c1 = hts[4], cts[4]

    # ---- row 2: layer 1 of all three modules ----
    row2_inputs = [(poser_l1, False), (poser_l1, True),
                   (fc_l1, False), (fc_l1, True),
                   (vel_l1, False)]
    row2_layers = [pp.lstm[1]["fwd"], pp.lstm[1]["bwd"],
                   pf.lstm[1]["fwd"], pf.lstm[1]["bwd"],
                   pv.lstm[1]["fwd"]]
    x_cat2 = _row_projections(row2_inputs, row2_layers)
    h0s2 = (zeros(256), zeros(256), zeros(64), zeros(64), vel_h[1])
    c0s2 = (zeros(256), zeros(256), zeros(64), zeros(64), vel_c[1])
    ys2, hts2, cts2 = scan(
        x_cat2, tuple(l.w_hh for l in row2_layers), h0s2, c0s2, _ROW_H)
    poser_out = torch.cat([ys2[0], ys2[1].flip(0)], dim=-1)
    fc_out = torch.cat([ys2[2], ys2[3].flip(0)], dim=-1)
    vel_out = ys2[4]

    poser_r6d = pp.linear2(poser_out)
    contact = pf.linear2(fc_out)
    vel = pv.linear2(vel_out)
    vel_hc = (torch.stack([vel_h1, hts2[4]]), torch.stack([vel_c1, cts2[4]]))
    return poser_r6d, contact, vel, vel_hc
