"""The four MobilePoser estimation modules (counterpart of
`mobileposer_tpu/models/modules.py`), inference only.

Each module is an RNN block (`nn/lstm.py`). The configs are the
reference's layer sizes (joints.py:29, poser.py:32, footcontact.py:28,
velocity.py:29). The training losses arrive with the training slice
(ROADMAP.md queue A item 8).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.nn.lstm import LSTMConfig, RNNBlock, rnn_apply

N_IMU = C.model_config.n_imu                     # 60
N_JOINTS_OUT = C.model_config.n_output_joints    # 24
N_REDUCED = C.joint_set.n_reduced                # 16

MODULE_CONFIGS: Dict[str, LSTMConfig] = {
    # IMU(60) -> 24x3 joint positions
    "joints": LSTMConfig(N_IMU, N_JOINTS_OUT * 3, 256),
    # [joints(72) | IMU(60)] -> 16 reduced joints x r6d
    "poser": LSTMConfig(N_JOINTS_OUT * 3 + N_IMU, N_REDUCED * 6, 256),
    # [joints | IMU](132) -> 2 foot-contact logits
    "footcontact": LSTMConfig(N_JOINTS_OUT * 3 + N_IMU, 2, 64),
    # [joints | IMU](132) -> 24x3 per-joint velocity; streaming (uni) LSTM
    "velocity": LSTMConfig(N_JOINTS_OUT * 3 + N_IMU, N_JOINTS_OUT * 3, 256,
                           bidirectional=False),
}


def init_all_modules(generator: Optional[torch.Generator] = None,
                     device=None) -> nn.ModuleDict:
    """Random weights for the four modules on `device` (the CUDA card
    unless given), drawn from `generator` so a seed fixes them. The JAX
    package draws other numbers from the same seed: tests that compare
    the two carry weights over with `nn.convert.params_from_jax`."""
    device = resolve_device(device)
    return nn.ModuleDict({name: RNNBlock(cfg, device=device,
                                         generator=generator)
                          for name, cfg in MODULE_CONFIGS.items()})


def module_apply(name: str, params: RNNBlock, x: torch.Tensor,
                 lengths=None, h0c0=None, backend: str = "auto",
                 time_major: bool = False):
    """Run one module's RNN block. Returns (y, (h_T, c_T))."""
    return rnn_apply(params, MODULE_CONFIGS[name], x, lengths, h0c0,
                     backend=backend, time_major=time_major)
