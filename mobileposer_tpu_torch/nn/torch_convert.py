"""The reference's PyTorch checkpoints to and from the params tree
(counterpart of `mobileposer_tpu/nn/torch_convert.py:32-137`).

The reference ships weights either as per-module Lightning checkpoints or
as one combined `state_dict` saved by `combine_weights.py:41-56`, with
submodule prefixes `joints.joints`, `pose.pose`, `foot_contact.footcontact`,
`velocity.vel` (attribute names from `net.py:41-44`, `joints.py:29`,
`poser.py:32`, `footcontact.py:28`, `velocity.py:29`). Torch LSTM weights
are `weight_ih_l{k}[_reverse]` of shape [4H, in] with gate order
(i, f, g, o), the gate order of the JAX layout, so conversion is a pure
transpose.

Both directions work on the JAX package's params-tree layout (nested
dicts and lists of float32 numpy arrays); `nn.convert.params_from_jax`
makes the port's modules from it. Checkpoints load with
`torch.load(weights_only=True)`: a file that needs arbitrary unpickling
is refused.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from mobileposer_tpu_torch.nn.lstm import LSTMConfig

# (our module name) -> state_dict prefix inside the combined checkpoint
COMBINED_PREFIXES: Dict[str, str] = {
    "joints": "joints.joints",
    "poser": "pose.pose",
    "footcontact": "foot_contact.footcontact",
    "velocity": "velocity.vel",
}


def _np(t) -> np.ndarray:
    """A tensor or an array as float32 numpy (bf16 widened exactly)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def convert_rnn_state_dict(sd: Mapping[str, object], prefix: str,
                           cfg: LSTMConfig) -> dict:
    """Extract one RNN block (linear1/rnn/linear2) from a torch
    state_dict."""
    g = lambda name: _np(sd[f"{prefix}.{name}"])  # noqa: E731
    params = {
        "linear1": {"w": g("linear1.weight").T, "b": g("linear1.bias")},
        "linear2": {"w": g("linear2.weight").T, "b": g("linear2.bias")},
        "lstm": [],
    }
    for layer in range(cfg.n_layers):
        dirs = {}
        for dname, suffix in (("fwd", ""), ("bwd", "_reverse")):
            if dname == "bwd" and not cfg.bidirectional:
                continue
            dirs[dname] = {
                "w_ih": g(f"rnn.weight_ih_l{layer}{suffix}").T,
                "w_hh": g(f"rnn.weight_hh_l{layer}{suffix}").T,
                "b_ih": g(f"rnn.bias_ih_l{layer}{suffix}"),
                "b_hh": g(f"rnn.bias_hh_l{layer}{suffix}"),
            }
        params["lstm"].append(dirs)
    return params


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """A raw state_dict or a Lightning checkpoint's `state_dict`
    (reference behavior: utils/model_utils.py:6-15), loaded with
    `weights_only=True`, as float32 numpy arrays."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: _np(v) for k, v in obj.items()
            if isinstance(v, (torch.Tensor, np.ndarray))}


def convert_mobileposer_checkpoint(sd_or_path,
                                   configs: Mapping[str, LSTMConfig]) -> dict:
    """Combined checkpoint -> {"joints": ..., "poser": ..., ...} tree.

    `configs` maps the module names to their LSTMConfig
    (`models.modules.MODULE_CONFIGS`). Accepts a path or an already
    loaded state_dict.
    """
    sd = (load_torch_state_dict(sd_or_path)
          if isinstance(sd_or_path, (str, bytes))
          or hasattr(sd_or_path, "__fspath__") else sd_or_path)
    return {name: convert_rnn_state_dict(sd, COMBINED_PREFIXES[name],
                                         configs[name])
            for name in configs}


def export_rnn_state_dict(params: dict, prefix: str) -> Dict[str, np.ndarray]:
    """Inverse of convert_rnn_state_dict: one RNN block back to torch
    state_dict keys (numpy values; transpose-only, exact)."""
    sd = {
        f"{prefix}.linear1.weight": _np(params["linear1"]["w"]).T.copy(),
        f"{prefix}.linear1.bias": _np(params["linear1"]["b"]).copy(),
        f"{prefix}.linear2.weight": _np(params["linear2"]["w"]).T.copy(),
        f"{prefix}.linear2.bias": _np(params["linear2"]["b"]).copy(),
    }
    for layer, dirs in enumerate(params["lstm"]):
        for dname, suffix in (("fwd", ""), ("bwd", "_reverse")):
            if dname not in dirs:
                continue
            d = dirs[dname]
            sd[f"{prefix}.rnn.weight_ih_l{layer}{suffix}"] = \
                _np(d["w_ih"]).T.copy()
            sd[f"{prefix}.rnn.weight_hh_l{layer}{suffix}"] = \
                _np(d["w_hh"]).T.copy()
            sd[f"{prefix}.rnn.bias_ih_l{layer}{suffix}"] = \
                _np(d["b_ih"]).copy()
            sd[f"{prefix}.rnn.bias_hh_l{layer}{suffix}"] = \
                _np(d["b_hh"]).copy()
    return sd


def export_to_torch_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """A params tree -> the reference's COMBINED state_dict layout
    (reference combine_weights.py:41-56 prefixes), so a checkpoint trained
    here can be evaluated by the reference's own evaluate.py. Exact
    inverse of convert_mobileposer_checkpoint."""
    sd: Dict[str, np.ndarray] = {}
    for name, prefix in COMBINED_PREFIXES.items():
        if name in params:
            sd.update(export_rnn_state_dict(params[name], prefix))
    return sd


def save_torch_checkpoint(params: dict, path) -> None:
    """torch.save the reference-format combined state_dict (torch
    tensors, loadable by the reference's load_model,
    utils/model_utils.py:6-15)."""
    sd = {k: torch.from_numpy(v) for k, v in
          export_to_torch_state_dict(params).items()}
    torch.save(sd, path)
