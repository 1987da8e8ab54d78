"""Weights between the JAX package's `.npz` layout and the port's modules.

Counterpart of `mobileposer_tpu/nn/torch_convert.py` (`load_from_npz`,
`export_to_npz`) and `mobileposer_tpu/utils/io.py` (`loadz_typed`,
`savez_typed`): an own copy of each that reads and writes the same `.npz`
archives, `__dtypes__` manifest included, and needs neither JAX nor the
JAX package. Either package loads the other's checkpoints.

The JAX pytree layout is kept: LSTM weights are input-major
(w_ih [D, 4H], w_hh [H, 4H]; `nn/lstm.py:53-63` there), which is also the
layout the CUDA kernels read. Only the linears move to torch's
`nn.Linear` layout (weight [out, in]), a transpose.
"""

from __future__ import annotations

import json
import numpy as np
import torch
from torch import nn

from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS
from mobileposer_tpu_torch.nn.lstm import (LSTMConfig, LSTMDirectionInt8,
                                           RNNBlock, check_float32)
from mobileposer_tpu_torch.ops.quant import is_quantized

# the keys of one direction of one layer: float, and W8A8
# (`ops.quant.quantize_lstm_direction`)
_FLOAT_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")
_INT8_KEYS = ("w_ih", "w_ih_scale", "w_hh", "w_hh_scale", "b")


def _loadz_typed(path) -> dict:
    """Flat {key: array} from an archive written by the JAX package's
    `savez_typed`; archives without a `__dtypes__` manifest load as plain
    `np.load` dicts. bfloat16 archives are refused (they need the bf16
    path: ROADMAP.md queue A item 14)."""
    # allow_pickle stays False: model archives must never execute pickle
    # payloads on load
    with np.load(path) as z:
        if "__dtypes__" not in z.files:
            return {k: z[k] for k in z.files}
        dtypes = json.loads(str(z["__dtypes__"]))
        out = {}
        for key, dt in dtypes.items():
            if dt == "bfloat16":
                raise NotImplementedError(
                    f"{key} is bfloat16; bf16 weights are not ported "
                    "(ROADMAP.md queue A item 14)")
            out[key] = z[key]
        return out


def load_npz(path) -> dict:
    """Nested params pytree (dicts of numpy arrays; list indices restored
    as lists) from a JAX-package `.npz`, as `load_from_npz` returns it."""
    root: dict = {}
    for key, val in _loadz_typed(path).items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def export_npz(tree: dict, path) -> None:
    """Flatten a params pytree (nested dicts and lists of arrays) into an
    `.npz` with the `__dtypes__` manifest, as the JAX package's
    `export_to_npz` + `savez_typed` write it: keys are '/'-joined paths,
    list indices as digits."""
    flat = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}/{k}" if key else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{key}/{i}")
        else:
            flat[key] = np.asarray(node)

    walk(tree, "")
    dtypes = {k: str(v.dtype) for k, v in flat.items()}
    np.savez(path, __dtypes__=json.dumps(dtypes), **flat)


def rnn_block_to_jax(block: RNNBlock) -> dict:
    """One `RNNBlock` -> its JAX-layout numpy pytree ({"linear1",
    "linear2", "lstm"}; linears as w [in, out]; W8A8 directions in the
    quantized layout), the inverse of `rnn_block_from_jax`."""
    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().copy()

    return {
        "linear1": {"w": arr(block.linear1.weight.t()),
                    "b": arr(block.linear1.bias)},
        "linear2": {"w": arr(block.linear2.weight.t()),
                    "b": arr(block.linear2.bias)},
        "lstm": [{d: {k: arr(getattr(mod, k))
                      for k in (_INT8_KEYS if is_quantized(mod)
                                else _FLOAT_KEYS)}
                  for d, mod in layer.items()} for layer in block.lstm],
    }


def params_to_jax(modules) -> dict:
    """The port's modules ({name: RNNBlock}) -> the JAX package's params
    pytree of numpy arrays, the inverse of `params_from_jax`."""
    return {name: rnn_block_to_jax(block) for name, block in modules.items()}


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = np.asarray(src)
    if src.dtype == np.int8:
        raise NotImplementedError(
            f"{name} is int8 in a float direction (keys {_FLOAT_KEYS}); a "
            f"W8A8 direction has the keys {_INT8_KEYS} "
            "(ops.quant.quantize_lstm_direction)")
    if src.dtype.kind != "f":
        raise ValueError(f"{name}: expected a float array, got {src.dtype}")
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: expected shape {tuple(dst.shape)}, got "
                         f"{tuple(src.shape)}")
    dst.copy_(torch.tensor(src.astype(np.float32)))


def rnn_block_from_jax(tree: dict, cfg: LSTMConfig, device) -> RNNBlock:
    """One RNN block's numpy pytree ({"linear1", "linear2", "lstm"}) ->
    an `RNNBlock` on `device`, every float array carried over as float32,
    W8A8 directions as `LSTMDirectionInt8`."""
    # a private generator: the placeholder draws leave the global RNG alone
    block = RNNBlock(cfg, device=device, generator=torch.Generator())
    for lin in ("linear1", "linear2"):
        mod = getattr(block, lin)
        _copy(mod.weight, np.asarray(tree[lin]["w"]).T, f"{lin}/w")
        _copy(mod.bias, tree[lin]["b"], f"{lin}/b")
    if len(tree["lstm"]) != cfg.n_layers:
        raise ValueError(f"expected {cfg.n_layers} LSTM layers, got "
                         f"{len(tree['lstm'])}")
    for li, (dirs, layer) in enumerate(zip(tree["lstm"], block.lstm)):
        if set(dirs) != set(layer.keys()):
            raise ValueError(f"lstm/{li}: expected directions "
                             f"{sorted(layer.keys())}, got {sorted(dirs)}")
        for dname, mod in list(layer.items()):
            where = f"lstm/{li}/{dname}"
            if set(dirs[dname]) == set(_INT8_KEYS):
                try:
                    layer[dname] = LSTMDirectionInt8(
                        **{k: dirs[dname][k] for k in _INT8_KEYS},
                        device=device)
                except ValueError as e:
                    raise ValueError(f"{where}/{e}") from None
                if layer[dname].w_ih.shape != mod.w_ih.shape:
                    raise ValueError(
                        f"{where}/w_ih: expected shape "
                        f"{tuple(mod.w_ih.shape)}, got "
                        f"{tuple(layer[dname].w_ih.shape)}")
                continue
            for k in _FLOAT_KEYS:
                _copy(getattr(mod, k), dirs[dname][k], f"{where}/{k}")
    return block


def params_from_jax(tree: dict, device=None,
                    dtype: torch.dtype = torch.float32) -> nn.ModuleDict:
    """The JAX package's params pytree (numpy leaves, e.g. from `load_npz`
    or `init_all_modules` there) -> the port's four modules on `device`
    (the CUDA card unless given). Float16/32/64 leaves are cast to
    float32, the only float dtype the port runs. A direction in the W8A8
    layout of the JAX package's `quantize_params_int8` (int8 w_ih/w_hh,
    float32 scales, pre-summed b) becomes an `LSTMDirectionInt8` with its
    arrays as they are."""
    check_float32(dtype)
    device = resolve_device(device)
    return nn.ModuleDict({name: rnn_block_from_jax(tree[name], cfg, device)
                          for name, cfg in MODULE_CONFIGS.items()})
