"""Weights between the JAX package's `.npz` layout and the port's modules.

Counterpart of `mobileposer_tpu/nn/torch_convert.py` (`load_from_npz`,
`export_to_npz`): an own copy of each that reads and writes the same `.npz`
archives, through the port's `utils.io.savez_typed` / `loadz_typed`
(`__dtypes__` manifest included), and needs neither JAX nor the JAX
package. Either package loads the other's checkpoints.

The JAX pytree layout is kept: LSTM weights are input-major
(w_ih [D, 4H], w_hh [H, 4H]; `nn/lstm.py:53-63` there), which is also the
layout the CUDA kernels read. Only the linears move to torch's
`nn.Linear` layout (weight [out, in]), a transpose.

bfloat16 leaves ride in the archives as uint16 bit patterns under a
"bfloat16" manifest entry (`utils/io.py`); in the port's pytrees a bf16
leaf is a CPU `torch.bfloat16` tensor, and both directions move the bits
unrounded.
`cast_params` is the counterpart of the JAX package's
`nn.torch_convert.cast_params`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS
from mobileposer_tpu_torch.nn.lstm import (  # noqa: F401 (cast_params)
    LSTMConfig, LSTMDirectionInt8, RNNBlock, cast_params, check_dtype)
from mobileposer_tpu_torch.nn.rnn_with_init import (RNNWithInit,
                                                    RNNWithInitConfig)
from mobileposer_tpu_torch.ops.quant import is_quantized
from mobileposer_tpu_torch.utils.io import (bf16_bits, bf16_from_bits,
                                            loadz_typed, savez_typed)

# the keys of one direction of one layer: float, and W8A8
# (`ops.quant.quantize_lstm_direction`)
_FLOAT_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")
_INT8_KEYS = ("w_ih", "w_ih_scale", "w_hh", "w_hh_scale", "b")


def load_npz(path) -> dict:
    """Nested params pytree (dicts of numpy arrays; list indices restored
    as lists) from a JAX-package `.npz`, as `load_from_npz` returns it."""
    root: dict = {}
    for key, val in loadz_typed(path).items():
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
    list indices as digits; bfloat16 leaves as their uint16 bits."""
    flat = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}/{k}" if key else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{key}/{i}")
        else:
            flat[key] = node

    walk(tree, "")
    savez_typed(path, flat)


def rnn_block_to_jax(block: RNNBlock) -> dict:
    """One `RNNBlock` -> its JAX-layout numpy pytree ({"linear1",
    "linear2", "lstm"}; linears as w [in, out]; W8A8 directions in the
    quantized layout; bf16 leaves as CPU torch.bfloat16 tensors), the
    inverse of `rnn_block_from_jax`."""
    def arr(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().clone()
        return t.numpy().copy()

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
    bits = bf16_bits(src)
    if bits is not None:            # widened to float32, exactly
        src = bf16_from_bits(bits)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: expected shape {tuple(dst.shape)}, "
                             f"got {tuple(src.shape)}")
        dst.copy_(src.float())
        return
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
    an `RNNBlock` on `device`, every float array carried over as float32
    (bf16 leaves widened exactly), W8A8 directions as
    `LSTMDirectionInt8`."""
    # a private generator: the placeholder draws leave the global RNG alone
    block = RNNBlock(cfg, device=device, generator=torch.Generator())
    for lin in ("linear1", "linear2"):
        _linear_from_jax(getattr(block, lin), tree[lin], lin)
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


def _linear_from_jax(mod: nn.Linear, tree: dict, name: str) -> None:
    """Copy a JAX linear ({"w" [in, out], "b" [out]}) into an
    `nn.Linear` (weight [out, in])."""
    w = tree["w"]
    _copy(mod.weight, w.t() if isinstance(w, torch.Tensor)
          else np.asarray(w).T, f"{name}/w")
    _copy(mod.bias, tree["b"], f"{name}/b")


def rnn_with_init_from_jax(tree: dict, cfg: RNNWithInitConfig,
                           device=None) -> RNNWithInit:
    """The JAX package's `init_rnn_with_init` pytree ({"rnn", "init1",
    "init2", "init3"}) -> an `RNNWithInit` on `device` (the CUDA card
    unless given), every array carried over as float32."""
    device = resolve_device(device)
    # a private generator: the placeholder draws leave the global RNG alone
    mod = RNNWithInit(cfg, device=device, generator=torch.Generator())
    mod.rnn = rnn_block_from_jax(tree["rnn"], cfg.rnn, device)
    for name in ("init1", "init2", "init3"):
        _linear_from_jax(getattr(mod, name), tree[name], name)
    return mod


def params_from_jax(tree: dict, device=None,
                    dtype: torch.dtype = torch.float32) -> nn.ModuleDict:
    """The JAX package's params pytree (numpy leaves, e.g. from `load_npz`
    or `init_all_modules` there) -> the port's four modules on `device`
    (the CUDA card unless given), in `dtype`: float32, or bfloat16 for
    inference. Float leaves (bf16/16/32/64) are carried over as float32,
    then cast as `cast_params` casts them, so `dtype=torch.bfloat16`
    gives `cast_params(params_from_jax(tree), torch.bfloat16)` and a bf16
    archive its own bits. A direction in the W8A8 layout of the JAX
    package's `quantize_params_int8` (int8 w_ih/w_hh, float32 scales,
    pre-summed b) becomes an `LSTMDirectionInt8` with its arrays as they
    are."""
    check_dtype(dtype)
    device = resolve_device(device)
    params = nn.ModuleDict({name: rnn_block_from_jax(tree[name], cfg, device)
                            for name, cfg in MODULE_CONFIGS.items()})
    return params if dtype == torch.float32 else cast_params(params, dtype)
