"""AOT serving bundles (counterpart of `mobileposer_tpu/serving.py`).

Serializes the batched streaming step (exact windowed semantics or carry
mode) or the stateless batched OFFLINE forward as a `torch.export`
program, beside the weights (and, for streaming modes, a fresh streaming
state), so a serving host runs the model without the model's Python
code tracing or re-deriving anything:

    # build box
    save_bundle("bundle/", net, params, n_streams=256, mode="exact")

    # serving host (needs torch and this package's `ops` for the custom
    # ops of the LSTM kernels and the state classes, but never runs the
    # model code)
    step, params, state, meta = load_bundle("bundle/")
    (pose, joints, root, contact), state = step(params, state, frames)

The bundle is `step.pt2` (`torch.export.save`: the graph and the body
model's constants, not the weights), `weights.npz` (the JAX package's
typed layout, `nn.convert.export_npz` of `params_to_jax`, so either
package reads the other's weights), `state.npz` (`leaf_i` in the order of
the JAX package's `tree_leaves` of the state; bf16 leaves as their bits
under the `__dtypes__` manifest) and `meta.json`. The program takes the
weights as graph inputs: `step(params, state, frames)`, as the JAX one
does, runs whatever weights `load_bundle` returns.

Every LSTM layer of the exact and offline programs is one node of a
custom op of `ops/lstm_cuda.py` (`mobileposer_tpu_torch::bilstm_layer`,
...), which launches the same hand-written kernel as the eager step
(#1, #2 exact; #3 offline; #4 to #6 on int8 params); the carry program
runs no LSTM kernel, as eager carry mode does. Deliberate differences
from the JAX package: `device=` in place of `platforms=` (a bundle runs on
the device it was exported on: a CUDA bundle where no CUDA device is
visible raises, it never runs on the CPU instead; `device="cpu"` exports
a CPU bundle, for tests), and `step.pt2` in place of `step.jaxexport`.

What AOT buys here: the host runs the saved graph without tracing the
model modules (`models/`, `nn/`), and the weights are data. It skips no
compilation, since there is none: the graph runs the same kernels and
cuBLAS calls op by op through `torch.fx.GraphModule` code, and each call
first checks its inputs' shapes and dtypes. Measured by `chip_smoke.py`
phase 4h on one H100 (80GB HBM3, 700 W; PERF.md section 6): the
exact float32 step at 256 streams exports and saves in 4.7 to 7.1 s,
loads in 0.6 to 0.8 s and runs its first step in 0.009 to 0.35 s,
against 0.007 s for the eager first step; its steady step takes 1.003x
to 1.064x the eager one. The offline program unrolls `_fuse_velocity`'s
frame loop: at 64 x 512 it exports and saves in 36 to 83 s and loads in
7 to 11 s.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from mobileposer_tpu_torch.models.net import (MobilePoserNet, OnlineState,
                                              _soa_constants)
from mobileposer_tpu_torch.models.streaming import (BiCarry, CarryState,
                                                    JointsCarry)
from mobileposer_tpu_torch.nn.convert import (export_npz, load_npz,
                                              params_from_jax, params_to_jax)
from mobileposer_tpu_torch.nn.lstm import check_dtype, check_lengths
from mobileposer_tpu_torch.ops import lstm_cuda  # noqa: F401 (the ops)
from mobileposer_tpu_torch.utils.io import bf16_bits, loadz_typed

_STEP_FILE = "step.pt2"
_WEIGHTS_FILE = "weights.npz"
_STATE_FILE = "state.npz"
_META_FILE = "meta.json"

_STATE_CLASSES = ((OnlineState, "mobileposer_tpu_torch.OnlineState"),
                  (CarryState, "mobileposer_tpu_torch.CarryState"),
                  (JointsCarry, "mobileposer_tpu_torch.JointsCarry"),
                  (BiCarry, "mobileposer_tpu_torch.BiCarry"))


def _register_state_serialization() -> None:
    """Give the streaming-state NamedTuples serialized names, so that
    `torch.export.save` writes the program's input spec (the counterpart
    of `jax.export.register_namedtuple_serialization`). Idempotent."""
    for cls, name in _STATE_CLASSES:
        if cls not in pytree.SUPPORTED_SERIALIZED_TYPES:
            pytree._register_namedtuple(cls, serialized_type_name=name)


class _Program(nn.ModuleDict):
    """The four modules with `fn(modules, *args)` as forward, so that
    `torch.func.functional_call` swaps in weights passed as inputs."""

    def __init__(self, params: nn.ModuleDict, fn):
        super().__init__(params)
        self._fn = fn

    def forward(self, *args):
        return self._fn(self, *args)


class _WeightsAsInputs(nn.Module):
    """forward(weights, *args): the program on `weights`, a dict of the
    modules' parameters and buffers by name. The modules are held outside
    the module tree, so the exported program owns no weight of its own."""

    def __init__(self, program: _Program):
        super().__init__()
        self.__dict__["_program"] = program

    def forward(self, weights, *args):
        return torch.func.functional_call(self._program, weights, args)


def _weights(params: nn.Module) -> dict:
    """The program's weight input: every parameter and buffer by name."""
    return {**dict(params.named_parameters()),
            **dict(params.named_buffers())}


def _resolve(net: MobilePoserNet, device) -> torch.device:
    """The device to export for: the net's; a given one must be it."""
    if device is not None and torch.device(device).type != net.device.type:
        raise ValueError(f"device {device} differs from the net's "
                         f"{net.device}: build the net on the device the "
                         "bundle is for")
    return net.device


def _export(net: MobilePoserNet, params: nn.Module, fn, args, dtype):
    """`torch.export` of `fn(params, *args)` with the weights as the first
    input. The body model's tensor caches are built first, outside the
    trace, so that the eager path never sees a traced tensor."""
    check_dtype(dtype)
    _register_state_serialization()
    _soa_constants(net.body_model, net.device, dtype)
    module = _WeightsAsInputs(_Program(params, fn))
    with torch.no_grad():
        return torch.export.export(module, (_weights(params), *args),
                                   strict=False)


def export_offline_forward(net: MobilePoserNet, params: nn.Module,
                           batch_size: int, seq_len: int,
                           dtype: torch.dtype = torch.float32, device=None
                           ) -> torch.export.ExportedProgram:
    """Export the batched OFFLINE forward for batch-processing deployments
    (whole padded sequences in, pose/joints/tran/contact out; stateless).
    Signature: (weights, imu [B, T, 60], lengths int64 [B]) -> (pose,
    joints, tran, contact), the program dataset evaluation runs
    (`evaluation.pose_eval.forward_offline_batched`). The graph does not
    check the lengths' values: `load_bundle`'s step does."""
    from mobileposer_tpu_torch.evaluation.pose_eval import \
        forward_offline_batched

    device = _resolve(net, device)

    def fn(modules, imu, lengths):
        return forward_offline_batched(net, modules, imu, lengths)

    imu = torch.zeros((batch_size, seq_len, 60), dtype=dtype, device=device)
    lengths = torch.full((batch_size,), seq_len, dtype=torch.int64,
                         device=device)
    return _export(net, params, fn, (imu, lengths), dtype)


def _fresh_state(net: MobilePoserNet, n_streams: int, mode: str, dtype):
    if mode == "carry":
        return net.init_carry_state_batched(n_streams, dtype=dtype)
    if mode == "exact":
        return net.init_online_state_batched(n_streams, dtype=dtype)
    raise ValueError(f"mode must be 'carry' or 'exact', got {mode!r}")


def export_streaming_step(net: MobilePoserNet, params: nn.Module,
                          n_streams: int, mode: str = "carry",
                          dtype: torch.dtype = torch.float32, device=None,
                          state=None) -> torch.export.ExportedProgram:
    """Export one batched streaming step.

    The exported program has the live step's signature: (weights, state,
    frames [S, 60]) -> ((pose, joints, root, contact), new_state), with
    `weights` the modules' parameters and buffers by name (`load_bundle`'s
    step takes the modules). Body-model constants are baked into the
    program."""
    device = _resolve(net, device)
    if state is None:
        state = _fresh_state(net, n_streams, mode, dtype)
    step = (MobilePoserNet.forward_carry_batched if mode == "carry"
            else MobilePoserNet.forward_online_batched)

    def fn(modules, state, frames):
        return step(net, modules, state, frames)

    frames = torch.zeros((n_streams, 60), dtype=dtype, device=device)
    return _export(net, params, fn, (state, frames), dtype)


def _save_state_npz(path, state) -> None:
    export_npz({f"leaf_{i}": leaf.detach().cpu()
                for i, leaf in enumerate(pytree.tree_leaves(state))}, path)


def _state_treedef(mode: str):
    """Tree structure of a fresh streaming state, from placeholder leaves
    (no body model needed at load time)."""
    if mode == "carry":
        template = CarryState(0, 0, JointsCarry(0, 0, 0, 0, 0, 0),
                              BiCarry(0, 0, 0, 0), BiCarry(0, 0, 0, 0),
                              0, 0, 0, 0, 0, 0)
    else:
        template = OnlineState(0, 0, 0, 0, 0, 0, 0, 0)
    return pytree.tree_structure(template)


def _tensor(a, device) -> torch.Tensor:
    return (a if isinstance(a, torch.Tensor)
            else torch.from_numpy(np.array(a))).to(device)


def _load_state_npz(path, mode: str, device):
    flat = loadz_typed(path)
    leaves = [_tensor(flat[f"leaf_{i}"], device) for i in range(len(flat))]
    return pytree.tree_unflatten(leaves, _state_treedef(mode))


def _params_from_tree(tree: dict, device) -> nn.ModuleDict:
    """The port's modules from a weights tree, each leaf in its stored
    dtype: `params_from_jax` widens bf16 leaves to float32, so they are
    cast back one by one (a bf16 bundle of int8 params keeps its float32
    `b` and scales)."""
    params = params_from_jax(tree, device=device)
    for name, block in params.items():
        t = tree[name]
        pairs = [(t[lin][k], getattr(block, lin), attr)
                 for lin in ("linear1", "linear2")
                 for k, attr in (("w", "weight"), ("b", "bias"))]
        pairs += [(arr, layer[d], k)
                  for dirs, layer in zip(t["lstm"], block.lstm)
                  for d, arrays in dirs.items() for k, arr in arrays.items()]
        for src, mod, attr in pairs:
            if bf16_bits(src) is None:
                continue
            if attr in mod._parameters:
                mod._parameters[attr].data = mod._parameters[attr].data.to(
                    torch.bfloat16)
            else:
                mod._buffers[attr] = mod._buffers[attr].to(torch.bfloat16)
    return params


def save_bundle(directory, net: MobilePoserNet, params: nn.Module,
                n_streams: int, mode: str = "carry",
                dtype: torch.dtype = torch.float32, device=None,
                seq_len: int = 512, quantize: str | None = None) -> Path:
    """Write a self-contained serving bundle: exported program + weights
    + fresh state + metadata.

    mode='carry'/'exact' exports the batched STREAMING step (n_streams
    concurrent streams, carried state). mode='offline' exports the
    stateless batched offline forward over [n_streams, seq_len, 60]
    padded sequences (batch-processing deployments; no state file).

    quantize='int8' quantizes the params (`ops.quant.quantize_params_int8`)
    before export: the int8 weights ship in the weights archive (about 4x
    smaller than float32) and the exact and offline programs call the
    int8 kernels' ops (#4 to #6)."""
    directory = Path(directory)
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize {quantize!r}")
    device = _resolve(net, device)
    if quantize == "int8":
        from mobileposer_tpu_torch.ops.quant import quantize_params_int8
        params = quantize_params_int8(params)
    if mode == "offline":
        exported = export_offline_forward(net, params, n_streams, seq_len,
                                          dtype, device)
        state = None
    else:
        state = _fresh_state(net, n_streams, mode, dtype)
        exported = export_streaming_step(net, params, n_streams, mode,
                                         dtype, device, state=state)
    # the example inputs would be pickled into the file as objects;
    # without them loading unpickles tensors only
    exported.example_inputs = None
    directory.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, directory / _STEP_FILE)
    export_npz(params_to_jax(params), directory / _WEIGHTS_FILE)
    if state is not None:
        _save_state_npz(directory / _STATE_FILE, state)
    (directory / _META_FILE).write_text(json.dumps({
        "mode": mode,
        "n_streams": n_streams,
        **({"seq_len": seq_len} if mode == "offline" else {}),
        "dtype": str(dtype).removeprefix("torch."),
        **({"quantize": quantize} if quantize else {}),
        "device": device.type,
        "torch_version": torch.__version__,
        "format": "torch.export program (typed npz)",
    }, indent=2))
    return directory


def load_bundle(directory):
    """Load a serving bundle. Returns (step, params, fresh_state, meta);
    `step(params, state, frames)` runs the exported program on the
    modules' weights (no model code runs). Offline bundles return
    state=None and `step(params, imu, lengths) -> (pose, joints, tran,
    contact)`, which checks host lengths against the padded length first.

    The bundle runs on the device it was exported for (`meta["device"]`):
    a CUDA bundle raises where no CUDA device is visible."""
    _register_state_serialization()
    directory = Path(directory)
    meta = json.loads((directory / _META_FILE).read_text())
    if meta["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{directory} was exported for device {meta['device']!r} and "
            "no CUDA device is visible; a bundle never runs on another "
            "device")
    device = torch.device(meta["device"])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    program = torch.export.load(directory / _STEP_FILE).module()
    params = _params_from_tree(load_npz(directory / _WEIGHTS_FILE), device)
    if meta["mode"] == "offline":
        B, T = meta["n_streams"], meta["seq_len"]

        def step(params, imu, lengths):
            return program(_weights(params), imu,
                           check_lengths(lengths, B, T, device))
        return step, params, None, meta
    state = _load_state_npz(directory / _STATE_FILE, meta["mode"], device)

    def step(params, state, frames):
        return program(_weights(params), state, frames)

    return step, params, state, meta
