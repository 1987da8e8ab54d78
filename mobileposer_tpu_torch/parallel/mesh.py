"""Device meshes and sharding in one process (counterpart of
`mobileposer_tpu/parallel/mesh.py`).

The JAX package declares a `jax.sharding.Mesh`, replicates the params,
shards the batch or the stream slots over a `data` axis and lets XLA (or
`jax.shard_map`) run each shard on its device. Here a mesh is an explicit
1-D sequence of `torch.device`s, and the sharded forward is spelled out:

  * `replicate_params` copies the params once per distinct device;
  * `shard_batch` / `shard_stream_state` split the rows (or the stream
    axis) into one equal part per mesh entry, each moved to its entry's
    device (`Sharded`);
  * `shard_map(fn, mesh)` calls `fn` once per shard under the shard's
    device context, every shard issued before any is fetched, so the
    cards' work overlaps; each shard's kernels see only local tensors.
    One thread issues every shard: a shard's forward is bound by the
    host's launches, so a sharded call costs about the shards' host times
    added up (a thread per card was slower still: the threads contend for
    the interpreter lock; PERF.md);
  * `gather` brings the per-shard outputs to the host, one pinned copy per
    tensor and one event per device, and concatenates them.

The forward has no cross-row operation, so no collective is needed and a
sharded result equals the one-device result up to the per-shard tiling.

A mesh may name one device more than once: its shards then run one after
another on that device. That is how the CPU tests (eight `cpu` entries)
and a one-card run rehearse the sharded route.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from mobileposer_tpu_torch.device import device_context, resolve_device

#: the name of the mesh's one axis, as the JAX package names it
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh (its one axis is DATA_AXIS): one device
    per shard, repeats allowed."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def _check_device(device) -> torch.device:
    """`device` resolved; a CUDA index past the cards present raises
    (a mesh never falls back to another device)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index >= torch.cuda.device_count():
        raise RuntimeError(f"{device} is not present: "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return device


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A mesh over `devices`, or over every local CUDA device (the JAX
    package's `jax.devices()`), cut to the first `n_devices`. Raises when
    no CUDA device is present and none is named, or when fewer devices
    exist than `n_devices` asks for."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device found; name the mesh's "
                               "devices (e.g. devices=['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_check_device(d) for d in devices]
    if n_devices is not None:
        if not 0 < n_devices <= len(devices):
            raise ValueError(f"n_devices={n_devices} of {len(devices)} "
                             "device(s)")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


def data_parallel_mesh(device: torch.device) -> Optional[Mesh]:
    """The mesh a CLI's `--data-parallel` runs on: every local card when
    the run is on the card and there is more than one, else None (one
    device, no mesh), as the JAX CLIs build a mesh only over more than
    one device."""
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return make_mesh()
    return None


class Sharded(list):
    """Per-shard values, entry i on the mesh's device i."""


class Replicated(dict):
    """One copy of a value per distinct device: {device: value}."""


def _module_device(params: nn.Module) -> Optional[torch.device]:
    for t in list(params.parameters()) + list(params.buffers()):
        return t.device
    return None


def _copy_to(value, device: torch.device):
    """`value` on `device`: a module deep-copied and moved (itself when it
    is there already), a tensor moved, an object with `.on(device)` (a
    `MobilePoserNet`) rebound."""
    if isinstance(value, nn.Module):
        if _module_device(value) == device:
            return value
        with device_context(device):
            return copy.deepcopy(value).to(device)
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if hasattr(value, "on"):
        return value.on(device)
    raise TypeError(f"cannot place a {type(value).__name__} on a device")


def replicate_params(value, mesh: Mesh) -> Replicated:
    """`value` once per distinct device of the mesh: the params (an
    `nn.Module`), or a net or a tensor that every shard reads. An existing
    `Replicated` over the same devices is returned as it is."""
    if isinstance(value, Replicated):
        if set(value) != set(mesh.distinct):
            raise ValueError(f"replicated over {sorted(map(str, value))}, "
                             f"the mesh holds {list(map(str, mesh.distinct))}")
        return value
    return Replicated({d: _copy_to(value, d) for d in mesh.distinct})


def _split(x, dim: int, mesh: Mesh) -> Sharded:
    """x (numpy or tensor) in mesh.size equal parts along `dim`, part i on
    device i."""
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} shards; "
                         "pad the batch (pad_batch_to_multiple)")
    t = torch.as_tensor(x)
    return Sharded(part.to(d) for part, d in
                   zip(torch.chunk(t, mesh.size, dim), mesh.devices))


def shard_batch(batch, mesh: Mesh, batch_dim: int = 0) -> Sharded:
    """A batch (a dict of arrays, or one array) split over the mesh:
    `Sharded` per-shard dicts (or arrays). batch_dim=1 handles time-major
    batches; 1-D arrays (`lengths`) always shard on their only axis."""
    def parts(x):
        return _split(x, 0 if np.ndim(x) <= 1 else batch_dim, mesh)
    if not isinstance(batch, dict):
        return parts(batch)
    split = {k: parts(v) for k, v in batch.items()}
    return Sharded({k: split[k][i] for k in batch} for i in range(mesh.size))


def _tree_map(fn, tree, *rest):
    """`fn` over the leaves of nested tuples, NamedTuples, lists and dicts
    (the streaming states), with matching trees `rest`; a `Sharded` value
    is a leaf."""
    if isinstance(tree, Sharded):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return type(tree)({k: _tree_map(fn, v, *(r[k] for r in rest))
                           for k, v in tree.items()})
    if isinstance(tree, (tuple, list)):
        vals = [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        return _rebuild(tree, vals)
    return fn(tree, *rest)


def shard_stream_state(state, n_streams: int, mesh: Mesh,
                       stream_axes=None) -> Sharded:
    """A batched streaming state split over the mesh along its stream
    axis: `Sharded` states of n_streams / mesh.size streams each.

    The stream axis of each leaf comes from `stream_axes` (a matching
    tree of ints), or from the state class's `STREAM_AXES`
    (`models.net.OnlineState`, `models.streaming.CarryState`): exact,
    never inferred. For a tree with neither, a leaf whose leading (then
    second) axis has n_streams entries is split there and any other leaf
    is copied to every shard; that guess is ambiguous when n_streams
    equals another dimension (the layer stack, the ring length), which is
    why the named states declare their axes."""
    if n_streams % mesh.size:
        raise ValueError(f"{n_streams} streams do not divide over "
                         f"{mesh.size} shards")
    if stream_axes is None:
        stream_axes = getattr(type(state), "STREAM_AXES", None)

    def copies(x):
        return Sharded(x.to(d) for d in mesh.devices)

    def by_axis(x, ax):
        if x.ndim == 0:
            return copies(x)
        if x.shape[ax] != n_streams:
            # an UNBATCHED state shares the class (and STREAM_AXES) with
            # its batched variant: its declared axis indexes a window or
            # layer dimension instead
            raise ValueError(
                f"declared stream axis {ax} of a leaf with shape "
                f"{tuple(x.shape)} does not have size n_streams={n_streams}; "
                "is this state batched (init_*_state_batched)?")
        return _split(x, ax, mesh)

    def guessed(x):
        if x.ndim >= 1 and x.shape[0] == n_streams:
            return _split(x, 0, mesh)
        if x.ndim >= 2 and x.shape[1] == n_streams:
            return _split(x, 1, mesh)
        return copies(x)

    split = (_tree_map(by_axis, state, stream_axes)
             if stream_axes is not None else _tree_map(guessed, state))
    return Sharded(_tree_map(lambda parts: parts[i], split)
                   for i in range(mesh.size))


def pad_batch_to_multiple(batch: dict, multiple: int,
                          batch_dim: int = 0) -> dict:
    """Pad the batch dim of a numpy batch so it divides the mesh; padded
    rows are zeros with length 0, so masked losses ignore them.
    batch_dim=1 for time-major batches; 1-D arrays (`lengths`) always pad
    on their only axis."""
    probe = next(v for v in batch.values() if np.ndim(v) > 1)
    pad = (-probe.shape[batch_dim]) % multiple
    if pad == 0:
        return batch
    out = {}
    for k, v in batch.items():
        d = 0 if np.ndim(v) <= 1 else batch_dim
        widths = [(0, 0)] * np.ndim(v)
        widths[d] = (0, pad)
        out[k] = np.pad(v, widths)
    return out


def shard_map(fn, mesh: Mesh):
    """`fn` run once per shard: the returned callable takes `Sharded`
    arguments (entry i goes to shard i), `Replicated` ones (the shard's
    device's copy) and any other value (passed to every shard as it is),
    and returns the `Sharded` per-shard results. The calls run in mesh
    order in the caller's thread, each under its shard's device context,
    without waiting for a device, so the shards' work is all issued
    before any result is fetched (`gather`)."""
    def run(*args):
        outs = Sharded()
        for i, d in enumerate(mesh.devices):
            with device_context(d):
                outs.append(fn(*(a[i] if isinstance(a, Sharded)
                                 else a[d] if isinstance(a, Replicated)
                                 else a for a in args)))
        return outs
    return run


def copy_to_host(outs: Iterable):
    """Start copying per-shard output trees to the host: (host trees, the
    events that mark them complete). On the card each tensor goes into
    pinned memory with `non_blocking`, and one event per distinct device
    is recorded after its shards' copies; on the CPU the tensors are
    cloned and there are no events. Wait with `wait_host_copies`."""
    host = []
    events = {}
    for out in outs:
        def to_host(x):
            if not isinstance(x, torch.Tensor):
                return x
            if x.device.type != "cuda":
                return x.clone()
            with device_context(x.device):
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
            events[x.device] = None
            return h
        host.append(_tree_map(to_host, out))
    for d in events:
        with device_context(d):
            events[d] = torch.cuda.Event()
            events[d].record()
    return host, list(events.values())


def wait_host_copies(events) -> None:
    for e in events:
        e.synchronize()


def _rebuild(tree, vals):
    return type(tree)(*vals) if hasattr(tree, "_fields") else \
        type(tree)(vals)


def _prune(tree, dims):
    """`tree` with every subtree whose `dims` entry is None replaced by
    None (not fetched)."""
    if dims is None:
        return None
    if isinstance(dims, int) or isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        return type(tree)({k: _prune(v, dims[k]) for k, v in tree.items()})
    return _rebuild(tree, [_prune(v, d) for v, d in zip(tree, dims)])


def _concat(parts, orig, dims):
    """Host trees `parts` concatenated leaf by leaf along `dims`; a
    subtree whose `dims` entry is None comes from the per-shard device
    trees `orig`, as `Sharded`."""
    if dims is None:
        return Sharded(orig)
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return first if len(parts) == 1 else torch.cat(parts, dim=dims)
    if isinstance(first, dict):
        return type(first)({k: _concat(
            [p[k] for p in parts], [o[k] for o in orig],
            dims if isinstance(dims, int) else dims[k]) for k in first})
    sub = [dims] * len(first) if isinstance(dims, int) else dims
    return _rebuild(first, [_concat([p[i] for p in parts],
                                    [o[i] for o in orig], sub[i])
                            for i in range(len(first))])


def gather(outs: Sharded, dims=0, copies=None):
    """Per-shard outputs fetched to the host and concatenated. `dims`
    gives the concatenation axis: an int for every leaf, or a tree
    mirroring the output whose None entries mark subtrees that are not
    fetched but returned per shard on their devices (`Sharded`), as a
    final streaming state is. `copies`, the `copy_to_host` of the outputs
    issued earlier (a pipelined server's tick), is waited for instead of
    copying now."""
    if copies is None:
        copies = copy_to_host([_prune(o, dims) for o in outs])
    host, events = copies
    wait_host_copies(events)
    return _concat(host, list(outs), dims)


def stream_sequence_sharded(net, params, frames, mesh: Mesh,
                            mode: str = "exact",
                            dtype: torch.dtype = torch.float32, state=None):
    """S streams over frames [N, S, 60] (numpy or a tensor) through the
    exact (`forward_online_sequence_batched`) or carry
    (`forward_carry_sequence_batched`) streaming path, the streams sharded
    over the mesh: the counterpart of the JAX package's jitted streaming
    call on stream-sharded state and frames. Each shard runs the
    single-device path on its device, so exact mode launches the layer
    kernels (#1 and #2, or #4 and #6 on int8 params) per shard.

    `state` (per-shard states, `shard_stream_state`) continues streams; a
    fresh state in `dtype` otherwise. Returns ((pose, joints, root, contact) on the host,
    [N, S, ...] in `dtype`'s outputs, the final `Sharded` states on their
    devices)."""
    if mode not in ("exact", "carry"):
        raise ValueError(f"mode must be 'exact' or 'carry', got {mode!r}")
    S = frames.shape[1]
    if state is None:
        init = (net.init_carry_state_batched if mode == "carry"
                else net.init_online_state_batched)
        state = shard_stream_state(init(S, dtype), S, mesh)
    method = ("forward_carry_sequence_batched" if mode == "carry"
              else "forward_online_sequence_batched")

    def step(n, p, st, fr):
        return getattr(n, method)(p, st, fr.to(dtype))
    outs = shard_map(step, mesh)(replicate_params(net, mesh),
                                 replicate_params(params, mesh), state,
                                 shard_batch(frames, mesh, batch_dim=1))
    return gather(outs, (1, None))
