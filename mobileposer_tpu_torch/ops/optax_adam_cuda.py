"""CUDA step of optax's Adam / AdamW on bf16 params (`csrc/optax_adam.cu`),
the update of `train.trainer.OptaxAdam`.

It replaces no Pallas kernel: the JAX package's update is optax's, which
XLA fuses inside the jitted train step. The plain version below
(`optax_adam_plain`) is optax's chain as torch ops, one tensor after
another, 17 ops a tensor (19 with AdamW's decay); the kernel computes the
same chain with the same roundings for every tensor of a step in one
launch, in place, on the current stream, with no sync and no allocation.

On CPU tensors `optax_adam` runs the plain version. On CUDA tensors it
checks its inputs (bf16, one device, each tensor's p, g, mu and nu of one
shape and contiguous), raises on anything else, and launches the kernel,
up to `MAX_TENSORS` tensors a launch. Every launch adds one to
`launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from mobileposer_tpu_torch.ops import _build

SOURCE = "optax_adam.cu"
#: tensors one launch takes (the kernel's parameter struct holds them)
MAX_TENSORS = 32
#: the kernel's blocks per multiprocessor, at most (256 threads each)
BLOCKS_PER_SM = 8

#: launches since the last `reset_launches()`
launches = {"optax_adam_bf16": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def constants(b1: float, b2: float, eps: float, weight_decay: float,
              lr: float, count: int, dtype: torch.dtype) -> torch.Tensor:
    """The step's nine constants as a CPU tensor in `dtype`, each Python
    constant rounded to it as JAX rounds a weak-typed scalar: 1 - b1, b1,
    1 - b2, b2, the bias corrections 1 - b**count (in float32, then
    rounded), eps, the weight decay, -lr."""
    one = np.float32(1)
    return torch.tensor(
        [1 - b1, b1, 1 - b2, b2, one - np.float32(b1) ** count,
         one - np.float32(b2) ** count, eps, weight_decay, -lr], dtype=dtype)


def _check(params, grads, mus, nus) -> None:
    """What the CUDA kernel takes."""
    n = len(params)
    if not (len(grads) == len(mus) == len(nus) == n) or n == 0:
        raise ValueError(f"need one grad, mu and nu per param: {n} params, "
                         f"{len(grads)} grads, {len(mus)} mu, {len(nus)} nu")
    device = params[0].device
    for i, ts in enumerate(zip(params, grads, mus, nus)):
        for name, t in zip(("param", "grad", "mu", "nu"), ts):
            if t.dtype != torch.bfloat16:
                raise ValueError(f"the CUDA kernel takes bfloat16 tensors, "
                                 f"{name}[{i}] is {t.dtype}")
            if t.device != device:
                raise ValueError(f"{name}[{i}] is on {t.device}, param[0] "
                                 f"on {device}")
            if t.shape != ts[0].shape:
                raise ValueError(f"{name}[{i}] must be {tuple(ts[0].shape)}, "
                                 f"got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name}[{i}] must be contiguous")
        if not 0 < ts[0].numel() <= 2 ** 30:
            raise ValueError(f"the CUDA kernel takes 1 to 2**30 elements a "
                             f"tensor, param[{i}] has {ts[0].numel()}")


@torch.no_grad()
def optax_adam_plain(params, grads, mus, nus, consts: torch.Tensor,
                     decay: bool) -> None:
    """Plain version of `optax_adam`: optax's chain as torch ops, one
    tensor after another, every op rounded to the params' dtype."""
    c1, d1, c2, d2, bc1, bc2, eps, wd, neg_lr = consts.to(
        params[0].device).unbind()
    for p, g, mu, nu in zip(params, grads, mus, nus):
        mu.copy_(c1 * g + d1 * mu)
        nu.copy_(c2 * (g * g) + d2 * nu)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        if decay:
            u = u + wd * p
        p.copy_(p + neg_lr * u)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use) and load the kernel."""
    return declare(_build.load(SOURCE))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entries of a library built from `SOURCE`."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.optax_adam_bf16.argtypes = [P] * 5 + [I, P, I, I, P]
    lib.optax_adam_bf16.restype = I
    lib.optax_adam_error_string.argtypes = [I]
    lib.optax_adam_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int) -> int:
    props = torch.cuda.get_device_properties(device_index)
    return props.multi_processor_count * BLOCKS_PER_SM


def build() -> None:
    """Compile and load the kernel now rather than at first launch."""
    _lib()


def optax_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
               consts: torch.Tensor, decay: bool) -> None:
    """One optax Adam (AdamW with `decay`) step of every tensor, in place:
    params, their grads and their moments mu and nu, all in one dtype on
    one device; `consts` the nine constants of `constants`, on the CPU in
    that dtype."""
    dev = params[0].device
    if dev.type == "cpu":
        optax_adam_plain(params, grads, mus, nus, consts, decay)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(params, grads, mus, nus)
    bits = (ctypes.c_ushort * 9)(
        *(b & 0xFFFF for b in consts.view(torch.int16).tolist()))
    lib = _lib()
    max_blocks = _max_blocks(dev.index if dev.index is not None
                             else torch.cuda.current_device())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(0, len(params), MAX_TENSORS):
            part = slice(i, i + MAX_TENSORS)
            n = len(params[part])

            def ptrs(ts):
                return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

            err = lib.optax_adam_bf16(
                ptrs(params[part]), ptrs(grads[part]), ptrs(mus[part]),
                ptrs(nus[part]),
                (ctypes.c_longlong * n)(*(p.numel() for p in params[part])),
                n, bits, int(decay), max_blocks, stream)
            if err != 0:
                msg = lib.optax_adam_error_string(err).decode()
                raise RuntimeError(f"optax_adam_bf16 launch failed: CUDA "
                                   f"error {err} ({msg})")
            launches["optax_adam_bf16"] += 1
