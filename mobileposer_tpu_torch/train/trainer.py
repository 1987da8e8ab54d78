"""Training loop on one CUDA device or data-parallel over several
(counterpart of `mobileposer_tpu/train/trainer.py`): per-module
optimizers, the concurrent four-module step, top-k checkpointing and
resume.

Behavioral parity target: reference `mobileposer/train.py`
(TrainingManager, train.py:33-97), per-module `configure_optimizers`
(AdamW for joints, joints.py:114; Adam elsewhere, poser.py:147,
footcontact.py:100, velocity.py:121) and Lightning's ModelCheckpoint top-3
by validation loss (train.py:48-58).

Every LSTM layer of a train step runs the training kernels (#7 forward,
#8 backward, `ops/lstm_train_cuda.py`) through `backend='auto_train'`, or
with the residuals stored in bf16 through 'auto_train_bf16res';
validation runs under `torch.no_grad()` on the inference route (the masked
kernels #3), the counterpart of the JAX package's `backend='xla'`
validation. Random draws come from explicit `torch.Generator`s, so the
numbers differ from the JAX package's `jax.random` streams; the recipe
(splits, shuffles, batches) is the same numpy code and gives the same
batches.

Data parallelism runs one process per device over `torch.distributed`
(`parallel.distributed`; `cli.train` spawns the ranks or runs under
torchrun), where the JAX package runs one program over a device mesh.
Every rank assembles the same global batch, keeps its own rows and runs
the training kernels on them; the losses and gradients are reduced
across the ranks in one collective before the non-finite guard, so every
rank updates (or skips) the same way. Two rules, as in the JAX package:

  * 'gspmd' (the default) equals the one-device step on the whole batch
    up to the order of the sums: every rank draws the whole batch's noise
    and dropout masks from the same generator and keeps its rows, each
    masked loss is normalized by the whole batch's valid frames
    (`models.modules`, `count_lengths`), and the parts are summed. The
    JAX package's gspmd route gives up its Pallas kernels on more than
    one device; the port's keeps #7 and #8.
  * 'shard_map' (`make_shard_map_train_step`, and
    `make_multi_train_step(mesh=...)` by default): each rank folds its
    rank into the draw (`parallel.fold_in`) and normalizes by its own
    rows, and the losses and gradients are averaged across the ranks.

Only rank 0 writes checkpoints, `train_state.pt`, metrics and records.
"""

from __future__ import annotations

import dataclasses
import io
import json
import re
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.data.prefetch import BatchPrefetcher
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.models import modules as M
from mobileposer_tpu_torch.nn.convert import (export_npz, load_npz,
                                              rnn_block_from_jax,
                                              rnn_block_to_jax)
from mobileposer_tpu_torch.nn.lstm import (TRAIN_BACKENDS, LSTMDirectionInt8,
                                           RNNBlock, check_backend)
from mobileposer_tpu_torch.parallel import distributed as D
from mobileposer_tpu_torch.parallel.mesh import Mesh, pad_batch_to_multiple
from mobileposer_tpu_torch.utils.metrics import (JSONLSink, MultiSink,
                                                 make_sinks)
from mobileposer_tpu_torch.utils.profiling import span

MODULE_NAMES = ("poser", "joints", "footcontact", "velocity")

DP_IMPLS = ("gspmd", "shard_map")


@dataclasses.dataclass
class TrainState:
    """One module's training state. `params` and `opt` are updated in
    place by a step (the JAX package's state is immutable and returned
    anew); `step` counts steps taken, skipped ones included."""
    params: RNNBlock
    opt: torch.optim.Optimizer
    step: int = 0


class OptaxAdam(torch.optim.Optimizer):
    """optax's `adam(lr)` / `adamw(lr)` (`scale_by_adam`, then for AdamW
    `add_decayed_weights`, then `scale_by_learning_rate`, then
    `apply_updates`) step for step in the params' own dtype, for bf16
    params: the moments in the params' dtype (`mu_dtype=None`), every
    operation rounded to it, and every Python constant (1 - b1, b1,
    1 - b2, b2, eps, the weight decay, -lr) rounded to it first, as JAX
    rounds a weak-typed scalar; the bias corrections 1 - b**count in
    float32, then rounded. torch's Adam and AdamW on bf16 params compute
    in float32 with the constants unrounded and scale before the square
    root, which moved parameters by ~120 bf16 ulps of their magnitude
    from jitted optax's within three steps (on the CPU); this order gives
    optax's bits (`tests/test_torch_train_bf16.py`)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        consts = {}   # the constants in each params' dtype, one copy each
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
                key = (p.dtype, p.device, st["step"], id(group))
                if key not in consts:
                    n, one = st["step"], np.float32(1)
                    consts[key] = torch.tensor(
                        [1 - b1, b1, 1 - b2, b2, one - np.float32(b1) ** n,
                         one - np.float32(b2) ** n, group["eps"],
                         group["weight_decay"], -group["lr"]],
                        dtype=p.dtype).to(p.device).unbind()
                c1, d1, c2, d2, bc1, bc2, eps, wd, neg_lr = consts[key]
                g, mu, nu = p.grad, st["mu"], st["nu"]
                mu.copy_(c1 * g + d1 * mu)
                nu.copy_(c2 * (g * g) + d2 * nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                if group["weight_decay"]:
                    u = u + wd * p
                p.copy_(p + neg_lr * u)


def make_optimizer(module_name: str, lr: float,
                   params: nn.Module) -> torch.optim.Optimizer:
    """AdamW for joints (reference: joints.py:114), Adam for the rest, at
    optax's defaults: betas (0.9, 0.999), eps 1e-8, and for AdamW a weight
    decay of 1e-4 (optax's default; torch's is 1e-2). One parameter group,
    so AdamW decays every parameter, biases included, as optax does.
    float32 params take torch's Adam / AdamW, bf16 params `OptaxAdam`
    (optax's order and roundings in bf16). Refuses W8A8-quantized
    modules, whose int8 weights no optimizer can update."""
    if any(isinstance(m, LSTMDirectionInt8) for m in params.modules()):
        raise ValueError("int8-quantized params are inference-only "
                         "(rounding has no gradient); train float params")
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8)
    decay = {"weight_decay": 1e-4} if module_name == "joints" else {}
    if any(p.dtype == torch.bfloat16 for p in params.parameters()):
        return OptaxAdam(params.parameters(), **kw, **decay)
    if module_name == "joints":
        return torch.optim.AdamW(params.parameters(), **decay, **kw)
    return torch.optim.Adam(params.parameters(), **kw)


def loss_fn_for(module_name: str, body_model=None,
                backend: str = "auto_train") -> Callable:
    """Loss for one module: (params, batch, generator, train=True,
    time_major=False, rows=None, count_lengths=None) -> scalar. Draws the
    module's noise and dropout mask from `generator`
    (`models.modules.draw`), then runs its deterministic loss. Only poser
    reads `body_model`. `rows` and `count_lengths` make it this rank's
    part of the whole batch's loss (the 'gspmd' rule)."""
    loss = M.LOSSES[module_name]
    extra = {"body_model": body_model} if module_name == "poser" else {}

    def fn(params, batch, generator, train: bool = True,
           time_major: bool = False, rows=None, count_lengths=None):
        draws = M.draw(module_name, batch, generator, train, rows)
        return loss(params, batch, draws, train=train, backend=backend,
                    time_major=time_major, count_lengths=count_lengths,
                    **extra)
    return fn


def init_train_state(module_name: str, generator: torch.Generator,
                     lr: float, device=None,
                     dtype: torch.dtype = torch.float32) -> TrainState:
    """Fresh weights drawn from `generator` (a CPU generator) in `dtype`
    (float32, or bf16 params), with gradients on, and a fresh optimizer
    (`make_optimizer`)."""
    params = RNNBlock(M.MODULE_CONFIGS[module_name], device=device,
                      generator=generator, dtype=dtype).requires_grad_(True)
    return TrainState(params, make_optimizer(module_name, lr, params))


def _state_from_tree(module_name: str, tree: dict, lr: float,
                     device) -> TrainState:
    """Warm start: weights from a JAX-layout numpy pytree, a fresh
    optimizer."""
    params = rnn_block_from_jax(tree, M.MODULE_CONFIGS[module_name],
                                device).requires_grad_(True)
    return TrainState(params, make_optimizer(module_name, lr, params))


def _all_finite(loss: torch.Tensor, params: nn.Module) -> torch.Tensor:
    """One device bool: the loss and every gradient are finite."""
    return torch.stack([torch.isfinite(loss).all()]
                       + [torch.isfinite(p.grad).all()
                          for p in params.parameters()
                          if p.grad is not None]).all()


def _apply_updates(states: Dict[str, TrainState],
                   losses: Dict[str, torch.Tensor]) -> None:
    """Non-finite containment (trainer.py:102-112, 235-242 of the JAX
    package): a module whose loss or any gradient is not finite keeps its
    parameters and optimizer state, while its step count still advances.
    torch's optimizers update their moments in place, so the decision is
    made before `optimizer.step()`: the flags of all modules are fetched
    together, which costs one host sync per train step."""
    names = list(losses)
    with span("mp.train.finite_flags"):
        flags = torch.stack([_all_finite(losses[n], states[n].params)
                             for n in names]).tolist()
    for n, ok in zip(names, flags):
        if ok:
            states[n].opt.step()
        states[n].step += 1


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on `device`; lengths as int64."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    for k in ("lengths", "global_lengths"):
        if k in out:
            out[k] = out[k].long()
    return out


# ---------------------------------------------------------------------------
# Data parallelism across processes
# ---------------------------------------------------------------------------

def _data_parallel(mesh: Optional[Mesh]):
    """(rank, world) of a step over `mesh`, or None on one device. A mesh
    of more than one entry trains one process per entry: the process
    group must hold exactly that many ranks."""
    if mesh is None or mesh.size == 1:
        return None
    world = D.world_size()
    if world != mesh.size:
        raise RuntimeError(
            f"a {mesh.size}-entry mesh trains one process per entry; this "
            f"process group holds {world} (initialize_distributed, "
            "torchrun, or cli.train's spawn)")
    return D.rank(), world


def local_rows(batch: Dict[str, np.ndarray], rank: int, world: int
               ) -> Dict[str, np.ndarray]:
    """This rank's rows of a global numpy batch, padded to a multiple of
    the ranks (padded rows have length 0), with the whole batch's
    lengths as `global_lengths`, which the 'gspmd' normalizers count."""
    batch = pad_batch_to_multiple(batch, world)
    local = D.host_local_batch(batch, rank, world)
    local["global_lengths"] = batch["lengths"]
    return local


def _rank_losses(loss_fns, params, batch, generator, dp, dp_impl: str,
                 train: bool, time_major: bool = False):
    """Each module's loss on this process's rows: the whole loss on one
    device; under 'shard_map' the rank's own loss, its draws folded with
    its rank; under 'gspmd' the rank's part of the whole batch's loss."""
    kw = {}
    if dp is not None:
        rank, world = dp
        if dp_impl == "shard_map":
            generator = D.fold_in(generator, rank)
        else:
            B = batch["imu"].shape[0]
            kw = dict(rows=(rank * B, world * B),
                      count_lengths=batch["global_lengths"])
    return {n: fn(params[n], batch, generator, train=train,
                  time_major=time_major, **kw)
            for n, fn in loss_fns.items()}


def all_reduce_step(losses: Dict[str, torch.Tensor], modules: Dict[str, nn.Module],
                    world: int, mean: bool) -> Dict[str, torch.Tensor]:
    """The losses and every gradient summed across the ranks ('gspmd':
    the parts of the whole batch's loss) or averaged ('shard_map'), in
    one collective on one flat buffer; the gradients are written back.
    Returns the reduced losses."""
    names = list(losses)
    params = [p for n in names for p in modules[n].parameters()
              if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params]
                     + [torch.stack([losses[n].detach() for n in names])])
    torch.distributed.all_reduce(flat)
    if mean:
        flat /= world
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return {n: flat[offset + i] for i, n in enumerate(names)}


def _broadcast_params(modules) -> None:
    """Rank 0's parameters on every rank: the ranks start equal and stay
    equal (the same reduced gradients through the same optimizer)."""
    with torch.no_grad():
        for m in modules:
            for t in list(m.parameters()) + list(m.buffers()):
                torch.distributed.broadcast(t, 0)


def _check_dp(dp, dp_impl: str, time_major: bool) -> None:
    if dp_impl not in DP_IMPLS:
        raise ValueError(f"dp_impl must be one of {DP_IMPLS}, got "
                         f"{dp_impl!r}")
    if dp is not None and time_major:
        raise ValueError("data-parallel steps take batch-major batches")


def make_train_step(module_name: str, body_model=None,
                    time_major: bool = False, backend: str = "auto_train",
                    mesh: Optional[Mesh] = None, dp_impl: str = "gspmd"):
    """(state, batch, generator) -> (state, loss) for one module: the
    loss and its gradients through the training kernels, then the
    optimizer update unless something is not finite. `batch` holds
    tensors on the state's device, [T, B, ...] when time_major (lengths
    stays [B]). The optimizer, and so the learning rate, is the state's
    own (`init_train_state`).

    With a mesh of more than one entry, each rank of the process group
    calls the step on its rows (`local_rows`) under `dp_impl` (see the
    module docstring); the returned loss is the reduced one."""
    loss_fns = {module_name: loss_fn_for(module_name, body_model,
                                         backend=backend)}
    dp = _data_parallel(mesh)
    _check_dp(dp, dp_impl, time_major)

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        state.opt.zero_grad(set_to_none=True)
        losses = _rank_losses(loss_fns, {module_name: state.params}, batch,
                              generator, dp, dp_impl, True, time_major)
        losses[module_name].backward()
        if dp is not None:
            losses = all_reduce_step(losses, {module_name: state.params},
                                     dp[1], mean=dp_impl == "shard_map")
        _apply_updates({module_name: state}, losses)
        return state, losses[module_name].detach()

    return step


def make_shard_map_train_step(module_name: str, mesh: Mesh, body_model=None,
                              backend: str = "auto_train"):
    """The 'shard_map' data-parallel step of one module: each rank runs
    the training kernels on its rows with its own draws, and the loss and
    gradients are averaged across the ranks (trainer.py:117-176 of the
    JAX package)."""
    return make_train_step(module_name, body_model, backend=backend,
                           mesh=mesh, dp_impl="shard_map")


def make_multi_train_step(body_model=None, backend: str = "auto_train",
                          module_names=MODULE_NAMES,
                          mesh: Optional[Mesh] = None,
                          dp_impl: str = "shard_map"):
    """One step advancing all modules on one batch: the sum of their
    losses differentiated once (the parameter sets are disjoint, so each
    module gets its own gradient), then each module's own optimizer and
    its own non-finite containment. Returns (states, {module: loss}).
    Draws are taken from the one generator in `module_names` order.

    With a mesh of more than one entry the step is data-parallel over the
    process group, 'shard_map' unless `dp_impl` says 'gspmd' (the JAX
    package's `make_multi_train_step(mesh=...)` is its shard_map step);
    all modules' losses and gradients go in one collective."""
    loss_fns = {n: loss_fn_for(n, body_model, backend=backend)
                for n in module_names}
    dp = _data_parallel(mesh)
    _check_dp(dp, dp_impl, False)

    def step(states: Dict[str, TrainState], batch: dict,
             generator: torch.Generator):
        with span("mp.train.forward"):
            for n in module_names:
                states[n].opt.zero_grad(set_to_none=True)
            losses = _rank_losses(loss_fns, {n: states[n].params
                                             for n in module_names},
                                  batch, generator, dp, dp_impl, True)
        with span("mp.train.backward"):
            sum(losses.values()).backward()
            if dp is not None:
                losses = all_reduce_step(
                    losses, {n: states[n].params for n in module_names},
                    dp[1], mean=dp_impl == "shard_map")
        _apply_updates(states, losses)
        return states, {n: v.detach() for n, v in losses.items()}

    return step


def make_multi_eval_step(body_model=None, module_names=MODULE_NAMES,
                         time_major: bool = False,
                         mesh: Optional[Mesh] = None):
    """All modules' validation losses on one batch: no gradients, the
    inference route (train=False, the masked kernels), as the JAX package
    validates on XLA without the training kernels' residual writes. With
    a mesh of more than one entry, each rank computes its part of the
    whole batch's losses (the 'gspmd' rule, as the JAX package validates
    on the sharded batch under either rule) and the parts are summed
    across the ranks."""
    loss_fns = {n: loss_fn_for(n, body_model, backend="auto")
                for n in module_names}
    dp = _data_parallel(mesh)
    _check_dp(dp, "gspmd", time_major)

    @torch.no_grad()
    def step(params: Dict[str, RNNBlock], batch: dict, generator):
        losses = _rank_losses(loss_fns, params, batch, generator, dp,
                              "gspmd", False, time_major)
        if dp is not None:
            flat = torch.stack([losses[n] for n in module_names])
            torch.distributed.all_reduce(flat)
            losses = {n: flat[i] for i, n in enumerate(module_names)}
        return losses
    return step


def make_eval_step(module_name: str, body_model=None,
                   time_major: bool = False, mesh: Optional[Mesh] = None):
    """Validation loss of one module (`make_multi_eval_step`)."""
    step = make_multi_eval_step(body_model, (module_name,), time_major, mesh)

    def one(params, batch, generator):
        return step({module_name: params}, batch, generator)[module_name]
    return one


# ---------------------------------------------------------------------------
# Checkpointing (reference: train.py:48-58, utils/file_utils.py:17-27)
# ---------------------------------------------------------------------------

_CKPT_RE = re.compile(r"epoch=(\d+)-valloss=([0-9.]+)\.npz$")


class Checkpointer:
    """Keep the top-k lowest-validation-loss checkpoints as .npz files in
    the JAX package's layout, so either package's `combine_weights` and
    `load_from_npz` read them."""

    def __init__(self, directory, top_k: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k

    def should_save(self, val_loss: float) -> bool:
        """True when val_loss would enter the top-k."""
        cands = self._candidates()
        return len(cands) < self.top_k or val_loss < cands[-1][0]

    def save(self, params: RNNBlock, epoch: int, val_loss: float) -> Path:
        path = self.dir / f"epoch={epoch}-valloss={val_loss:.4f}.npz"
        export_npz(rnn_block_to_jax(params), path)
        self._prune()
        return path

    def _candidates(self):
        out = []
        for p in self.dir.glob("epoch=*-valloss=*.npz"):
            m = _CKPT_RE.search(p.name)
            if m:
                out.append((float(m.group(2)), p))
        return sorted(out, key=lambda x: x[0])

    def _prune(self):
        for _, p in self._candidates()[self.top_k:]:
            p.unlink()

    def best(self) -> Optional[Path]:
        cands = self._candidates()
        return cands[0][1] if cands else None


def get_best_checkpoint(directory) -> Optional[Path]:
    """Best checkpoint in a module dir (reference: utils/file_utils.py:23-27)."""
    return Checkpointer(directory).best()


# -- full-state checkpoint / resume. The JAX package writes
# `train_state.npz` with optax's flattened leaves, which torch cannot
# share; the port writes its own `train_state.pt`: the module's
# state_dict, the optimizer's state_dict, the step and the epoch.

STATE_FILE = "train_state.pt"


def save_training_state(path, module_name: str, state: TrainState,
                        epoch: int) -> Path:
    """Persist params + optimizer state + counters for exact resume."""
    torch.save({"module": module_name, "epoch": epoch, "step": state.step,
                "params": state.params.state_dict(),
                "optimizer": state.opt.state_dict()}, path)
    return Path(path)


def restore_training_state(path, lr: float, device=None):
    """Restore (TrainState, module_name, next_epoch) from
    `save_training_state`'s file (a path, or a file object holding its
    bytes)."""
    device = resolve_device(device)
    z = torch.load(path, map_location=device, weights_only=True)
    state = init_train_state(z["module"], torch.Generator(), lr, device)
    state.params.load_state_dict(z["params"])
    state.opt.load_state_dict(z["optimizer"])
    state.step = int(z["step"])
    return state, z["module"], int(z["epoch"]) + 1


def get_checkpoint_path(root=None) -> Path:
    """Next numbered run dir under checkpoints/ (reference: train.py:100-113)."""
    root = Path(root) if root else C.paths.checkpoint
    root.mkdir(parents=True, exist_ok=True)
    nums = [int(p.name) for p in root.iterdir() if p.name.isdigit()]
    return root / str(max(nums) + 1 if nums else 1)


def _train_val_split(n: int, seed: int, val_fraction: float):
    """Deterministic sample-level split (reference: data.py:151-153).
    Returns (val_idx, train_idx, rng)."""
    rng_np = np.random.default_rng(seed)
    perm = rng_np.permutation(n)
    n_val = max(1, int(n * val_fraction))
    return perm[:n_val], perm[n_val:], rng_np


def _epoch_batches(dataset, idxs, batch_size: int, W: int, shuffle_rng):
    """One epoch of assembled batches over `idxs`, dropping the last
    partial batch."""
    order = (shuffle_rng.permutation(len(idxs)) if shuffle_rng
             else np.arange(len(idxs)))
    bs = max(1, min(batch_size, len(idxs)))
    for b0 in range(0, len(order) - bs + 1, bs):
        yield dataset._assemble(idxs[order[b0:b0 + bs]], W)


def _mean(values) -> float:
    """Mean of scalar tensors as a float (one fetch), NaN when empty."""
    if not values:
        return float("nan")
    return float(np.mean(torch.stack(values).cpu().numpy()))


# ---------------------------------------------------------------------------
# Training manager (reference: train.py:33-97)
# ---------------------------------------------------------------------------

class TrainingManager:
    """Per-module or concurrent training on one device, or data-parallel
    with one process per device."""

    def __init__(self, finetune: Optional[str] = None,
                 fast_dev_run: bool = False, mesh=None,
                 hypers: Optional[C.TrainHypers] = None,
                 dp_impl: str = "gspmd", backend: str = "auto_train",
                 device=None):
        """backend: 'auto_train' (the training kernels) or
        'auto_train_bf16res' (the same, residuals stored in bf16; the JAX
        package runs it on the TPU and resolves it to its float32 XLA path
        elsewhere, the port's CPU path runs the plain versions with the
        residuals rounded), used by `train_module` and `train_all` alike.
        The JAX package's 'xla' has no counterpart here.

        mesh: one entry per rank of the process group (`parallel.Mesh`);
        this process trains on entry `rank`. Without one, an initialized
        process group of more than one rank trains data-parallel over its
        ranks' devices (the JAX manager's default mesh over every
        device), and no group means one device. dp_impl: 'gspmd' (equal
        to one device on the whole batch) or 'shard_map' (per-rank draws
        and normalization, averaged); see the module docstring."""
        if dp_impl not in DP_IMPLS:
            raise ValueError(f"dp_impl must be one of {DP_IMPLS}, got "
                             f"{dp_impl!r}")
        check_backend(backend)
        if backend not in TRAIN_BACKENDS:
            raise ValueError(f"backend must be a training backend "
                             f"{TRAIN_BACKENDS}, got {backend!r}")
        self.finetune = finetune
        self.fast_dev_run = fast_dev_run
        self.hypers = hypers or (C.finetune_hypers if finetune
                                 else C.train_hypers)
        self.backend = backend
        if mesh is None and D.world_size() > 1:
            mesh = D.process_mesh(device)
        dp = _data_parallel(mesh)
        self.rank, self.world = dp if dp is not None else (0, 1)
        if mesh is not None:
            own = mesh.devices[self.rank]
            if device is not None and resolve_device(device) != own:
                raise ValueError(f"device {device} is not this rank's mesh "
                                 f"entry {own}")
            device = own
        self.mesh = mesh
        self.dp_impl = dp_impl
        self.device = resolve_device(device)

    @property
    def writer(self) -> bool:
        """Only rank 0 writes checkpoints, train state, metrics, records."""
        return self.rank == 0

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> dict:
        """A numpy batch on this process's device: the whole batch on one
        device, this rank's rows (`local_rows`) under data parallelism."""
        if self.world > 1:
            batch = local_rows(batch, self.rank, self.world)
        return to_device(batch, self.device)

    def _share_params(self, modules) -> None:
        if self.world > 1:
            _broadcast_params(modules)

    def _restore(self, path):
        """`restore_training_state` of `path` as rank 0 sees it, on every
        rank, or None when rank 0 has no such file. Rank 0 alone reads
        the file and sends its bytes to the others, so that every rank
        resumes, or starts fresh, at the same epoch with the same
        optimizer state, whatever file system the others see."""
        path = Path(path)
        raw = path.read_bytes() if self.rank == 0 and path.exists() else None
        if self.world > 1:
            raw = D.broadcast_from_rank0(raw)
        if raw is None:
            return None
        return restore_training_state(io.BytesIO(raw), self.hypers.lr,
                                      self.device)

    def _generators(self, seed: int):
        """(CPU generator for weight init, generator on the device for the
        per-step draws), both from `seed`."""
        return (torch.Generator().manual_seed(seed),
                torch.Generator(device=self.device).manual_seed(seed))

    def _sink(self, metrics, log_file):
        if not self.writer:
            return MultiSink([])
        sink = make_sinks(metrics)
        if log_file:
            sink = MultiSink(sink.sinks + [JSONLSink(log_file)])
        return sink

    def train_module(self, module_name: str, dataset, checkpoint_path,
                     init_params: Optional[dict] = None,
                     body_model=None, seed: Optional[int] = None,
                     val_fraction: float = 0.1,
                     log_file: Optional[str] = None,
                     metrics: Optional[str] = None,
                     resume_from=None) -> Dict:
        """Train one module over `dataset` (a train-fold PoseDataset).
        Returns {"params": the RNNBlock, "history", "checkpointer"}. 90/10
        train/val split as the reference (data.py:153). `resume_from`
        restarts from a `train_state.pt` (rank 0's, on every rank); one is
        written every 5 epochs and after the last. `init_params` is a
        JAX-layout numpy pytree."""
        h = self.hypers
        seed = h.seed if seed is None else seed
        init_gen, gen = self._generators(seed)
        start_epoch = 0
        restored = (self._restore(resume_from) if resume_from is not None
                    else None)
        if resume_from is not None and restored is None:
            raise FileNotFoundError(f"no training state at {resume_from}")
        if restored is not None:
            state, ckpt_module, start_epoch = restored
            if ckpt_module != module_name:
                raise ValueError(f"checkpoint is for {ckpt_module}, not "
                                 f"{module_name}")
        elif init_params is not None:
            state = _state_from_tree(module_name, init_params, h.lr,
                                     self.device)
        else:
            state = init_train_state(module_name, init_gen, h.lr,
                                     self.device)
        self._share_params([state.params])
        train_step = make_train_step(module_name, body_model,
                                     backend=self.backend, mesh=self.mesh,
                                     dp_impl=self.dp_impl)
        eval_step = make_eval_step(module_name, body_model, mesh=self.mesh)
        val_idx, train_idx, rng_np = _train_val_split(len(dataset), seed,
                                                      val_fraction)
        W = C.datasets.window_length
        epochs = 1 if self.fast_dev_run else h.num_epochs
        history = {"train_loss": [], "val_loss": []}
        ckpt = Checkpointer(Path(checkpoint_path) / module_name)
        sink = self._sink(metrics, log_file)

        def batches_from(idxs, shuffle_rng):
            return _epoch_batches(dataset, idxs, h.batch_size, W, shuffle_rng)

        step_i = 0
        try:
            for epoch in range(start_epoch, epochs):
                t0 = time.time()
                losses = []
                with BatchPrefetcher(batches_from(train_idx, rng_np)) as pf:
                    for batch in pf:
                        state, loss = train_step(
                            state, self._device_batch(batch), gen)
                        losses.append(loss)
                        step_i += 1
                        if self.fast_dev_run and step_i >= 2:
                            break
                train_loss = _mean(losses)
                val_losses = []
                for batch in batches_from(val_idx, None):
                    val_losses.append(eval_step(
                        state.params, self._device_batch(batch), gen))
                    if self.fast_dev_run:
                        break
                val_loss = _mean(val_losses) if val_losses else train_loss
                history["train_loss"].append(train_loss)
                history["val_loss"].append(val_loss)
                if not self.writer:
                    continue
                if np.isfinite(val_loss) and ckpt.should_save(val_loss):
                    ckpt.save(state.params, epoch, val_loss)
                if epoch % 5 == 4 or epoch == epochs - 1:
                    save_training_state(ckpt.dir / STATE_FILE, module_name,
                                        state, epoch)
                rec = {"module": module_name, "epoch": epoch,
                       "train_loss": train_loss, "val_loss": val_loss,
                       "seconds": round(time.time() - t0, 3)}
                print(json.dumps(rec))
                sink.log(rec)
        finally:
            sink.close()
        return {"params": state.params, "history": history,
                "checkpointer": ckpt}

    def train_all(self, dataset, checkpoint_path, body_model=None,
                  seed: Optional[int] = None, val_fraction: float = 0.1,
                  metrics: Optional[str] = None,
                  log_file: Optional[str] = None,
                  module_names=MODULE_NAMES,
                  init_params: Optional[Dict[str, dict]] = None,
                  resume: bool = False) -> Dict:
        """Train all modules concurrently in one pass over the data
        (`make_multi_train_step`), with the checkpoint layout and record
        schema of four `train_module` calls.

        `resume=True` restores each module's `train_state.pt` under
        `checkpoint_path/<module>/`, and only from a consistent set: every
        module present at the same epoch; otherwise training restarts
        fresh. Under data parallelism rank 0's files decide, and every
        rank restores from their bytes. `init_params` ({module: JAX-layout numpy pytree}) warm
        starts the named modules with fresh optimizers.
        """
        h = self.hypers
        seed = h.seed if seed is None else seed
        init_gen, gen = self._generators(seed)
        ckpts = {n: Checkpointer(Path(checkpoint_path) / n)
                 for n in module_names}
        start_epoch = 0
        states: Dict[str, TrainState] = {}
        if resume:
            epochs_found = []
            for n in module_names:
                p = ckpts[n].dir / STATE_FILE
                restored = self._restore(p)
                if restored is not None:
                    st, mod, nxt = restored
                    if mod != n:
                        raise ValueError(f"{p} is for {mod}, not {n}")
                    states[n] = st
                    epochs_found.append(nxt)
            if (len(epochs_found) == len(module_names)
                    and len(set(epochs_found)) == 1):
                start_epoch = epochs_found[0]
            else:
                if epochs_found and self.writer:
                    print(json.dumps({
                        "resume": "inconsistent train_state snapshots "
                                  f"(epochs {sorted(set(epochs_found))}); "
                                  "restarting from scratch"}))
                states = {}
        if not states:
            for n in module_names:
                if init_params and n in init_params:
                    states[n] = _state_from_tree(n, init_params[n], h.lr,
                                                 self.device)
                else:
                    states[n] = init_train_state(n, init_gen, h.lr,
                                                 self.device)
        self._share_params([states[n].params for n in module_names])
        train_step = make_multi_train_step(body_model, backend=self.backend,
                                           module_names=module_names,
                                           mesh=self.mesh,
                                           dp_impl=self.dp_impl)
        eval_step = make_multi_eval_step(body_model, module_names,
                                         mesh=self.mesh)
        val_idx, train_idx, rng_np = _train_val_split(len(dataset), seed,
                                                      val_fraction)
        W = C.datasets.window_length
        epochs = 1 if self.fast_dev_run else h.num_epochs
        history = {m: {"train_loss": [], "val_loss": []}
                   for m in module_names}
        sink = self._sink(metrics, log_file)

        def batches_from(idxs, shuffle_rng):
            return _epoch_batches(dataset, idxs, h.batch_size, W, shuffle_rng)

        try:
            for epoch in range(start_epoch, epochs):
                t0 = time.time()
                losses = {m: [] for m in module_names}
                with BatchPrefetcher(batches_from(train_idx, rng_np)) as pf:
                    for step_i, batch in enumerate(pf):
                        states, batch_losses = train_step(
                            states, self._device_batch(batch), gen)
                        for m in module_names:
                            losses[m].append(batch_losses[m])
                        if self.fast_dev_run and step_i >= 1:
                            break
                train_losses = {m: _mean(losses[m]) for m in module_names}
                val_acc = {m: [] for m in module_names}
                for batch in batches_from(val_idx, None):
                    vl = eval_step({m: states[m].params
                                    for m in module_names},
                                   self._device_batch(batch), gen)
                    for m in module_names:
                        val_acc[m].append(vl[m])
                    if self.fast_dev_run:
                        break
                dt = round(time.time() - t0, 3)
                for m in module_names:
                    val_loss = (_mean(val_acc[m]) if val_acc[m]
                                else train_losses[m])
                    history[m]["train_loss"].append(train_losses[m])
                    history[m]["val_loss"].append(val_loss)
                    if not self.writer:
                        continue
                    if np.isfinite(val_loss) and ckpts[m].should_save(
                            val_loss):
                        ckpts[m].save(states[m].params, epoch, val_loss)
                    if epoch % 5 == 4 or epoch == epochs - 1:
                        save_training_state(ckpts[m].dir / STATE_FILE, m,
                                            states[m], epoch)
                    rec = {"module": m, "epoch": epoch,
                           "train_loss": train_losses[m],
                           "val_loss": val_loss, "seconds": dt,
                           "concurrent": True}
                    print(json.dumps(rec))
                    sink.log(rec)
        finally:
            sink.close()
        return {"params": {m: states[m].params for m in module_names},
                "history": history, "checkpointers": ckpts}


def combine_weights(checkpoint_path, out_path=None,
                    finetune: Optional[str] = None) -> Path:
    """Merge each module's best checkpoint into one weights file
    (reference: combine_weights.py:41-56). With `finetune`, joints and
    poser come from the finetuned_{dataset} subdir (combine_weights.py:27-31)."""
    checkpoint_path = Path(checkpoint_path)
    combined = {}
    for name in MODULE_NAMES:
        module_dir = checkpoint_path / name
        if finetune and name in ("poser", "joints"):
            module_dir = checkpoint_path / f"finetuned_{finetune}" / name
        best = get_best_checkpoint(module_dir)
        if best is None:
            raise FileNotFoundError(f"no checkpoint for module {name} "
                                    f"in {module_dir}")
        combined[name] = load_npz(best)
    default_name = "model_finetuned.npz" if finetune else "base_model.npz"
    out_path = Path(out_path or (checkpoint_path / default_name))
    export_npz(combined, out_path)
    return out_path


def load_combined_weights(path) -> dict:
    """A combined weights file as the JAX-layout numpy pytree; build the
    modules with `nn.convert.params_from_jax`."""
    return load_npz(path)
