"""Training loop on one CUDA device (counterpart of
`mobileposer_tpu/train/trainer.py`): per-module optimizers, the concurrent
four-module step, top-k checkpointing and resume.

Behavioral parity target: reference `mobileposer/train.py`
(TrainingManager, train.py:33-97), per-module `configure_optimizers`
(AdamW for joints, joints.py:114; Adam elsewhere, poser.py:147,
footcontact.py:100, velocity.py:121) and Lightning's ModelCheckpoint top-3
by validation loss (train.py:48-58).

Every LSTM layer of a train step runs the training kernels (#7 forward,
#8 backward, `ops/lstm_train_cuda.py`) through `backend='auto_train'`;
validation runs under `torch.no_grad()` on the inference route (the masked
kernels #3), the counterpart of the JAX package's `backend='xla'`
validation. Random draws come from explicit `torch.Generator`s, so the
numbers differ from the JAX package's `jax.random` streams; the recipe
(splits, shuffles, batches) is the same numpy code and gives the same
batches.

Single device only: a `mesh`, `dp_impl='shard_map'` or more than one
device raise NotImplementedError (ROADMAP.md queue A item 22).
"""

from __future__ import annotations

import dataclasses
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
from mobileposer_tpu_torch.nn.lstm import (TRAIN_BACKENDS, RNNBlock,
                                           check_backend)
from mobileposer_tpu_torch.utils.metrics import (JSONLSink, MultiSink,
                                                 make_sinks)

MODULE_NAMES = ("poser", "joints", "footcontact", "velocity")

_PARALLEL_ROW = ("data-parallel training over torch.distributed, "
                 "ROADMAP.md queue A item 22")


@dataclasses.dataclass
class TrainState:
    """One module's training state. `params` and `opt` are updated in
    place by a step (the JAX package's state is immutable and returned
    anew); `step` counts steps taken, skipped ones included."""
    params: RNNBlock
    opt: torch.optim.Optimizer
    step: int = 0


def make_optimizer(module_name: str, lr: float,
                   params: nn.Module) -> torch.optim.Optimizer:
    """AdamW for joints (reference: joints.py:114), Adam for the rest, at
    optax's defaults: betas (0.9, 0.999), eps 1e-8, and for AdamW a weight
    decay of 1e-4 (optax's default; torch's is 1e-2). One parameter group,
    so AdamW decays every parameter, biases included, as optax does."""
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if module_name == "joints":
        return torch.optim.AdamW(params.parameters(), weight_decay=1e-4,
                                 **kw)
    return torch.optim.Adam(params.parameters(), **kw)


def loss_fn_for(module_name: str, body_model=None,
                backend: str = "auto_train") -> Callable:
    """Loss for one module: (params, batch, generator, train=True,
    time_major=False) -> scalar. Draws the module's noise and dropout mask
    from `generator` (`models.modules.draw`), then runs its deterministic
    loss. Only poser reads `body_model`."""
    loss = M.LOSSES[module_name]
    extra = {"body_model": body_model} if module_name == "poser" else {}

    def fn(params, batch, generator, train: bool = True,
           time_major: bool = False):
        draws = M.draw(module_name, batch, generator, train)
        return loss(params, batch, draws, train=train, backend=backend,
                    time_major=time_major, **extra)
    return fn


def init_train_state(module_name: str, generator: torch.Generator,
                     lr: float, device=None) -> TrainState:
    """Fresh weights drawn from `generator` (a CPU generator), with
    gradients on, and a fresh optimizer."""
    params = RNNBlock(M.MODULE_CONFIGS[module_name], device=device,
                      generator=generator).requires_grad_(True)
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
    if "lengths" in out:
        out["lengths"] = out["lengths"].long()
    return out


def make_train_step(module_name: str, body_model=None,
                    time_major: bool = False, backend: str = "auto_train"):
    """(state, batch, generator) -> (state, loss) for one module: the
    loss and its gradients through the training kernels, then the
    optimizer update unless something is not finite. `batch` holds
    tensors on the state's device, [T, B, ...] when time_major (lengths
    stays [B]). The optimizer, and so the learning rate, is the state's
    own (`init_train_state`)."""
    loss_fn = loss_fn_for(module_name, body_model, backend=backend)

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        state.opt.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, batch, generator, train=True,
                       time_major=time_major)
        loss.backward()
        _apply_updates({module_name: state}, {module_name: loss})
        return state, loss.detach()

    return step


def make_multi_train_step(body_model=None, backend: str = "auto_train",
                          module_names=MODULE_NAMES):
    """One step advancing all modules on one batch: the sum of their
    losses differentiated once (the parameter sets are disjoint, so each
    module gets its own gradient), then each module's own optimizer and
    its own non-finite containment. Returns (states, {module: loss}).
    Draws are taken from the one generator in `module_names` order."""
    loss_fns = {n: loss_fn_for(n, body_model, backend=backend)
                for n in module_names}

    def step(states: Dict[str, TrainState], batch: dict,
             generator: torch.Generator):
        for n in module_names:
            states[n].opt.zero_grad(set_to_none=True)
        losses = {n: loss_fns[n](states[n].params, batch, generator,
                                 train=True)
                  for n in module_names}
        sum(losses.values()).backward()
        _apply_updates(states, losses)
        return states, {n: v.detach() for n, v in losses.items()}

    return step


def make_eval_step(module_name: str, body_model=None,
                   time_major: bool = False):
    """Validation loss of one module: no gradients, the inference route
    (train=False, the masked kernels), as the JAX package validates on
    XLA without the training kernels' residual writes."""
    loss_fn = loss_fn_for(module_name, body_model, backend="auto")

    @torch.no_grad()
    def step(params, batch, generator):
        return loss_fn(params, batch, generator, train=False,
                       time_major=time_major)
    return step


def make_multi_eval_step(body_model=None, module_names=MODULE_NAMES):
    """All modules' validation losses on one batch."""
    steps = {n: make_eval_step(n, body_model) for n in module_names}

    def step(params: Dict[str, RNNBlock], batch: dict, generator):
        return {n: steps[n](params[n], batch, generator)
                for n in module_names}
    return step


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
    `save_training_state`'s file."""
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
    """Per-module or concurrent training on one device."""

    def __init__(self, finetune: Optional[str] = None,
                 fast_dev_run: bool = False, mesh=None,
                 hypers: Optional[C.TrainHypers] = None,
                 dp_impl: str = "gspmd", backend: str = "auto_train",
                 device=None):
        """backend: 'auto_train' (the training kernels). The JAX package's
        'auto_train_bf16res' raises NotImplementedError naming its ROADMAP
        row; its 'xla' has no counterpart here. `mesh` and
        dp_impl='shard_map' are multi-device options and raise."""
        if mesh is not None or dp_impl != "gspmd":
            raise NotImplementedError(
                f"mesh / dp_impl={dp_impl!r}: one device only "
                f"({_PARALLEL_ROW})")
        check_backend(backend)
        if backend not in TRAIN_BACKENDS:
            raise ValueError(f"backend must be a training backend "
                             f"{TRAIN_BACKENDS}, got {backend!r}")
        self.finetune = finetune
        self.fast_dev_run = fast_dev_run
        self.hypers = hypers or (C.finetune_hypers if finetune
                                 else C.train_hypers)
        self.backend = backend
        self.device = resolve_device(device)

    def _generators(self, seed: int):
        """(CPU generator for weight init, generator on the device for the
        per-step draws), both from `seed`."""
        return (torch.Generator().manual_seed(seed),
                torch.Generator(device=self.device).manual_seed(seed))

    def _sink(self, metrics, log_file):
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
        restarts from a `train_state.pt`; one is written every 5 epochs
        and after the last. `init_params` is a JAX-layout numpy pytree."""
        h = self.hypers
        seed = h.seed if seed is None else seed
        init_gen, gen = self._generators(seed)
        start_epoch = 0
        if resume_from is not None:
            state, ckpt_module, start_epoch = restore_training_state(
                resume_from, h.lr, self.device)
            if ckpt_module != module_name:
                raise ValueError(f"checkpoint is for {ckpt_module}, not "
                                 f"{module_name}")
        elif init_params is not None:
            state = _state_from_tree(module_name, init_params, h.lr,
                                     self.device)
        else:
            state = init_train_state(module_name, init_gen, h.lr,
                                     self.device)
        train_step = make_train_step(module_name, body_model,
                                     backend=self.backend)
        eval_step = make_eval_step(module_name, body_model)
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
                            state, to_device(batch, self.device), gen)
                        losses.append(loss)
                        step_i += 1
                        if self.fast_dev_run and step_i >= 2:
                            break
                train_loss = _mean(losses)
                val_losses = []
                for batch in batches_from(val_idx, None):
                    val_losses.append(eval_step(
                        state.params, to_device(batch, self.device), gen))
                    if self.fast_dev_run:
                        break
                val_loss = _mean(val_losses) if val_losses else train_loss
                history["train_loss"].append(train_loss)
                history["val_loss"].append(val_loss)
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
        fresh. `init_params` ({module: JAX-layout numpy pytree}) warm
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
                if p.exists():
                    st, mod, nxt = restore_training_state(p, h.lr,
                                                          self.device)
                    if mod != n:
                        raise ValueError(f"{p} is for {mod}, not {n}")
                    states[n] = st
                    epochs_found.append(nxt)
            if (len(epochs_found) == len(module_names)
                    and len(set(epochs_found)) == 1):
                start_epoch = epochs_found[0]
            else:
                if epochs_found:
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
        train_step = make_multi_train_step(body_model, backend=self.backend,
                                           module_names=module_names)
        eval_step = make_multi_eval_step(body_model, module_names)
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
                            states, to_device(batch, self.device), gen)
                        for m in module_names:
                            losses[m].append(batch_losses[m])
                        if self.fast_dev_run and step_i >= 1:
                            break
                train_losses = {m: _mean(losses[m]) for m in module_names}
                val_acc = {m: [] for m in module_names}
                for batch in batches_from(val_idx, None):
                    vl = eval_step({m: states[m].params
                                    for m in module_names},
                                   to_device(batch, self.device), gen)
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
