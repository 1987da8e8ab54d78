"""Train MobilePoser modules on the card (counterpart of
`mobileposer_tpu/cli/train.py`; reference CLI: mobileposer/train.py:116-154).

    python -m mobileposer_tpu_torch.cli.train [--module poser] [--concurrent]
        [--finetune dip|imuposer] [--init-from weights.npz|model.pth]
        [--fast-dev-run] [--checkpoint-dir D] [--combine] [--resume]
        [--metrics jsonl:p,csv:p,tensorboard:dir,wandb:project]
        [--bf16-residuals] [--device cpu]

Reads every processed file under $MP_PROCESSED (the train fold), or with
`--finetune` the finetune set's file under $MP_PROCESSED/eval with the
finetune hyperparameters (batch 32, lr 5e-5, 15 epochs); writes
per-module checkpoints in the JAX package's `.npz` layout and a
`metrics.jsonl` under the checkpoint dir. Runs on the CUDA card unless
`--device` names another device (`cpu` runs the kernels' plain versions).
`--bf16-residuals` stores the training kernels' residuals in bf16
(backend 'auto_train_bf16res', as the JAX CLI maps it).

On a host with more than one card and no `--device`, training is
data-parallel over every card, as the JAX CLI's default mesh spans every
device: one rank per card is spawned (`parallel.join_or_spawn`), each
runs this CLI on its card, and rank 0 writes the checkpoints. Under
torchrun (`torchrun --nproc-per-node N -m mobileposer_tpu_torch.cli.train
...`) each process joins the group as its rank instead, on
cuda:LOCAL_RANK (or `--device`; `--device cpu` trains over gloo). The
rule is `TrainingManager`'s default, 'gspmd': the same step as one card
on the whole batch.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.data import PoseDataset
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.models.utils import load_model
from mobileposer_tpu_torch.parallel import distributed as D
from mobileposer_tpu_torch.train import (MODULE_NAMES, TrainingManager,
                                         combine_weights, get_checkpoint_path)


def rank_main(rank: int, device, argv) -> str:
    """One spawned rank: this CLI on the rank's device."""
    return str(main(list(argv) + ["--device", str(device)]))


def main(argv=None) -> Path:
    """Train; returns the checkpoint dir."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--module", default=None, choices=MODULE_NAMES,
                        help="train a single module (default: all)")
    parser.add_argument("--finetune", default=None,
                        help="finetune dataset key (dip / imuposer)")
    parser.add_argument("--init-from", default=None,
                        help="combined weights (.npz, or the reference's "
                             ".pth) to initialize from")
    parser.add_argument("--fast-dev-run", action="store_true")
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--combine", action="store_true",
                        help="merge best checkpoints after training")
    parser.add_argument("--resume", action="store_true",
                        help="resume each module from its train_state.pt "
                             "in --checkpoint-dir (params + optimizer + "
                             "epoch)")
    parser.add_argument("--metrics", default=None,
                        help="extra metric sinks, comma-separated: "
                             "jsonl:<path>, csv:<path>, tensorboard:<dir>, "
                             "wandb:<project> (JSONL in the checkpoint dir "
                             "is always written)")
    parser.add_argument("--bf16-residuals", action="store_true",
                        help="store the training kernels' residuals in "
                             "bf16 (backend 'auto_train_bf16res')")
    parser.add_argument("--concurrent", action="store_true",
                        help="advance all modules on each batch in one "
                             "step (TrainingManager.train_all; same "
                             "checkpoint layout)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    if args.concurrent and args.module:
        parser.error("--concurrent trains all modules; drop --module")
    spawned = D.join_or_spawn(rank_main, argv, args.device)
    if spawned is not None:
        return Path(spawned[0])
    args.device = D.rank_device(args.device)
    say = print if D.rank() == 0 else (lambda *a, **k: None)

    mgr = TrainingManager(finetune=args.finetune,
                          fast_dev_run=args.fast_dev_run,
                          backend=("auto_train_bf16res" if args.bf16_residuals
                                   else "auto_train"),
                          device=args.device)
    body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    dataset = PoseDataset(fold="train", finetune=args.finetune,
                          body_model=body, device=mgr.device)
    if len(dataset) == 0:
        raise SystemExit("no training data found under "
                         f"{C.paths.processed_datasets}")
    # rank 0 numbers the run dir, the other ranks take its choice
    ckpt_path = args.checkpoint_dir
    if ckpt_path is None and mgr.writer:
        ckpt_path = get_checkpoint_path()
    ckpt_path = Path(D.broadcast_from_rank0(str(ckpt_path)))
    init_params = load_model(args.init_from) if args.init_from else None

    if args.concurrent:
        say("-" * 50)
        say(f"Training all modules concurrently: {MODULE_NAMES}")
        say("-" * 50)
        mgr.train_all(dataset, ckpt_path, body_model=body,
                      log_file=str(ckpt_path / "metrics.jsonl"),
                      metrics=args.metrics, resume=args.resume,
                      init_params=init_params)
    else:
        for name in [args.module] if args.module else list(MODULE_NAMES):
            say("-" * 50)
            say(f"Training module: {name}")
            say("-" * 50)
            resume_from = None
            if args.resume:
                # rank 0 decides: the other ranks may not see its files
                ts = ckpt_path / name / "train_state.pt"
                resume_from = ts if D.broadcast_from_rank0(ts.exists()) \
                    else None
            mgr.train_module(
                name, dataset, ckpt_path,
                init_params=init_params[name] if init_params else None,
                body_model=body if name == "poser" else None,
                log_file=str(ckpt_path / "metrics.jsonl"),
                metrics=args.metrics, resume_from=resume_from)
    if args.combine and mgr.writer:
        out = combine_weights(ckpt_path)
        print(f"Combined weights written to {out}")
    return ckpt_path


if __name__ == "__main__":
    main()
