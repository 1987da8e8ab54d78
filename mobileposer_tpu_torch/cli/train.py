"""Train MobilePoser modules on the card (counterpart of
`mobileposer_tpu/cli/train.py`; reference CLI: mobileposer/train.py:116-154).

    python -m mobileposer_tpu_torch.cli.train [--module poser] [--concurrent]
        [--init-from weights.npz|model.pth] [--fast-dev-run] [--checkpoint-dir D]
        [--combine] [--resume] [--metrics jsonl:p,csv:p] [--bf16-residuals]
        [--device cpu]

Reads every processed file under $MP_PROCESSED (the train fold), writes
per-module checkpoints in the JAX package's `.npz` layout and a
`metrics.jsonl` under the checkpoint dir. Runs on the CUDA card unless
`--device` names another device (`cpu` runs the kernels' plain versions).
`--bf16-residuals` stores the training kernels' residuals in bf16
(backend 'auto_train_bf16res', as the JAX CLI maps it). `--finetune` and
the tensorboard/wandb sinks are accepted as the JAX CLI accepts them and
raise NotImplementedError naming the ROADMAP row that adds them.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.data import PoseDataset
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.models.utils import load_model
from mobileposer_tpu_torch.train import (MODULE_NAMES, TrainingManager,
                                         combine_weights, get_checkpoint_path)


def main(argv=None) -> Path:
    """Train; returns the checkpoint dir."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--module", default=None, choices=MODULE_NAMES,
                        help="train a single module (default: all)")
    parser.add_argument("--finetune", default=None,
                        help="not ported (ROADMAP.md queue A item 24)")
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
                             "jsonl:<path>, csv:<path> (JSONL in the "
                             "checkpoint dir is always written)")
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
    if args.finetune:
        raise NotImplementedError(
            "--finetune (the finetune recipe, cli/finetune.py) is not "
            "ported (ROADMAP.md queue A item 24)")

    mgr = TrainingManager(fast_dev_run=args.fast_dev_run,
                          backend=("auto_train_bf16res" if args.bf16_residuals
                                   else "auto_train"),
                          device=args.device)
    body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    dataset = PoseDataset(fold="train", body_model=body, device=mgr.device)
    if len(dataset) == 0:
        raise SystemExit("no training data found under "
                         f"{C.paths.processed_datasets}")
    ckpt_path = (Path(args.checkpoint_dir) if args.checkpoint_dir
                 else get_checkpoint_path())
    init_params = load_model(args.init_from) if args.init_from else None

    if args.concurrent:
        print("-" * 50)
        print(f"Training all modules concurrently: {MODULE_NAMES}")
        print("-" * 50)
        mgr.train_all(dataset, ckpt_path, body_model=body,
                      log_file=str(ckpt_path / "metrics.jsonl"),
                      metrics=args.metrics, resume=args.resume,
                      init_params=init_params)
    else:
        for name in [args.module] if args.module else list(MODULE_NAMES):
            print("-" * 50)
            print(f"Training module: {name}")
            print("-" * 50)
            resume_from = None
            if args.resume:
                ts = ckpt_path / name / "train_state.pt"
                resume_from = ts if ts.exists() else None
            mgr.train_module(
                name, dataset, ckpt_path,
                init_params=init_params[name] if init_params else None,
                body_model=body if name == "poser" else None,
                log_file=str(ckpt_path / "metrics.jsonl"),
                metrics=args.metrics, resume_from=resume_from)
    if args.combine:
        out = combine_weights(ckpt_path)
        print(f"Combined weights written to {out}")
    return ckpt_path


if __name__ == "__main__":
    main()
