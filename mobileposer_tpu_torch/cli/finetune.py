"""Finetune the pose modules on real-IMU data on the card (counterpart of
`mobileposer_tpu/cli/finetune.py`; reference recipe: finetune.sh, DIP
first, then IMUPoser chained).

    python -m mobileposer_tpu_torch.cli.finetune --dataset dip \\
        --checkpoint-dir checkpoints/1 [--concurrent] [--device cpu]
    python -m mobileposer_tpu_torch.cli.finetune --dataset imuposer \\
        --checkpoint-dir checkpoints/1      # uses finetuned_dip as init

Only `joints` and `poser` are finetuned (the translation modules stay
frozen, reference combine_weights.py:27-31; data.py:83 skips translation
data in finetune mode). Each starts from its best checkpoint with a fresh
optimizer and the finetune hyperparameters; the output lands in
`<checkpoint-dir>/finetuned_<dataset>/`, where
`combine_weights(finetune=...)` reads it. Runs on the CUDA card unless
`--device` names another device; with more than one card and no
`--device`, data-parallel over every card, or under torchrun, as
`cli.train` runs.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.data import PoseDataset
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.nn.convert import load_npz
from mobileposer_tpu_torch.parallel import distributed as D
from mobileposer_tpu_torch.train import TrainingManager, get_best_checkpoint

FINETUNE_MODULES = ("joints", "poser")


def rank_main(rank: int, device, argv) -> str:
    """One spawned rank: this CLI on the rank's device."""
    return str(main(list(argv) + ["--device", str(device)]))


def main(argv=None) -> Path:
    """Finetune; returns the output dir."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", required=True,
                        choices=list(C.datasets.finetune_datasets.keys()))
    parser.add_argument("--checkpoint-dir", required=True,
                        help="base-training run dir with per-module "
                             "checkpoints")
    parser.add_argument("--fast-dev-run", action="store_true")
    parser.add_argument("--concurrent", action="store_true",
                        help="finetune joints and poser together on each "
                             "batch (TrainingManager.train_all)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    spawned = D.join_or_spawn(rank_main, argv, args.device)
    if spawned is not None:
        return Path(spawned[0])
    args.device = D.rank_device(args.device)
    say = print if D.rank() == 0 else (lambda *a, **k: None)

    ckpt_dir = Path(args.checkpoint_dir)
    # the IMUPoser finetune chains off the DIP finetune (finetune.sh:10-13)
    init_dir = (ckpt_dir / "finetuned_dip" if args.dataset == "imuposer"
                else ckpt_dir)
    out_dir = ckpt_dir / f"finetuned_{args.dataset}"

    mgr = TrainingManager(finetune=args.dataset,
                          fast_dev_run=args.fast_dev_run, device=args.device)
    body = ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    dataset = PoseDataset(fold="train", finetune=args.dataset,
                          body_model=body, device=mgr.device)
    if len(dataset) == 0:
        raise SystemExit(f"no finetune data for {args.dataset} under "
                         f"{C.paths.eval_dir}")

    init = {}
    for name in FINETUNE_MODULES:
        best = get_best_checkpoint(init_dir / name)
        if best is None:
            raise SystemExit(f"no init checkpoint for {name} in "
                             f"{init_dir / name}")
        init[name] = load_npz(best)
        say(f"Finetuning {name} from {best}")
    if args.concurrent:
        mgr.train_all(dataset, out_dir, body_model=body,
                      module_names=FINETUNE_MODULES, init_params=init,
                      log_file=str(out_dir / "metrics.jsonl"))
    else:
        for name in FINETUNE_MODULES:
            mgr.train_module(name, dataset, out_dir,
                             init_params=init[name],
                             body_model=body if name == "poser" else None,
                             log_file=str(out_dir / "metrics.jsonl"))
    say(f"Finetuned checkpoints in {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
