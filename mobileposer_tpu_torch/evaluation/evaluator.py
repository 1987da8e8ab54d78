"""Full-motion metric suite on PyTorch (counterpart of
`mobileposer_tpu/evaluation/evaluator.py`).

Behavioral parity target: reference `mobileposer/articulate/evaluator.py`
(`FullMotionEvaluator`, evaluator.py:269-343) and the binary-classification
evaluators (evaluator.py:33-100).

  * The JAX package pads every sequence to a 512-frame bucket and masks
    the statistics, so one compiled program serves any length. Eager
    PyTorch compiles nothing per shape, so here the metrics run on the N
    valid frames alone; the statistics are the masked ones of the JAX
    package with every frame valid (the tests hold the two to each other).
  * FK and skinning run in blocks of `_FK_BLOCK` frames, so memory stays
    bounded for any sequence length.
  * Means and stds follow torch semantics exactly: `std(dim=0)` is the
    unbiased std over time per joint or vertex, then averaged.
  * FK, skinning and `angle_between` run in full float32 whatever the
    process-wide TF32 setting (`precision.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel

_FK_BLOCK = 128


def _mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over every entry; 0 when there is none (the JAX package's
    masked mean with every row valid)."""
    return x.sum() / max(x.numel(), 1)


def _std0_mean(x: torch.Tensor) -> torch.Tensor:
    """torch `x.std(dim=0).mean()` over the rows of x, with the JAX
    package's guards: the divisors are max(n, 1) and max(n - 1, 1), so no
    row or one row gives 0, not NaN."""
    n = x.shape[0]
    mean = x.sum(dim=0, keepdim=True) / max(n, 1)
    var = ((x - mean) ** 2).sum(dim=0) / max(n - 1, 1)
    return torch.sqrt(var).mean()


class FullMotionEvaluator:
    """10-metric motion evaluator (reference: evaluator.py:269-343), on
    `device` (the CUDA card unless given)."""

    def __init__(self, body_model: Optional[ParametricModel] = None,
                 joint_mask: Optional[Tuple[int, ...]] = C.EVAL_JOINT_MASK,
                 fps: int = C.datasets.fps, align_joint: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.body = body_model or ParametricModel.from_file_or_synthetic(
            C.paths.smpl_file)
        self.joint_mask = (None if joint_mask is None
                           else torch.as_tensor(joint_mask,
                                                device=self.device))
        self.fps = fps
        self.align_joint = align_joint

    def _fk(self, pose: torch.Tensor, tran: torch.Tensor):
        """(global rotations, joints, vertices) in blocks of _FK_BLOCK
        frames."""
        outs = [self.body.forward_kinematics(pose[i:i + _FK_BLOCK],
                                             tran=tran[i:i + _FK_BLOCK],
                                             calc_mesh=True)
                for i in range(0, pose.shape[0], _FK_BLOCK)]
        return tuple(torch.cat(o) for o in zip(*outs))

    def _metrics(self, pose_p, pose_t, tran_p, tran_t) -> torch.Tensor:
        f = self.fps
        pose_global_p, joint_p, vertex_p = self._fk(pose_p, tran_p)
        pose_global_t, joint_t, vertex_t = self._fk(pose_t, tran_t)

        a = self.align_joint
        offset = (joint_t[:, a] - joint_p[:, a])[:, None]
        ve = torch.linalg.vector_norm(vertex_p + offset - vertex_t, dim=2)
        je = torch.linalg.vector_norm(joint_p + offset - joint_t, dim=2)
        lae = R.radian_to_degree(R.angle_between(pose_p, pose_t)).reshape(
            -1, 24)
        gae = R.radian_to_degree(
            R.angle_between(pose_global_p, pose_global_t)).reshape(-1, 24)

        def jerk(x):
            jk = (x[3:] - 3 * x[2:-1] + 3 * x[1:-2] - x[:-3]) * (f ** 3)
            return torch.linalg.vector_norm(jk, dim=2)              # [N-3, 24]

        te = torch.linalg.vector_norm(
            (joint_p[f:, :1] - joint_p[:-f, :1])
            - (joint_t[f:, :1] - joint_t[:-f, :1]), dim=2) * 100

        def stat(x):
            return torch.stack([_mean(x), _std0_mean(x)])

        rows = [stat(je), stat(ve), stat(lae), stat(gae),
                stat(jerk(joint_p)), stat(jerk(joint_t)), stat(te)]
        if self.joint_mask is not None:
            rows += [stat(x.index_select(1, self.joint_mask))
                     for x in (je, lae, gae)]
        else:
            rows += [je.new_zeros(2)] * 3
        return torch.stack(rows)                                   # [10, 2]

    def __call__(self, pose_p, pose_t, tran_p=None, tran_t=None) -> np.ndarray:
        """pose_*: [N, 24, 3, 3] local rotations; tran_*: [N, 3] or None.
        Returns the [10, 2] (mean, std) table of evaluator.py:292-343."""
        def dev(x, shape):
            return torch.as_tensor(np.asarray(x, np.float32).reshape(shape),
                                   device=self.device)

        pose_p = dev(pose_p, (-1, 24, 3, 3))
        pose_t = dev(pose_t, (-1, 24, 3, 3))
        n = pose_p.shape[0]
        zeros = np.zeros((n, 3), np.float32)
        tran_p = dev(zeros if tran_p is None else tran_p, (-1, 3))
        tran_t = dev(zeros if tran_t is None else tran_t, (-1, 3))
        return self._metrics(pose_p, pose_t, tran_p, tran_t).cpu().numpy()


# ---------------------------------------------------------------------------
# Binary classification metrics (reference: evaluator.py:33-100)
# ---------------------------------------------------------------------------

def binary_confusion_matrix(p: torch.Tensor, t: torch.Tensor,
                            is_after_sigmoid: bool = False) -> torch.Tensor:
    """[2,2] matrix [[tp, fn], [fp, tn]] (reference: evaluator.py:47-62),
    positive = 1 as in the JAX package."""
    pred = (p > (0.5 if is_after_sigmoid else 0.0)).to(torch.int64)
    t = t.to(torch.int64)
    tp = torch.sum((pred == 1) & (t == 1))
    fn = torch.sum((pred == 0) & (t == 1))
    fp = torch.sum((pred == 1) & (t == 0))
    tn = torch.sum((pred == 0) & (t == 0))
    return torch.stack([torch.stack([tp, fn]), torch.stack([fp, tn])])


def binary_classification_errors(p: torch.Tensor, t: torch.Tensor,
                                 is_after_sigmoid: bool = False
                                 ) -> torch.Tensor:
    """[[precision+, precision-], [recall+, recall-], [f1+, f1-]]
    (reference: evaluator.py:65-100), with guarded denominators."""
    (tp, fn), (fp, tn) = binary_confusion_matrix(
        p, t, is_after_sigmoid).to(torch.float32)
    eps = 1e-12
    prec_p = tp / torch.clamp_min(tp + fp, 1)
    prec_n = tn / torch.clamp_min(tn + fn, 1)
    rec_p = tp / torch.clamp_min(tp + fn, 1)
    rec_n = tn / torch.clamp_min(tn + fp, 1)
    f1_p = 2 * prec_p * rec_p / torch.clamp_min(prec_p + rec_p, eps)
    f1_n = 2 * prec_n * rec_n / torch.clamp_min(prec_n + rec_n, eps)
    return torch.stack([torch.stack([prec_p, prec_n]),
                        torch.stack([rec_p, rec_n]),
                        torch.stack([f1_p, f1_n])])
