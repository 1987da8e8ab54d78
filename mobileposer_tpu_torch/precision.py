"""Full float32 matrix products for the small-matrix kinematics.

Counterpart of `mobileposer_tpu/utils/precision.py`. FK, LBS and
`angle_between` are batches of 3x3 and skinning products whose results
feed metrics in degrees and centimetres; TF32 keeps about three decimal
digits, so they run in full float32 whatever the process-wide
`torch.backends.cuda.matmul.allow_tf32` says. (The IK of `models/net.py`
is written as elementwise products and needs no guard.)
"""

from __future__ import annotations

import functools

import torch


def f32_matmuls(fn):
    """Decorator: run `fn` with TF32 matmuls off, then restore the setting.
    The setting is process-wide, so concurrent threads see it too."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return wrapper
