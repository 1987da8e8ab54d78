"""Model-level utilities (counterpart of `mobileposer_tpu/models/utils.py`;
reference `mobileposer/utils/model_utils.py`)."""

from __future__ import annotations

from mobileposer_tpu_torch.models.modules import MODULE_CONFIGS


def load_model(path) -> dict:
    """Weights as the params tree (JAX layout, numpy leaves) from either
    the JAX package's combined .npz or the reference's torch checkpoint
    (reference: model_utils.py:6-15); `nn.convert.params_from_jax` makes
    the port's modules from it."""
    path = str(path)
    if path.endswith(".npz"):
        from mobileposer_tpu_torch.nn.convert import load_npz
        return load_npz(path)
    from mobileposer_tpu_torch.nn.torch_convert import \
        convert_mobileposer_checkpoint
    return convert_mobileposer_checkpoint(path, MODULE_CONFIGS)
