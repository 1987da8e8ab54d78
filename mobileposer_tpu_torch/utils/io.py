"""Small IO helpers (counterpart of `mobileposer_tpu/utils/io.py`;
reference `articulate/utils/torch/io.py` and `utils/file_utils.py`).

`savez_typed` / `loadz_typed` are the one implementation of the typed
`.npz` format in the port: `nn/convert.py` (checkpoints, combined weights)
and `serving.py` (bundles) write and read through them. Their archives are
the JAX package's, bit for bit: bfloat16 leaves ride as uint16 bit
patterns under a "bfloat16" entry of a `__dtypes__` JSON manifest. numpy
has no bfloat16 of its own (the JAX package's comes from ml_dtypes, which
the port does not need), so in the port a bf16 leaf is a CPU
`torch.bfloat16` tensor; both directions move the bits unrounded.
"""

from __future__ import annotations

import datetime
import json
from pathlib import Path

import numpy as np
import torch


def load_txt_mat(path, delimiter: str = None) -> np.ndarray:
    """Load a whitespace/CSV matrix text file (reference: io.py:13)."""
    return np.loadtxt(path, delimiter=delimiter, dtype=np.float32)


def save_txt_mat(path, mat, fmt: str = "%.6f", delimiter: str = " ") -> None:
    np.savetxt(path, np.asarray(mat), fmt=fmt, delimiter=delimiter)


def bf16_bits(a):
    """The uint16 bit patterns of a bfloat16 leaf (a torch.bfloat16
    tensor, or a numpy array of ml_dtypes' bfloat16 as the JAX package
    hands them out), else None."""
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.bfloat16:
            return None
        return a.detach().cpu().contiguous().view(torch.int16).numpy().view(
            np.uint16)
    if str(getattr(a, "dtype", "")) == "bfloat16":
        return np.ascontiguousarray(a).view(np.uint16)
    return None


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """A CPU torch.bfloat16 tensor holding (a copy of) these uint16 bit
    patterns."""
    return torch.from_numpy(np.array(bits, np.uint16).view(np.int16)).view(
        torch.bfloat16)


def savez_typed(path, flat: dict) -> None:
    """`np.savez` of a flat {key: array} that round-trips bfloat16: bf16
    leaves as their uint16 bits, every key's dtype name in a `__dtypes__`
    JSON manifest. Leaves are numpy arrays, scalars or tensors (moved to
    the host)."""
    dtypes, arrays = {}, {}
    for key, val in flat.items():
        bits = bf16_bits(val)
        if bits is None:
            if isinstance(val, torch.Tensor):
                val = val.detach().cpu().numpy()
            val = np.asarray(val)
            dtypes[key] = str(val.dtype)
        else:
            val = bits
            dtypes[key] = "bfloat16"
        arrays[key] = val
    np.savez(path, __dtypes__=json.dumps(dtypes), **arrays)


def loadz_typed(path) -> dict:
    """Inverse of `savez_typed`: flat {key: array}, bfloat16 leaves as
    torch.bfloat16 tensors of their stored bits. Archives written without
    the manifest load as plain `np.load` dicts."""
    # allow_pickle stays False: neither format stores object arrays, and
    # model archives must never execute pickle payloads on load
    with np.load(path) as z:
        if "__dtypes__" not in z.files:
            return {k: z[k] for k in z.files}
        dtypes = json.loads(str(z["__dtypes__"]))
        return {key: bf16_from_bits(z[key]) if dt == "bfloat16" else z[key]
                for key, dt in dtypes.items()}


def get_datestring() -> str:
    """Run-name datestring (reference: utils/file_utils.py)."""
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def make_dir(path) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p
