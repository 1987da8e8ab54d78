"""Build the CUDA sources in `csrc/` with nvcc at first use; load with ctypes.

Each source has a plain `extern "C"` interface and includes no PyTorch
header, so one nvcc call takes seconds. The shared library lands in
`ops/build/` (listed in .gitignore) under a name that carries a hash of
the source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. Pointers
and the stream cross as `ctypes.c_void_p`; each C entry returns
`cudaGetLastError()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
        "kernels are built from source at first use")


def library_path(source: str) -> Path:
    """Where the library built from `csrc/<source>` lives."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile `csrc/<source>` unless its library exists. The compiler's
    output, register and shared-memory counts included, is kept beside
    the library as `<name>.log`. Raises RuntimeError if nvcc fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
        capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out


def load(source: str) -> ctypes.CDLL:
    """Build if needed, then load the library. The caller declares the
    argument and return types of the entries it calls."""
    return ctypes.CDLL(str(build(source)))
