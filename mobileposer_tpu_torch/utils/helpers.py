"""Small shared helpers (counterpart of `mobileposer_tpu/utils/helpers.py`).

`getenv_flag` reproduces the reference's `helpers.getenv` semantics
(helpers.py:4): numeric strings are int-cast, so ONLINE=0 / PHYSICS=0
disable the feature — `bool(os.environ.get(...))` would treat "0" as on.

The JAX package's `enable_persistent_compile_cache` configures JAX's
compile cache and has no counterpart here: eager PyTorch compiles
nothing, and the port's CUDA kernels are cached by `ops/_build.py` (the
library name carries a hash of the source and flags).
"""

from __future__ import annotations

import hashlib
import os
import platform


def host_cache_dir(prefix: str = "/tmp/jax_cache") -> str:
    """`prefix` keyed by the host CPU's generation: `prefix_<hash>`, the
    hash of the first "flags" (x86) or "Features" (aarch64) line of
    /proc/cpuinfo, else of the machine and processor names. Caches of
    code compiled for one CPU generation stay apart from another's when
    the directory outlives a host change."""
    tag = hashlib.sha1((platform.machine()
                        + platform.processor()).encode()).hexdigest()[:10]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    tag = hashlib.sha1(line.encode()).hexdigest()[:10]
                    break
    except OSError:
        pass
    return f"{prefix}_{tag}"


def getenv_flag(name: str, default: bool = False) -> bool:
    """The environment variable `name` as a flag: unset or empty gives
    `default`, a number its int cast ("0" is off), any other string on."""
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return bool(int(v))
    except ValueError:
        return True
