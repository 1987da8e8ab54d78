"""Merge recorded dev sessions into one dataset file (counterpart of
`mobileposer_tpu/cli/combiner.py`; reference CLI: mobileposer/combiner.py).

    python -m mobileposer_tpu_torch.cli.combiner --sessions dev_*.npz
        [--out dev.npz]

Host code only. Each session's five device slots are put in the model's
slot order; the output is the `sequences` object `.npz` that
`data.load_processed_file` reads (default `data/dev/combined.npz` under
MP_ROOT).
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

import numpy as np

from mobileposer_tpu_torch import config as C

# recorded device slots -> model slot order (reference: combiner.py:13-20)
SLOT_REORDER = [1, 4, 3, 0, 2]


def main(argv=None) -> Path:
    """Merge; returns the output path."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sessions", nargs="+", required=True,
                        help="session .npz files (globs allowed)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    files = []
    for pattern in args.sessions:
        files.extend(sorted(glob.glob(pattern)))
    if not files:
        raise SystemExit("no session files matched")

    merged = {"acc": [], "ori": [], "pose": [], "tran": []}
    for f in files:
        z = np.load(f, allow_pickle=True)
        acc = np.asarray(z["acc"])
        ori = np.asarray(z["ori"])
        if acc.ndim == 3 and acc.shape[1] == 5:
            acc = acc[:, SLOT_REORDER]
            ori = ori[:, SLOT_REORDER]
        merged["acc"].append(acc)
        merged["ori"].append(ori)
        merged["pose"].append(np.asarray(z["pose"]))
        merged["tran"].append(np.asarray(z["tran"]))
        print(f"{f}: {acc.shape[0]} frames")

    out = Path(args.out or (C.paths.dev_data / "combined.npz"))
    if out.suffix != ".npz":
        out = out.with_suffix(out.suffix + ".npz")   # np.savez appends .npz
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, sequences=np.asarray(
        [{k: v[i] for k, v in merged.items()} for i in range(len(files))],
        dtype=object))
    print(f"Combined {len(files)} sessions -> {out}")
    return out


if __name__ == "__main__":
    main()
