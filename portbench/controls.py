"""The readings that the limits in `limits/<cell>.json` were set from: each
cell's control, and the faults a training cell is held against, at the
cell's own size, on the seeds given. The benchmark's runs do not run this.

    python3 -m portbench.controls --cell f32.stream512 --seeds 1,2,3 \
        [--ticks 1620]

Controls (the nearest precision below the configuration's):
  * float32 cells: the reference put in the program's place with TF32 on
    (every product of the linears and the cuDNN LSTMs);
  * bf16 cells: the reference in fp8 arithmetic (`Fp8`: every result
    rounded to e4m3 at a per-tensor scale).
Training faults: half of the batch left out, the mean taken over the rest
(the reference on the first half of each batch, in the program's place).
A state left unchanged reads 1 on `change_gap` and needs no run.
Each reading prints as one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import check, motion, weights  # noqa: E402
from portbench.manifest import Manifest  # noqa: E402
from portbench.reference import model as ref_model  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402


@contextlib.contextmanager
def tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _stream_frames(cfg, tr, seed, n_ticks, dev):
    """The frames of the streams a run of `seed` checks, n_ticks of them."""
    table = motion.stream_table(tr, seed, dev).cpu().numpy()
    pick = torch.randperm(tr["streams"],
                          generator=motion.generator(seed, 5, "cpu"))
    sample = np.sort(pick[:tr["check_streams"]].numpy())
    frames = torch.from_numpy(table[np.arange(n_ticks) % table.shape[0]]
                              [:, sample])
    return frames.to(dev).to(weights.DTYPES[cfg["dtype"]]).float()


@torch.no_grad()
def reference_as_program(cfg, flat, frames):
    """The reference's own outputs in the program's form, its root from
    its own fusion chain."""
    ref = ref_model.stream_outputs(cfg, weights.views(cfg, flat), frames)
    n, K = frames.shape[:2]
    pose = ref_model.pose_from_r6d(cfg, ref["r6d"].reshape(n * K, -1))
    feet = ref_model.rest_pose_joints(cfg, frames.device)[cfg["feet"]]
    last = feet.expand(K, 2, 3)
    root = torch.zeros((K, 3), device=frames.device)
    roots = []
    for t in range(n):
        c = ref["contact"][t]
        root = ref_model.fusion_step(cfg, ref["joints"][t], c, ref["vel"][t],
                                     last, root, c[:, 0] > c[:, 1])
        last = ref["joints"][t][:, cfg["feet"]]
        roots.append(root)
    return {"pose": pose.reshape(n, K, 24, 3, 3), "joints": ref["joints"],
            "root": torch.stack(roots), "contact": ref["contact"]}


def stream_tf32(cfg, tr, seed, n_ticks, dev):
    flat = weights.make_flat(cfg, seed, dev)
    frames = _stream_frames(cfg, tr, seed, n_ticks, dev)
    with tf32(True):
        prog = reference_as_program(cfg, flat, frames)
    return check.stream(cfg, flat, frames, prog)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 at a per-tensor scale (its largest magnitude to
    e4m3's 448), widened back; the gradient passes the rounding."""
    s = (x.detach().abs().amax().float() / 448.0).clamp_min(1e-30)
    q = ((x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s)
    return x + (q - x.detach())


class Fp8(TorchFunctionMode):
    """fp8 arithmetic: every floating result of a torch operation rounded
    by `_fp8`, inputs and weights included (round them on entry), with
    `torch.lstm` run as a loop of such operations."""

    def __enter__(self):
        self._lstm, torch.lstm = torch.lstm, _lstm_loop
        return super().__enter__()

    def __exit__(self, *exc):
        torch.lstm = self._lstm
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (isinstance(out, torch.Tensor) and out.is_floating_point()
                and out.numel() and out.dtype != torch.float8_e4m3fn):
            return _fp8(out)
        return out


def _lstm_loop(h, hx, flat, has_b, L, drop, train, bidir, batch_first):
    """`torch.lstm`'s calling convention (time-major, biases, no dropout) as a loop
    of plain operations."""
    n_dir = 2 if bidir else 1
    h0, c0 = hx
    x, hs, cs = h, [], []
    for layer in range(L):
        outs = []
        for d in range(n_dir):
            i0 = 4 * (layer * n_dir + d)
            w_ih, w_hh, b_ih, b_hh = flat[i0:i0 + 4]
            xs = x if d == 0 else x.flip(0)
            proj = xs @ w_ih.t() + b_ih + b_hh
            hh, cc = h0[layer * n_dir + d], c0[layer * n_dir + d]
            ys = []
            for t in range(xs.shape[0]):
                g = proj[t] + hh @ w_hh.t()
                i, f, gg, o = g.chunk(4, dim=-1)
                cc = torch.sigmoid(f) * cc + torch.sigmoid(i) * torch.tanh(gg)
                hh = torch.sigmoid(o) * torch.tanh(cc)
                ys.append(hh)
            y = torch.stack(ys)
            outs.append(y if d == 0 else y.flip(0))
            hs.append(hh)
            cs.append(cc)
        x = torch.cat(outs, dim=-1)
    return x, torch.stack(hs), torch.stack(cs)


def _train_inputs(cfg, tr, seed, dev):
    flat0 = weights.make_flat(cfg, seed, dev)
    pool = motion.train_pool(tr, seed, dev)
    return flat0, pool[:tr["checked_steps"]]


def train_readings(cfg, tr, seed, dev, variant):
    """check.train readings of `variant` in the program's place against
    the float32 reference: 'tf32', 'fp8' or 'half_batch'."""
    flat0, batches = _train_inputs(cfg, tr, seed, dev)
    ref = check.train_reference(cfg, flat0, batches,
                                motion.generator(seed, 4, dev))
    gen = motion.generator(seed, 4, dev)
    if variant == "tf32":
        with tf32(True):
            ctl = check.train_reference(cfg, flat0, batches, gen)
    else:
        real = ref_train.losses
        ref_train.losses = {"fp8": _fp8_losses,
                            "half_batch": _half_batch_losses}[variant](real)
        try:
            ctl = check.train_reference(cfg, flat0, batches, gen)
        finally:
            ref_train.losses = real
    return check.train(ref, ctl)


def _fp8_losses(real):
    """The losses (forward) in fp8 arithmetic; the backward and the
    optimizer as they are."""
    def losses(cfg, leaves, batch, dr):
        with Fp8():
            return real(cfg, leaves, batch, dr)
    return losses


def _half_batch_losses(real):
    """The losses over the first half of each batch: the whole batch's
    draws are made, half of the rows kept."""
    def losses(cfg, leaves, batch, dr):
        B = batch["imu"].shape[0] // 2
        b = {k: (v[:B] if v.dim() and v.shape[0] == 2 * B else v)
             for k, v in batch.items()}
        d = {m: (None if n is None else n[:B], k[:B])
             for m, (n, k) in dr.items()}
        return real(cfg, leaves, b, d)
    return losses


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--ticks", type=int, default=1620,
                    help="stream ticks to compare (a 20 s run's at 512 streams)")
    ap.add_argument("--variants", default="")
    args = ap.parse_args()
    man = Manifest()
    cell = man.cell(args.cell)
    cfg = man.config(cell["config"])
    tr = man.traffic(cell["traffic"])
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if tr["kind"] == "stream":
        default = "tf32"
    else:
        default = ("tf32" if cfg["dtype"] == "float32" else "fp8") + \
            ",half_batch"
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in (args.variants or default).split(","):
            if tr["kind"] == "stream":
                r = stream_tf32(cfg, tr, seed, args.ticks, dev)
            else:
                r = train_readings(cfg, tr, seed, dev, variant)
            print(json.dumps({"cell": args.cell, "seed": seed,
                              "variant": variant, "readings": r}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
