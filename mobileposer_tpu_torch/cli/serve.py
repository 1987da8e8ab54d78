"""Run the multi-stream pose inference server on the card (counterpart of
`mobileposer_tpu/cli/serve.py`).

    python -m mobileposer_tpu_torch.cli.serve --model weights.npz \\
        [--port 9000] [--max-streams 64] [--tick-hz 30] [--carry] \\
        [--int8 | --bf16] [--wire f16] [--no-pipeline] [--device cpu]

Weights are the JAX package's `.npz` archives or the reference's torch
checkpoints (`.pth`, `models.utils.load_model`). Runs on the CUDA card
unless `--device` names another device (`cpu` runs the kernels' plain
versions). `--bf16` casts the loaded params to bfloat16
(`nn.convert.cast_params`, as the JAX CLI does): the server then runs its
state, frames and step in bf16, exact and carry mode. `--int8 --bf16`
casts first and hands `quantize="int8"` to the server, which quantizes
the bf16 cast (int8 on bf16 params, the JAX package's serving
configuration). `--data-parallel` serves on the one device when one is
visible, as the JAX CLI does with one device; over more than one CUDA
device it is accepted as the JAX CLI accepts it and raises
NotImplementedError naming the ROADMAP row that adds it.
"""

from __future__ import annotations

import argparse
import json

import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.models.utils import load_model
from mobileposer_tpu_torch.nn.convert import cast_params, params_from_jax
from mobileposer_tpu_torch.stream import PoseServer


def build_server(args) -> PoseServer:
    """The server the parsed arguments describe (bound, not running)."""
    device = resolve_device(args.device)
    # the JAX CLI builds a mesh only over more than one device
    if (args.data_parallel and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            "--data-parallel over more than one CUDA device is not ported "
            "(ROADMAP.md queue A item 16)")
    net = MobilePoserNet(ParametricModel.from_file_or_synthetic(
        C.paths.smpl_file), device=device)
    params = params_from_jax(load_model(args.model), device=net.device)
    if args.bf16:
        params = cast_params(params, torch.bfloat16)
    return PoseServer(net, params, host=args.host, port=args.port,
                      max_streams=args.max_streams, tick_hz=args.tick_hz,
                      mode="carry" if args.carry else "exact",
                      pipelined=not args.no_pipeline,
                      quantize="int8" if args.int8 else None,
                      wire=args.wire, fetch_workers=args.fetch_workers)


def main(argv=None) -> dict:
    """Serve until Ctrl-C or `--duration` seconds; print and return the
    server's `stats()`."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True,
                        help="combined weights (.npz from the JAX package, "
                             "or the reference's .pth)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9000)
    parser.add_argument("--max-streams", type=int, default=64)
    parser.add_argument("--tick-hz", type=float, default=30.0)
    parser.add_argument("--duration", type=float, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--bf16", action="store_true",
                        help="serve on bf16-cast params: bf16 state, "
                             "frames and step (exact and carry mode); "
                             "replies stay float32 or f16 on the wire; "
                             "with --int8 the server quantizes the bf16 "
                             "cast")
    parser.add_argument("--data-parallel", action="store_true",
                        help="serves on the one device; over more than "
                             "one CUDA device not ported (ROADMAP.md "
                             "queue A item 16)")
    parser.add_argument("--carry", action="store_true",
                        help="carry-mode streaming (models/streaming.py): "
                             "approximate window semantics, no LSTM "
                             "kernel")
    parser.add_argument("--int8", action="store_true",
                        help="W8A8-quantize the LSTM matmuls (ops/quant.py); "
                             "exact and carry modes")
    parser.add_argument("--wire", default="f32", choices=["f32", "f16"],
                        help="reply wire format: f16 halves the reply bytes "
                             "(pose and contact as half floats, translation "
                             "f32) and the device-to-host copy; clients "
                             "pass the matching wire= to PoseClient")
    parser.add_argument("--fetch-workers", type=int, default=1,
                        help="pipelined reply-fetcher threads; a tick "
                             "fetched after a newer one was sent is "
                             "dropped whole, never delivered stale")
    parser.add_argument("--no-pipeline", action="store_true",
                        help="synchronous ticks (replies copied and sent "
                             "inside the tick). Default: the pipelined "
                             "tick, whose replies carry the same content "
                             "one tick later")
    args = parser.parse_args(argv)
    server = build_server(args)
    print(f"Pose server on udp://{args.host}:{server.port} "
          f"({args.max_streams} streams @ {args.tick_hz} Hz, "
          f"{server.mode} mode on {server.device}"
          + (", int8" if args.int8 else "")
          + (", bf16" if args.bf16 else "")
          + (", f16 wire" if args.wire == "f16" else "")
          + (", pipelined" if server.pipelined else ", synchronous")
          + "). Ctrl-C to stop.", flush=True)
    try:
        server.run(duration=args.duration)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        server.close()
    stats = server.stats()
    print("\n" + json.dumps(stats), flush=True)
    return stats


if __name__ == "__main__":
    main()
