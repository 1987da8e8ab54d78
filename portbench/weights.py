"""Weights and body arrays the benchmark makes and hands to both sides.

The weights are drawn on the device from the seed in one call, as one
flat buffer in the configuration's dtype, uniform in +-1/sqrt(fan) per
leaf (torch's default: fan is a linear's input width and an LSTM's
hidden width). Leaves keep the program's names and layouts: linears
[out, in], LSTM directions w_ih [in, 4H], w_hh [H, 4H], b_ih, b_hh [4H],
gates (i, f, g, o). The body is a T-pose skeleton from the configuration
file, with one vertex per joint.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import motion

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def leaves(cfg: dict) -> list:
    """[(module, leaf name, shape, fan)] in a fixed order."""
    out = []
    for name, m in cfg["modules"].items():
        H, n_dir = m["n_hidden"], 2 if m["bidirectional"] else 1
        out += [(name, "linear1.weight", (H, m["n_input"]), m["n_input"]),
                (name, "linear1.bias", (H,), m["n_input"]),
                (name, "linear2.weight", (m["n_output"], H * n_dir), H * n_dir),
                (name, "linear2.bias", (m["n_output"],), H * n_dir)]
        for layer in range(m["n_layers"]):
            n_in = H if layer == 0 else H * n_dir
            for d in ("fwd", "bwd")[:n_dir]:
                pre = f"lstm.{layer}.{d}."
                out += [(name, pre + "w_ih", (n_in, 4 * H), H),
                        (name, pre + "w_hh", (H, 4 * H), H),
                        (name, pre + "b_ih", (4 * H,), H),
                        (name, pre + "b_hh", (4 * H,), H)]
    return out


def make_flat(cfg: dict, seed: int, device) -> torch.Tensor:
    """The flat weight buffer in the configuration's dtype on `device`."""
    ls = leaves(cfg)
    sizes = [math.prod(shape) for _, _, shape, _ in ls]
    total = sum(sizes)
    if total != cfg["parameters"]:
        raise ValueError(f"{cfg['name']}: {total} parameters, the file says "
                         f"{cfg['parameters']}")
    bounds = torch.repeat_interleave(
        torch.tensor([1.0 / math.sqrt(fan) for *_, fan in ls], device=device),
        torch.tensor(sizes, device=device))
    u = torch.rand(total, generator=motion.generator(seed, 3, device),
                   device=device)
    return ((2.0 * u - 1.0) * bounds).to(DTYPES[cfg["dtype"]])


def views(cfg: dict, flat: torch.Tensor) -> dict:
    """{module: {leaf name: view of `flat`}}."""
    out, off = {}, 0
    for mod, name, shape, _ in leaves(cfg):
        n = math.prod(shape)
        out.setdefault(mod, {})[name] = flat[off:off + n].view(shape)
        off += n
    return out


@torch.no_grad()
def load_into(cfg: dict, flat: torch.Tensor, modules) -> None:
    """Copy the buffer into the program's modules (a mapping of module
    name to `torch.nn.Module`), leaf by name; every leaf of both sides
    has to match in name, shape and dtype."""
    want = views(cfg, flat)
    for mod, leafs in want.items():
        have = dict(modules[mod].named_parameters())
        if set(have) != set(leafs):
            raise ValueError(f"{mod}: the program's leaves {sorted(have)} are "
                             f"not the configuration's {sorted(leafs)}")
        for name, v in leafs.items():
            p = have[name]
            if p.shape != v.shape or p.dtype != v.dtype:
                raise ValueError(f"{mod}.{name}: program {tuple(p.shape)} "
                                 f"{p.dtype}, benchmark {tuple(v.shape)} "
                                 f"{v.dtype}")
            p.copy_(v)


def body_arrays(cfg: dict) -> dict:
    """The arrays of the body the program's `ParametricModel` is built
    from: the configuration's rest joints, one vertex per joint."""
    J = np.asarray(cfg["rest_joints"], np.float32)
    n = J.shape[0]
    eye = np.eye(n, dtype=np.float32)
    return dict(J_regressor=eye, weights=eye,
                posedirs=np.zeros((n, 3, (n - 1) * 9), np.float32),
                shapedirs=np.zeros((n, 3, 10), np.float32),
                v_template=J.copy(), J=J, f=np.array([[0, 1, 2]], np.int32),
                parents=tuple(cfg["parents"]))
