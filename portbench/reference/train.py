"""Plain-PyTorch reference of the concurrent four-module training step:
the draws, the four losses (reference joints.py:54-75, poser.py:65-103,
footcontact.py:43-72, velocity.py:51-86), their gradients by autograd
and Adam (AdamW for joints) in optax's form, in the params' dtype.

Draws: the step takes its joint-input noise and dropout masks from the
generator it is handed, module by module in the configuration's
`draw_order`, the noise (standard normal of the joint targets' shape)
first, then the keep mask (uniform < 1 - dropout, of the hidden
activation's shape). `draws` makes the same calls in the same order on a
generator seeded alike, so both sides see the same numbers.
"""

from __future__ import annotations

import torch

from portbench.reference.model import block, positions_from_r6d


def draws(cfg: dict, batch: dict, gen: torch.Generator) -> dict:
    """{module: (noise or None, keep)} for one step."""
    B, T = batch["imu"].shape[:2]
    tr = cfg["train"]
    out = {}
    for name in tr["draw_order"]:
        mod = cfg["modules"][name]
        noise = None
        if name in tr["noise_std"]:
            noise = torch.randn(tuple(batch["joints"].shape), generator=gen,
                                device=gen.device)
        keep = torch.rand((B, T, mod["n_hidden"]), generator=gen,
                          device=gen.device) < (1.0 - mod["dropout"])
        out[name] = (noise, keep)
    return out


def _apply(leafs, mod, x_bm, keep):
    """A block on a batch-major input with its keep mask, batch-major out."""
    y, _ = block(leafs, mod, x_bm.transpose(0, 1), keep=keep.transpose(0, 1),
                 train=True)
    return y.transpose(0, 1)


def _temporal(pred, order):
    d = torch.diff(pred, n=order, dim=1)
    return d.abs().sum(dim=2).sum(dim=1).mean()


def losses(cfg: dict, leaves: dict, batch: dict, dr: dict) -> dict:
    """The four training losses of one batch (every window full length)."""
    mods, tr = cfg["modules"], cfg["train"]
    imu = batch["imu"].float()
    B, T = imu.shape[:2]
    tj = batch["joints"].float().reshape(B, T, -1)
    tw = tr["temporal_weight"]
    out = {}

    pred = _apply(leaves["joints"], mods["joints"], imu, dr["joints"][1])
    out["joints"] = ((pred - tj) ** 2).mean() + tw * _temporal(pred, 2)

    def noisy(name):
        return torch.cat([tj + tr["noise_std"][name] * dr[name][0].reshape(
            B, T, -1), imu], dim=-1)

    pred = _apply(leaves["poser"], mods["poser"], noisy("poser"),
                  dr["poser"][1])
    tgt = batch["pose_r6d"].float().reshape(B, T, 24, 6)[
        :, :, cfg["reduced_joints"]].reshape(B, T, -1)
    pos = positions_from_r6d(cfg, pred.reshape(B * T, -1)).reshape(B, T, -1)
    out["poser"] = (((pred - tgt) ** 2).mean() + tw * _temporal(pred, 3)
                    + ((pos - tj) ** 2).mean())

    logits = _apply(leaves["footcontact"], mods["footcontact"],
                    noisy("footcontact"), dr["footcontact"][1])
    lab = batch["contacts"].float()
    out["footcontact"] = (torch.clamp_min(logits, 0) - logits * lab
                          + torch.log1p(torch.exp(-logits.abs()))).mean()

    pred = _apply(leaves["velocity"], mods["velocity"], noisy("velocity"),
                  dr["velocity"][1])
    tv = batch["vels"].float().reshape(B, T, -1)
    err = (pred - tv) ** 2
    total = 0.0
    for n in (1, 3, 9):
        k = T // n
        total = total + err[:, :k * n].reshape(B, k, n, -1).mean(
            dim=(0, 2, 3)).sum()
    out["velocity"] = total
    return out


class Adam:
    """optax's adam / adamw (scale_by_adam, add_decayed_weights,
    scale_by_learning_rate) on a list of leaves, every operation in the
    leaves' dtype, the bias corrections in float32 then rounded to it."""

    def __init__(self, params, lr, betas, eps, weight_decay=0.0):
        self.params, self.lr, self.eps, self.wd = params, lr, eps, weight_decay
        self.b1, self.b2 = betas
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** self.count
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            def c(v):
                return torch.as_tensor(v, dtype=p.dtype, device=p.device)
            mu.copy_(c(1 - b1) * g + c(b1) * mu)
            nu.copy_(c(1 - b2) * (g * g) + c(b2) * nu)
            u = (mu / c(bc1)) / (torch.sqrt(nu / c(bc2)) + c(self.eps))
            if self.wd:
                u = u + c(self.wd) * p
            p.copy_(p + c(-self.lr) * u)


def run_steps(cfg: dict, leaves: dict, batches: list, gen: torch.Generator):
    """len(batches) concurrent steps from `leaves` ({module: {leaf:
    tensor}}, copied, in the params' dtype). Returns (losses [step]
    {module: float}, the first step's gradients as the optimizer takes
    them, mu / (1 - b1), and the leaves after the last step), each a
    {module: {leaf: tensor}}."""
    tr = cfg["train"]
    params = {m: {k: v.detach().clone().requires_grad_(True)
                  for k, v in ls.items()} for m, ls in leaves.items()}
    opts = {m: Adam(list(ls.values()), tr["lr"], tr["betas"], tr["eps"],
                    tr["weight_decay"].get(m, 0.0))
            for m, ls in params.items()}
    history, first_grads = [], None
    for batch in batches:
        dr = draws(cfg, batch, gen)
        ls = losses(cfg, params, batch, dr)
        for ps in params.values():
            for p in ps.values():
                p.grad = None
        sum(ls.values()).backward()
        history.append({m: float(v.detach()) for m, v in ls.items()})
        for m, ps in params.items():
            opts[m].step([p.grad for p in ps.values()])
        if first_grads is None:
            first_grads = {m: {k: mu / (1 - tr["betas"][0])
                               for k, mu in zip(params[m], opts[m].mu)}
                           for m in params}
    return history, first_grads, {m: {k: v.detach() for k, v in ps.items()}
                                  for m, ps in params.items()}
