"""Plain-PyTorch reference of the MobilePoser network: the four RNN blocks,
the r6d decode and IK of the pose, the positions of the poser loss, and
the translation fusion of the streaming step (reference
mobileposer/models/ and net.py, as the configuration file states them).

It runs in float32 on float32 copies of whatever weights it is given
(bf16 weights are widened), its LSTMs through `torch.lstm`. It imports
nothing but torch, and takes only the configuration, the benchmark's
weights and the inputs. On the card, call it with TF32 off: the
benchmark sets the backends' flags.
"""

from __future__ import annotations

import warnings

import torch

# torch.lstm compacts the weights it is handed into cuDNN's layout at each
# call; the reference takes that cost and not the warning about it
warnings.filterwarnings("ignore", message="RNN module weights are not part")


def _lstm_flat(leafs: dict, layer: int, n_dir: int) -> list:
    out = []
    for d in ("fwd", "bwd")[:n_dir]:
        pre = f"lstm.{layer}.{d}."
        out += [leafs[pre + "w_ih"].t().contiguous(),
                leafs[pre + "w_hh"].t().contiguous(),
                leafs[pre + "b_ih"], leafs[pre + "b_hh"]]
    return out


def block(leafs: dict, mod: dict, x: torch.Tensor, h0c0=None, keep=None,
          train: bool = False):
    """One RNN block, time-major: x [T, B, n_input] -> (y [T, B,
    n_output], (h_T, c_T) [n_layers * n_dir, B, H]). linear1, ReLU, the
    dropout given by its keep mask [T, B, H] (train), the (bi)LSTM stack,
    linear2. Leaves are float tensors in the program's layouts."""
    f = {k: v.float() for k, v in leafs.items()}
    n_dir = 2 if mod["bidirectional"] else 1
    H, L = mod["n_hidden"], mod["n_layers"]
    h = torch.relu(x @ f["linear1.weight"].t() + f["linear1.bias"])
    if keep is not None:
        h = torch.where(keep, h / (1.0 - mod["dropout"]), h.new_zeros(()))
    if h0c0 is None:
        z = h.new_zeros((L * n_dir, x.shape[1], H))
        h0c0 = (z, z)
    flat = [w for layer in range(L) for w in _lstm_flat(f, layer, n_dir)]
    y, h_T, c_T = torch.lstm(h, tuple(t.float() for t in h0c0), flat, True,
                             L, 0.0, train, n_dir == 2, False)
    return y @ f["linear2.weight"].t() + f["linear2.bias"], (h_T, c_T)


def r6d_to_rotation(r6d: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] by Gram-Schmidt; the 6 numbers are the
    first two columns (reference angular.py:167-182), a norm's square
    clamped at 1e-16 as the reference's eps."""
    def unit(v):
        return v / torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True),
                                              1e-16))
    c0 = unit(r6d[..., 0:3])
    v2 = r6d[..., 3:6]
    c1 = unit(v2 - (c0 * v2).sum(-1, keepdim=True) * c0)
    c2 = torch.linalg.cross(c0, c1, dim=-1)
    return torch.stack([c0, c1, c2], dim=-1)


def pose_from_r6d(cfg: dict, r6d: torch.Tensor) -> torch.Tensor:
    """Reduced global r6d [N, 6 * len(reduced)] -> the 24 joints' local
    rotations [N, 24, 3, 3] (reference net.py:93-99): identity at the
    joints outside the reduced set, IK (local = parent^T @ global),
    identity at the ignored joints, the root's global rotation kept."""
    red, par = cfg["reduced_joints"], cfg["parents"]
    n_j = len(par)
    N = r6d.shape[0]
    rot = r6d_to_rotation(r6d.reshape(N, len(red), 6))
    glob = torch.eye(3, dtype=rot.dtype, device=rot.device).repeat(N, n_j, 1, 1)
    glob[:, red] = rot
    parent = [max(p, 0) for p in par]
    local = glob[:, parent].transpose(-1, -2) @ glob
    local[:, cfg["ignored_joints"]] = torch.eye(3, dtype=rot.dtype,
                                                device=rot.device)
    local[:, 0] = glob[:, 0]
    return local


def rest_pose_joints(cfg: dict, device) -> torch.Tensor:
    """The rest joints [24, 3] with the root at the origin."""
    J = torch.tensor(cfg["rest_joints"], dtype=torch.float32, device=device)
    return J - J[:1]


def positions_from_r6d(cfg: dict, r6d: torch.Tensor) -> torch.Tensor:
    """Joint positions [N, 72] of the reduced global r6d [N, 96] on the
    rest skeleton: each joint's bone turned by the global rotation of its
    parent's nearest reduced ancestor, summed down the tree from the
    root at the origin (the poser loss's position term)."""
    red, par = cfg["reduced_joints"], cfg["parents"]
    N = r6d.shape[0]
    rot = r6d_to_rotation(r6d.reshape(N, len(red), 6))
    j0 = rest_pose_joints(cfg, r6d.device)
    pos = [j0[0].expand(N, 3)]
    for j in range(1, len(par)):
        a = par[j]
        while a not in red:
            a = par[a]
        bone = j0[j] - j0[par[j]]
        pos.append(pos[par[j]] + rot[:, red.index(a)] @ bone)
    return torch.stack(pos, dim=1).reshape(N, -1)


def fusion_step(cfg: dict, joints: torch.Tensor, contact: torch.Tensor,
                vel: torch.Tensor, last_feet: torch.Tensor,
                root_prev: torch.Tensor, left_first: torch.Tensor):
    """One frame of the streaming translation fusion (reference
    net.py:186-208) for S streams: joints [S, 24, 3], contact logits
    [S, 2], the velocity module's output [S, 72] at the emitted frame,
    the previous frame's feet [S, 2, 3] and root [S, 3], and the contact
    branch (`left_first` [S] bool: the left foot anchors). Returns the
    root [S, 3] after this frame."""
    feet = joints[:, cfg["feet"]]
    disp = last_feet - feet                                   # [S, 2, 3]
    contact_vel = torch.where(left_first[:, None], disp[:, 0], disp[:, 1])
    contact_vel = contact_vel + torch.tensor(
        [0.0, cfg["gravity_velocity"], 0.0], device=joints.device)
    root_vel = vel.reshape(-1, 24, 3)[:, 0] / (cfg["fps"] / cfg["vel_scale"])
    cmax = contact.max(dim=1).values
    if cfg["online_sigmoid"]:
        cmax = torch.sigmoid(cmax)
    lo, hi = cfg["prob_threshold"]
    w = ((torch.clamp(cmax, lo, hi) - lo) / (hi - lo))[:, None]
    velocity = root_vel * (1 - w) + contact_vel * w
    floor_y = float(rest_pose_joints(cfg, "cpu")[cfg["feet"], 1].min())
    foot_y = root_prev[:, 1] + feet[:, :, 1].min(dim=1).values
    v_y = torch.where(foot_y + velocity[:, 1] <= floor_y, floor_y - foot_y,
                      velocity[:, 1])
    velocity = torch.cat([velocity[:, :1], v_y[:, None], velocity[:, 2:]], 1)
    return root_prev + velocity


def window_index(n_ticks: int, past: int, future: int, device) -> torch.Tensor:
    """[n_ticks, past + future] frame index of each tick's window: the
    last past + future frames up to the tick, the first frame repeated
    before the stream's start (reference net.py:175)."""
    W = past + future
    t = torch.arange(n_ticks, device=device)[:, None]
    return torch.clamp_min(t - (W - 1) + torch.arange(W, device=device), 0)


def pose_gap(cfg: dict, r6d: torch.Tensor, local: torch.Tensor) -> float:
    """How far poses [N, 24, 3, 3] of local rotations lie from the ones
    the reference's reduced r6d [N, 96] decode to, as one number: each
    joint's largest entry gap to the reference's pose (decoded in float64)
    over the magnification that the decode and the IK give an r6d error of
    the r6d's median size at that joint: m / |v1| + m / |v2 minus its part
    along v1|, for the joint and, through the IK, its parent. So the number
    reads the error of the network's output, not the decode's
    conditioning, which reaches 1e-4 for float32 rounding alone at an
    r6d whose two vectors are near parallel."""
    red, par = cfg["reduced_joints"], cfg["parents"]
    N = local.shape[0]
    r = r6d.double()
    ref = pose_from_r6d(cfg, r)
    v = r.reshape(N, len(red), 6)
    v1, v2 = v[..., 0:3], v[..., 3:6]
    n1 = v1.norm(dim=-1)
    u1 = v1 / n1.clamp_min(1e-300)[..., None]
    n2 = (v2 - (v2 * u1).sum(-1, keepdim=True) * u1).norm(dim=-1)
    m = torch.cat([n1, v2.norm(dim=-1)]).median()
    k = torch.zeros((N, len(par)), dtype=r.dtype, device=r.device)
    k[:, red] = m / n1.clamp_min(1e-300) + m / n2.clamp_min(1e-300)
    k = k + k[:, [max(p, 0) for p in par]] * (torch.arange(len(par)) > 0
                                              ).to(k)
    diff = (local.double() - ref).abs().amax(dim=(-1, -2))
    return float((diff / k.clamp_min(1.0)).max())


@torch.no_grad()
def stream_outputs(cfg: dict, leaves: dict, frames: torch.Tensor,
                   block_ticks: int = 256):
    """The streaming step's outputs, tick by tick, of K streams that
    started at tick 0: frames [n_ticks, K, 60] float32. Returns float32
    tensors at the emitted frame: the poser's reduced r6d [n, K, 96],
    joints [n, K, 24, 3], contact logits [n, K, 2] and the velocity
    module's output [n, K, 72]. The three bidirectional modules run on
    every tick's window at once, in blocks of ticks; the velocity module
    carries its LSTM state from each tick's window to the next (reference
    velocity.py:45-48)."""
    mods = cfg["modules"]
    past, future = cfg["window"]["past"], cfg["window"]["future"]
    n, K, D = frames.shape
    idx = window_index(n, past, future, frames.device)
    outs = {k: [] for k in ("r6d", "joints", "contact", "vel")}
    hc = None
    for b0 in range(0, n, block_ticks):
        b1 = min(n, b0 + block_ticks)
        x = frames[idx[b0:b1]]                          # [nb, W, K, D]
        nb, W = x.shape[:2]
        x = x.permute(1, 0, 2, 3).reshape(W, nb * K, D)
        joints, _ = block(leaves["joints"], mods["joints"], x)
        x132 = torch.cat([joints, x], dim=-1)
        r6d, _ = block(leaves["poser"], mods["poser"], x132)
        contact, _ = block(leaves["footcontact"], mods["footcontact"], x132)
        outs["r6d"].append(r6d[past].reshape(nb, K, -1))
        outs["joints"].append(joints[past].reshape(nb, K, 24, 3))
        outs["contact"].append(contact[past].reshape(nb, K, 2))
        x132 = x132.reshape(W, nb, K, -1)
        for i in range(nb):
            y, hc = block(leaves["velocity"], mods["velocity"], x132[:, i],
                          h0c0=hc)
            outs["vel"].append(y[past])
    return {k: (torch.stack(v) if k == "vel" else torch.cat(v))
            for k, v in outs.items()}
