"""On the card: the full-length float route of `lstm_forward_cuda`, on the
fold entries of kernels #1 and #2 (the bias added in the scan, the
backward direction read and written in time order, both directions' ys in
one [T, B, 2H] buffer), against the route it replaced (the bias added on
the host, the backward input flipped, the entries of the Pallas contract,
their ys flipped back and concatenated), bit for bit at the streaming
shapes [45, 512, 256] and [45, 512, 64], in float32 and bf16; and a
profiled `forward_online_batched` tick at 512 streams: one scan launch a
layer, and no bias add, flip or concat inside the LSTM layers.

Tests marked `chip` skip without a card. Run them on a machine with one,
where JAX is not installed and the tests' conftest cannot load:
`python -m pytest tests/test_torch_scan_fold_chip.py -q -m chip
--noconftest -p no:cacheprovider`.
"""

import pytest
import torch

from mobileposer_tpu_torch.models.modules import init_all_modules
from mobileposer_tpu_torch.ops import lstm_cuda

BF16 = torch.bfloat16
T, S = 45, 512

pytestmark = pytest.mark.chip


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _bits(t):
    t = t.detach().contiguous().cpu()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _old_forward(layers, xs, h0c0, bidirectional):
    """The route the fold entries replaced, time-major: x @ w_ih + (b_ih +
    b_hh) on the host, the backward input flipped, the entries of the
    Pallas contract, ys_b flipped back, the directions concatenated."""
    n_dir = 2 if bidirectional else 1
    h0, c0 = h0c0
    hs, cs = [], []
    for li, layer in enumerate(layers):
        if bidirectional:
            pf, pb = layer["fwd"], layer["bwd"]
            x_f = lstm_cuda._project_timesteps(xs, pf).contiguous()
            x_b = lstm_cuda._project_timesteps(torch.flip(xs, (0,)),
                                               pb).contiguous()
            s = li * n_dir
            ys_f, ys_b, (hf, cf), (hb, cb) = lstm_cuda.bilstm_layer(
                x_f, x_b, pf.w_hh, pb.w_hh, h0[s], c0[s], h0[s + 1],
                c0[s + 1])
            xs = torch.cat([ys_f, torch.flip(ys_b, (0,))], dim=-1)
            hs += [hf, hb]
            cs += [cf, cb]
        else:
            p = layer["fwd"]
            x_proj = lstm_cuda._project_timesteps(xs, p).contiguous()
            xs, (h, c) = lstm_cuda.lstm_layer(x_proj, p.w_hh, h0[li], c0[li])
            hs.append(h)
            cs.append(c)
    return xs, (torch.stack(hs), torch.stack(cs))


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["joints", "footcontact", "velocity"])
def test_fold_route_equals_the_old_route(cuda_device, name, dtype):
    """A module's (bi)LSTM stack at 512 streams of 45 frames (H = 256 for
    joints and velocity, 64 for footcontact), on nonzero initial states:
    the fold route gives the old route's bits, outputs and final states,
    with one fold-entry launch a layer (and the old route one launch a
    layer of the old entry)."""
    torch.manual_seed(0)
    params = init_all_modules(torch.Generator().manual_seed(5),
                              device=cuda_device, dtype=dtype)[name]
    layers = params.lstm
    n_dir = 2 if "bwd" in layers[0] else 1
    H = layers[0]["fwd"].w_hh.shape[0]
    D = layers[0]["fwd"].w_ih.shape[0]
    gen = torch.Generator(cuda_device).manual_seed(7)
    xs = torch.randn(T, S, D, generator=gen, device=cuda_device).to(dtype)
    h0c0 = tuple((0.5 * torch.randn(len(layers) * n_dir, S, H, generator=gen,
                                    device=cuda_device)).to(dtype)
                 for _ in range(2))
    with torch.no_grad():
        lstm_cuda.reset_launches()
        y, (h, c) = lstm_cuda.lstm_forward_cuda(
            layers, xs, h0c0, bidirectional=n_dir == 2, time_major=True)
        s = {torch.float32: "f32", BF16: "bf16"}[dtype]
        kind = f"{'bi' * (n_dir == 2)}lstm_scan"
        assert {k: v for k, v in lstm_cuda.launches.items() if v} == {
            f"{kind}_fold_{s}": len(layers)}
        lstm_cuda.reset_launches()
        wy, (wh, wc) = _old_forward(layers, xs, h0c0, n_dir == 2)
        assert {k: v for k, v in lstm_cuda.launches.items() if v} == {
            f"{kind}_{s}": len(layers)}
    torch.cuda.synchronize(cuda_device)
    for what, g, w in (("y", y, wy), ("h_T", h, wh), ("c_T", c, wc)):
        assert torch.equal(_bits(g), _bits(w)), what


def _lstm_ranges(prof):
    """The aten ops inside each of the profiler's `lstm_forward_cuda`
    ranges, with their input shapes."""
    def walk(e):
        yield e
        for ch in e.cpu_children:
            yield from walk(ch)

    return [[(d.name, d.input_shapes) for d in walk(e)
             if d.name.startswith("aten::")]
            for e in prof.events()
            # the range on the host (the profiler also shows it on the card)
            if e.name == "lstm_forward_cuda"
            and e.device_type == torch.autograd.DeviceType.CPU]


def test_tick_runs_one_scan_a_layer_and_no_glue(cuda_device, monkeypatch):
    """One `forward_online_batched` tick at 512 streams, profiled: each of
    the four modules' LSTM stacks is its products, its bias sums ([4H]
    adds), its two layer scans and the stack of its final states; no flip,
    no add over a [T, B, 4H] product and no concat of layer outputs."""
    from mobileposer_tpu_torch.kinematics.smpl import ParametricModel
    from mobileposer_tpu_torch.models.net import MobilePoserNet
    from mobileposer_tpu_torch.ops import lstm_cuda as L

    inner = L.lstm_forward_cuda

    def ranged(*args, **kw):
        with torch.profiler.record_function("lstm_forward_cuda"):
            return inner(*args, **kw)

    monkeypatch.setattr(L, "lstm_forward_cuda", ranged)
    params = init_all_modules(torch.Generator().manual_seed(3),
                              device=cuda_device)
    net = MobilePoserNet(body_model=ParametricModel.synthetic(),
                         device=cuda_device)
    state = net.init_online_state_batched(S)
    frames = torch.randn(S, 60, device=cuda_device) * 0.1
    with torch.no_grad():
        for _ in range(2):   # warm: every kernel built, every shape seen
            _, state = net.forward_online_batched(params, state, frames)
        torch.cuda.synchronize(cuda_device)
        L.reset_launches()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
                record_shapes=True) as prof:
            net.forward_online_batched(params, state, frames)
            torch.cuda.synchronize(cuda_device)
    assert {k: v for k, v in L.launches.items() if v} == {
        "bilstm_scan_fold_f32": 6, "lstm_scan_fold_f32": 2}
    ranges = _lstm_ranges(prof)
    assert len(ranges) == 4
    for ops in ranges:
        names = [n for n, _ in ops]
        assert "aten::flip" not in names
        # a concat only inside the stacks of h_T and c_T
        assert names.count("aten::cat") <= names.count("aten::stack"), names
        for n, shapes in ops:
            if n == "aten::add":   # the bias sums, [4H], only
                assert all(len(s) <= 1 for s in shapes), shapes
    # on the card: the eight layer scans, and no flip anywhere in the tick
    # (the kernels launched through ctypes are not attributed to a range)
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("lstm_scan_kernel" in k for k in kernels) == 8, kernels
    assert not any("flip" in k for k in kernels), kernels
