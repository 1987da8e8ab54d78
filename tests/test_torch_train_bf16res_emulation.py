"""The bf16-residual entries of the training kernels
(`ops/csrc/lstm_train.cu`: `lstm_train_fwd_bf16res`,
`lstm_train_bwd_bf16res`, `lstm_train_dw_bf16res`) built with g++ against
the CPU stand-in of the CUDA runtime (`tests/cuda_emu/`, its
`cuda_bf16.h` included) and run on the CPU.

The bf16res entries are the f32 entries' kernels instantiated on a bf16
residual type: the forward rounds acts, hseq and cseq to bf16 as it
stores them and changes nothing else, the backward scan and the dW
reduction widen the bf16 residuals (exactly) as they use them. Hence
three identities that hold bit for bit, checked at H = 32 and 64, at
every rows-per-cluster template, with partial batch tiles and a ragged
mask (an empty and a full row): the forward's ys, h_T and c_T equal the
f32 entry's, its acts, hseq and cseq equal the f32 entry's rounded to
bf16, and the backward scan and the dW reduction on the bf16 residuals
equal the f32 entries on the same residuals widened. The dW reduction is
also checked at H = 64 and 160 with a row count that leaves a partial
stage (and slabs that do). Against the plain bf16res versions: 1e-5 (the
stand-in does not contract FMAs as nvcc does; see
tests/test_torch_cuda_emulation.py), the residuals within 1 bf16 ulp on
at most 1% of them (a float32 last bit apart can land a value on the
other side of a bf16 rounding boundary). Last, the wrappers launch the
bf16res entries on bf16 residuals and refuse mixed residual dtypes.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from mobileposer_tpu_torch import bench
from mobileposer_tpu_torch.ops import lstm_train_cuda as train_cuda
from test_torch_cuda_emulation import _call, _emu_build

BF16 = torch.bfloat16
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def train_lib(tmp_path_factory):
    """lstm_train.cu built for the CPU stand-in, its f32 and bf16res
    entries declared."""
    lib = _emu_build(tmp_path_factory, "lstm_train.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    for suffix in ("f32", "bf16res"):
        getattr(lib, f"lstm_train_fwd_{suffix}").argtypes = (
            [P] * 11 + [I] * 4 + [P])
        getattr(lib, f"lstm_train_bwd_{suffix}").argtypes = (
            [P] * 11 + [I] * 4 + [P])
        getattr(lib, f"lstm_train_dw_{suffix}").argtypes = (
            [P] * 3 + [I] * 4 + [P])
    return lib


def _inputs(rng, T, B, H):
    """x_proj, w_hh, h0, c0 (nonzero), a ragged mask (row 0 empty, row 1
    full) and dy, dh_T, dc_T, all float32."""
    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32))

    bound = 1.0 / math.sqrt(H)
    x_proj = t(T, B, 4 * H)
    w_hh = torch.from_numpy(rng.uniform(-bound, bound, (H, 4 * H)).astype(
        np.float32))
    h0, c0 = t(B, H, scale=0.5), t(B, H, scale=0.5)
    lengths = rng.randint(1, T + 1, size=B)
    lengths[0] = 0
    if B > 1:
        lengths[1] = T
    mask = (torch.arange(T)[:, None] < torch.from_numpy(lengths)[None]
            ).float().contiguous()
    return x_proj, w_hh, h0, c0, mask, t(T, B, H), t(B, H), t(B, H)


def _fwd(lib, suffix, rdt, x_proj, w_hh, h0, c0, mask, rows):
    """One forward launch on the stand-in: ys, acts, hseq, cseq, h_T,
    c_T, the residuals in `rdt`."""
    T, B, H4 = x_proj.shape
    H = H4 // 4
    out = [torch.full((T, B, H), float("nan"))]
    out += [torch.full((T, B, n), float("nan")).to(rdt)
            for n in (4 * H, H, H)]
    out += [torch.full((B, H), float("nan")) for _ in range(2)]
    _call(getattr(lib, f"lstm_train_fwd_{suffix}"), x_proj, w_hh, h0, c0,
          mask, *out, T, B, H, rows)
    return out


def _bwd(lib, suffix, dy, dh_t, dc_t, acts, cseq, c_prev, w_hh, mask, rows):
    """One backward-scan launch on the stand-in: dx_proj, dh0, dc0."""
    T, B, H = dy.shape
    out = [torch.full((T, B, 4 * H), float("nan"))]
    out += [torch.full((B, H), float("nan")) for _ in range(2)]
    _call(getattr(lib, f"lstm_train_bwd_{suffix}"), dy, dh_t, dc_t, acts,
          cseq, c_prev, w_hh, mask, *out, T, B, H, rows)
    return out


def _dw(lib, suffix, h_prev, dgates, n_slabs, per_slab):
    """The dW reduction on the stand-in, its slabs summed in order."""
    N, H = h_prev.shape[0] * h_prev.shape[1], h_prev.shape[-1]
    slabs = torch.full((n_slabs, H, 4 * H), float("nan"))
    _call(getattr(lib, f"lstm_train_dw_{suffix}"), h_prev, dgates, slabs, N,
          H, n_slabs, per_slab)
    return slabs.sum(0)


def _bf16_ulps(got, want) -> float:
    """The largest difference in bf16 ulps of want's largest magnitude."""
    ulp = 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - 7)
    return float((got.float() - want.float()).abs().max()) / ulp


@pytest.mark.parametrize("T,B,H,rows", [
    (3, 3, 32, 1), (3, 5, 64, 2), (3, 7, 32, 4), (3, 9, 64, 8),
    (3, 13, 32, 12), (3, 20, 64, 16), (3, 37, 32, 18), (3, 41, 64, 20),
    (3, 50, 32, 24), (3, 33, 64, 32)])
def test_bf16res_entries_are_the_f32_entries_on_rounded_residuals(
        train_lib, T, B, H, rows):
    rng = np.random.RandomState(T + B + H + rows)
    x_proj, w_hh, h0, c0, mask, dy, dh_t, dc_t = _inputs(rng, T, B, H)

    f32 = _fwd(train_lib, "f32", torch.float32, x_proj, w_hh, h0, c0, mask,
               rows)
    b16 = _fwd(train_lib, "bf16res", BF16, x_proj, w_hh, h0, c0, mask, rows)
    for i, name in ((0, "ys"), (4, "h_T"), (5, "c_T")):
        assert torch.equal(b16[i], f32[i]), name
    for i, name in ((1, "acts"), (2, "hseq"), (3, "cseq")):
        assert torch.equal(b16[i], f32[i].to(BF16)), name
    want = train_cuda.lstm_train_fwd_plain(x_proj, w_hh, h0, c0, mask,
                                           residual_dtype=BF16)
    for i, name in ((0, "ys"), (4, "h_T"), (5, "c_T")):
        np.testing.assert_allclose(b16[i].numpy(), want[i].numpy(),
                                   atol=TOL, err_msg=name)
    for i, name in ((1, "acts"), (2, "hseq"), (3, "cseq")):
        assert _bf16_ulps(b16[i], want[i]) <= 1, name
        assert float((b16[i] != want[i]).float().mean()) <= 0.01, name

    # the backward on the bf16 residuals, and the f32 entry on them widened
    _, acts, hseq, cseq, _, _ = b16
    h_prev = torch.cat([h0.to(BF16)[None], hseq[:-1]]).contiguous()
    c_prev = torch.cat([c0.to(BF16)[None], cseq[:-1]]).contiguous()
    got = _bwd(train_lib, "bf16res", dy, dh_t, dc_t, acts, cseq, c_prev,
               w_hh, mask, rows)
    wide = _bwd(train_lib, "f32", dy, dh_t, dc_t, acts.float(),
                cseq.float(), c_prev.float(), w_hh, mask, rows)
    for name, g, w in zip(("dx_proj", "dh0", "dc0"), got, wide):
        assert torch.equal(g, w), name
    dx, dw, dh0, dc0 = train_cuda.lstm_train_bwd_plain(
        dy, dh_t, dc_t, acts, cseq, h_prev, c_prev, w_hh, mask)
    for name, g, w in zip(("dx_proj", "dh0", "dc0"), got, (dx, dh0, dc0)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL,
                                   err_msg=name)

    # the dW reduction on the scan's dgates, in the wrapper's slabs
    n_slabs, per_slab = train_cuda._dw_slabs(T * B, H)
    dw16 = _dw(train_lib, "bf16res", h_prev, got[0], n_slabs, per_slab)
    assert torch.equal(dw16, _dw(train_lib, "f32", h_prev.float(), got[0],
                                 n_slabs, per_slab))
    np.testing.assert_allclose(dw16.numpy(), dw.numpy(),
                               atol=TOL * float(dw.abs().max()))


@pytest.mark.parametrize("H", [64, 160])
def test_bf16res_dw_with_stage_and_column_tails(train_lib, H):
    """N = 3 x 45 = 135 rows (eight whole 16-row stages and a tail of 7),
    in one slab and in three of 50 rows (each with its own tail); at
    H = 160 the second 64-row tile of dw_hh holds 32 rows past H, whose
    copies are zero-filled. Bit for bit the f32 entry on h_prev widened,
    and within 1e-5 of the largest entry of the plain reduction."""
    rng = np.random.RandomState(H)
    T, B = 3, 45
    h_prev = torch.from_numpy(rng.randn(T, B, H).astype(np.float32)).to(BF16)
    dgates = torch.from_numpy(rng.randn(T, B, 4 * H).astype(np.float32))
    want = train_cuda.lstm_train_dw_plain(h_prev, dgates)
    for n_slabs, per_slab in ((1, T * B), (3, 50)):
        got = _dw(train_lib, "bf16res", h_prev, dgates, n_slabs, per_slab)
        assert torch.equal(got, _dw(train_lib, "f32", h_prev.float(), dgates,
                                    n_slabs, per_slab))
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=TOL * float(want.abs().max()))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    kernel route (into a recording `_call`)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_wrappers_launch_the_bf16res_entries(monkeypatch):
    """On bf16 residuals the wrappers launch the *_bf16res entries, with
    bf16 residual outputs from the forward and the bf16 h_prev handed to
    dW as it is; the f32 entries on float32 ones."""
    calls = []
    monkeypatch.setattr(train_cuda, "_call",
                        lambda name, *args: calls.append((name, args)))
    # the outputs the wrappers allocate on "the card" land on the CPU
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: empty(*a, **k))
    monkeypatch.setattr(
        train_cuda, "train_geometry",
        lambda b, h, dev: train_cuda._train_geometry(b, h, 16))
    T, B, H = 2, 3, 32
    rng = np.random.RandomState(0)
    x_proj, w_hh, h0, c0, mask, dy, dh_t, dc_t = (
        t.as_subclass(_OnCard) for t in _inputs(rng, T, B, H))
    for rdt, suffix in ((torch.float32, "f32"), (BF16, "bf16res")):
        calls.clear()
        out = train_cuda.lstm_train_fwd(x_proj, w_hh, h0, c0, mask,
                                        residual_dtype=rdt)
        assert [o.dtype for o in out] == [torch.float32, rdt, rdt, rdt,
                                          torch.float32, torch.float32]
        seq = [torch.zeros(T, B, n, dtype=rdt).as_subclass(_OnCard)
               for n in (4 * H, H, H, H)]
        train_cuda.lstm_train_bwd(dy, dh_t, dc_t, *seq, w_hh, mask,
                                  residual_dtype=rdt)
        assert [name for name, _ in calls] == [
            f"lstm_train_{k}_{suffix}" for k in ("fwd", "bwd", "dw")]
        assert calls[2][1][0] is seq[2]       # h_prev, as it is


def test_wrappers_refuse_mixed_residual_dtypes():
    """The four residuals share one dtype, float32 or bf16, and it is the
    one asked for; dy, dh_T, dc_T and the mask share the I/O dtype, and
    bf16 I/O takes bf16 w_hh."""
    T, B, H = 2, 3, 32
    x_proj, w_hh, h0, c0, mask, dy, dh_t, dc_t = _inputs(
        np.random.RandomState(1), T, B, H)
    _, acts, hseq, cseq, _, _ = train_cuda.lstm_train_fwd(
        x_proj, w_hh, h0, c0, mask, residual_dtype=BF16)
    args = [dy, dh_t, dc_t, acts, cseq, hseq, cseq, w_hh, mask]
    train_cuda.lstm_train_bwd(*args, residual_dtype=BF16)
    for i, name in ((3, "acts"), (4, "c_new_seq"), (5, "h_prev_seq"),
                    (6, "c_prev_seq")):
        mixed = list(args)
        mixed[i] = mixed[i].float()
        with pytest.raises(ValueError, match=name):
            train_cuda.lstm_train_bwd(*mixed, residual_dtype=BF16)
    with pytest.raises(ValueError, match="acts"):
        train_cuda.lstm_train_bwd(*args)            # float32 asked for
    bad = list(args)
    bad[0] = bad[0].to(BF16)
    with pytest.raises(ValueError, match="dy"):
        train_cuda.lstm_train_bwd(*bad, residual_dtype=BF16)
    # bf16 I/O takes bf16 w_hh (a bf16 w_hh beside float32 I/O is the
    # wbf16 entries' case: bf16 params, a float32 input)
    bad = [a.to(BF16) if i in (0, 1, 2, 8) else a for i, a in
           enumerate(args)]
    with pytest.raises(ValueError, match="w_hh"):
        train_cuda.lstm_train_bwd(*bad, residual_dtype=BF16)
    with pytest.raises(ValueError, match="residual_dtype"):
        train_cuda.lstm_train_fwd(x_proj, w_hh, h0, c0, mask,
                                  residual_dtype=torch.float16)
    assert set(train_cuda.launches.values()) == {0}


def test_bench_groups_the_bf16res_kernels():
    """The traced step's kernel names: a bf16res entry's kernel goes to
    its f32 group's name with ' bf16res' appended."""
    f32 = ("void (anonymous namespace)::lstm_train_fwd_kernel<18, float>"
           "(float const*, float const*, float const*, float const*, float "
           "const*, float*, float*, float*, float*, float*, float*, int, "
           "int, int)")
    assert bench._kernel_group(f32) == (
        "#7 lstm_train_fwd (ops/csrc/lstm_train.cu)")
    for kernel, group in (
            ("lstm_train_fwd_kernel<18, __nv_bfloat16>(float const*, "
             "__nv_bfloat16*)", "#7 lstm_train_fwd"),
            ("lstm_train_bwd_kernel<18, __nv_bfloat16>(float const*, "
             "__nv_bfloat16 const*)", "#8 lstm_train_bwd scan"),
            ("lstm_train_dw_kernel<2, __nv_bfloat16>(__nv_bfloat16 const*, "
             "float const*, float*, int, int, int)",
             "#8 lstm_train_dw reduction")):
        assert bench._kernel_group("void (anonymous namespace)::" + kernel) \
            == f"{group} (ops/csrc/lstm_train.cu) bf16res"
