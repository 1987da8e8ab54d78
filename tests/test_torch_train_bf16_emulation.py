"""The training kernels' entries for bf16 params (`ops/csrc/lstm_train.cu`:
`lstm_train_{fwd,bwd}_bf16`, `_bf16_bf16res`, `lstm_train_bwd_wbf16`,
`_wbf16_bf16res`) built with g++ against the CPU stand-in of the CUDA
runtime (`tests/cuda_emu/`, its `cuda_bf16.h` included) and run on the
CPU.

First through the wrappers themselves: CPU tensors that report a CUDA
device take `lstm_train_fwd`'s and `lstm_train_bwd`'s kernel route into
the stand-in's library, so the entry each dtype picks, the float32
dgates the bf16 scans write for the dW reduction, the slab sum and the
output dtypes are those of a launch on the card; each is held to the
plain version on the same inputs. The stand-in does not contract FMAs as
nvcc does and sums in the kernel's order, so a float32 result may differ
in its last bits; where nothing is rounded to bf16 after it (the float32
forward on bf16 params: the f32 entry on the widened w_hh) that stays
within 1e-5. Where h or dgates are rounded for a product, a last bit can
land a value on the other side of a bf16 rounding boundary: the bf16
outputs are held in bf16 ulps of their largest magnitude, as phase 3f
holds the bf16 scans, 2 over the shape; the float32 outputs of the wbf16
backward (dx_proj, dh0, dc0) in float32 terms, their relative L2
difference within WBF16_REL_L2, which the f32 entry on the widened w_hh
(the same scan without the dgates rounding) must exceed. The dW reduction
takes the bf16 scan's float32 dgates (not rounded: most hold more than
bf16's bits) and gives the plain float32 dW of those dgates within 1e-6
of its largest entry.

Then the identity the design keeps: built with the two roundings left
out (h to the I/O type before the recurrent product, dgates to w_hh's
type before the dh product), the bf16-I/O entries on bf16-exact inputs
give the f32 entry's sums bit for bit, their bf16 outputs its outputs
rounded; the wbf16 backward is the f32 entry on the widened w_hh.
"""

import contextlib
import ctypes
import math
import types

import numpy as np
import pytest
import torch

from mobileposer_tpu_torch.ops import lstm_train_cuda as train_cuda
from test_torch_cuda_emulation import _call, _emu_build
from test_torch_train_bf16res_emulation import _bf16_ulps

BF16, F32 = torch.bfloat16, torch.float32
TOL = 1e-5
ULPS = 2
DW_RTOL = 1e-6
# the wbf16 backward's float32 outputs against the plain version: relative
# L2 (7.3e-7 measured); the f32 entry on the widened w_hh, which leaves the
# dgates rounding out, is 1.1e-4 or more away on each of them
WBF16_REL_L2 = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _declare(lib):
    """Every entry's argument types, as `lstm_train_cuda._lib` declares
    them."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for suffix in train_cuda.FWD_ENTRY.values():
        getattr(lib, f"lstm_train_fwd_{suffix}").argtypes = (
            [P] * 11 + [I] * 4 + [P])
    for suffix in train_cuda.SCAN_ENTRY.values():
        n_bwd = 12 if suffix in ("bf16", "bf16_bf16res") else 11
        getattr(lib, f"lstm_train_bwd_{suffix}").argtypes = (
            [P] * n_bwd + [I] * 4 + [P])
    for suffix in train_cuda.RESIDUAL_ENTRY.values():
        getattr(lib, f"lstm_train_dw_{suffix}").argtypes = (
            [P] * 3 + [I] * 4 + [P])
    lib.lstm_train_error_string.argtypes = [I]
    lib.lstm_train_error_string.restype = ctypes.c_char_p
    return lib


@pytest.fixture(scope="module")
def train_lib(tmp_path_factory):
    """lstm_train.cu as it is, built for the stand-in."""
    return _declare(_emu_build(tmp_path_factory, "lstm_train.cu"))


@pytest.fixture(scope="module")
def unrounded_lib(tmp_path_factory):
    """lstm_train.cu built with the rounding of h before the recurrent
    product and of dgates before the dh product left out."""
    return _declare(_emu_build(tmp_path_factory, "lstm_train.cu", edits=(
        ("round_io<IO>(h_keep)", "h_keep"),
        ("round_io<W>(", "("))))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    kernel route."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def on_card(monkeypatch):
    """Route the wrappers' launches into a stand-in library at a given
    rows per cluster; outputs are allocated NaN-filled on the CPU, and the
    launch counters are a fresh copy."""
    empty = torch.empty

    def use(lib, rows):
        monkeypatch.setattr(train_cuda, "_lib", lambda: lib)
        monkeypatch.setattr(train_cuda, "train_geometry",
                            lambda B, H, dev: types.SimpleNamespace(rows=rows))
        monkeypatch.setattr(train_cuda, "launches",
                            dict.fromkeys(train_cuda.launches, 0))
        monkeypatch.setattr(torch.cuda, "device",
                            lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda: types.SimpleNamespace(cuda_stream=None))
        monkeypatch.setattr(torch, "empty", lambda shape, dtype=None,
                            device=None: empty(shape, dtype=dtype).fill_(
                                float("nan")))
    return use


def _card(*ts):
    return [t.as_subclass(_OnCard) for t in ts]


def _inputs(rng, T, B, H, io, bf16_exact=False):
    """x_proj, w_hh (bf16), h0, c0 (nonzero), a ragged mask (row 0 empty,
    row 1 full) and dy, dh_T, dc_T, in the I/O dtype `io`; with
    `bf16_exact` float32 values that bf16 holds exactly."""
    def t(*shape, scale=1.0):
        a = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
        return a.to(BF16).float() if bf16_exact else a

    bound = 1.0 / math.sqrt(H)
    x_proj = t(T, B, 4 * H)
    w_hh = torch.from_numpy(rng.uniform(-bound, bound, (H, 4 * H)).astype(
        np.float32)).to(BF16)
    h0, c0 = t(B, H, scale=0.5), t(B, H, scale=0.5)
    lengths = rng.randint(1, T + 1, size=B)
    lengths[0] = 0
    if B > 1:
        lengths[1] = T
    mask = (torch.arange(T)[:, None] < torch.from_numpy(lengths)[None]
            ).float()
    dy, dh_t, dc_t = t(T, B, H), t(B, H), t(B, H)
    return [a.to(io) if i != 1 else a for i, a in enumerate(
        (x_proj, w_hh, h0, c0, mask, dy, dh_t, dc_t))]


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm())


def _close(got, want, name, rounded: bool):
    """Within TOL, or with `rounded` (a bf16 rounding downstream of the
    float32 sums) a bf16 output within ULPS bf16 ulps of want's largest
    magnitude and a float32 one within WBF16_REL_L2 relative L2."""
    assert got.dtype == want.dtype, name
    if rounded and got.dtype == BF16:
        assert _bf16_ulps(got, want) <= ULPS, name
    elif rounded:
        assert _rel_l2(got, want) <= WBF16_REL_L2, name
    else:
        assert float((got - want).abs().max()) <= TOL, name


@pytest.mark.parametrize("io,rdt", [(BF16, F32), (BF16, BF16), (F32, F32),
                                    (F32, BF16)],
                         ids=["bf16", "bf16_bf16res", "wbf16",
                              "wbf16_bf16res"])
@pytest.mark.parametrize("T,B,H,rows", [(3, 5, 32, 2), (4, 37, 64, 18),
                                        (3, 13, 96, 12)])
def test_wrappers_launch_the_bf16_param_entries(train_lib, on_card, io, rdt,
                                                T, B, H, rows):
    rng = np.random.RandomState(T + B + H + rows)
    x, w, h0, c0, mask, dy, dh_t, dc_t = _inputs(rng, T, B, H, io)
    want = train_cuda.lstm_train_fwd(x, w, h0, c0, mask, rdt)
    _, acts, hseq, cseq, _, _ = want
    h_prev = torch.cat([h0.to(rdt)[None], hseq[:-1]])
    c_prev = torch.cat([c0.to(rdt)[None], cseq[:-1]])
    bargs = (dy, dh_t, dc_t, acts, cseq, h_prev, c_prev, w, mask)
    want_b = train_cuda.lstm_train_bwd(*bargs, residual_dtype=rdt)
    plain_dgates = train_cuda.lstm_train_bwd_plain(
        dy.float(), dh_t.float(), dc_t.float(), acts, cseq, h_prev, c_prev,
        w, mask.float())[0]      # the unrounded dgates (the I/O widened)

    suffix = train_cuda.SCAN_ENTRY[(io, BF16, rdt)]
    on_card(train_lib, rows)
    got = train_cuda.lstm_train_fwd(*_card(x, w, h0, c0, mask), rdt)
    for name, g, v in zip(("ys", "acts", "hseq", "cseq", "h_T", "c_T"), got,
                          want):
        _close(g, v, name, io == BF16 or g.dtype == BF16)
    assert bool((got[0][mask == 0] == 0).all())
    gb = train_cuda.lstm_train_bwd(*_card(*bargs), residual_dtype=rdt)
    for name, g, v in zip(("dx_proj", "dw_hh", "dh0", "dc0"), gb, want_b):
        _close(g, v, name, True)
    assert gb[1].dtype == BF16 and gb[0].dtype == io
    assert train_cuda.launches == {
        **dict.fromkeys(train_cuda.launches, 0),
        f"lstm_train_fwd_{train_cuda.FWD_ENTRY[(io, rdt)]}": 1,
        f"lstm_train_bwd_{suffix}": 1,
        f"lstm_train_dw_{train_cuda.RESIDUAL_ENTRY[rdt]}": 1}
    if io == F32:
        # the same scan without the dgates rounding (the f32 entry on the
        # widened w_hh) fails the float32 outputs' bound
        control = train_cuda.lstm_train_bwd(
            *_card(*bargs[:7], w.float(), mask), residual_dtype=rdt)
        for i in (0, 2, 3):
            assert _rel_l2(control[i], want_b[i]) > WBF16_REL_L2, i

    # the dW reduction on the scan's float32 dgates against the plain
    # float32 dW of the same dgates
    _, _, _, dgates = train_cuda._bwd_scan(*_card(dy, dh_t, dc_t, acts, cseq,
                                                  c_prev, w, mask))
    assert dgates.dtype == F32 and _bf16_ulps(dgates, plain_dgates) <= ULPS
    assert float((dgates != dgates.to(BF16).float()).float().mean()) > 0.5
    n_slabs, per_slab = train_cuda._dw_slabs(T * B, H)
    slabs = torch.full((n_slabs, H, 4 * H), float("nan"))
    _call(getattr(train_lib,
                  f"lstm_train_dw_{train_cuda.RESIDUAL_ENTRY[rdt]}"),
          h_prev, dgates, slabs, T * B, H, n_slabs, per_slab)
    want_dw = train_cuda.lstm_train_dw_plain(h_prev, dgates)
    assert float((slabs.sum(0) - want_dw).abs().max()) <= \
        DW_RTOL * float(want_dw.abs().max())


def _entry(lib, kind, suffix, *args):
    """One launch of entry lstm_train_<kind>_<suffix>: its outputs,
    NaN-filled before (shapes and dtypes as the wrappers allocate)."""
    out = []
    if kind == "fwd":
        x, w, h0, c0, mask, rdt = args
        T, B, H4 = x.shape
        H, io = H4 // 4, x.dtype
        out = [torch.full((T, B, H), float("nan")).to(io)]
        out += [torch.full((T, B, n), float("nan")).to(rdt)
                for n in (H4, H, H)]
        out += [torch.full((B, H), float("nan")).to(io) for _ in range(2)]
        _call(getattr(lib, f"lstm_train_fwd_{suffix}"), x, w, h0, c0, mask,
              *out, T, B, H, 4)
    else:
        dy, dh_t, dc_t, acts, cseq, c_prev, w, mask = args
        T, B, H = dy.shape
        io = dy.dtype
        out = [torch.full((T, B, 4 * H), float("nan")).to(io)]
        if suffix in ("bf16", "bf16_bf16res"):
            out.append(torch.full((T, B, 4 * H), float("nan")))
        out += [torch.full((B, H), float("nan")).to(io) for _ in range(2)]
        _call(getattr(lib, f"lstm_train_bwd_{suffix}"), dy, dh_t, dc_t, acts,
              cseq, c_prev, w, mask, *out, T, B, H, 4)
    return out


@pytest.mark.parametrize("rdt", [F32, BF16], ids=["f32res", "bf16res"])
def test_entries_without_their_roundings_are_the_f32_entry(
        train_lib, unrounded_lib, rdt):
    """bf16-exact inputs at T = 5, B = 9, H = 64 (a partial tile at four
    rows a cluster): built without the two roundings, a bf16-I/O entry's
    residuals and float32 dgates equal the f32 entry's bits (on the same
    inputs widened), and its bf16 outputs those rounded; the wbf16
    backward without the dgates rounding equals the f32 entry on the
    widened w_hh."""
    rng = np.random.RandomState(11)
    T, B, H = 5, 9, 64
    x, w, h0, c0, mask, dy, dh_t, dc_t = _inputs(rng, T, B, H, F32,
                                                 bf16_exact=True)
    w32 = w.float()
    ref = _entry(unrounded_lib, "fwd", train_cuda.RESIDUAL_ENTRY[rdt], x, w32,
                 h0, c0, mask, rdt)
    b16 = _entry(unrounded_lib, "fwd", train_cuda.SCAN_ENTRY[(BF16, BF16,
                                                              rdt)],
                 *(a.to(BF16) for a in (x, w, h0, c0, mask)), rdt)
    for i, name in enumerate(("ys", "acts", "hseq", "cseq", "h_T", "c_T")):
        want = ref[i] if i in (1, 2, 3) else ref[i].to(BF16)
        assert torch.equal(b16[i], want), name

    _, acts, hseq, cseq, _, _ = ref
    c_prev = torch.cat([c0.to(rdt)[None], cseq[:-1]])
    rb = _entry(unrounded_lib, "bwd", train_cuda.RESIDUAL_ENTRY[rdt], dy,
                dh_t, dc_t, acts, cseq, c_prev, w32, mask)
    bb = _entry(unrounded_lib, "bwd", train_cuda.SCAN_ENTRY[(BF16, BF16,
                                                             rdt)],
                *(a.to(BF16) for a in (dy, dh_t, dc_t)), acts, cseq, c_prev,
                w, mask.to(BF16))
    dx, dgates, dh0, dc0 = bb
    assert torch.equal(dgates, rb[0])
    for g, want, name in ((dx, rb[0], "dx_proj"), (dh0, rb[1], "dh0"),
                          (dc0, rb[2], "dc0")):
        assert torch.equal(g, want.to(BF16)), name
    wbb = _entry(unrounded_lib, "bwd", train_cuda.SCAN_ENTRY[(F32, BF16,
                                                              rdt)],
                 dy, dh_t, dc_t, acts, cseq, c_prev, w, mask)
    for a, b in zip(wbb, rb):
        assert torch.equal(a, b)


def test_wrappers_check_the_bf16_param_dtypes():
    """bf16 I/O takes bf16 w_hh; the state and the mask come in the I/O
    dtype (x_proj's forward, dy's backward); float16 is refused."""
    rng = np.random.RandomState(2)
    x, w, h0, c0, mask, dy, dh_t, dc_t = _inputs(rng, 2, 3, 32, BF16)
    with pytest.raises(ValueError, match="w_hh"):
        train_cuda.lstm_train_fwd(x, w.float(), h0, c0, mask)
    with pytest.raises(ValueError, match="h0 must be torch.bfloat16 as "
                                         "x_proj is"):
        train_cuda.lstm_train_fwd(x, w, h0.float(), c0, mask)
    with pytest.raises(ValueError, match="mask"):
        train_cuda.lstm_train_fwd(x, w, h0, c0, mask.float())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        train_cuda.lstm_train_fwd(x.half(), w, h0, c0, mask)
    _, acts, hseq, cseq, _, _ = train_cuda.lstm_train_fwd(x, w, h0, c0, mask)
    args = [dy, dh_t, dc_t, acts, cseq, hseq, cseq, w, mask]
    with pytest.raises(ValueError, match="dh_T must be torch.bfloat16 as dy"):
        train_cuda.lstm_train_bwd(*[a.float() if i == 1 else a
                                    for i, a in enumerate(args)])
    with pytest.raises(ValueError, match="w_hh"):
        train_cuda.lstm_train_bwd(*[a.float() if i == 7 else a
                                    for i, a in enumerate(args)])
    assert set(train_cuda.launches.values()) == {0}
