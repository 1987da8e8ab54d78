"""The fold entries of the full-length float scans (`ops/csrc/lstm_scan.cu`
`lstm_scan_fold_*` and `bilstm_scan_fold_*`, kernels #2 and #1 on the
route `lstm_forward_cuda` takes without lengths), built with g++ against
the CPU stand-in of the CUDA runtime (`tests/cuda_emu/`), as
`tests/test_torch_cuda_emulation.py` builds the other entries.

A fold entry takes x @ w_ih without the bias and the bias b_ih + b_hh
apart, adds the bias in the scan, reads and writes the backward direction
in time order and may write both directions into the halves of one
[T, B, 2H] buffer. Held here, in float32 and bf16 I/O, at H = 64 and 256
with odd T and B:

  * bit for bit, the entries the parent route used, fed the old way: the
    bias added on the host, the backward input flipped in time, its
    outputs flipped back, the two directions concatenated. Both run the
    one body in one summation order, and the scan's bias add rounds as the
    host's add rounds, so nothing may differ;
  * the plain versions fed the old way, within a tolerance: the stand-in
    does not contract a*b + c into FMAs as nvcc does and the plain version
    multiplies with torch.matmul, so float32 values differ by rounding
    over a few steps (1e-5, the emulation tests' TOL); in bf16 the float32
    sums differ in order and an output on the other side of a rounding
    boundary moves by one ulp (2 ulps, the bf16 emulation tests' bound);
  * the wrappers' CUDA route into the stand-in (the argument order, the
    out buffer's halves, the launch counts) and `lstm_forward_cuda`
    through it against its CPU route (the same tolerances), and
    `lstm_forward_cuda` with and without lengths against the JAX
    package's `lstm_forward`.
"""

import contextlib
import ctypes
import math
import types

import numpy as np
import pytest
import torch

from mobileposer_tpu_torch.ops import lstm_cuda
from test_torch_cuda_emulation import _call, _emu_build

BF16 = torch.bfloat16
TOL = 1e-5
SCAN_ULPS = 2
SUFFIX = {torch.float32: "f32", BF16: "bf16"}

# odd T and B at H = 64 and 256; rows per cluster from one (one column a
# lane) through every rows-per-lane template class the streaming shapes
# use, to 35 (from 33 on the bf16 body's own product addressing); the
# bidirectional cases writing one [T, B, 2H] buffer or two [T, B, H] ones
CASES = [
    (1, 5, 7, 64, 3, False), (2, 5, 7, 64, 3, True), (2, 3, 9, 64, 9, False),
    (1, 3, 13, 256, 5, False), (2, 3, 13, 256, 13, True),
    (2, 3, 5, 256, 1, True), (2, 3, 35, 64, 35, True)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scan_lib(tmp_path_factory):
    """lstm_scan.cu built for the CPU stand-in, every entry declared as the
    wrappers declare it."""
    lib = _emu_build(tmp_path_factory, "lstm_scan.cu")
    for name, args in lstm_cuda._ENTRIES["lstm_scan.cu"].items():
        getattr(lib, name).argtypes = lstm_cuda.entry_argtypes(*args)
    return lib


def _dirs(rng, T, B, H, n_dir, io):
    """Per direction (x @ w_ih [T, B, 4H], w_hh [H, 4H], b_ih + b_hh [4H],
    h0, c0 [B, H]) in the I/O dtype `io`; w_hh drawn as torch.nn.LSTM
    draws it."""
    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(io)

    bound = 1.0 / math.sqrt(H)
    return [(t(T, B, 4 * H),
             torch.from_numpy(rng.uniform(-bound, bound, (H, 4 * H)).astype(
                 np.float32)).to(io),
             t(4 * H, scale=0.5), t(B, H, scale=0.5), t(B, H, scale=0.5))
            for _ in range(n_dir)]


def _nan(*shape, io):
    return torch.full(shape, float("nan"), dtype=io)


def _old_way(lib, dirs, rows):
    """The parent route on the stand-in: the bias added on the host, the
    backward input flipped, the old entry, its ys flipped back, the two
    directions concatenated. Returns (ys [T, B, n_dir H], [h_T, c_T per
    direction])."""
    T, B, H4 = dirs[0][0].shape
    H, io = H4 // 4, dirs[0][0].dtype
    xs = [x + b for x, _, b, _, _ in dirs]
    if len(dirs) == 2:
        xs[1] = torch.flip(xs[1], (0,))
    ys = [_nan(T, B, H, io=io) for _ in dirs]
    hc = [_nan(B, H, io=io) for _ in range(2 * len(dirs))]
    kind = f"{'bi' * (len(dirs) == 2)}lstm_scan_{SUFFIX[io]}"
    ws = [d[1] for d in dirs]
    states = [s for d in dirs for s in d[3:]]
    _call(getattr(lib, kind), *xs, *ws, *states, *ys, *hc, T, B, H, rows)
    if len(dirs) == 2:
        ys[1] = torch.flip(ys[1], (0,))
    return torch.cat(ys, dim=-1), hc


def _fold(lib, dirs, rows, joined):
    """The fold entry on the stand-in: x @ w_ih and the bias apart, the
    backward direction in time order; `joined`, both directions' ys in
    one [T, B, 2H] buffer. Returns what `_old_way` returns."""
    T, B, H4 = dirs[0][0].shape
    H, io = H4 // 4, dirs[0][0].dtype
    hc = [_nan(B, H, io=io) for _ in range(2 * len(dirs))]
    if len(dirs) == 1:
        (x, w, b, h0, c0), = dirs
        ys = _nan(T, B, H, io=io)
        _call(getattr(lib, f"lstm_scan_fold_{SUFFIX[io]}"), x, w, b, h0, c0,
              ys, *hc, T, B, H, rows)
        return ys, hc
    (xf, wf, bf, h0f, c0f), (xb, wb, bb, h0b, c0b) = dirs
    if joined:
        out = _nan(T, B, 2 * H, io=io)
        ptrs = (out.data_ptr(), out[..., H:].data_ptr())
    else:
        apart = [_nan(T, B, H, io=io) for _ in range(2)]
        ptrs = tuple(a.data_ptr() for a in apart)
    _call(getattr(lib, f"bilstm_scan_fold_{SUFFIX[io]}"), xf, xb, wf, wb,
          bf, bb, h0f, c0f, h0b, c0b, *ptrs, *hc, T, B, H, rows,
          2 * H if joined else H)
    return (out if joined else torch.cat(apart, dim=-1)), hc


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the largest magnitude of x."""
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


def _assert_close(got, want, what):
    """float32 within TOL, bf16 within SCAN_ULPS ulps (see the note)."""
    assert got.dtype == want.dtype, what
    if got.dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                   err_msg=what)
    else:
        err = float((got.float() - want.float()).abs().max())
        assert err <= SCAN_ULPS * _ulp(want), f"{what}: {err}"


@pytest.mark.parametrize("io", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_dir,T,B,H,rows,joined", CASES)
def test_fold_entries_equal_the_old_way_bit_for_bit(scan_lib, io, n_dir, T,
                                                    B, H, rows, joined):
    """Bit for bit (every output's bits, signed zeros included): the fold
    entry against the entry of the parent route fed the old way."""
    dirs = _dirs(np.random.RandomState(n_dir + T + B + H + rows), T, B, H,
                 n_dir, io)
    got_ys, got_hc = _fold(scan_lib, dirs, rows, joined)
    want_ys, want_hc = _old_way(scan_lib, dirs, rows)
    assert torch.equal(_bits(got_ys), _bits(want_ys)), "ys"
    for i, (g, w) in enumerate(zip(got_hc, want_hc)):
        assert torch.equal(_bits(g), _bits(w)), ("h_T", "c_T")[i % 2]


@pytest.mark.parametrize("io", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_dir,T,B,H,rows,joined", CASES[:5])
def test_fold_entries_match_plain_versions(scan_lib, io, n_dir, T, B, H,
                                           rows, joined):
    """Within the tolerances of the note: the fold entry against
    `lstm_layer_plain` / `bilstm_layer_plain` fed the old way (the bias
    added on the host, the backward input flipped, its ys flipped back,
    the directions concatenated)."""
    dirs = _dirs(np.random.RandomState(50 + n_dir + T + B + H), T, B, H,
                 n_dir, io)
    got_ys, got_hc = _fold(scan_lib, dirs, rows, joined)
    if n_dir == 1:
        (x, w, b, h0, c0), = dirs
        ys, hc = lstm_cuda.lstm_layer_plain(x + b, w, h0, c0)
        want_hc = list(hc)
    else:
        (xf, wf, bf, h0f, c0f), (xb, wb, bb, h0b, c0b) = dirs
        ys_f, ys_b, hc_f, hc_b = lstm_cuda.bilstm_layer_plain(
            xf + bf, torch.flip(xb + bb, (0,)), wf, wb, h0f, c0f, h0b, c0b)
        ys = torch.cat([ys_f, torch.flip(ys_b, (0,))], dim=-1)
        want_hc = [*hc_f, *hc_b]
    _assert_close(got_ys, ys, "ys")
    for i, (g, w) in enumerate(zip(got_hc, want_hc)):
        _assert_close(g, w, ("h_T", "c_T")[i % 2])


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    kernel route."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def on_card(monkeypatch, scan_lib):
    """Route the wrappers' launches into the stand-in library at a given
    rows per cluster; outputs are allocated NaN-filled on the CPU, and the
    launch counters are a fresh copy. Returns the counters."""
    empty = torch.empty
    counts = dict.fromkeys(lstm_cuda.launches, 0)

    def use(rows):
        monkeypatch.setattr(lstm_cuda, "_lib", lambda source: scan_lib)
        monkeypatch.setattr(lstm_cuda, "scan_geometry",
                            lambda n_dir, B, H, dev, masked=False,
                            int8=False: types.SimpleNamespace(rows=rows))
        monkeypatch.setattr(lstm_cuda, "launches", counts)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda: types.SimpleNamespace(cuda_stream=None))
        monkeypatch.setattr(torch, "empty", lambda shape, dtype=None,
                            device=None: empty(shape, dtype=dtype).fill_(
                                float("nan")))
        return counts
    return use


def _card(*ts):
    return [t.as_subclass(_OnCard) for t in ts]


@pytest.mark.parametrize("io", [torch.float32, BF16], ids=["f32", "bf16"])
def test_wrappers_launch_the_fold_entries(on_card, io):
    """Given the biases, `lstm_layer` and `bilstm_layer` launch the fold
    entries of their I/O dtype (counted under the fold entries' own names;
    without the biases, the old entry under its own), with `out` write its
    halves and return them as views, and equal their CPU route (the plain
    versions) within the note's tolerances."""
    T, B, H = 5, 7, 64
    counts = on_card(3)
    rng = np.random.RandomState(7)
    (xf, wf, bf, h0f, c0f), (xb, wb, bb, h0b, c0b) = _dirs(rng, T, B, H, 2,
                                                           io)
    args = (xf, xb, wf, wb, h0f, c0f, h0b, c0b, bf, bb)
    cpu_f, cpu_b, cpu_hf, cpu_hb = lstm_cuda.bilstm_layer(*args)
    out = torch.full((T, B, 2 * H), float("nan"), dtype=io).as_subclass(
        _OnCard)
    ys_f, ys_b, hc_f, hc_b = lstm_cuda.bilstm_layer(*_card(*args), out=out)
    assert ys_f.data_ptr() == out.data_ptr()
    assert ys_b.data_ptr() == out[..., H:].data_ptr()
    for name, g, w in zip(("ys_f", "ys_b", "h_f", "c_f", "h_b", "c_b"),
                          (ys_f, ys_b, *hc_f, *hc_b),
                          (cpu_f, cpu_b, *cpu_hf, *cpu_hb)):
        _assert_close(torch.Tensor(g).contiguous(), w, name)
    apart = lstm_cuda.bilstm_layer(*_card(*args))
    assert torch.equal(torch.Tensor(apart[0]), torch.Tensor(ys_f))
    assert torch.equal(torch.Tensor(apart[1]), torch.Tensor(ys_b))
    ys, (h_t, c_t) = lstm_cuda.lstm_layer(*_card(xf, wf, h0f, c0f, bf))
    cpu = lstm_cuda.lstm_layer(xf, wf, h0f, c0f, bf)
    for name, g, w in zip(("ys", "h_T", "c_T"), (ys, h_t, c_t),
                          (cpu[0], *cpu[1])):
        _assert_close(torch.Tensor(g), w, name)
    lstm_cuda.bilstm_layer(*_card(*args[:8]))
    s = SUFFIX[io]
    assert {k: v for k, v in counts.items() if v} == {
        f"bilstm_scan_fold_{s}": 2, f"lstm_scan_fold_{s}": 1,
        f"bilstm_scan_{s}": 1}


def _layers(rng, n_layers, D, H, n_dir, io, card):
    """A layer stack of random float directions (w_ih, w_hh, b_ih, b_hh)
    in `io`, as SimpleNamespaces; on the card's stand-in with `card`."""
    layers = []
    for li in range(n_layers):
        d_in = D if li == 0 else n_dir * H
        layer = {}
        for name in ("fwd", "bwd")[:n_dir]:
            ts = [torch.from_numpy((rng.randn(*shape) * scale).astype(
                np.float32)).to(io) for shape, scale in (
                    ((d_in, 4 * H), 1 / math.sqrt(d_in)),
                    ((H, 4 * H), 1 / math.sqrt(H)), ((4 * H,), 0.3),
                    ((4 * H,), 0.3))]
            if card:
                ts = _card(*ts)
            layer[name] = types.SimpleNamespace(w_ih=ts[0], w_hh=ts[1],
                                                b_ih=ts[2], b_hh=ts[3])
        layers.append(layer)
    return layers


@pytest.mark.parametrize("io", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bidirectional,H", [(True, 64), (False, 64),
                                             (True, 256)])
def test_lstm_forward_through_the_fold_entries(on_card, io, bidirectional,
                                               H):
    """`lstm_forward_cuda` on the stand-in: one scan launch a layer (the
    fold entry; no other kernel of this module), its output the last
    layer's [T, B, 2H] buffer as it is, and the CPU route's values within
    the note's tolerances, on nonzero initial states."""
    T, B, D, L = 3, 5, 24, 2
    n_dir = 2 if bidirectional else 1
    counts = on_card(3)
    rng = np.random.RandomState(H + n_dir)
    x = torch.from_numpy(rng.randn(B, T, D).astype(np.float32)).to(io)
    hc = [torch.from_numpy((rng.randn(L * n_dir, B, H) * 0.5).astype(
        np.float32)).to(io) for _ in range(2)]
    want = lstm_cuda.lstm_forward_cuda(
        _layers(np.random.RandomState(1), L, D, H, n_dir, io, False), x, hc,
        bidirectional=bidirectional)
    got = lstm_cuda.lstm_forward_cuda(
        _layers(np.random.RandomState(1), L, D, H, n_dir, io, True),
        *_card(x), _card(*hc), bidirectional=bidirectional)
    name = f"{'bi' * bidirectional}lstm_scan_fold_{SUFFIX[io]}"
    assert {k: v for k, v in counts.items() if v} == {name: L}
    y = torch.Tensor(got[0])
    if bidirectional:   # [B, T, 2H]: the buffer the last scan wrote
        assert y.transpose(0, 1).is_contiguous()
    _assert_close(y.contiguous(), want[0], "y")
    for name, g, w in zip(("h_T", "c_T"), got[1], want[1]):
        _assert_close(torch.Tensor(g), w, name)


@pytest.mark.parametrize("io", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bi", [True, False], ids=["bi", "uni"])
def test_ops_with_the_biases(io, bi):
    """`torch.library.opcheck` (schema, fake implementation, autograd
    registration, AOT dispatch) on `bilstm_layer` / `lstm_layer` given the
    fold entries' biases; their outputs equal the wrappers' at 0.0."""
    T, B, H = 3, 2, 8
    dirs = _dirs(np.random.RandomState(4), T, B, H, 2 if bi else 1, io)
    if bi:
        (xf, wf, bf, h0f, c0f), (xb, wb, bb, h0b, c0b) = dirs
        args = [xf, xb, wf, wb, h0f, c0f, h0b, c0b, bf, bb]
        op = lstm_cuda.bilstm_layer_op
        ys_f, ys_b, hc_f, hc_b = lstm_cuda.bilstm_layer(*args)
        want = (ys_f, ys_b, *hc_f, *hc_b)
    else:
        (x, w, b, h0, c0), = dirs
        args = [x, w, h0, c0, b]
        op = lstm_cuda.lstm_layer_op
        ys, hc = lstm_cuda.lstm_layer(*args)
        want = (ys, *hc)
    torch.library.opcheck(op, args)
    got = op(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == io and torch.equal(g, w)


def test_wrappers_refuse_bad_fold_arguments():
    """One direction's bias without the other's, a bias of another dtype
    or length, and `out` without the biases or of another shape raise."""
    rng = np.random.RandomState(3)
    (xf, wf, bf, h0f, c0f), (xb, wb, bb, h0b, c0b) = _dirs(
        rng, 3, 2, 32, 2, torch.float32)
    args = (xf, xb, wf, wb, h0f, c0f, h0b, c0b)
    with pytest.raises(ValueError, match="both directions"):
        lstm_cuda.bilstm_layer(*args, bf, None)
    with pytest.raises(ValueError, match="bias must be float32"):
        lstm_cuda.bilstm_layer(*args, bf, bb.to(BF16))
    with pytest.raises(ValueError, match="bias must be"):
        lstm_cuda.lstm_layer(xf, wf, h0f, c0f, bf[:-4])
    with pytest.raises(ValueError, match="out takes the fold"):
        lstm_cuda.bilstm_layer(*args, out=torch.zeros(3, 2, 64))
    with pytest.raises(ValueError, match="out must be"):
        lstm_cuda.bilstm_layer(*args, bf, bb, torch.zeros(3, 2, 32))


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("ragged", [False, True])
def test_lstm_forward_agrees_with_the_jax_reference(bidirectional, ragged):
    """`lstm_forward_cuda` on the CPU, without lengths (the fold route) and
    with them (the masked route), against the JAX package's `lstm_forward`
    on the same weights (1e-5), outputs and final states."""
    import jax.numpy as jnp
    from mobileposer_tpu.nn import lstm_forward as jax_lstm_forward

    T, B, D, H, L = 7, 3, 12, 16, 2
    n_dir = 2 if bidirectional else 1
    layers = _layers(np.random.RandomState(11), L, D, H, n_dir,
                     torch.float32, False)
    rng = np.random.RandomState(12)
    x = rng.randn(B, T, D).astype(np.float32)
    h0, c0 = ((rng.randn(L * n_dir, B, H) * 0.5).astype(np.float32)
              for _ in range(2))
    lengths = np.array([7, 4, 1]) if ragged else None
    got = lstm_cuda.lstm_forward_cuda(
        layers, torch.from_numpy(x), (torch.from_numpy(h0),
                                      torch.from_numpy(c0)),
        bidirectional=bidirectional,
        lengths=None if lengths is None else torch.from_numpy(lengths))
    jax_layers = [{k: {f: jnp.asarray(getattr(p, f).numpy())
                       for f in ("w_ih", "w_hh", "b_ih", "b_hh")}
                   for k, p in layer.items()} for layer in layers]
    want = jax_lstm_forward(
        jax_layers, jnp.asarray(x),
        None if lengths is None else jnp.asarray(lengths),
        (jnp.asarray(h0), jnp.asarray(c0)), bidirectional=bidirectional)
    y, (h, c) = got
    wy, (wh, wc) = want
    if ragged:   # outputs past a row's length are the kernels' zeros there
        valid = (np.arange(T)[None, :] < lengths[:, None])[..., None]
        np.testing.assert_allclose(y.numpy() * valid, np.asarray(wy) * valid,
                                   atol=TOL)
    else:
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(wc), atol=TOL)
