"""The port's AOT serving bundles (`mobileposer_tpu_torch/serving.py`)
against the JAX package's live steps, on the CPU.

Weights are the JAX package's random `init_all_modules(PRNGKey(0))`,
carried over with `params_from_jax`; frames come from a seeded numpy
generator and go to both packages. Tolerances: 2e-5 against the JAX
package (the streaming pins of tests/test_torch_net.py), 1e-6 against the
port's own eager step (the program runs the same ops), 0.05 on joints in
bf16 (tests/test_torch_bf16.py) and 2e-3 on int8 params, on the trained
fixture as in tests/test_torch_quant.py.

Also here: the eight layer wrappers as `torch.library` custom ops
(`opcheck`, the op route of `lstm_forward_cuda` against the eager one),
the graph's nodes, the refusals and `cli.export_serving`.
"""

import json
import logging
import os
import shutil
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jax
import jax.numpy as jnp

import mobileposer_tpu.serving as jax_serving
from mobileposer_tpu.evaluation.pose_eval import \
    forward_offline_batched as jax_forward_offline_batched
from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.models import MobilePoserNet as JaxNet
from mobileposer_tpu.models import init_all_modules as jax_init_all_modules
from mobileposer_tpu.nn import cast_params as jax_cast_params
from mobileposer_tpu.nn import load_from_npz
from mobileposer_tpu.ops import quant as jq
from mobileposer_tpu_torch import serving
from mobileposer_tpu_torch.cli import export_serving as export_cli
from mobileposer_tpu_torch.evaluation.pose_eval import forward_offline_batched
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.nn.convert import cast_params, params_from_jax
from mobileposer_tpu_torch.ops import lstm_cuda

BF16 = torch.bfloat16
ATOL_JAX, ATOL_EAGER, BF16_TOL, INT8_TOL = 2e-5, 1e-6, 0.05, 2e-3
OP = "mobileposer_tpu_torch."
_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def nets():
    return (JaxNet(JaxBody.synthetic(num_vertices=240)),
            MobilePoserNet(ParametricModel.synthetic(num_vertices=240),
                           device="cpu"))


@pytest.fixture(scope="module")
def weights():
    """(the JAX params as numpy, the port's modules)."""
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_all_modules(jax.random.PRNGKey(0)))
    return tree, params_from_jax(tree, device="cpu")


@pytest.fixture(scope="module")
def jax_steps(nets):
    jnet = nets[0]
    return {"carry": jax.jit(jnet.forward_carry_batched),
            "exact": jax.jit(jnet.forward_online_batched)}


def _frames(seed, S, dtype=np.float32):
    return (np.random.RandomState(seed).randn(S, 60) * 0.1).astype(dtype)


def _jax_state(jnet, mode, S, dtype=jnp.float32):
    return (jnet.init_carry_state_batched(S, dtype=dtype) if mode == "carry"
            else jnet.init_online_state_batched(S, dtype=dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_trees_close(got, want, atol, what):
    g, w = pytree.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=atol,
                                   err_msg=f"{what}: leaf {i}")


def _targets(graph) -> Counter:
    return Counter(str(n.target) for n in graph.nodes
                   if n.op == "call_function")


# ---------------------------------------------------------------------------
# Streaming programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["carry", "exact"])
def test_exported_step_matches_jax_and_eager(nets, weights, jax_steps, mode):
    jnet, net = nets
    tree, params = weights
    S = 3
    exported = serving.export_streaming_step(net, params, S, mode=mode)
    program = exported.module()
    jst = _jax_state(jnet, mode, S)
    st = st_eager = serving._fresh_state(net, S, mode, torch.float32)
    for seed in (1, 2):
        frames = _frames(seed, S)
        want, jst = jax_steps[mode](tree, jst, frames)
        got, st = program(serving._weights(params), st,
                          torch.from_numpy(frames))
        eager = (net.forward_carry_batched if mode == "carry"
                 else net.forward_online_batched)(params, st_eager,
                                                  torch.from_numpy(frames))
        st_eager = eager[1]
        _assert_trees_close(got, want, ATOL_JAX, f"{mode} outputs vs JAX")
        _assert_trees_close(st, jst, ATOL_JAX, f"{mode} state vs JAX")
        for a, b in zip(pytree.tree_leaves((got, st)),
                        pytree.tree_leaves(eager)):
            np.testing.assert_allclose(_f32(a), _f32(b), atol=ATOL_EAGER)


def test_carry_bundle_round_trip(nets, weights, jax_steps, tmp_path):
    """Disk round trip, S = 2 streams over N = 5 frames with the state
    threaded, against the JAX live step and the port's eager step."""
    jnet, net = nets
    tree, params = weights
    S, N = 2, 5
    serving.save_bundle(tmp_path / "b", net, params, n_streams=S,
                        mode="carry")
    step, p, st, meta = serving.load_bundle(tmp_path / "b")
    assert meta["mode"] == "carry" and meta["n_streams"] == S
    assert meta["device"] == "cpu" and meta["dtype"] == "float32"
    jst = _jax_state(jnet, "carry", S)
    st_eager = net.init_carry_state_batched(S)
    for seed in range(N):
        frames = _frames(10 + seed, S)
        got, st = step(p, st, torch.from_numpy(frames))
        want, jst = jax_steps["carry"](tree, jst, frames)
        eager, st_eager = net.forward_carry_batched(
            params, st_eager, torch.from_numpy(frames))
        _assert_trees_close(got, want, ATOL_JAX, f"frame {seed}")
        _assert_trees_close(st, jst, ATOL_JAX, f"frame {seed} state")
        for a, b in zip(got, eager):
            np.testing.assert_allclose(_f32(a), _f32(b), atol=ATOL_EAGER)


@pytest.mark.parametrize("mode", ["carry", "exact"])
def test_bf16_bundle_round_trip(nets, weights, tmp_path, mode):
    """bf16 bundles keep their dtypes through the archives (bf16 leaves
    as bits), the fusion accumulators stay float32, the reloaded weights
    equal the cast ones bit for bit, and the joints stay within 0.05 of
    the JAX package's bf16 live step."""
    jnet, net = nets
    tree, params = weights
    S = 2
    p16 = jax_cast_params(tree, jnp.bfloat16)
    params16 = params_from_jax(jax.tree_util.tree_map(np.asarray, p16),
                               device="cpu", dtype=BF16)
    serving.save_bundle(tmp_path / "b16", net, params16, n_streams=S,
                        mode=mode, dtype=BF16)
    step, p, st, meta = serving.load_bundle(tmp_path / "b16")
    assert meta["dtype"] == "bfloat16"
    assert p["joints"].linear1.weight.dtype == BF16
    window = st.imu_ring if mode == "carry" else st.imu
    assert window.dtype == BF16 and st.vel_h.dtype == BF16
    assert st.last_root_pos.dtype == torch.float32   # accumulators
    assert st.current_root_y.dtype == torch.float32
    for a, b in zip(serving._weights(p).values(),
                    serving._weights(params16).values()):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    jst = _jax_state(jnet, mode, S, jnp.bfloat16)
    run = jax.jit(jnet.forward_carry_batched if mode == "carry"
                  else jnet.forward_online_batched)
    for seed in (3, 4):
        frames = _frames(seed, S) * 3
        (pose, joints, root, _), st = step(
            p, st, torch.from_numpy(frames).to(BF16))
        (_, jjoints, _, _), jst = run(p16, jst,
                                      jnp.asarray(frames, jnp.bfloat16))
        assert pose.dtype == joints.dtype == BF16
        assert root.dtype == torch.float32
        assert np.abs(_f32(joints).reshape(S, -1)
                      - _f32(jjoints).reshape(S, -1)).max() < BF16_TOL


def test_int8_on_bf16_bundle_keeps_every_dtype(nets, weights, tmp_path):
    """quantize='int8' on bf16 params (cast, then quantized, as
    `export_serving --bf16 --int8` does): the reloaded modules hold every
    tensor in its own dtype (int8 weights, float32 scales and `b`, bf16
    linears) bit for bit, and the loaded step equals the eager one."""
    from mobileposer_tpu_torch.ops.quant import quantize_params_int8
    _, net = nets
    _, params = weights
    S = 2
    params16 = cast_params(params, BF16)
    serving.save_bundle(tmp_path / "b", net, params16, n_streams=S,
                        mode="exact", dtype=BF16, quantize="int8")
    step, p, st, _ = serving.load_bundle(tmp_path / "b")
    want = serving._weights(quantize_params_int8(params16))
    got = serving._weights(p)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    d = p["poser"].lstm[1]["bwd"]
    assert (d.w_hh.dtype, d.w_hh_scale.dtype, d.b.dtype) == (
        torch.int8, torch.float32, torch.float32)
    frames = torch.from_numpy(_frames(6, S)).to(BF16)
    got_out = step(p, st, frames)
    eager = net.forward_online_batched(p, st, frames)
    for a, b in zip(pytree.tree_leaves(got_out), pytree.tree_leaves(eager)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(_f32(a), _f32(b), atol=ATOL_EAGER)


def test_int8_exact_bundle_matches_jax(nets, weights, tmp_path):
    """quantize='int8': the reloaded exact step against the JAX package's
    quantized live step on the trained fixture (where the port's int8
    bound of tests/test_torch_quant.py holds; on the random weights a
    one-level flip of an int8 value moves the pose by up to 5.1e-3 through
    the r6d normalization, eager and bundle alike) and against the port's
    eager quantized step at 1e-6, state threaded; the int8 archive under
    0.45x the float32 one, as the JAX test demands."""
    from mobileposer_tpu_torch.ops.quant import quantize_params_int8
    jnet, net = nets
    trained = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                     load_from_npz(_FIXTURE))
    params = params_from_jax(trained, device="cpu")
    S, N = 2, 3
    serving.save_bundle(tmp_path / "b8", net, params, n_streams=S,
                        mode="exact", quantize="int8")
    step, p, st, meta = serving.load_bundle(tmp_path / "b8")
    assert meta["quantize"] == "int8"
    d = p["joints"].lstm[0]["fwd"]
    assert d.w_ih.dtype == torch.int8 and d.w_ih_scale.dtype == torch.float32
    qtree = jax.tree_util.tree_map(np.asarray,
                                   jq.quantize_params_int8(trained))
    qparams = quantize_params_int8(params)
    run = jax.jit(jnet.forward_online_batched)
    jst = jnet.init_online_state_batched(S)
    st_eager = net.init_online_state_batched(S)
    for seed in range(N):
        frames = _frames(20 + seed, S)
        got, st = step(p, st, torch.from_numpy(frames))
        want, jst = run(qtree, jst, frames)
        eager, st_eager = net.forward_online_batched(
            qparams, st_eager, torch.from_numpy(frames))
        _assert_trees_close(got, want, INT8_TOL, f"frame {seed}")
        for a, b in zip(pytree.tree_leaves((got, st)),
                        pytree.tree_leaves((eager, st_eager))):
            np.testing.assert_allclose(_f32(a), _f32(b), atol=ATOL_EAGER)
    serving.save_bundle(tmp_path / "bf", net, params, n_streams=S,
                        mode="carry")
    q_size = os.path.getsize(tmp_path / "b8" / serving._WEIGHTS_FILE)
    f_size = os.path.getsize(tmp_path / "bf" / serving._WEIGHTS_FILE)
    assert q_size < 0.45 * f_size, (q_size, f_size)


def test_offline_bundle_matches_jax(nets, weights, tmp_path):
    """The stateless offline program, B = 2 sequences padded to T = 64
    with lengths [64, 32], against the JAX package's
    `forward_offline_batched`; its step refuses lengths past T."""
    jnet, net = nets
    tree, params = weights
    B, T = 2, 64
    serving.save_bundle(tmp_path / "off", net, params, n_streams=B,
                        mode="offline", seq_len=T)
    step, p, st, meta = serving.load_bundle(tmp_path / "off")
    assert st is None and meta["seq_len"] == T
    imu = (np.random.RandomState(5).randn(B, T, 60) * 0.1).astype(np.float32)
    lengths = np.array([64, 32], np.int32)
    got = step(p, torch.from_numpy(imu), lengths)
    want = jax_forward_offline_batched(jnet, tree, jnp.asarray(imu),
                                       jnp.asarray(lengths))
    eager = forward_offline_batched(net, params, torch.from_numpy(imu),
                                    torch.from_numpy(lengths))
    for name, g, w, e in zip(("pose", "joints", "tran", "contact"), got,
                             want, eager):
        assert tuple(g.shape) == np.shape(w), name
        for b, n in enumerate(lengths):
            np.testing.assert_allclose(_f32(g)[b, :n], _f32(w)[b, :n],
                                       atol=ATOL_JAX, err_msg=name)
        np.testing.assert_allclose(_f32(g), _f32(e), atol=ATOL_EAGER)
    with pytest.raises(ValueError, match="lengths must lie in"):
        step(p, torch.from_numpy(imu), [65, 3])


# ---------------------------------------------------------------------------
# The archives, shared with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["carry", "exact"])
def test_archives_read_by_jax(nets, weights, tmp_path, mode):
    """The port's weights.npz loads in the JAX package bit for bit, and
    its state.npz equals what the JAX package's bundle writes, leaf for
    leaf (`mobileposer_tpu.serving._save_state_npz` of its fresh
    state)."""
    jnet, net = nets
    tree, params = weights
    S = 2
    out = serving.save_bundle(tmp_path / "b", net, params, n_streams=S,
                              mode=mode)
    jtree = load_from_npz(str(out / serving._WEIGHTS_FILE))
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(tree)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    jax_serving._save_state_npz(tmp_path / "jax_state.npz",
                                _jax_state(jnet, mode, S))
    with np.load(out / serving._STATE_FILE) as mine, \
            np.load(tmp_path / "jax_state.npz") as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        assert json.loads(str(mine["__dtypes__"])) == json.loads(
            str(theirs["__dtypes__"]))
        for k in theirs.files:
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    # and the JAX loader rebuilds its state tree from the port's file
    jst = jax_serving._load_state_npz(out / serving._STATE_FILE, mode)
    _assert_trees_close(serving._load_state_npz(out / serving._STATE_FILE,
                                                mode, "cpu"), jst, 0.0, mode)


# ---------------------------------------------------------------------------
# The graph, loading, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,quantize,want", [
    ("exact", None, {"bilstm_layer": 6, "lstm_layer": 2}),
    ("exact", "int8", {"bilstm_layer_int8": 6, "lstm_layer_int8": 2}),
    ("offline", None, {"bilstm_layer_masked": 6, "lstm_layer_masked": 2}),
    ("offline", "int8", {"bilstm_layer_masked_int8": 6,
                         "lstm_layer_masked_int8": 2}),
    ("carry", None, {}),
])
def test_loaded_graph_holds_one_op_per_layer(nets, weights, tmp_path, mode,
                                             quantize, want):
    """One custom-op node per LSTM layer call, counted by target in the
    graph read back from disk, and no traced plain scan (its tanh)."""
    _, net = nets
    _, params = weights
    out = serving.save_bundle(tmp_path / "b", net, params, n_streams=2,
                              mode=mode, seq_len=16, quantize=quantize)
    targets = _targets(torch.export.load(out / serving._STEP_FILE).graph)
    ops = {t[len(OP):].removesuffix(".default"): n
           for t, n in targets.items() if t.startswith(OP)}
    assert ops == want
    if mode != "carry":
        assert not any("tanh" in t for t in targets), targets


def test_loading_unpickles_no_object(nets, weights, tmp_path, monkeypatch,
                                     caplog):
    """`load_bundle` never falls back to `torch.load(weights_only=False)`:
    the example inputs are not saved."""
    _, net = nets
    _, params = weights
    out = serving.save_bundle(tmp_path / "b", net, params, n_streams=2,
                              mode="exact")
    calls = []
    load = torch.load

    def spy(*args, **kwargs):
        calls.append(kwargs.get("weights_only"))
        return load(*args, **kwargs)

    monkeypatch.setattr(torch, "load", spy)
    with caplog.at_level(logging.DEBUG):
        serving.load_bundle(out)
    assert False not in calls, calls
    assert not any("weights_only=False" in r.getMessage()
                   for r in caplog.records)


def test_refusals(nets, weights, tmp_path, monkeypatch):
    """A bad mode, an unknown quantize, another device than the net's,
    and a CUDA bundle where no card is visible all raise."""
    _, net = nets
    _, params = weights
    with pytest.raises(ValueError, match="mode"):
        serving.save_bundle(tmp_path / "x", net, params, 2, mode="windowed")
    with pytest.raises(ValueError, match="unknown quantize"):
        serving.save_bundle(tmp_path / "x", net, params, 2, quantize="int4")
    with pytest.raises(ValueError, match="differs from the net"):
        serving.export_streaming_step(net, params, 2, device="cuda")
    out = serving.save_bundle(tmp_path / "b", net, params, 2, mode="carry")
    meta = json.loads((out / serving._META_FILE).read_text())
    meta["device"] = "cuda"
    (out / serving._META_FILE).write_text(json.dumps(meta))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda'"):
        serving.load_bundle(out)


# ---------------------------------------------------------------------------
# The custom ops
# ---------------------------------------------------------------------------

def _op_args(op, dtype, rng):
    """Tiny inputs for one op: T = 3, B = 2, H = 8."""
    T, B, H = 3, 2, 8
    name = op._name
    n_dir = lstm_cuda.OPS[op]
    int8 = name.endswith("int8")

    def t(*shape, scale=0.5):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(dtype)

    args = [t(T, B, 4 * H) for _ in range(n_dir)]
    if int8:
        args += [torch.from_numpy(rng.randint(-127, 128, (H, 4 * H)).astype(
            np.int8)) for _ in range(n_dir)]
        args += [torch.from_numpy(rng.uniform(1e-3, 1e-2, 4 * H).astype(
            np.float32)) for _ in range(n_dir)]
    else:
        args += [t(H, 4 * H, scale=0.2) for _ in range(n_dir)]
    args += [t(B, H) for _ in range(2 * n_dir)]
    if "masked" in name:
        args.append(torch.tensor([[1, 1], [1, 0], [0, 0]], dtype=dtype))
    return args


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("op", list(lstm_cuda.OPS), ids=lambda o: o._name)
def test_opcheck(op, dtype):
    """`torch.library.opcheck` (schema, fake implementation, autograd
    registration, AOT dispatch) on each op; its outputs are the wrapper's
    and, in the op's layout, shaped as the fake says."""
    args = _op_args(op, dtype, np.random.RandomState(0))
    torch.library.opcheck(op, args)
    out = op(*args)
    T, B, H4 = args[0].shape
    n_dir = lstm_cuda.OPS[op]
    assert [tuple(o.shape) for o in out] == (
        [(T, B, H4 // 4)] * n_dir + [(B, H4 // 4)] * (2 * n_dir))
    assert all(o.dtype == dtype for o in out)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_op_route_equals_eager_route(weights, monkeypatch, masked, int8):
    """`lstm_forward_cuda` through the ops (as under tracing) equals the
    direct wrapper route at 0.0, with the same wrapper calls (a kernel
    launch each on the card)."""
    from mobileposer_tpu_torch.ops.quant import quantize_params_int8
    _, params = weights
    block = params["poser"]
    if int8:
        block = quantize_params_int8(block)
    calls = Counter()
    for name in ("lstm_layer", "bilstm_layer", "lstm_layer_masked",
                 "bilstm_layer_masked", "lstm_layer_int8",
                 "bilstm_layer_int8", "lstm_layer_masked_int8",
                 "bilstm_layer_masked_int8"):
        def counted(*args, _f=getattr(lstm_cuda, name), _n=name):
            calls[_n] += 1
            return _f(*args)
        monkeypatch.setattr(lstm_cuda, name, counted)
    # the routes name the wrappers: rebuild them over the counted ones
    monkeypatch.setattr(lstm_cuda, "_ROUTES", {
        (m, q): (getattr(lstm_cuda, f"bilstm_layer{'_masked' * m}"
                                    f"{'_int8' * q}"),
                 getattr(lstm_cuda, f"lstm_layer{'_masked' * m}"
                                    f"{'_int8' * q}"))
        for m in (False, True) for q in (False, True)})
    x = torch.from_numpy((np.random.RandomState(8).randn(2, 7, 256)
                          * 0.3).astype(np.float32))
    lengths = torch.tensor([7, 4]) if masked else None
    runs = []
    for tracing in (False, True):
        calls.clear()
        monkeypatch.setattr(torch.compiler, "is_compiling",
                            lambda tracing=tracing: tracing)
        y, (h, c) = lstm_cuda.lstm_forward_cuda(block.lstm, x,
                                                lengths=lengths)
        runs.append(((y, h, c), dict(calls)))
    (eager, eager_calls), (ops, op_calls) = runs
    for a, b in zip(eager, ops):
        assert torch.equal(a, b)
    kind = f"bilstm_layer{'_masked' * masked}{'_int8' * int8}"
    assert eager_calls == op_calls == {kind: 2}


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_export_serving_smoke_test(nets, tmp_path, monkeypatch, capsys):
    """`cli.export_serving --device cpu --mode exact --streams 2
    --smoke-test` (random weights from seed 0) exports, reloads and runs
    one step."""
    _, net = nets
    monkeypatch.setattr(ParametricModel, "from_file_or_synthetic",
                        classmethod(lambda cls, f: net.body_model))
    out = tmp_path / "cli_bundle"
    export_cli.main(["--out", str(out), "--device", "cpu", "--mode",
                     "exact", "--streams", "2", "--smoke-test"])
    printed = capsys.readouterr().out
    assert "smoke test ok" in printed and "on cpu" in printed
    assert json.loads((out / serving._META_FILE).read_text())["mode"] == \
        "exact"
    shutil.rmtree(out)
