"""The port's `parallel/` package against the JAX package's on the CPU:
padding, batch and stream-state sharding, the process-slice arithmetic
and `initialize_distributed`'s wiring (tests/test_distributed.py:55-150),
and the sharded streaming path, exact and carry, float32 and int8, over a
mesh of 8 CPU entries against the JAX package's run over its 8-device
mesh (tests/conftest.py) and against the port's own one-device run.

Weights: the trained fixture, carried across with `params_from_jax`;
frames from numpy with a seed. Tolerances are stated at each assert.
"""

import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from mobileposer_tpu import parallel as jax_parallel
from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.models import MobilePoserNet as JaxNet
from mobileposer_tpu.models import net as jax_net_mod
from mobileposer_tpu.models import streaming as jax_streaming
from mobileposer_tpu.nn import load_from_npz
from mobileposer_tpu.ops import quant as jq
from mobileposer_tpu_torch import parallel
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet, OnlineState
from mobileposer_tpu_torch.models.streaming import CarryState
from mobileposer_tpu_torch.nn.convert import params_from_jax
from mobileposer_tpu_torch.ops.quant import quantize_params_int8
from mobileposer_tpu_torch.parallel import distributed as D

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
def trees():
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  load_from_npz(_FIXTURE))
    return {None: tree,
            "int8": jax.tree_util.tree_map(np.asarray,
                                           jq.quantize_params_int8(tree))}


def _cpu_mesh(n):
    return parallel.make_mesh(devices=["cpu"] * n)


def _jax_shards(x):
    """A sharded JAX array's per-device blocks, in device order."""
    order = {d: i for i, d in enumerate(jax.devices())}
    blocks = sorted(x.addressable_shards, key=lambda s: order[s.device])
    return [np.asarray(s.data) for s in blocks]


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------

def _np_batch(rng, B=6, T=5):
    return {"imu": rng.randn(B, T, 3).astype(np.float32),
            "joints": rng.randn(B, T, 2).astype(np.float32),
            "lengths": rng.randint(1, T + 1, size=B).astype(np.int32)}


@pytest.mark.parametrize("batch_dim", [0, 1])
def test_pad_and_shard_batch_match_jax(batch_dim):
    """Padding to a multiple of 4 and sharding over 4 entries give the
    JAX package's arrays and per-device blocks, bit for bit (time-major
    with batch_dim=1, `lengths` on its only axis)."""
    batch = _np_batch(np.random.RandomState(batch_dim))
    if batch_dim:
        batch = {k: (v if v.ndim == 1 else np.ascontiguousarray(
            np.swapaxes(v, 0, 1))) for k, v in batch.items()}
    got = parallel.pad_batch_to_multiple(batch, 4, batch_dim)
    want = jax_parallel.pad_batch_to_multiple(batch, 4, batch_dim)
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert parallel.pad_batch_to_multiple(got, 4, batch_dim) is got
    shards = parallel.shard_batch(got, _cpu_mesh(4), batch_dim=batch_dim)
    jshards = jax_parallel.shard_batch(want, jax_parallel.make_mesh(4),
                                       batch_dim=batch_dim)
    for k in batch:
        for i, block in enumerate(_jax_shards(jshards[k])):
            np.testing.assert_array_equal(shards[i][k].numpy(), block)
    with pytest.raises(ValueError, match="divide"):
        parallel.shard_batch(batch, _cpu_mesh(4), batch_dim=batch_dim)


def test_make_mesh_and_replicate():
    """A mesh names its devices, repeats allowed; a card that is not
    there, or none at all, raises rather than falling back to the CPU;
    the params are kept once per distinct device."""
    mesh = _cpu_mesh(3)
    assert mesh.size == 3 and mesh.distinct == (torch.device("cpu"),)
    assert parallel.make_mesh(2, devices=["cpu"] * 3).size == 2
    with pytest.raises(ValueError, match="n_devices"):
        parallel.make_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(RuntimeError, match="not present"):
        parallel.make_mesh(devices=["cpu", "cuda:0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh()
    block = torch.nn.Linear(2, 2)
    rep = parallel.replicate_params(block, mesh)
    assert list(rep) == [torch.device("cpu")] and rep[mesh.devices[0]] is block
    assert parallel.replicate_params(rep, mesh) is rep
    with pytest.raises(ValueError, match="replicated over"):
        parallel.replicate_params(rep, parallel.Mesh(
            (torch.device("cpu"), torch.device("meta"))))


def test_shard_map_runs_every_shard_in_mesh_order_on_its_copy():
    """`shard_map` over two distinct devices (the CPU and `meta`, which
    runs no work): each shard gets its entry of a `Sharded` argument,
    its device's copy of a `Replicated` one and any other argument as it
    is, the calls run in mesh order in the caller's thread, and the
    results come back in mesh order; a shard that raises fails the call.
    """
    import threading
    cpu, meta = torch.device("cpu"), torch.device("meta")
    mesh = parallel.Mesh((cpu, meta, cpu, meta))
    order = []

    def fn(i, w, scale, x):
        order.append(i)
        return (i, threading.get_ident(), str((x * w * scale).device))
    w = parallel.replicate_params(torch.ones(2), mesh)
    assert set(w) == {cpu, meta}
    out = parallel.shard_map(fn, mesh)(
        parallel.Sharded(range(4)), w, 2.0,
        parallel.Sharded(torch.ones(2, device=d) for d in mesh.devices))
    assert order == [0, 1, 2, 3] and [o[0] for o in out] == [0, 1, 2, 3]
    assert {o[1] for o in out} == {threading.get_ident()}
    assert [o[2] for o in out] == ["cpu", "meta"] * 2

    def bad(i):
        if i == 3:
            raise RuntimeError("shard 3 failed")
        return i
    with pytest.raises(RuntimeError, match="shard 3 failed"):
        parallel.shard_map(bad, mesh)(parallel.Sharded(range(4)))


@pytest.mark.parametrize("kind", ["carry", "online"])
def test_shard_stream_state_exact_axes_beat_shape_collision(nets, kind):
    """tests/test_streaming_carry.py:277-300: with S = 2, the stream count
    collides with the velocity carry's 2 layers; the declared axes split
    the stream axis anyway. Each shard's leaves equal the JAX package's
    per-device blocks of the same fresh state."""
    jnet, net = nets
    S = 2
    jinit = getattr(jnet, f"init_{kind}_state_batched")
    init = getattr(net, f"init_{kind}_state_batched")
    jst = jax_parallel.shard_stream_state(jinit(S), S,
                                          jax_parallel.make_mesh(2))
    shards = parallel.shard_stream_state(init(S), S, _cpu_mesh(2))
    assert shards[0].vel_h.shape == (2, 1, 256)              # [L, S/2, H]
    assert shards[0].initialized.shape == (1,)
    for i, shard in enumerate(shards):
        for g, w in zip(jax.tree_util.tree_leaves(shard),
                        jax.tree_util.tree_leaves(jst)):
            np.testing.assert_array_equal(g.numpy(), _jax_shards(w)[i])


def test_stream_axes_match_the_jax_package():
    """The port's declared axes are the JAX package's, field for field,
    and mirror each state's structure."""
    got = jax.tree_util.tree_leaves(OnlineState.STREAM_AXES)
    want = jax.tree_util.tree_leaves(jax_net_mod.MobilePoserNet.OnlineState
                                     .STREAM_AXES)
    assert got == want
    assert OnlineState.STREAM_AXES._fields == OnlineState._fields
    assert (jax.tree_util.tree_leaves(CarryState.STREAM_AXES)
            == jax.tree_util.tree_leaves(
                jax_streaming.CarryState.STREAM_AXES))


def test_shard_stream_state_guesses_and_refuses(nets):
    """tests/test_streaming_carry.py:318-330: an unbatched state shares
    its class with the batched one and is refused; a tree without
    declared axes is split by the shape rule and other leaves copied; a
    stream count that does not divide is refused."""
    _, net = nets
    with pytest.raises(ValueError, match="n_streams"):
        parallel.shard_stream_state(net.init_online_state(), 1, _cpu_mesh(1))
    tree = {"a": torch.arange(8.0).reshape(4, 2),
            "b": torch.zeros(3, 4), "c": torch.ones(5)}
    shards = parallel.shard_stream_state(tree, 4, _cpu_mesh(2))
    assert shards[1]["a"].tolist() == [[4.0, 5.0], [6.0, 7.0]]
    assert shards[1]["b"].shape == (3, 2) and shards[1]["c"].shape == (5,)
    with pytest.raises(ValueError, match="divide"):
        parallel.shard_stream_state(tree, 4, _cpu_mesh(3))


# ---------------------------------------------------------------------------
# Process topology and initialization (tests/test_distributed.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(32, 0, 1), (32, 1, 4), (12, 2, 3),
                                  (8, 2, 2), (8, -1, 2), (8, 0, 0),
                                  (10, 0, 4)])
def test_host_local_batch_slice_matches_jax(args):
    """The same slices, and the same refusals, as the JAX package."""
    try:
        want = jax_parallel.host_local_batch_slice(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split()[0]):
            D.host_local_batch_slice(*args)
        return
    assert D.host_local_batch_slice(*args) == want
    batch = _np_batch(np.random.RandomState(0), B=args[0])
    rows = D.host_local_batch(batch, *args[1:])
    start, size = want
    for k, v in batch.items():
        np.testing.assert_array_equal(rows[k], v[start:start + size])


def test_host_slice_defaults_to_live_topology():
    assert D.host_local_batch_slice(32) == (0, 32)


@pytest.fixture
def captured(monkeypatch):
    calls = []
    monkeypatch.setattr(D.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    return calls


def test_initialize_distributed_single_process_noop(captured):
    assert D.initialize_distributed(device="cpu") is False
    assert captured == []


def test_initialize_distributed_env_wiring(captured, monkeypatch):
    """torchrun's variables where the JAX package reads JAX_*; gloo for a
    CPU device, NCCL for a card, or the backend the caller names."""
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert D.initialize_distributed(device="cpu") is True
    assert D.initialize_distributed(device="cuda:0") is True
    assert D.initialize_distributed(backend="gloo", device="cuda:0") is True
    base = {"init_method": "tcp://10.0.0.1:1234", "world_size": 4,
            "rank": 3}
    assert captured == [dict(base, backend=b)
                        for b in ("gloo", "nccl", "gloo")]


def test_initialize_distributed_explicit_zero_beats_env(captured,
                                                        monkeypatch):
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "8")
    assert D.initialize_distributed("10.0.0.1:1234", num_processes=2,
                                    process_id=0, device="cpu") is True
    assert captured == [{"backend": "gloo",
                         "init_method": "tcp://10.0.0.1:1234",
                         "world_size": 2, "rank": 0}]


def test_fold_in_gives_each_rank_its_own_reproducible_stream():
    def draws(k):
        g = torch.Generator().manual_seed(5)
        return torch.randn(4, generator=D.fold_in(g, k)), g
    a0, g0 = draws(0)
    a1, _ = draws(1)
    assert torch.equal(a0, draws(0)[0]) and not torch.equal(a0, a1)
    # the base generator moved on, so the next fold draws anew
    assert not torch.equal(torch.randn(4, generator=D.fold_in(g0, 0)), a0)


# ---------------------------------------------------------------------------
# Sharded streaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "carry"])
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_sharded_streaming_matches_jax_and_one_device(nets, trees, mode,
                                                      quantize):
    """S = 8 streams x N = 3 frames over a mesh of 8 CPU entries, fresh,
    then continued from the sharded final state: against the JAX
    package's jitted call on stream-sharded state and frames over its 8
    devices (tests/test_net.py:260, tests/test_streaming_carry.py:216) at
    its pins, 3e-5 in float32 and 2e-3 on int8 params (the flips of
    tests/test_torch_quant.py); against the port's one-device run at
    1e-4 in float32 and at the same int8 pin (torch's CPU matmul rounds
    the float input projection differently at another batch size, and
    the per-row re-quantization of h can make that a flip)."""
    jnet, net = nets
    tree = trees[quantize]
    params = params_from_jax(trees[None], device="cpu")
    if quantize:
        params = quantize_params_int8(params)
    S, N = 8, 3
    tol = 2e-3 if quantize else 3e-5
    jmesh = jax_parallel.make_mesh()
    jinit = (jnet.init_carry_state_batched if mode == "carry"
             else jnet.init_online_state_batched)
    jrun = jax.jit(jnet.forward_carry_sequence_batched if mode == "carry"
                   else jnet.forward_online_sequence_batched)
    jparams = jax_parallel.replicate_params(tree, jmesh)
    jst = jax_parallel.shard_stream_state(jinit(S), S, jmesh)
    mesh, one = _cpu_mesh(8), _cpu_mesh(1)
    st = st1 = None
    rng = np.random.RandomState(30)
    for call in ("fresh", "continued"):
        frames = (rng.randn(N, S, 60) * 0.1).astype(np.float32)
        want, jst = jrun(jparams, jst, jax.device_put(
            frames, NamedSharding(jmesh, P(None, "data"))))
        got, st = parallel.stream_sequence_sharded(net, params, frames, mesh,
                                                   mode, state=st)
        single, st1 = parallel.stream_sequence_sharded(net, params, frames,
                                                       one, mode, state=st1)
        assert isinstance(st, parallel.Sharded) and len(st) == 8
        for name, g, w, s in zip(("pose", "joints", "root", "contact"),
                                 got, want, single):
            assert tuple(g.shape) == np.shape(w), name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                       err_msg=f"{call}: {name} vs JAX")
            np.testing.assert_allclose(g.numpy(), s.numpy(),
                                       atol=tol if quantize else 1e-4,
                                       err_msg=f"{call}: {name} vs one")
