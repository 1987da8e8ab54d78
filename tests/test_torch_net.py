"""The port's streaming path against the JAX package, on the CPU, at full
model width with few streams and frames.

Weights come from the JAX package (random `init_all_modules(PRNGKey(0))`,
and separately the trained fixture) and cross with
`nn.convert.params_from_jax`; frames and states are made with numpy from a
seed and handed to both packages. Tolerances: 2e-5 for every output and
state field, 3e-5 for the integrated root translation, 1e-6 for the pose
assembly alone (the pins tests/test_net.py uses inside the JAX package).
"""

import os

import numpy as np
import pytest
import torch

import jax

from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.models import MobilePoserNet as JaxNet
from mobileposer_tpu.models import forward as jax_forward
from mobileposer_tpu.models import init_all_modules as jax_init_all_modules
from mobileposer_tpu.models import \
    reduced_global_to_full_soa as jax_reduced_global_to_full_soa
from mobileposer_tpu.nn import load_from_npz
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import (MobilePoserNet, OnlineState, forward,
                                          reduced_global_to_full_soa)
from mobileposer_tpu_torch.nn.convert import params_from_jax

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")
ATOL, ATOL_ROOT = 2e-5, 3e-5


@pytest.fixture(scope="module")
def bodies():
    return JaxBody.synthetic(num_vertices=240), ParametricModel.synthetic(
        num_vertices=240)


@pytest.fixture(scope="module")
def nets(bodies):
    return JaxNet(bodies[0]), MobilePoserNet(bodies[1], device="cpu")


@pytest.fixture(scope="module")
def weights():
    """{name: (jax params as numpy, the port's modules)} for random and
    trained weights; the f16 fixture is computed in f32 by both."""
    random = jax.tree_util.tree_map(
        np.asarray, jax_init_all_modules(jax.random.PRNGKey(0)))
    trained = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                     load_from_npz(_FIXTURE))
    return {name: (tree, params_from_jax(tree, device="cpu"))
            for name, tree in (("random", random), ("trained", trained))}


@pytest.fixture(scope="module")
def jax_runs(nets):
    """One jitted JAX program per mode, shared by every test case."""
    jnet = nets[0]
    return {mode: jax.jit(lambda p, st, f, mode=mode:
                          jnet.forward_online_sequence_batched(
                              p, st, f, mode=mode, chunk=3))
            for mode in ("scan", "unfolded")}


def test_synthetic_body_is_bit_identical(bodies):
    jb, tb = bodies
    np.testing.assert_array_equal(tb._J, jb._J)
    np.testing.assert_array_equal(tb._v_template, jb._v_template)
    assert tb.parent == jb.parent
    for a, b in zip(tb.get_zero_pose_joint_and_vertex(),
                    jb.get_zero_pose_joint_and_vertex()):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_r6d_to_rotation_matrix_matches_jax():
    from mobileposer_tpu.kinematics import rotation as jax_R
    from mobileposer_tpu_torch.kinematics import rotation as R
    r6d = np.random.RandomState(4).randn(50, 6).astype(np.float32)
    r6d[:3, :3] = 0.0        # degenerate first column: the clamped norm
    want = np.asarray(jax_R.r6d_to_rotation_matrix(r6d))
    got = R.r6d_to_rotation_matrix(torch.from_numpy(r6d))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(
        R.lerp(got[:, 0], got[:, 1], 0.25).numpy(),
        np.asarray(jax_R.lerp(want[:, 0], want[:, 1], 0.25)), atol=1e-6)


def test_reduced_global_to_full_soa_matches_jax(bodies):
    r6d = np.random.RandomState(5).randn(37, 96).astype(np.float32)
    r6d0 = r6d.copy()
    r6d0[:, :12] = 0.0       # degenerate input: the clamped-norm path
    for x in (r6d, r6d0):
        want = np.asarray(jax_reduced_global_to_full_soa(x, bodies[0]))
        got = reduced_global_to_full_soa(torch.from_numpy(x), bodies[1])
        assert got.shape == (37, 24, 3, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("which", ["random", "trained"])
def test_forward_pose_index_matches_jax(which, weights, bodies):
    tree, params = weights[which]
    rng = np.random.RandomState(11)
    imu = (rng.randn(2, 45, 60) * 0.1).astype(np.float32)
    h0c0 = tuple((rng.randn(2, 2, 256) * 0.3).astype(np.float32)
                 for _ in range(2))
    want = jax_forward(tree, imu, bodies[0], vel_h0c0=h0c0, pose_index=40)
    got = forward(params, torch.from_numpy(imu), bodies[1],
                  vel_h0c0=tuple(map(torch.from_numpy, h0c0)), pose_index=40)
    assert got[0].shape == (2, 24, 3, 3)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    for g, w in zip(got[4], want[4]):                 # velocity (h, c)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def _fresh_state(jnet, S):
    return jnet.init_online_state_batched(S)


def _warm_state(jnet, S, rng):
    """A stream batch mid-run: some streams initialized, nonzero carries,
    moved anchors and root."""
    st = jnet.init_online_state_batched(S)
    f32 = lambda *s: (rng.randn(*s)).astype(np.float32)  # noqa: E731
    return st._replace(
        imu=f32(S, 45, 60) * 0.1,
        initialized=np.arange(S) % 2 == 0,
        vel_h=f32(2, S, 256) * 0.3, vel_c=f32(2, S, 256) * 0.3,
        last_lfoot=st.last_lfoot + f32(S, 3) * 0.05,
        last_rfoot=st.last_rfoot + f32(S, 3) * 0.05,
        current_root_y=f32(S) * 0.1, last_root_pos=f32(S, 3) * 0.5)


def _to_port(state) -> OnlineState:
    return OnlineState(*(torch.from_numpy(np.asarray(x)) for x in state))


def _assert_close(got, want, where):
    (pose, joints, root, contact), st = got
    (jpose, jjoints, jroot, jcontact), jst = want
    for name, g, w, tol in (("pose", pose, jpose, ATOL),
                            ("joints", joints, jjoints, ATOL),
                            ("root", root, jroot, ATOL_ROOT),
                            ("contact", contact, jcontact, ATOL)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (where, name)
        np.testing.assert_allclose(g.numpy(), w, atol=tol,
                                   err_msg=f"{where}: {name}")
    for name, g, w in zip(OnlineState._fields, st, jst):
        tol = ATOL_ROOT if name in ("current_root_y", "last_root_pos") else ATOL
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w, np.float32), atol=tol,
                                   err_msg=f"{where}: state.{name}")


@pytest.mark.parametrize("which", ["random", "trained"])
@pytest.mark.parametrize("mode", ["scan", "unfolded"])
def test_sequence_batched_matches_jax(mode, which, nets, weights, jax_runs):
    """S=3 streams x N=7 frames (unfolded: chunk=3, so a tail chunk of
    one frame), from a fresh and from a pre-initialized state, then a
    second call continuing from each final state."""
    jnet, net = nets
    tree, params = weights[which]
    S, N = 3, 7
    rng = np.random.RandomState(21)
    for start in ("fresh", "warm"):
        jst = (_fresh_state(jnet, S) if start == "fresh"
               else _warm_state(jnet, S, rng))
        st = _to_port(jst)
        for call in ("first", "continued"):
            frames = (rng.randn(N, S, 60) * 0.1).astype(np.float32)
            want = jax_runs[mode](tree, jst, frames)
            got = net.forward_online_sequence_batched(
                params, st, torch.from_numpy(frames), mode=mode, chunk=3)
            _assert_close(got, want, f"{mode}/{which}/{start}/{call}")
            st, jst = got[1], want[1]


def test_auto_mode_and_bad_options(nets, weights):
    net = nets[1]
    params = weights["random"][1]
    st = net.init_online_state_batched(2)
    frames = torch.zeros(1, 2, 60)
    with pytest.raises(ValueError, match="unknown streaming mode"):
        net.forward_online_sequence_batched(params, st, frames, mode="x")
    # a training backend, bf16 residuals too, is refused by this
    # inference entry point
    with pytest.raises(NotImplementedError, match="inference entry point"):
        net.forward_online_sequence_batched(params, st, frames,
                                            backend="auto_train_bf16res")
    # float32 and bfloat16 are the dtypes the port runs
    with pytest.raises(NotImplementedError, match="float32 and bfloat16"):
        net.init_online_state_batched(2, dtype=torch.float16)
