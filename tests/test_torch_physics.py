"""The port's physics layer (`physics/`) against the JAX package's, on the
CPU (`device="cpu"`), on the synthetic body with 240 vertices.

At 8 seeded states (the JAX tests' `_rand_state`), every `DynamicsModel`
output is held to the JAX one, relative to the output's largest
magnitude:

  * 1e-4 for inverse dynamics, h and M (the port sums the recursions over
    an ancestor mask, in another order than the JAX code's per-body
    loops: float32 rounding);
  * 1e-5 for the kinematic quantities (body and point kinematics, the
    three Jacobians, the CoM terms, the ZMP, `integrate_q`);
  * 5e-3 for `forward_dynamics`: both solve M qdd = tau - h by a float32
    Cholesky factorization with one refinement step, and M's small
    leaf-inertia eigenvalues make it ill-conditioned (condition number
    between 7e4 and 1e5 at these states, pinned below), so the two
    solutions differ by up to cond(M) times the float32 epsilon.

The port's own cross-checks follow the JAX tests: ID == M qdd + h, M
symmetric positive definite, FD inverts ID, J qdot equals the point
velocity. `PhysicsOptimizer`, with and without `dynamics`, is held to
the JAX one over a 30-frame sequence (pose and tran at 1e-5); the QR's
sign fix makes Q unique where diag(R) != 0, so the libraries' sign
choices do not show.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.kinematics import rotation as JR
from mobileposer_tpu.physics import BodyParams as JaxBodyParams
from mobileposer_tpu.physics import DynamicsModel as JaxDynamics
from mobileposer_tpu.physics import PhysicsOptimizer as JaxOptimizer
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.physics import (BodyParams, DebugParams,
                                           DynamicsModel, PhysicsOptimizer,
                                           physics_enabled)
from mobileposer_tpu_torch.physics.dynamics import DOF, N_BODIES

ID_TOL = 1e-4
KIN_TOL = 1e-5
FD_TOL = 5e-3
SEEDS = range(8)
POINT = np.array([0.05, -0.02, 0.03], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand_state(seed, q_scale=0.4, v_scale=0.8):
    """tests/test_dynamics.py:_rand_state of the JAX package."""
    rng = np.random.RandomState(seed)
    q = np.concatenate([rng.randn(3) * 0.2,
                        rng.randn(N_BODIES * 3) * q_scale]).astype(np.float32)
    qdot = (rng.randn(DOF) * v_scale).astype(np.float32)
    qddot = (rng.randn(DOF) * v_scale).astype(np.float32)
    return q, qdot, qddot


def _tau(seed):
    return (np.random.RandomState(100 + seed).randn(DOF) * 5).astype(
        np.float32)


# name -> (call on a model with a state (q, qdot, qddot, tau), tolerance)
FUNCS = {
    "inverse_dynamics": (lambda m, q, v, a, t: m.inverse_dynamics(q, v, a),
                         ID_TOL),
    "calc_h": (lambda m, q, v, a, t: m.calc_h(q, v), ID_TOL),
    "calc_M": (lambda m, q, v, a, t: m.calc_M(q), ID_TOL),
    "forward_dynamics": (lambda m, q, v, a, t: m.forward_dynamics(q, v, t),
                         FD_TOL),
    "calc_point_Jacobian": (
        lambda m, q, v, a, t: m.calc_point_Jacobian(q, 20, POINT), KIN_TOL),
    "calc_body_Jacobian": (lambda m, q, v, a, t: m.calc_body_Jacobian(q, 15),
                           KIN_TOL),
    "calc_space_Jacobian": (
        lambda m, q, v, a, t: m.calc_space_Jacobian(q, 11), KIN_TOL),
    "calc_point_velocity": (
        lambda m, q, v, a, t: m.calc_point_velocity(q, v, 21, POINT),
        KIN_TOL),
    "calc_point_acceleration": (
        lambda m, q, v, a, t: m.calc_point_acceleration(q, v, a, 10, POINT),
        KIN_TOL),
    "body_coordinates": (lambda m, q, v, a, t: (
        m.calc_body_position(q, 7), m.calc_body_orientation(q, 7),
        m.calc_body_to_base_coordinates(q, 18, POINT),
        m.calc_base_to_body_coordinates(q, 18, POINT)), KIN_TOL),
    "center_of_mass": (lambda m, q, v, a, t: (
        m.calc_center_of_mass_position(q, v)
        + m.calc_center_of_mass_position_velocity(q, v)
        + m.calc_center_of_mass_position_velocity_acceleration(q, v, a)),
        KIN_TOL),
    "calc_zero_moment_point": (
        lambda m, q, v, a, t: m.calc_zero_moment_point(q, v, a), KIN_TOL),
    "integrate_q": (lambda m, q, v, a, t: m.integrate_q(q, v, 0.01),
                    KIN_TOL),
}


@pytest.fixture(scope="module")
def models():
    jb = JaxBody.synthetic(num_vertices=240)
    tb = ParametricModel.synthetic(num_vertices=240)
    return (JaxDynamics(body_model=jb),
            DynamicsModel(body_model=tb, device="cpu"), jb, tb)


@pytest.fixture(scope="module")
def jax_refs(models):
    """{name: [the JAX outputs at each seed]}, each function jit-ed once."""
    jm = models[0]
    refs = {}
    for name, (fn, _) in FUNCS.items():
        f = jax.jit(lambda q, v, a, t, fn=fn: fn(jm, q, v, a, t))
        refs[name] = [jax.tree_util.tree_map(
            np.array, f(*_rand_state(s), _tau(s))) for s in SEEDS]
    return refs


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    return [out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)]


def test_body_params_equal_jax(models):
    _, _, jb, tb = models
    want, got = JaxBodyParams.from_smpl(jb), BodyParams.from_smpl(tb)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got.mass.sum(), 70.0, rtol=1e-5)


@pytest.mark.parametrize("name", list(FUNCS))
def test_dynamics_against_jax(models, jax_refs, name):
    tm = models[1]
    fn, tol = FUNCS[name]
    for s, want in zip(SEEDS, jax_refs[name]):
        got = fn(tm, *_rand_state(s), _tau(s))
        for g, w in zip(_flat(got), _flat(want)):
            assert g.shape == w.shape, name
            scale = max(float(np.abs(w).max()), 1e-6)
            err = float(np.abs(g - w).max()) / scale
            assert err <= tol, f"{name} seed {s}: {err} relative (tol {tol})"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inverse_dynamics_equals_M_qddot_plus_h(models, seed):
    """Newton-Euler against the independently assembled mass matrix."""
    tm = models[1]
    q, qdot, qddot = _rand_state(seed)
    tau = tm.inverse_dynamics(q, qdot, qddot).double()
    M, h = tm.calc_M(q).double(), tm.calc_h(q, qdot).double()
    want = M @ torch.tensor(qddot).double() + h
    err = float((tau - want).abs().max() / want.abs().max())
    assert err <= ID_TOL, err


def test_mass_matrix_symmetric_positive_definite(models):
    """Also pins the condition number FD_TOL is argued from."""
    tm = models[1]
    for s in SEEDS:
        M = tm.calc_M(_rand_state(s)[0]).double()
        assert float((M - M.T).abs().max()) <= 1e-6 * float(M.abs().max())
        eig = torch.linalg.eigvalsh(M)
        assert float(eig.min()) > 0
        assert 7e4 <= float(eig.max() / eig.min()) <= 1e5


def test_forward_inverts_inverse_dynamics_and_point_jacobian(models):
    tm = models[1]
    q, qdot, qddot = _rand_state(2)
    tau = tm.inverse_dynamics(q, qdot, qddot)
    back = tm.forward_dynamics(q, qdot, tau)
    assert float((back - torch.tensor(qddot)).abs().max()) <= \
        FD_TOL * float(np.abs(qddot).max())
    J = tm.calc_point_Jacobian(q, 20, POINT)
    v = tm.calc_point_velocity(q, qdot, 20, POINT)
    torch.testing.assert_close(J @ torch.tensor(qdot), v, atol=1e-5,
                               rtol=0)


def _sequence(T=30):
    rng = np.random.RandomState(7)
    aa = np.cumsum(rng.randn(T, 24, 3) * 0.05, 0).astype(np.float32)
    pose = np.asarray(JR.axis_angle_to_rotation_matrix(
        aa.reshape(-1, 3))).reshape(T, 24, 3, 3)
    contact = (rng.randn(T, 2) * 3).astype(np.float32)
    tran = np.cumsum(rng.randn(T, 3) * 0.01, 0).astype(np.float32)
    return pose, contact, tran


@pytest.mark.parametrize("with_dynamics", [False, True])
def test_physics_optimizer_against_jax(models, with_dynamics):
    jm, tm, jb, tb = models
    jopt = JaxOptimizer(body_model=jb, contact_threshold=0.5,
                        dynamics=jm if with_dynamics else None)
    topt = PhysicsOptimizer(body_model=tb, contact_threshold=0.5,
                            dynamics=tm if with_dynamics else None,
                            device=None if with_dynamics else "cpu")
    assert topt.device.type == "cpu"
    step = jax.jit(jopt.optimize_frame)
    jstate, tstate = jopt.reset_states(), topt.reset_states()
    zero_vel = np.zeros((24, 3), np.float32)
    for p, c, t in zip(*_sequence()):
        (jp, jt), jstate = step(jnp.asarray(p), jnp.asarray(zero_vel),
                                jnp.asarray(c), None, jstate, jnp.asarray(t))
        (tp, tt), tstate = topt.optimize_frame(torch.tensor(p), zero_vel, c,
                                               None, tstate, torch.tensor(t))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=KIN_TOL)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=KIN_TOL)
    for g, w in zip(tstate, jstate):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=KIN_TOL)


def test_physics_optimizer_without_body(models):
    """No body: smoothing alone, the translation passed through."""
    p, c, t = (x[:2] for x in _sequence())
    opt = PhysicsOptimizer(smoothing=0.3, device="cpu")
    (p1, t1), st = opt.optimize_frame(p[0], None, c[0], None)
    np.testing.assert_allclose(p1.numpy(), p[0], atol=1e-6)
    (p2, t2), _ = opt.optimize_frame(p[1], None, c[1], None, st, t[1])
    np.testing.assert_allclose(t2.numpy(), t[1])
    rtr = p2 @ p2.transpose(1, 2)
    np.testing.assert_allclose(rtr.numpy(),
                               np.broadcast_to(np.eye(3), rtr.shape),
                               atol=1e-5)


def test_physics_enabled(monkeypatch):
    for value, want in (("0", False), ("1", True), ("", False),
                        ("yes", True)):
        monkeypatch.setenv("PHYSICS", value)
        assert physics_enabled() is want
    monkeypatch.delenv("PHYSICS")
    assert physics_enabled() is False


def test_debug_params_round_trip_and_live_reload(tmp_path):
    """The JAX package's test_extras case on the port's copy: the json
    schema, slider-like clamping, live reload on a file change."""
    f = tmp_path / "dbg.json"
    attrs = [{"name": "kp", "min": 0.0, "max": 10.0, "value": 2.5},
             {"name": "kd", "min": 0.0, "max": 1.0, "value": 5.0}]  # >max
    f.write_text(json.dumps(attrs))
    p = DebugParams.from_json(f)
    assert p["kp"] == 2.5
    assert p["kd"] == 1.0
    p["kp"] = -3.0
    assert p["kp"] == 0.0
    assert "kd" in p and "ki" not in p and sorted(p) == ["kd", "kp"]
    out = tmp_path / "saved.json"
    p.save(out)
    assert DebugParams.from_json(out).values() == p.values()
    with pytest.raises(ValueError):
        DebugParams(attrs).save()

    attrs[0]["value"] = 7.0
    f.write_text(json.dumps(attrs))
    os.utime(f, (time.time() + 2, time.time() + 2))
    assert p.poll() is True
    assert p["kp"] == 7.0
    f.write_text("{broken")
    os.utime(f, (time.time() + 4, time.time() + 4))
    assert p.poll() is False
    assert p["kp"] == 7.0
