"""The port's kinematics library surface against the JAX package's, on the
CPU: the rotation conversions, the SE(3) and tree operations of
`kinematics/spatial.py`, the `ParametricModel` wrappers (on the synthetic
body with 240 vertices), `make_combo_imu`, the config properties,
`models/utils.py` and the array-of-structures pose assembly of
`models/net.py`.

Inputs are drawn with numpy from a seed; the JAX references are computed
once per module. Tolerance 1e-5 in float32 (absolute, on values of order
one), rotations compared as rotations (`angle_between`, 1e-5 rad).
`svd_rotate` and `rotation_matrix_to_euler_angle` are held only on
well-conditioned inputs: point sets of 20 random points (no degenerate
configuration) and euler angles away from gimbal lock (the Tait-Bryan
middle angle within 1.2 rad of 0, the proper-Euler one in [0.3, 2.8]),
where both functions are continuous.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobileposer_tpu import config as JC
from mobileposer_tpu.data.dataset import make_combo_imu as jax_make_combo_imu
from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.kinematics import SMPLJoint as JaxSMPLJoint
from mobileposer_tpu.kinematics import rotation as JR
from mobileposer_tpu.kinematics import spatial as JS
from mobileposer_tpu.models import net as jnet
from mobileposer_tpu.models import utils as jutils
from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.data import make_combo_imu
from mobileposer_tpu_torch.kinematics import (ParametricModel, SMPLJoint,
                                              SMPL_PARENTS)
from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.kinematics import spatial as S
from mobileposer_tpu_torch.models import net
from mobileposer_tpu_torch.models import utils as mutils

TOL = 1e-5
N = 16
SEQS = ["XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX", "xyz", "zyx", "ZXZ",
        "XYX", "yzy", "zxz"]
REPS = list(R.RotationRepresentation)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.tensor(np.array(x))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _rot_close(got, want, tol=TOL):
    ang = R.angle_between(torch.as_tensor(got).reshape(-1, 3, 3),
                          _t(want).reshape(-1, 3, 3))
    assert float(ang.max()) < tol, float(ang.max())


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    aa = (rng.randn(N, 3) * 0.8).astype(np.float32)
    pose_aa = (rng.randn(4, 24, 3) * 0.4).astype(np.float32)
    tb = np.concatenate([rng.uniform(-3, 3, (N, 1)),
                         rng.uniform(-1.2, 1.2, (N, 1)),
                         rng.uniform(-3, 3, (N, 1))], 1).astype(np.float32)
    pe = np.concatenate([rng.uniform(-3, 3, (N, 1)),
                         rng.uniform(0.3, 2.8, (N, 1)),
                         rng.uniform(-3, 3, (N, 1))], 1).astype(np.float32)
    return dict(
        aa=aa, quat=rng.randn(N, 4).astype(np.float32),
        r6d=rng.randn(N, 6).astype(np.float32),
        rotm=np.asarray(JR.axis_angle_to_rotation_matrix(aa)),
        euler_tb=tb, euler_pe=pe,
        angles=(rng.randn(N) * 7).astype(np.float32),
        pose=np.asarray(JR.axis_angle_to_rotation_matrix(
            pose_aa.reshape(-1, 3))).reshape(4, 24, 3, 3),
        p_local=(rng.randn(4, 24, 3) * 0.2).astype(np.float32),
        src=rng.randn(3, 20, 3).astype(np.float32),
        noise=(rng.randn(3, 20, 3) * 0.01).astype(np.float32),
        r6d_red=rng.randn(5, 96).astype(np.float32),
        acc=rng.randn(7, 5, 3).astype(np.float32),
        ori=rng.randn(7, 5, 3, 3).astype(np.float32),
        glb_acc=rng.randn(9, 6, 3).astype(np.float32),
        glb_ori=np.asarray(JR.axis_angle_to_rotation_matrix(
            rng.randn(54, 3).astype(np.float32))).reshape(9, 6, 3, 3),
        seq=rng.randn(11, 4, 3).astype(np.float32),
    )


@pytest.fixture(scope="module")
def bodies():
    return JaxBody.synthetic(num_vertices=240), \
        ParametricModel.synthetic(num_vertices=240)


# ---------------------------------------------------------------------------
# Rotation
# ---------------------------------------------------------------------------

def test_angle_helpers(data):
    a = data["angles"]
    _close(R.degree_to_radian(_t(a)), JR.degree_to_radian(a))
    _close(R.normalize_angle(_t(a)), JR.normalize_angle(jnp.asarray(a)))
    b = a[::-1].copy()
    _close(R.angle_difference(_t(a), _t(b)),
           JR.angle_difference(jnp.asarray(a), jnp.asarray(b)))
    assert R.RotationRepresentation.__members__.keys() == \
        JR.RotationRepresentation.__members__.keys()
    assert [m.value for m in R.RotationRepresentation] == \
        [m.value for m in JR.RotationRepresentation]


def test_normalize_tensor_return_norm(data):
    x = np.concatenate([data["quat"], np.zeros((1, 4), np.float32)])
    got, norm = R.normalize_tensor(_t(x), return_norm=True)
    want, wnorm = JR.normalize_tensor(jnp.asarray(x), return_norm=True)
    _close(got, want)
    _close(norm, wnorm)


def test_quaternion_conversions(data):
    _close(R.quaternion_to_rotation_matrix(_t(data["quat"])),
           JR.quaternion_to_rotation_matrix(data["quat"]))
    _close(R.axis_angle_to_quaternion(_t(data["aa"])),
           JR.axis_angle_to_quaternion(data["aa"]))


def test_quaternion_round_trip(data):
    """axis-angle -> quaternion -> rotation is axis-angle -> rotation,
    and rotation -> quaternion -> rotation the identity."""
    q = R.axis_angle_to_quaternion(_t(data["aa"]))
    _rot_close(R.quaternion_to_rotation_matrix(q), data["rotm"])
    back = R.quaternion_to_rotation_matrix(
        R.rotation_matrix_to_quaternion(_t(data["rotm"])))
    _rot_close(back, data["rotm"])


@pytest.mark.parametrize("seq", SEQS)
def test_euler_against_jax_and_round_trip(data, seq):
    e = data["euler_tb"] if len(set(seq.lower())) == 3 else data["euler_pe"]
    rot = R.euler_angle_to_rotation_matrix(_t(e), seq)
    _close(rot, JR.euler_angle_to_rotation_matrix(e, seq))
    back = R.rotation_matrix_to_euler_angle(rot, seq)
    _close(back, JR.rotation_matrix_to_euler_angle(jnp.asarray(rot.numpy()),
                                                   seq))
    _rot_close(R.euler_angle_to_rotation_matrix(back, seq), rot.numpy())


def test_euler_rejects_bad_sequences():
    r = torch.eye(3)[None]
    for fn in (lambda: R.rotation_matrix_to_euler_angle(r, "XYx"),
               lambda: R.rotation_matrix_to_euler_angle(r, "XXY"),
               lambda: R.euler_angle_to_rotation_matrix(torch.zeros(1, 3),
                                                        "XyZ")):
        with pytest.raises(ValueError):
            fn()


@pytest.mark.parametrize("rep", REPS, ids=lambda r: r.name)
def test_to_rotation_matrix_and_angle_between(data, rep):
    x = {R.RotationRepresentation.AXIS_ANGLE: data["aa"],
         R.RotationRepresentation.ROTATION_MATRIX: data["rotm"],
         R.RotationRepresentation.QUATERNION: data["quat"],
         R.RotationRepresentation.R6D: data["r6d"],
         R.RotationRepresentation.EULER_ANGLE: data["euler_tb"]}[rep]
    jrep = JR.RotationRepresentation(rep.value)
    _close(R.to_rotation_matrix(_t(x), rep), JR.to_rotation_matrix(
        jnp.asarray(x), jrep))
    y = x[::-1].copy()
    _close(R.angle_between(_t(x), _t(y), rep),
           JR.angle_between(jnp.asarray(x), jnp.asarray(y), jrep))


def test_svd_rotate(data):
    """The rotation that maps each point set onto its rotated, slightly
    noisy copy: against the JAX function, and close to the rotation."""
    rot = data["rotm"][:3]
    tgt = np.einsum("nij,npj->npi", rot, data["src"]) + data["noise"]
    got = R.svd_rotate(_t(data["src"]), _t(tgt))
    want = JR.svd_rotate(jnp.asarray(data["src"]), jnp.asarray(tgt))
    _rot_close(got, want)
    _close(torch.linalg.det(got), np.ones(3))
    assert float(R.angle_between(got, _t(rot)).max()) < 0.02


def test_generate_random_rotation_matrix():
    """Rotations (orthonormal, det 1), fixed by the generator's seed; the
    JAX function draws from a key, so only the law is shared."""
    a = R.generate_random_rotation_matrix(torch.Generator().manual_seed(3),
                                          64)
    b = R.generate_random_rotation_matrix(torch.Generator().manual_seed(3),
                                          64)
    assert a.shape == (64, 3, 3) and torch.equal(a, b)
    _close(a @ a.transpose(1, 2), np.broadcast_to(np.eye(3), (64, 3, 3)))
    _close(torch.linalg.det(a), np.ones(64))


# ---------------------------------------------------------------------------
# SE(3) and trees
# ---------------------------------------------------------------------------

def test_transformation_matrices(data):
    rot, p = data["rotm"], data["aa"]
    T = S.transformation_matrix(_t(rot), _t(p))
    _close(T, JS.transformation_matrix(jnp.asarray(rot), jnp.asarray(p)))
    Rd, pd = S.decode_transformation_matrix(T)
    _close(Rd, rot)
    _close(pd, p)
    inv = S.inverse_transformation_matrix(T)
    _close(inv, JS.inverse_transformation_matrix(jnp.asarray(T.numpy())))
    _close(inv @ T, np.broadcast_to(np.eye(4), (N, 4, 4)))


@pytest.fixture(scope="module")
def tree_refs(data):
    par = SMPL_PARENTS
    pose, pl = jnp.asarray(data["pose"]), jnp.asarray(data["p_local"])
    Rg = jax.jit(lambda x: JS.forward_kinematics_R(x, par))(pose)
    Tl = JS.transformation_matrix(pose, pl)
    Tg = jax.jit(lambda x: JS.forward_kinematics_T(x, par))(Tl)
    return dict(
        R_global=np.asarray(Rg),
        R_local=np.asarray(jax.jit(
            lambda x: JS.inverse_kinematics_R(x, par))(Rg)),
        T_local=np.asarray(Tl), T_global=np.asarray(Tg),
        T_back=np.asarray(jax.jit(
            lambda x: JS.inverse_kinematics_T(x, par))(Tg)),
        joints=np.asarray(jax.jit(
            lambda x: JS.bone_vector_to_joint_position(x, par))(pl)),
        bones=np.asarray(jax.jit(
            lambda x: JS.joint_position_to_bone_vector(x, par))(pl)),
        from_global=np.asarray(jax.jit(
            lambda r, b: JS.joint_positions_from_global(r, b, par))(
                Rg, pl)),
    )


def test_forward_and_inverse_kinematics_R(data, tree_refs):
    Rg = S.forward_kinematics_R(_t(data["pose"]), SMPL_PARENTS)
    _close(Rg, tree_refs["R_global"])
    Rl = S.inverse_kinematics_R(_t(tree_refs["R_global"]), SMPL_PARENTS)
    _close(Rl, tree_refs["R_local"])
    _rot_close(Rl, data["pose"])                 # the round trip


def test_forward_and_inverse_kinematics_T(tree_refs):
    Tg = S.forward_kinematics_T(_t(tree_refs["T_local"]), SMPL_PARENTS)
    _close(Tg, tree_refs["T_global"])
    back = S.inverse_kinematics_T(Tg, SMPL_PARENTS)
    _close(back, tree_refs["T_back"])
    _close(back, tree_refs["T_local"])           # IK_T o FK_T = identity


def test_bone_vectors_and_joint_positions(data, tree_refs):
    pl = _t(data["p_local"])
    j = S.bone_vector_to_joint_position(pl, SMPL_PARENTS)
    _close(j, tree_refs["joints"])
    _close(S.joint_position_to_bone_vector(pl, SMPL_PARENTS),
           tree_refs["bones"])
    _close(S.joint_position_to_bone_vector(j, SMPL_PARENTS), pl)
    _close(S.joint_positions_from_global(_t(tree_refs["R_global"]), pl,
                                         SMPL_PARENTS),
           tree_refs["from_global"])


def test_parametric_model_wrappers(data, bodies, tree_refs):
    jb, tb = bodies
    pose, pl = data["pose"], data["p_local"]
    Rg = tree_refs["R_global"]
    cases = [
        ("bone_vector_to_joint_position", pl),
        ("joint_position_to_bone_vector", pl),
        ("forward_kinematics_R", pose),
        ("inverse_kinematics_R", Rg),
        ("forward_kinematics_T", tree_refs["T_local"]),
        ("inverse_kinematics_T", tree_refs["T_global"]),
        ("joint_positions_from_global", Rg),
    ]
    for name, x in cases:
        want = jax.jit(getattr(jb, name))(jnp.asarray(x))
        _close(getattr(tb, name)(_t(x)), want)
    # position-only FK equals full FK's joints on the body's bones
    _, joints = tb.forward_kinematics(_t(pose))
    _close(tb.joint_positions_from_global(
        tb.forward_kinematics_R(_t(pose))), joints)


def test_save_obj_mesh_and_joint_names(bodies, tmp_path):
    jb, tb = bodies
    v = np.random.RandomState(1).randn(240, 3).astype(np.float32)
    jb.save_obj_mesh(v, str(tmp_path / "j.obj"))
    tb.save_obj_mesh(torch.tensor(v), str(tmp_path / "t.obj"))
    assert (tmp_path / "j.obj").read_text() == \
        (tmp_path / "t.obj").read_text()
    assert {k: int(m) for k, m in SMPLJoint.__members__.items()} == \
        {k: int(m) for k, m in JaxSMPLJoint.__members__.items()}


# ---------------------------------------------------------------------------
# Data, config, model utilities
# ---------------------------------------------------------------------------

def test_make_combo_imu(data):
    for combo in ((1, 0, 0, 1, 0), (0, 1, 1, 0, 1)):
        mask = np.asarray(combo, np.float32)
        _close(make_combo_imu(_t(data["acc"]), _t(data["ori"]), _t(mask)),
               jax_make_combo_imu(jnp.asarray(data["acc"]),
                                  jnp.asarray(data["ori"]),
                                  jnp.asarray(mask)), tol=0)


def test_config_properties():
    assert C.paths.weights_file == JC.paths.weights_file
    assert C.model_config.n_pose_output == JC.model_config.n_pose_output
    assert C.amass.combos == JC.amass.combos
    assert C.amass.ignored_joints == JC.amass.ignored_joints
    assert C.joint_set.n_full == JC.joint_set.n_full == 24
    assert C.joint_set.n_ignored == JC.joint_set.n_ignored


def test_reduced_pose_to_full(data):
    x = data["rotm"].reshape(1, 1, -1).repeat(2, 0)[..., :16 * 9]
    x = np.concatenate([x, x[:, :, ::-1]], 1).copy()
    _close(mutils.reduced_pose_to_full(_t(x)),
           jutils.reduced_pose_to_full(jnp.asarray(x)), tol=0)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5, 11])
def test_smooth_avg(data, s):
    """Against the JAX function (even windows included), not a
    re-derivation."""
    _close(mutils.smooth_avg(_t(data["seq"]), s),
           jax.jit(lambda a: jutils.smooth_avg(a, s))(
               jnp.asarray(data["seq"])))


def test_normalize_and_concat(data):
    _close(mutils.normalize_and_concat(_t(data["glb_acc"]),
                                       _t(data["glb_ori"])),
           jax.jit(jutils.normalize_and_concat)(
               jnp.asarray(data["glb_acc"]), jnp.asarray(data["glb_ori"])))


@pytest.mark.parametrize("effective", [False, True])
def test_reduced_r6d_to_global(data, effective):
    _close(net.reduced_r6d_to_global(_t(data["r6d_red"]), effective),
           jax.jit(lambda x: jnet.reduced_r6d_to_global(x, effective))(
               jnp.asarray(data["r6d_red"])))


def test_reduced_global_to_full(data, bodies):
    """The array-of-structures assembly against the JAX one, and the
    port's streaming (SoA) assembly against the port's AoS one."""
    jb, tb = bodies
    x = _t(data["r6d_red"])
    aos = net.reduced_global_to_full(x, tb)
    _close(aos, jax.jit(lambda r: jnet.reduced_global_to_full(r, jb))(
        jnp.asarray(data["r6d_red"])))
    _close(net.reduced_global_to_full_soa(x, tb), aos.numpy(), tol=1e-6)
