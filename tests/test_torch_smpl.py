"""The port's SMPL body against the JAX package's, on the CPU: the
official-file loader on a chumpy-style pickle written here (chumpy not
installed), `from_file_or_synthetic`, and forward kinematics with shape
parameters and pose blend shapes.

Arrays are made with numpy from a seed. Tolerances: the loaders' arrays
are identical; FK and skinning 1e-5, the pin of tests/test_torch_eval.py
for float32 tree products.
"""

import pickle
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mobileposer_tpu.kinematics import rotation as JR
from mobileposer_tpu.kinematics import smpl as jax_smpl
from mobileposer_tpu_torch.kinematics import smpl
from mobileposer_tpu_torch.models import MobilePoserNet

ATOL = 1e-5
V = 240


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops: one torch thread beside other busy test processes, as
    tests/test_torch_eval.py runs them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays(seed=3):
    """Synthetic body arrays with nonzero pose blend shapes (the synthetic
    body's posedirs are zero, so they would test nothing)."""
    a = smpl.synthetic_smpl_arrays(num_vertices=V)
    rng = np.random.RandomState(seed)
    a["posedirs"] = (rng.uniform(-0.01, 0.01, (V, 3, 207))
                     .astype(np.float32))
    return a


@pytest.fixture(scope="module")
def smpl_file(tmp_path_factory):
    """An official-style pickle: chumpy `Ch` objects for the fields the
    official file keeps in chumpy, a kintree_table whose root parent is
    0xffffffff; chumpy removed before loading."""
    arrays = _arrays()
    fake = types.ModuleType("chumpy")
    exec("class Ch:\n    def __init__(self, x):\n        self.x = x\n",
         fake.__dict__)
    sys.modules["chumpy"] = fake
    try:
        data = {
            "J_regressor": arrays["J_regressor"],
            "weights": arrays["weights"],
            "posedirs": fake.Ch(arrays["posedirs"]),
            "shapedirs": fake.Ch(arrays["shapedirs"]),
            "v_template": fake.Ch(arrays["v_template"]),
            "J": fake.Ch(arrays["J"]),
            "f": arrays["f"],
            "kintree_table": np.stack([
                np.array([0xffffffff] + list(arrays["parents"][1:]),
                         np.int64),
                np.arange(24)]),
        }
        path = tmp_path_factory.mktemp("smpl") / "basicmodel_m.pkl"
        with open(path, "wb") as f:
            pickle.dump(data, f)
    finally:
        del sys.modules["chumpy"]            # chumpy is not installed
    return path, arrays


def test_loaders_give_identical_arrays(smpl_file):
    path, arrays = smpl_file
    got = smpl.load_smpl_arrays(str(path))
    assert "chumpy" not in sys.modules       # the port's loader leaves it
    try:
        want = jax_smpl.load_smpl_arrays(str(path))
    finally:
        sys.modules.pop("chumpy", None)      # the JAX loader's shim
        for sub in ("ch", "ch_ops", "reordering"):
            sys.modules.pop(f"chumpy.{sub}", None)
    assert got.keys() == want.keys()
    for k in got:
        if k == "parents":
            assert got[k] == want[k] == tuple(arrays["parents"])
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["posedirs"], arrays["posedirs"])


def test_from_file_or_synthetic(smpl_file, tmp_path):
    path, arrays = smpl_file
    body = smpl.ParametricModel.from_file_or_synthetic(path)
    np.testing.assert_array_equal(body._v_template, arrays["v_template"])
    np.testing.assert_array_equal(body.face, arrays["f"])
    assert body.num_vertices == V and body.num_joints == 24
    assert body.parent == tuple(arrays["parents"])
    # absent file: the synthetic body, bit for bit
    syn = smpl.ParametricModel.from_file_or_synthetic(tmp_path / "none.pkl")
    np.testing.assert_array_equal(
        syn._J, smpl.ParametricModel.synthetic()._J)
    # keyword arguments reach the constructor either way
    assert smpl.ParametricModel.from_file_or_synthetic(
        path, use_pose_blendshape=True).use_pose_blendshape
    # the streaming net builds its body from the file
    net = MobilePoserNet(smpl.ParametricModel.from_file_or_synthetic(path),
                         device="cpu")
    j = arrays["J"] - arrays["J"][:1]
    np.testing.assert_array_equal(net.feet_pos, j[10:12])


def _poses(rng, n, scale=0.5):
    aa = (rng.randn(n * 24, 3) * scale).astype(np.float32)
    return np.array(JR.axis_angle_to_rotation_matrix(aa)).reshape(
        n, 24, 3, 3)


@pytest.mark.parametrize("blend", [False, True])
@pytest.mark.parametrize("shape_kind", ["none", "per_pose", "shared"])
def test_forward_kinematics_with_shape_matches_jax(smpl_file, shape_kind,
                                                   blend):
    """Shape parameters per pose, one shape for the batch, or none; pose
    blend shapes on and off: rotations, joints and vertices at 1e-5."""
    path, _ = smpl_file
    # the JAX body from the arrays the file holds (the loaders agree,
    # test_loaders_give_identical_arrays), the port's from the file
    jbody = jax_smpl.ParametricModel(_arrays(), use_pose_blendshape=blend)
    body = smpl.ParametricModel(str(path), use_pose_blendshape=blend)
    rng = np.random.RandomState(7)
    n = 6
    pose = _poses(rng, n)
    tran = rng.randn(n, 3).astype(np.float32)
    shape = {"none": None,
             "per_pose": (rng.randn(n, 10) * 2).astype(np.float32),
             "shared": (rng.randn(10) * 2).astype(np.float32)}[shape_kind]
    want = jbody.forward_kinematics(
        jnp.asarray(pose), shape=None if shape is None else jnp.asarray(shape),
        tran=jnp.asarray(tran), calc_mesh=True)
    got = body.forward_kinematics(
        torch.from_numpy(pose),
        shape=None if shape is None else torch.from_numpy(shape),
        tran=torch.from_numpy(tran), calc_mesh=True)
    for name, g, w in zip(("rotations", "joints", "vertices"), got, want):
        assert tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)
    if shape is not None:
        for g, w in zip(body.get_zero_pose_joint_and_vertex(
                            torch.from_numpy(shape)),
                        jbody.get_zero_pose_joint_and_vertex(
                            jnp.asarray(shape))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    # without the mesh: the same rotations and joints
    got2 = body.forward_kinematics(
        torch.from_numpy(pose),
        shape=None if shape is None else torch.from_numpy(shape))
    np.testing.assert_allclose(got2[0].numpy(), got[0].numpy(), atol=0)
    np.testing.assert_allclose(got2[1].numpy() + tran[:, None],
                               got[1].numpy(), atol=1e-6)


def test_pose_blend_shapes_move_the_mesh_only(smpl_file):
    """Blend shapes change vertices, never joints or rotations; at the
    identity pose they add nothing."""
    path, _ = smpl_file
    plain = smpl.ParametricModel(str(path))
    blended = smpl.ParametricModel(str(path), use_pose_blendshape=True)
    pose = torch.from_numpy(_poses(np.random.RandomState(8), 3))
    a, b = (m.forward_kinematics(pose, calc_mesh=True)
            for m in (plain, blended))
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    assert float((a[2] - b[2]).abs().max()) > 1e-3
    eye = torch.eye(3).expand(2, 24, 3, 3)
    a, b = (m.forward_kinematics(eye, calc_mesh=True)
            for m in (plain, blended))
    np.testing.assert_array_equal(a[2].numpy(), b[2].numpy())
