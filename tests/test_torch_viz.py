"""The port's offline viewers (`viz/viewer.py`, `viz/render.py`,
`cli/render.py`) against the JAX package's, on the CPU (`device="cpu"`).

`MotionDump` and `SMPLViewer` bundles equal the JAX ones key for key
(1e-6), with the same OBJ count and `pose.txt`; `load_bundle_joints`
(forward kinematics) equals the JAX one at 1e-5. The renderer draws with
PIL where the JAX package plots with matplotlib, so its frames are
counted, not compared. `SequenceLoader.run_offline` / `run_online` on
the trained fixture's weights equal the JAX `SequenceLoader` at the slice
tolerance, 5e-5.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.models import MobilePoserNet as JaxNet
from mobileposer_tpu.nn import load_from_npz
from mobileposer_tpu.viz import MotionDump as JaxDump
from mobileposer_tpu.viz import SMPLViewer as JaxViewer
from mobileposer_tpu.viz import SequenceLoader as JaxLoader
from mobileposer_tpu.viz.render import load_bundle_joints as jax_bundle_joints
from mobileposer_tpu_torch.cli import render as render_cli
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.kinematics import smpl as smpl_mod
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.nn.convert import params_from_jax
from mobileposer_tpu_torch.viz import (MotionDump, SMPLViewer, SequenceLoader,
                                       render_motion)
from mobileposer_tpu_torch.viz.render import load_bundle_joints

SLICE_TOL = 5e-5
_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")
T = 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bodies():
    return JaxBody.synthetic(num_vertices=240), \
        ParametricModel.synthetic(num_vertices=240)


@pytest.fixture(scope="module")
def motion(bodies):
    jb, _ = bodies
    rng = np.random.RandomState(4)
    from mobileposer_tpu.kinematics import rotation as JR
    aa = (rng.randn(2, T * 24, 3) * 0.3).astype(np.float32)
    pose_p, pose_t = (np.asarray(JR.axis_angle_to_rotation_matrix(a))
                      .reshape(T, 24, 3, 3) for a in aa)
    tran_p = np.cumsum(rng.randn(T, 3) * 0.02, 0).astype(np.float32)
    tran_t = np.cumsum(rng.randn(T, 3) * 0.02, 0).astype(np.float32)
    return pose_p, tran_p, pose_t, tran_t


def _load(path):
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("gt_tran", [False, True])
def test_smpl_viewer_bundle_equals_jax(bodies, motion, tmp_path, gt_tran):
    jb, tb = bodies
    pose_p, tran_p, pose_t, tran_t = motion
    jpath = JaxViewer(jb, tmp_path / "jax").view(
        pose_p, tran_p, pose_t, tran_t, gt_tran=gt_tran, name="v")
    tpath = SMPLViewer(tb, tmp_path / "torch", device="cpu").view(
        torch.tensor(pose_p), torch.tensor(tran_p), pose_t, tran_t,
        gt_tran=gt_tran, name="v")
    want, got = _load(jpath), _load(tpath)
    assert sorted(got) == sorted(want) == ["pose_p", "pose_t", "tran_p",
                                           "tran_t"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["tran_t"][:, 0] - tran_t[:, 0], 1.0,
                               atol=1e-6)
    for f in ("pose.txt", "tran.txt"):
        assert (tmp_path / "torch" / f).read_text() == \
            (tmp_path / "jax" / f).read_text()


def test_smpl_viewer_without_ground_truth(bodies, motion, tmp_path):
    _, tb = bodies
    pose_p, tran_p, _, _ = motion
    got = _load(SMPLViewer(tb, tmp_path, device="cpu").view(pose_p, tran_p))
    assert sorted(got) == ["pose_p", "tran_p"]


def test_motion_dump_obj_sequence(bodies, motion, tmp_path):
    """OBJ meshes every `stride` frames, skinned on the device: the same
    files as the JAX package's (coordinates written %f)."""
    jb, tb = bodies
    pose_p, tran_p, _, _ = motion
    n_j = JaxDump(jb, tmp_path / "jax").save_obj_sequence(pose_p, tran_p,
                                                          stride=5)
    n_t = MotionDump(tb, tmp_path / "torch", device="cpu").save_obj_sequence(
        torch.tensor(pose_p), tran_p, stride=5)
    assert n_t == n_j == 3
    names = sorted(p.name for p in (tmp_path / "torch").glob("*.obj"))
    assert names == ["frame_00000.obj", "frame_00005.obj", "frame_00010.obj"]
    for name in names:
        got = np.loadtxt(tmp_path / "torch" / name, usecols=(1, 2, 3),
                         max_rows=240)
        want = np.loadtxt(tmp_path / "jax" / name, usecols=(1, 2, 3),
                          max_rows=240)
        np.testing.assert_allclose(got, want, atol=2e-6)
        tail = (tmp_path / "torch" / name).read_text().split("\nf ", 1)[1]
        assert tail == (tmp_path / "jax" / name).read_text().split(
            "\nf ", 1)[1]
    # without translations, and the npz writer
    assert MotionDump(tb, tmp_path / "t2", device="cpu").save_obj_sequence(
        pose_p[:3], stride=10) == 1
    z = _load(MotionDump(tb, tmp_path / "t2", device="cpu").save_npz(
        "m", pose=torch.tensor(pose_p), tran=tran_p))
    np.testing.assert_array_equal(z["pose"], pose_p)


def test_load_bundle_joints_equals_jax(bodies, motion, tmp_path):
    jb, tb = bodies
    path = SMPLViewer(tb, tmp_path, device="cpu").view(*motion, name="b")
    _, jp, jt = jax_bundle_joints(str(path), jb)
    bundle, tp, tt = load_bundle_joints(str(path), tb, device="cpu")
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    np.testing.assert_allclose(tt, jt, atol=1e-5)
    _, tp2, tt2 = load_bundle_joints({"pose_p": bundle["pose_p"]}, tb,
                                     device="cpu")
    assert tt2 is None and tp2.shape == (T, 24, 3)


def test_render_motion(bodies, motion, tmp_path):
    _, tb = bodies
    path = SMPLViewer(tb, tmp_path / "dump", device="cpu").view(*motion,
                                                                name="v")
    out = render_motion(path, tmp_path / "render", body=tb, stride=4,
                        gif=True, device="cpu")
    assert out.name == "motion.gif" and out.exists()
    pngs = sorted((tmp_path / "render").glob("frame_*.png"))
    assert [p.name for p in pngs] == ["frame_00000.png", "frame_00004.png",
                                      "frame_00008.png"]
    with Image.open(out) as gif:
        assert gif.n_frames == 3
    with Image.open(pngs[0]) as png:
        assert png.size == (480, 480)
        # the skeletons were drawn: not a blank frame
        assert len(png.getcolors(maxcolors=1 << 16)) > 1
    assert render_motion(path, tmp_path / "r2", body=tb, stride=100,
                         device="cpu") == tmp_path / "r2"


def test_cli_render(bodies, motion, tmp_path, monkeypatch):
    _, tb = bodies
    path = SMPLViewer(tb, tmp_path / "dump", device="cpu").view(*motion,
                                                                name="v")
    monkeypatch.setattr(smpl_mod.ParametricModel, "from_file_or_synthetic",
                        classmethod(lambda cls, *a, **k: tb))
    render_cli.main([str(path), "--out", str(tmp_path / "cli"), "--stride",
                     "3", "--gif", "--device", "cpu"])
    assert len(list((tmp_path / "cli").glob("frame_*.png"))) == 4
    assert (tmp_path / "cli" / "motion.gif").exists()


@pytest.fixture(scope="module")
def loaders(bodies):
    jb, tb = bodies
    tree = load_from_npz(_FIXTURE)
    jax_loader = JaxLoader(JaxNet(body_model=jb), tree)
    loader = SequenceLoader(MobilePoserNet(tb, device="cpu"),
                            params_from_jax(tree, device="cpu"),
                            device="cpu")
    imu = (np.random.RandomState(9).randn(48, 60) * 0.1).astype(np.float32)
    return jax_loader, loader, imu


def test_sequence_loader_offline(loaders):
    jax_loader, loader, imu = loaders
    want = jax_loader.run_offline(imu)
    got = loader.run_offline(torch.tensor(imu))
    for name, g, w in zip(("pose", "joints", "tran", "contact"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=SLICE_TOL, err_msg=name)


def test_sequence_loader_online(loaders):
    jax_loader, loader, imu = loaders
    want = jax_loader.run_online(imu[:16])
    got = loader.run_online(imu[:16])
    for name, g, w in zip(("pose", "tran"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=SLICE_TOL, err_msg=name)
