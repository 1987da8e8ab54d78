"""The port's raw-data processing against the JAX package on the CPU: the
synthesis helpers (alignment near pi, the NaN fill, the bias removal),
the four processors and `cli.process` on the same raw-format fixtures,
and each package reading the other's processed files.

The raw fixtures are written here with numpy from a seed, in the layouts
of the public datasets (AMASS `*_poses.npz`, DIP-IMU and TotalCapture
pickles, TotalCapture's `gt_skel_gbl_pos.txt`, IMUPoser pickles of
tensors); both packages run on a 240-vertex synthetic body. Tolerances:
`pose`, `ori`, `joint`, `tran` (and `shape`) within 1e-5; `acc` within
1e-5 of its own largest magnitude (second differences of vertex positions
times fps^2 = 900); `contact` exact on every frame whose foot displacement
is more than 1e-6 from the 0.008 threshold.
"""

import contextlib
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mobileposer_tpu.cli import process as jax_process_cli
from mobileposer_tpu.data import load_processed_file as jax_load
from mobileposer_tpu.data import synthesis as JS
from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.kinematics import rotation as JR
from mobileposer_tpu_torch.cli import process as process_cli
from mobileposer_tpu_torch.data import load_processed_file
from mobileposer_tpu_torch.data import process as P
from mobileposer_tpu_torch.data import synthesis as S
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.kinematics import rotation as R

ATOL = 1e-5
ACC_RTOL = 1e-5
CONTACT_BAND = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the CPU path is many small ops, which torch's
    thread pool slows down beside other busy test processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bodies():
    return JaxBody.synthetic(num_vertices=240), ParametricModel.synthetic(
        num_vertices=240)


def _aa(rng, T, joints=52, scale=0.1):
    return (rng.standard_normal((T, joints * 3)) * scale).astype(np.float32)


def _near_pi_root(rng, poses):
    """Root rotations of angle 3.0 to 3.14 rad about random axes."""
    T = poses.shape[0]
    axis = rng.standard_normal((T, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    poses[:, :3] = axis * rng.uniform(3.0, 3.14, (T, 1))
    return poses


def _amass_npz(path, rng, T, fps, near_pi=False):
    """An AMASS sequence; `near_pi`: smooth motion (integrated twists,
    whose accelerations are small beside the rounding the stencil
    amplifies) with roots turned by 3.0 to 3.14 rad."""
    path.parent.mkdir(parents=True, exist_ok=True)
    poses = _aa(rng, T)
    if near_pi:
        poses = np.cumsum(poses * 0.05, axis=0)
        poses[:, :3] = np.array([0.6, 0.0, 0.8], np.float32) * np.linspace(
            3.0, 3.14, T, dtype=np.float32)[:, None]
    np.savez(path, poses=poses,
             trans=np.cumsum(rng.normal(0, 0.02, (T, 3)), 0).astype(np.float32),
             betas=(rng.standard_normal(16) * 0.5).astype(np.float32),
             mocap_framerate=np.float64(fps))


def _dip_pkl(path, rng, T, nan_frames=()):
    path.parent.mkdir(parents=True, exist_ok=True)
    acc = rng.standard_normal((T, 17, 3))
    ori = rng.standard_normal((T, 17, 3, 3))
    for t in nan_frames:
        acc[t, 7] = np.nan
        ori[t, 0, 1] = np.nan
    with open(path, "wb") as f:
        pickle.dump({"imu_acc": acc, "imu_ori": ori,
                     "gt": _aa(rng, T, joints=24, scale=0.3)}, f)


def write_raw(root: Path, rng) -> dict:
    """Raw-format fixtures of the four datasets; returns their dirs."""
    d = {"amass": root / "AMASS", "dip": root / "DIP_IMU",
         "tc_imu": root / "TC_IMU", "tc_raw": root / "TC_raw",
         "imuposer": root / "IMUPoser"}
    a = d["amass"]
    _amass_npz(a / "ACCAD" / "s1" / "walk_poses.npz", rng, 80, 60)
    _amass_npz(a / "ACCAD" / "s1" / "turn_poses.npz", rng, 160, 120,
               near_pi=True)
    _amass_npz(a / "ACCAD" / "s1" / "skip_poses.npz", rng, 30, 100)
    _amass_npz(a / "ACCAD" / "s1" / "short_poses.npz", rng, 24, 60)
    _amass_npz(a / "ACCAD" / "s2" / "run_poses.npz", rng, 70, 59)
    (a / "ACCAD" / "s2" / "broken_poses.npz").write_bytes(b"not an npz")
    _amass_npz(a / "CMU" / "s1" / "jump_poses.npz", rng, 50, 60)
    # DIP-IMU at 60 Hz: a short NaN burst, NaNs on the first and last
    # frames, a run too long for the fill (discarded), an unreadable file
    _dip_pkl(d["dip"] / "s_09" / "01.pkl", rng, 130, nan_frames=(40, 41, 42))
    _dip_pkl(d["dip"] / "s_09" / "02.pkl", rng, 90, nan_frames=(0, 89))
    _dip_pkl(d["dip"] / "s_10" / "01.pkl", rng, 100,
             nan_frames=range(30, 50))
    (d["dip"] / "s_10" / "02.pkl").write_bytes(b"garbage")
    _dip_pkl(d["dip"] / "s_01" / "01.pkl", rng, 110, nan_frames=(5,))
    # TotalCapture: two motions with AMASS poses, one without (the pairing
    # case), the official mocap of all three; the AMASS npz also feeds
    # `process_amass` as the "TotalCapture" dataset
    T = 40
    d["tc_imu"].mkdir(parents=True)
    for motion, n in (("acting1", T), ("aamissing", T), ("walking2", T + 3)):
        with open(d["tc_imu"] / f"s1_{motion}.pkl", "wb") as f:
            pickle.dump({"ori": rng.standard_normal((n, 6, 3, 3)),
                         "acc": rng.standard_normal((n, 6, 3))}, f)
    (d["tc_imu"] / "notes.txt").write_text("not a pickle")
    for motion, n in (("acting1", T), ("walking2", T)):
        _amass_npz(a / "TotalCapture" / "S1" / f"{motion}_poses.npz", rng,
                   n, 60)
    joints = ["LeftFoot", "RightFoot", "Spine", "Head"]
    for motion, rows in (("aamissing", T + 5), ("acting1", T + 2),
                         ("walking2", T + 3)):
        (d["tc_raw"] / "S1" / motion).mkdir(parents=True)
        with open(d["tc_raw"] / "S1" / motion / "gt_skel_gbl_pos.txt",
                  "w") as f:
            f.write("\t".join(joints) + "\t\n")
            for _ in range(rows):
                f.write("\t".join(" ".join("%g" % v for v in
                                           rng.standard_normal(3) * 40)
                                  for _ in joints) + "\t\n")
    # IMUPoser: pickles of tensors, train subject P1, test subject P9
    for pid, seqs in (("P1", (50,)), ("P9", (45, 30)), ("P12", (20,))):
        (d["imuposer"] / pid).mkdir(parents=True)
        for i, n in enumerate(seqs):
            imu = np.concatenate([
                rng.standard_normal((n, 15)).astype(np.float32),
                rng.standard_normal((n, 45)).astype(np.float32)], axis=1)
            with open(d["imuposer"] / pid / f"seq{i}.pkl", "wb") as f:
                pickle.dump({"imu": torch.from_numpy(imu),
                             "pose": torch.from_numpy(_aa(rng, n, 24, 0.3)),
                             "trans": torch.from_numpy(rng.standard_normal(
                                 (n, 3)).astype(np.float32))}, f)
    return d


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _env_for(raw: dict, processed: Path):
    return _env(MP_RAW_AMASS=raw["amass"], MP_RAW_DIP=raw["dip"],
                MP_RAW_IMUPOSER=raw["imuposer"], MP_RAW_TC=raw["tc_raw"],
                MP_CALIB_TC=raw["tc_imu"], MP_PROCESSED=processed)


@contextlib.contextmanager
def _bodies_patched(bodies):
    """Both packages' default body (the SMPL file, else the 6,890-vertex
    synthetic one) replaced by the 240-vertex fixture bodies."""
    jb, tb = bodies
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBody, "from_file_or_synthetic",
                   classmethod(lambda cls, f, **kw: jb))
        mp.setattr(ParametricModel, "from_file_or_synthetic",
                   classmethod(lambda cls, f, **kw: tb))
        yield


DATASETS = ("amass", "dip", "totalcapture", "imuposer", "synthetic")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    return write_raw(tmp_path_factory.mktemp("raw"),
                     np.random.default_rng(20))


@pytest.fixture(scope="module")
def jax_outputs(raw, bodies, tmp_path_factory):
    """The JAX CLI's processed files of every dataset: {name: path}."""
    out = tmp_path_factory.mktemp("jax_processed")
    with _env_for(raw, out), _bodies_patched(bodies):
        for ds in DATASETS:
            jax_process_cli.main(["--dataset", ds])
    return {str(p.relative_to(out)): p for p in sorted(out.rglob("*.pt"))}


def _contact_band(joint: np.ndarray) -> np.ndarray:
    """[T, 2] True where a foot's displacement lies within CONTACT_BAND
    of the 0.008 threshold (frame 0 is never in the band)."""
    band = np.zeros((joint.shape[0], 2), bool)
    for i, j in enumerate((10, 11)):
        disp = np.linalg.norm(joint[1:, j] - joint[:-1, j], axis=1)
        band[1:, i] = np.abs(disp - 0.008) <= CONTACT_BAND
    return band


def compare_processed(port_path, jax_path) -> dict:
    """Hold a processed file of the port to the JAX package's: the same
    keys, sequences, shapes and dtypes, values at the module's
    tolerances. Returns the largest errors and the contact frames left
    out for lying in the threshold band."""
    a = torch.load(port_path, map_location="cpu", weights_only=True)
    b = torch.load(jax_path, map_location="cpu", weights_only=False)
    assert sorted(a) == sorted(b)
    errs = {"excluded_contact_frames": 0}
    for k in b:
        assert len(a[k]) == len(b[k]), k
        for i, (x, y) in enumerate(zip(a[k], b[k])):
            x, y = x.numpy(), y.numpy()
            assert x.shape == y.shape and x.dtype == y.dtype, (k, i)
            if k == "contact":
                band = _contact_band(b["joint"][i].numpy())
                errs["excluded_contact_frames"] += int(band.sum())
                np.testing.assert_array_equal(x[~band], y[~band])
                continue
            tol = ATOL
            if k == "acc":
                scale = max(float(np.abs(y).max()), 1e-30)
                tol = ACC_RTOL * scale
            err = float(np.abs(x - y).max()) if x.size else 0.0
            assert err <= tol, (k, i, err, tol)
            if k == "acc":      # reported relative to its largest magnitude
                err /= scale
            errs[k] = max(errs.get(k, 0.0), err)
    return errs


def test_align_amass_to_dip_near_pi(bodies):
    """Root angles from 0.3 to 3.14 rad: the root is held as a rotation
    (the log map may hand back the other axis-angle of an angle ~ pi),
    the rest exactly, and the matrix the processor stores at 1e-5."""
    rng = np.random.default_rng(0)
    pose = _aa(rng, 64, joints=24, scale=0.3).reshape(64, 24, 3)
    pose[32:] = _near_pi_root(rng, pose[32:].reshape(32, 72)).reshape(
        32, 24, 3)
    # rows 48 on: roots whose aligned rotation is the one near pi
    target = R.axis_angle_to_rotation_matrix(torch.from_numpy(pose[48:, 0]))
    rot = torch.as_tensor(S.AMASS_ROT, dtype=torch.float32)
    pose[48:, 0] = R.rotation_matrix_to_axis_angle(rot.T @ target).numpy()
    tran = rng.standard_normal((64, 3)).astype(np.float32)
    ja, jt = JS.align_amass_to_dip(jnp.asarray(pose), jnp.asarray(tran))
    ta, tt = S.align_amass_to_dip(torch.from_numpy(pose),
                                  torch.from_numpy(tran))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    np.testing.assert_array_equal(ta[:, 1:].numpy(), np.asarray(ja)[:, 1:])
    jr = R.axis_angle_to_rotation_matrix(torch.from_numpy(
        np.array(ja[:, 0])))
    tr = R.axis_angle_to_rotation_matrix(ta[:, 0])
    assert float(R.angle_between(tr, jr).max()) < 1e-5
    np.testing.assert_allclose(tr.numpy(), jr.numpy(), atol=ATOL)
    # the JAX rotation of the JAX root is the port's
    np.testing.assert_allclose(
        np.asarray(JR.axis_angle_to_rotation_matrix(ja[:, 0])), tr.numpy(),
        atol=ATOL)
    assert float(np.linalg.norm(pose[32:48, 0], axis=1).min()) > 3.0
    assert float(torch.linalg.norm(ta[48:, 0], dim=1).min()) > 3.0


def test_align_imuposer_and_bias_match_jax():
    rng = np.random.default_rng(1)
    rot = R.axis_angle_to_rotation_matrix(torch.from_numpy(
        _aa(rng, 20, joints=24, scale=0.5).reshape(-1, 3))).reshape(
            20, 24, 3, 3)
    tran = rng.standard_normal((20, 3)).astype(np.float32)
    jp, jt = JS.align_imuposer_to_dip(jnp.asarray(rot.numpy()),
                                      jnp.asarray(tran))
    tp, tt = S.align_imuposer_to_dip(rot, torch.from_numpy(tran))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    real = rng.standard_normal((30, 6, 3)).astype(np.float32)
    virt = rng.standard_normal((30, 6, 3)).astype(np.float32) * 5
    np.testing.assert_allclose(
        S.remove_acceleration_bias(torch.from_numpy(real),
                                   torch.from_numpy(virt)).numpy(),
        np.asarray(JS.remove_acceleration_bias(jnp.asarray(real),
                                               jnp.asarray(virt))),
        atol=1e-6)
    for fps in (59, 60, 100, 120, 250, 15):
        assert S.downsample_step(fps) == JS.downsample_step(fps)


@pytest.mark.parametrize("case", ["burst", "first_last", "long_run",
                                  "all_nan"])
def test_nan_fill_matches_jax(case):
    """Four forward/backward passes: a burst of 3 fills, NaNs on the first
    and last frames fill from their one neighbour, a run of 20 keeps its
    middle NaN (as in JAX), an all-NaN channel stays NaN."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 6, 3)).astype(np.float32)
    nan_frames = {"burst": [10, 11, 12], "first_last": [0, 39],
                  "long_run": list(range(10, 30)), "all_nan": []}[case]
    x[nan_frames, 2] = np.nan
    if case == "all_nan":
        x[:, 4, 1] = np.nan
    want = np.asarray(JS.nan_fill_nearest(jnp.asarray(x)))
    got = S.nan_fill_nearest(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any() == (case in ("long_run", "all_nan"))


def test_fk_mesh_chunk_does_not_change_values(bodies, monkeypatch):
    """The chunked float64 FK + skinning gives the same values in chunks
    of 7 frames as in one chunk; the chunk size follows the memory rule."""
    body = bodies[1]
    rng = np.random.default_rng(3)
    pose = R.axis_angle_to_rotation_matrix(torch.from_numpy(
        _aa(rng, 30, joints=24, scale=0.3).reshape(-1, 3))).reshape(
            30, 24, 3, 3)
    shape = torch.from_numpy(rng.standard_normal(10).astype(np.float32))
    tran = torch.from_numpy(rng.standard_normal((30, 3)).astype(np.float32))
    whole = P._fk_mesh_chunked(body, pose, shape, tran)
    with monkeypatch.context() as m:     # chunks of 7 frames
        m.setattr(P, "FK_MESH_BYTES", 7 * 240 * 240)
        assert P.fk_mesh_chunk(240) == 7
        parts = P._fk_mesh_chunked(body, pose, shape, tran)
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    _, joints_only, none = P._fk_mesh_chunked(body, pose, shape, tran,
                                              mesh=False)
    assert none is None
    np.testing.assert_array_equal(joints_only.numpy(), whole[1].numpy())
    assert P.fk_mesh_chunk(6890) == (1 << 30) // (240 * 6890) == 649
    # the tracked vertices are the float64 mesh's (the 240-vertex body
    # wraps them), within float32 rounding of the float32 mesh
    _, _, v = bodies[1].forward_kinematics(pose.double(), shape.double(),
                                           tran.double(), calc_mesh=True)
    vi = S.tracked_vertex_indices(240)
    assert whole[2].dtype == torch.float64
    np.testing.assert_array_equal(whole[2].numpy(), v[:, vi].numpy())
    _, _, v32 = bodies[1].forward_kinematics(pose, shape, tran,
                                             calc_mesh=True)
    np.testing.assert_allclose(whole[2].numpy(), v32[:, vi].numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("name", ["amass", "dip_test", "dip_train",
                                  "totalcapture", "imuposer_train",
                                  "imuposer_test"])
def test_processor_matches_jax(name, raw, bodies, jax_outputs, tmp_path,
                               capsys):
    """Each processor called directly with explicit dirs and
    device='cpu', against the JAX CLI's file of the same raw data."""
    body = bodies[1]
    out = tmp_path / "eval"
    if name == "amass":
        written = P.process_amass(body=body, raw_dir=raw["amass"],
                                  out_dir=tmp_path, device="cpu")
        assert [p.name for p in written] == [
            "ACCAD.pt", "CMU.pt", "TotalCapture.pt"]
        pairs = [(p, jax_outputs[p.name]) for p in written]
        # an existing output is kept (process.py:51)
        assert P.process_amass(body=body, raw_dir=raw["amass"],
                               out_dir=tmp_path, device="cpu") == []
    elif name.startswith("dip"):
        split = name.split("_")[1]
        path = P.process_dipimu(split=split, body=body, raw_dir=raw["dip"],
                                out_dir=out, device="cpu")
        pairs = [(path, jax_outputs[f"eval/{name}.pt"])]
    elif name == "totalcapture":
        path = P.process_totalcapture(
            body=body, calibrated_dir=raw["tc_imu"],
            raw_official_dir=raw["tc_raw"],
            amass_poses_dir=raw["amass"] / "TotalCapture", out_dir=out,
            device="cpu")
        pairs = [(path, jax_outputs["eval/totalcapture.pt"])]
    else:
        path = P.process_imuposer(split=name.split("_")[1],
                                  raw_dir=raw["imuposer"], out_dir=out,
                                  device="cpu")
        pairs = [(path, jax_outputs[f"eval/{name}.pt"])]
    printed = capsys.readouterr().out
    counts = {}
    for mine, theirs in pairs:
        errs = compare_processed(mine, theirs)
        print(name, Path(mine).name, errs)
        counts[Path(mine).name] = len(torch.load(mine, weights_only=True)[
            "acc"])
    # the skips and discards of the fixtures
    expect = {"amass": {"ACCAD.pt": 3, "CMU.pt": 1, "TotalCapture.pt": 2},
              "dip_test": {"dip_test.pt": 2}, "dip_train": {"dip_train.pt": 1},
              "totalcapture": {"totalcapture.pt": 2},
              "imuposer_train": {"imuposer_train.pt": 1},
              "imuposer_test": {"imuposer_test.pt": 2}}[name]
    assert counts == expect
    if name == "dip_test":
        assert "s_10/01.pkl: too many NaNs, discarded" in printed
        assert "Error processing" in printed
    if name == "totalcapture":
        assert "Failed to process: s1_aamissing.pkl" in printed


def test_cli_process_matches_jax_cli(raw, bodies, jax_outputs,
                                     tmp_path):
    """`cli.process --device cpu` for every --dataset writes the files the
    JAX CLI writes, with the same values."""
    with _env_for(raw, tmp_path), _bodies_patched(bodies):
        for ds in DATASETS:
            process_cli.main(["--dataset", ds, "--device", "cpu"])
    mine = {str(p.relative_to(tmp_path)): p
            for p in sorted(tmp_path.rglob("*.pt"))}
    assert sorted(mine) == sorted(jax_outputs) == [
        "ACCAD.pt", "CMU.pt", "TotalCapture.pt", "eval/dip_test.pt",
        "eval/dip_train.pt", "eval/imuposer_test.pt",
        "eval/imuposer_train.pt", "eval/totalcapture.pt", "synthetic.pt"]
    for rel, path in mine.items():
        compare_processed(path, jax_outputs[rel])


def test_each_package_reads_the_others_files(jax_outputs, tmp_path, raw,
                                             bodies):
    """`load_processed_file` of each package on the other's output: the
    same sequences and arrays."""
    with _env_for(raw, tmp_path), _bodies_patched(bodies):
        process_cli.main(["--dataset", "dip", "--split", "test",
                          "--device", "cpu"])
        process_cli.main(["--dataset", "amass", "--device", "cpu"])
    for rel in ("eval/dip_test.pt", "ACCAD.pt"):
        mine = tmp_path / rel
        for a, b in ((jax_load(mine), load_processed_file(mine)),
                     (load_processed_file(jax_outputs[rel]),
                      jax_load(jax_outputs[rel]))):
            assert len(a) == len(b) > 0
            for sa, sb in zip(a, b):
                assert sorted(sa) == sorted(sb)
                for k in sa:
                    np.testing.assert_array_equal(sa[k], sb[k])


def test_process_needs_a_device_when_no_gpu(monkeypatch, raw, tmp_path):
    """Without a card the processors and the CLI raise unless given a
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: P.process_imuposer(raw_dir=raw["imuposer"],
                                            out_dir=tmp_path),
                 lambda: process_cli.main(["--dataset", "imuposer"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
