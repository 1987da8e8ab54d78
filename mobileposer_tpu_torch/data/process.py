"""Raw-dataset processing: AMASS, DIP-IMU, TotalCapture and IMUPoser into
the reference's processed `.pt` files (counterpart of
`mobileposer_tpu/data/process.py`; reference `mobileposer/process.py:37-341`).

The host does the file IO and the sequence bookkeeping exactly as the JAX
package does; the math (alignment, FK and skinning, the virtual IMUs, the
NaN fill, the bias removal) runs on the given device, the CUDA card unless
the caller names another, through `data/synthesis.py`. The skinned mesh
stays on the device: only the 6 tracked vertices are gathered there, and
only the stored channels come back to the host.

The math runs in float64 from the float32 values read, and the outputs
are stored in float32. The acceleration stencil multiplies the vertices'
rounding by up to 4 * fps^2 = 3,600, so in float32 the boundary frames
carry ~1e-5 of max|acc| of rounding noise, which differs from device to
device: on an H100 against the CPU, with `chip_smoke.py`'s near-pi AMASS
sequence of the 6,890-vertex body, the chain in float32 left acc 1.14e-5
of its largest magnitude apart and float64 skinning alone 1.03e-5 (the
rotations' last bits, sin, cos and the log map of roots turned near pi,
differing too); in float64 throughout, 0.0.

Outputs use the reference's processed `.pt` schema (process.py:113-121)
with CPU tensors, so the JAX package's and the port's loaders read them.
"""

from __future__ import annotations

import glob
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.data import synthesis as S
from mobileposer_tpu_torch.device import resolve_device
from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.kinematics.smpl import ParametricModel

TARGET_FPS = C.datasets.fps

# Frames per FK + skinning call, chosen by memory: each frame holds, per
# mesh vertex, the blended rotation R_v and the einsum's copy of it (2 x 9
# float64 values) and four [3] vectors (t_v, R_v @ v, the skinned and the
# translated vertex). A chunk is held to FK_MESH_BYTES of these: 649
# frames of the 6,890-vertex body. The values do not depend on the chunk.
_LBS_BYTES_PER_VERTEX = 8 * (2 * 9 + 4 * 3)
FK_MESH_BYTES = 1 << 30


def fk_mesh_chunk(num_vertices: int) -> int:
    """Frames per FK + skinning call for a body of `num_vertices`."""
    return max(1, FK_MESH_BYTES // (_LBS_BYTES_PER_VERTEX * num_vertices))


def _fk_mesh_chunked(body: ParametricModel, pose: torch.Tensor,
                     shape: Optional[torch.Tensor],
                     tran: Optional[torch.Tensor], mesh: bool = True):
    """FK (+ skinning) of a whole sequence in float64, in chunks of
    frames, on the pose's device: (global rotations [N,24,3,3], joints
    [N,24,3], the 6 tracked vertices [N,6,3] or None without `mesh`), all
    float64 on that device.
    """
    chunk = fk_mesh_chunk(body.num_vertices)
    vi = torch.as_tensor(S.tracked_vertex_indices(body.num_vertices),
                         device=pose.device)
    pose = pose.double()
    shape = None if shape is None else shape.double()
    grots, joints, verts = [], [], []
    for i in range(0, pose.shape[0], chunk):
        t = None if tran is None else tran[i:i + chunk].double()
        out = body.forward_kinematics(pose[i:i + chunk], shape=shape, tran=t,
                                      calc_mesh=mesh)
        grots.append(out[0])
        joints.append(out[1])
        if mesh:
            verts.append(out[2].index_select(1, vi))
    return (torch.cat(grots), torch.cat(joints),
            torch.cat(verts) if mesh else None)


def _f64(x, device) -> torch.Tensor:
    """A host array as a float64 tensor on `device`."""
    return torch.as_tensor(x, device=device, dtype=torch.float64)


def _np(x: torch.Tensor) -> np.ndarray:
    """A host float32 array."""
    return x.float().cpu().numpy()


def _synthesize(body: ParametricModel, pose_rot: torch.Tensor,
                shape: Optional[torch.Tensor], tran: Optional[torch.Tensor]):
    """FK + virtual IMU channels of one sequence (process.py:102-121), as
    host arrays: joints, the sensor joints' global rotations, the tracked
    vertices' acceleration and the foot contact."""
    grot, joint, vert = _fk_mesh_chunked(body, pose_rot, shape, tran)
    ji = torch.as_tensor(S.JI_MASK, device=grot.device)
    return (_np(joint), _np(grot.index_select(1, ji)),
            _np(S.synthesize_acceleration(vert)),
            _np(S.foot_ground_probs(joint)))


def _aa_to_rot(pose_aa: torch.Tensor) -> torch.Tensor:
    """[T, 24, 3] axis-angle -> [T, 24, 3, 3]."""
    return R.axis_angle_to_rotation_matrix(pose_aa.reshape(-1, 3)).reshape(
        -1, 24, 3, 3)


def _save_pt(data: Dict[str, list], path: Path) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: [torch.from_numpy(np.ascontiguousarray(x)) for x in v]
                for k, v in data.items()}, path)
    return path


def process_amass(body: Optional[ParametricModel] = None,
                  amass_datasets: Optional[List[str]] = None,
                  raw_dir=None, out_dir=None, device=None) -> List[Path]:
    """AMASS -> synthetic-IMU training data (reference: process.py:37-127)."""
    device = resolve_device(device)
    body = body or ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    raw_dir = Path(raw_dir or C.paths.raw_amass)
    out_dir = Path(out_dir or C.paths.processed_datasets)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for ds_name in (amass_datasets or C.datasets.amass_datasets):
        out_path = out_dir / f"{ds_name}.pt"
        if out_path.exists():
            continue
        seq_pose, seq_tran, seq_shape = [], [], []
        for npz_fname in sorted(glob.glob(
                str(raw_dir / ds_name / "*/*_poses.npz"))):
            try:
                cdata = np.load(npz_fname)
            except Exception:
                continue
            framerate = int(cdata["mocap_framerate"])
            if framerate not in (120, 60, 59):
                continue
            step = S.downsample_step(framerate)
            pose = cdata["poses"][::step].astype(np.float32).reshape(-1, 52, 3)
            # merge the right index finger into joint 23, keep the body
            # joints (process.py:89-91)
            pose[:, 23] = pose[:, 37]
            pose = pose[:, :24]
            seq_pose.append(pose)
            seq_tran.append(cdata["trans"][::step].astype(np.float32))
            seq_shape.append(cdata["betas"][:10].astype(np.float32))
        if not seq_pose:
            print(f"AMASS dataset {ds_name}: no usable sequences")
            continue
        out = {k: [] for k in ("joint", "pose", "shape", "tran", "acc",
                               "ori", "contact")}
        for pose_aa, tran, shape in zip(seq_pose, seq_tran, seq_shape):
            if pose_aa.shape[0] <= 12:
                continue
            aligned_aa, tran_al = S.align_amass_to_dip(
                _f64(pose_aa, device), _f64(tran, device))
            p = _aa_to_rot(aligned_aa)
            joint, vrot, vacc, contact = _synthesize(
                body, p, _f64(shape, device), tran_al)
            out["pose"].append(_np(p))
            out["tran"].append(_np(tran_al))
            out["shape"].append(shape)
            out["joint"].append(joint)
            out["acc"].append(vacc)
            out["ori"].append(vrot)
            out["contact"].append(contact)
        written.append(_save_pt(out, out_path))
        print(f"Synthetic AMASS dataset saved: {out_path}")
    return written


def process_dipimu(split: str = "test", body: Optional[ParametricModel] = None,
                   raw_dir=None, out_dir=None, device=None) -> Path:
    """DIP-IMU -> finetune/eval data (reference: process.py:227-295)."""
    device = resolve_device(device)
    body = body or ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    raw_dir = Path(raw_dir or C.paths.raw_dip)
    out_dir = Path(out_dir or C.paths.eval_dir)
    imu_mask = [7, 8, 9, 10, 0, 2]
    subjects = (["s_09", "s_10"] if split == "test" else
                [f"s_{i:02d}" for i in range(1, 9)])
    step = S.downsample_step(60)
    out = {k: [] for k in ("joint", "pose", "shape", "tran", "acc", "ori")}
    for subject in subjects:
        sdir = raw_dir / subject
        if not sdir.exists():
            continue
        for motion in sorted(os.listdir(sdir)):
            path = sdir / motion
            try:
                with open(path, "rb") as f:
                    data = pickle.load(f, encoding="latin1")
                acc = np.asarray(data["imu_acc"], np.float32)[:, imu_mask]
                ori = np.asarray(data["imu_ori"], np.float32)[:, imu_mask]
                pose_aa = np.asarray(data["gt"], np.float32)
            except Exception as e:
                print(f"Error processing {path}: {e}")
                continue
            acc = _np(S.nan_fill_nearest(torch.as_tensor(acc, device=device)))
            ori = _np(S.nan_fill_nearest(torch.as_tensor(ori, device=device)))
            acc = acc[6:-6:step]
            ori = ori[6:-6:step]
            pose_aa = pose_aa[6:-6:step]
            if (np.isnan(acc).any() or np.isnan(ori).any()
                    or np.isnan(pose_aa).any()):
                print(f"DIP-IMU {subject}/{motion}: too many NaNs, discarded")
                continue
            shape = np.ones(10, np.float32)
            tran = np.zeros((pose_aa.shape[0], 3), np.float32)
            p = _aa_to_rot(_f64(pose_aa, device))
            # only the joints are stored: FK without the skinning
            _, joint, _ = _fk_mesh_chunked(
                body, p, torch.as_tensor(shape, device=device),
                torch.as_tensor(tran, device=device), mesh=False)
            out["acc"].append(acc)
            out["ori"].append(ori)
            out["pose"].append(_np(p))
            out["tran"].append(tran)
            out["shape"].append(shape)
            out["joint"].append(_np(joint))
    path = out_dir / f"dip_{split}.pt"
    _save_pt(out, path)
    print(f"Preprocessed DIP-IMU saved: {path}")
    return path


def _read_mocap_positions(pos_path: Path) -> np.ndarray:
    """LeftFoot, RightFoot and Spine positions [T, 3, 3] in inches from a
    TotalCapture `gt_skel_gbl_pos.txt`."""
    with open(pos_path) as f:
        header = f.readline().split("\t")
        idx = [header.index(k) for k in ("LeftFoot", "RightFoot", "Spine")]
        rows = []
        for line in f:
            cells = line.split("\t")[:-1]
            if not cells:
                continue
            rows.append([[float(v) for v in c.split(" ")] for c in cells])
    return np.asarray(rows, np.float32)[:, idx]


def process_totalcapture(body: Optional[ParametricModel] = None,
                         calibrated_dir=None, raw_official_dir=None,
                         amass_poses_dir=None, out_dir=None,
                         device=None) -> Path:
    """TotalCapture -> eval data with the accelerometer bias removed
    (reference: process.py:130-224)."""
    device = resolve_device(device)
    body = body or ParametricModel.from_file_or_synthetic(C.paths.smpl_file)
    calibrated_dir = Path(calibrated_dir or C.paths.calibrated_totalcapture)
    raw_official = Path(raw_official_dir or C.paths.raw_totalcapture_official)
    amass_dir = Path(amass_poses_dir
                     or (Path(C.paths.raw_amass) / "TotalCapture"))
    out_dir = Path(out_dir or C.paths.eval_dir)
    inches_to_meters = 0.0254
    subjects = ["S1", "S2", "S3", "S4", "S5"]

    accs, oris, poses, trans = [], [], [], []
    failed_to_process = set()
    for file in sorted(os.listdir(calibrated_dir)):
        if (not file.endswith(".pkl")
                or ("s5" in file and "acting3" in file)
                or not any(file.startswith(s.lower()) for s in subjects)):
            continue
        with open(calibrated_dir / file, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        ori = np.asarray(data["ori"], np.float32)
        acc = np.asarray(data["acc"], np.float32)
        subject, activity = file.split("_")[0], file.split("_")[1].split(".")[0]
        npz = amass_dir / subject.upper() / f"{activity}_poses.npz"
        try:
            pose_aa = np.load(npz)["poses"].astype(np.float32).reshape(-1, 52, 3)
        except Exception:
            # the trans loop below must skip this motion too, or every
            # later trans[i] pairs with the wrong sequence (reference:
            # process.py:161-163, failed_to_process)
            failed_to_process.add(f"{subject}_{activity}")
            print(f"Failed to process: {file}")
            continue
        pose_aa[:, 23] = pose_aa[:, 37]
        pose_aa = pose_aa[:, :24]
        n = min(acc.shape[0], pose_aa.shape[0])
        acc, ori, pose_aa = acc[:n], ori[:n], pose_aa[:n]
        # the calibrated IMU data is in the DIP frame, raw AMASS is z-up:
        # the rotation process_amass applies
        aligned_aa, _ = S.align_amass_to_dip(
            _f64(pose_aa, device),
            torch.zeros((n, 3), device=device, dtype=torch.float64))
        accs.append(acc)
        oris.append(ori)
        poses.append(_aa_to_rot(aligned_aa))

    # global positions from the official mocap (translation ground truth)
    for subject in subjects:
        sdir = raw_official / subject
        if not sdir.exists():
            continue
        for motion in sorted(os.listdir(sdir)):
            if ((subject == "S5" and motion == "acting3")
                    or motion.startswith(".")
                    or f"{subject.lower()}_{motion}" in failed_to_process):
                continue
            pos = _read_mocap_positions(
                sdir / motion / "gt_skel_gbl_pos.txt") * inches_to_meters
            pos[:, :, 0] *= -1
            pos[:, :, 2] *= -1
            trans.append(pos[:, 2] - pos[:1, 2])

    # pairing guard (reference: process.py:202-205): both lists were built
    # over the same motions in the same sorted order; a mismatch would pair
    # translations with the wrong sequences, so fail loudly
    assert len(accs) == len(trans), (
        f"TotalCapture pairing desync: {len(accs)} IMU sequences vs "
        f"{len(trans)} mocap translations")
    for i in range(len(accs)):
        if accs[i].shape[0] < trans[i].shape[0]:
            trans[i] = trans[i][:accs[i].shape[0]]
        assert trans[i].shape[0] == accs[i].shape[0], (
            f"sequence {i}: trans has {trans[i].shape[0]} frames, "
            f"imu has {accs[i].shape[0]}")
        # per-channel accelerometer bias against the synthetic
        # acceleration (process.py:207-214)
        _, _, vert = _fk_mesh_chunked(body, poses[i], None,
                                      _f64(trans[i], device))
        accs[i] = _np(S.remove_acceleration_bias(
            _f64(accs[i], device),
            S.synthesize_acceleration(vert)))

    path = out_dir / "totalcapture.pt"
    _save_pt({"acc": accs, "ori": oris, "pose": [_np(p) for p in poses],
              "tran": trans}, path)
    print(f"Preprocessed TotalCapture saved: {path}")
    return path


def process_imuposer(split: str = "train", body=None, raw_dir=None,
                     out_dir=None, device=None) -> Path:
    """IMUPoser -> train/eval data (reference: process.py:298-341)."""
    device = resolve_device(device)
    raw_dir = Path(raw_dir or C.paths.raw_imuposer)
    out_dir = Path(out_dir or C.paths.eval_dir)
    subjects = ([f"P{i}" for i in range(1, 9)] if split == "train"
                else ["P9", "P10"])
    out = {k: [] for k in ("acc", "ori", "pose", "tran")}
    for pid_path in sorted(raw_dir.iterdir() if raw_dir.exists() else []):
        if pid_path.name not in subjects:
            continue
        for fpath in sorted(pid_path.iterdir()):
            with open(fpath, "rb") as f:
                fdata = pickle.load(f)
            imu = np.asarray(fdata["imu"], np.float32)
            acc = imu[:, :5 * 3].reshape(-1, 5, 3)
            ori = imu[:, 5 * 3:].reshape(-1, 5, 3, 3)
            pose_aa = np.asarray(fdata["pose"], np.float32)
            tran = np.asarray(fdata["trans"], np.float32)
            p, tran = S.align_imuposer_to_dip(
                _aa_to_rot(_f64(pose_aa, device)), _f64(tran, device))
            out["acc"].append(acc)
            out["ori"].append(ori)
            out["pose"].append(_np(p))
            out["tran"].append(_np(tran))
    path = out_dir / f"imuposer_{split}.pt"
    _save_pt(out, path)
    print(f"Preprocessed IMUPoser saved: {path}")
    return path
