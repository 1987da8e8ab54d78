"""T-pose calibration math and per-frame input normalization (the port's
copy of `mobileposer_tpu/stream/calibration.py`, host numpy code).

Behavioral parity target: reference `mobileposer/live_demo.py:159-232`:
  * `smpl2imu`: transpose of the reference-IMU orientation held aligned with
    the body frame (live_demo.py:159-162)
  * `device2bone` / `acc_offsets`: per-device bone alignment + accelerometer
    bias from a 3 s T-pose hold (live_demo.py:165-174)
  * per-frame normalization: global-frame acc/ori, device->model slot
    reorder [1, 4, 3, 0, 2], combo zero-mask, flatten to the 60-dim model
    input (live_demo.py:210-232)

All host-side numpy (the per-frame math is tiny and latency-bound);
`normalize_frames` is also available batched.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.stream import quat_np as Q

# device slots (config.sensor) -> model slots [lw, rw, lp, rp, head]
# (reference: live_demo.py:216-217)
DEVICE_TO_MODEL_ORDER = np.array([1, 4, 3, 0, 2])
N_IMUS = 5


@dataclass
class Calibration:
    smpl2imu: np.ndarray       # [3, 3]
    device2bone: np.ndarray    # [5, 3, 3]
    acc_offsets: np.ndarray    # [5, 3, 1]

    def save(self, path):
        np.savez(path, smpl2imu=self.smpl2imu, device2bone=self.device2bone,
                 acc_offsets=self.acc_offsets)

    @classmethod
    def load(cls, path) -> "Calibration":
        z = np.load(path)
        return cls(z["smpl2imu"], z["device2bone"], z["acc_offsets"])


def compute_smpl2imu(reference_quat_wxyz: np.ndarray) -> np.ndarray:
    """Body-frame alignment from the reference IMU held with x=Left, y=Up,
    z=Forward (reference: live_demo.py:159-162). Input wxyz (the :7777 wire
    order)."""
    q = np.asarray(reference_quat_wxyz).reshape(4)
    mat = Q.quat_to_matrix(q[[1, 2, 3, 0]])     # wxyz -> xyzw
    return mat.T


def compute_device_calibration(smpl2imu: np.ndarray,
                               tpose_quats_wxyz: np.ndarray,
                               tpose_accs: np.ndarray) -> Calibration:
    """T-pose device2bone + accelerometer offsets (live_demo.py:165-174).

    tpose_quats_wxyz: [5, 4] mean orientation per device during the T-pose;
    tpose_accs: [5, 3] mean acceleration per device.
    """
    quats = np.asarray(tpose_quats_wxyz).reshape(N_IMUS, 4)
    oris = Q.quat_to_matrix(quats[:, [1, 2, 3, 0]])           # [5, 3, 3]
    device2bone = np.swapaxes(smpl2imu @ oris, 1, 2) @ np.eye(3)
    acc_offsets = smpl2imu @ np.asarray(tpose_accs).reshape(N_IMUS, 3, 1)
    return Calibration(np.asarray(smpl2imu), device2bone, acc_offsets)


def calibrate_frames(cal: Calibration, quats_wxyz: np.ndarray,
                     accs: np.ndarray):
    """[T, 5, 4] wxyz quats + [T, 5, 3] accels -> calibrated global-frame
    (glb_acc [T, 5, 3], glb_ori [T, 5, 3, 3]) in DEVICE slot order — the
    quantities the reference records as dev data (live_demo.py:210-213,
    266-275)."""
    quats = np.asarray(quats_wxyz).reshape(-1, N_IMUS, 4)
    accs = np.asarray(accs).reshape(-1, N_IMUS, 3)
    ori_raw = Q.quat_to_matrix(quats[..., [1, 2, 3, 0]])      # [T, 5, 3, 3]
    glb_acc = (cal.smpl2imu @ accs[..., None] - cal.acc_offsets)[..., 0]
    glb_ori = cal.smpl2imu @ ori_raw @ cal.device2bone
    return glb_acc, glb_ori


def normalize_frames(cal: Calibration, quats_wxyz: np.ndarray,
                     accs: np.ndarray, combo: str = "lw_rp") -> np.ndarray:
    """[T, 5, 4] wxyz quats + [T, 5, 3] accels -> [T, 60] model input
    (reference: live_demo.py:210-232)."""
    glb_acc, glb_ori = calibrate_frames(cal, quats_wxyz, accs)
    T = glb_acc.shape[0]

    _acc = glb_acc[:, DEVICE_TO_MODEL_ORDER] / C.amass.acc_scale
    _ori = glb_ori[:, DEVICE_TO_MODEL_ORDER]
    acc = np.zeros_like(_acc)
    ori = np.zeros_like(_ori)
    slots = list(C.COMBOS[combo])
    acc[:, slots] = _acc[:, slots]
    ori[:, slots] = _ori[:, slots]
    return np.concatenate([acc.reshape(T, -1), ori.reshape(T, -1)],
                          axis=1).astype(np.float32)


def identity_calibration() -> Calibration:
    """No-op calibration (tests / pre-calibrated replay data)."""
    return Calibration(np.eye(3),
                       np.tile(np.eye(3), (N_IMUS, 1, 1)),
                       np.zeros((N_IMUS, 3, 1)))
