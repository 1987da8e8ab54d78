"""Sensor data model: wire-format parsing, ring buffers, frame calibration
(the port's copy of `mobileposer_tpu/stream/sensor.py`, host numpy code).

Behavioral parity target: reference `mobileposer/utils/sensor_utils.py`
(SensorData, process_data, sensor2global) and the constants of
`mobileposer/constants.py:13-27`. scipy escapes are replaced with the local
numpy quaternion helpers (stream/quat_np.py).
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.stream import quat_np as Q

# Wire-format constants (reference: constants.py:13-27).
KEYS = ("unix_timestamp", "sensor_timestamp",
        "accel_x", "accel_y", "accel_z",
        "quart_x", "quart_y", "quart_z", "quart_w",
        "roll", "pitch", "yaw")
STOP = "stop"
SEP = ":"
OUT_UDP_PORT = 7777
OUT_UDP_IP = "127.0.0.1"
HOST = "0.0.0.0"
PORTS = (8001, 8002, 8003, 8004, 8005)
CHUNK = 2048
BUFFER_SIZE = 50
MIN_TIME_DIFF = 1 / 25.6          # rebroadcast rate limit, seconds

DEVICE_IDS = C.sensor.id_map      # name -> slot id
# Device types whose axes get remapped into the phone convention. NOTE: the
# reference guards this with `device_name == Devices.Right_Headphone`
# (sensor_utils.py:115) — an int-vs-Enum comparison that is always False, so
# its remap is dead code; we implement the evident intent (remap earbuds).
HEADPHONE_TYPES = ("headphone",)


class SensorData:
    """Per-device ring buffers + timestamp re-referencing + calibration
    (reference: sensor_utils.py:9-75)."""

    def __init__(self, buffer_size: int = BUFFER_SIZE):
        ids = list(DEVICE_IDS.values())
        self.raw_acc_buffer = {i: collections.deque(
            np.zeros((buffer_size, 3)), maxlen=buffer_size) for i in ids}
        self.raw_ori_buffer = {i: collections.deque(
            np.tile(np.array([0.0, 0, 0, 1]), (buffer_size, 1)),
            maxlen=buffer_size) for i in ids}
        self.calibration_quats = {i: np.array([0.0, 0, 0, 1]) for i in ids}
        self.virtual_acc = {i: np.zeros((1, 3)) for i in ids}
        self.virtual_ori = {i: np.array([0.0, 0, 0, 1]) for i in ids}
        self.reference_times: Dict[int, Optional[list]] = {i: None for i in ids}

    def update(self, device_id: int, curr_acc, curr_ori, timestamps) -> float:
        if self.reference_times[device_id] is None:
            self.reference_times[device_id] = [timestamps[0], timestamps[1]]
        ref = self.reference_times[device_id]
        curr_timestamp = ref[0] + timestamps[1] - ref[1]
        self.raw_acc_buffer[device_id].append(np.asarray(curr_acc).flatten())
        self.raw_ori_buffer[device_id].append(np.asarray(curr_ori).flatten())
        return curr_timestamp

    def calibrate(self, n_frames: int = 30) -> None:
        """Mean orientation over the last n frames becomes the device's
        global inertial frame (reference: sensor_utils.py:51-61)."""
        for _id, buf in self.raw_ori_buffer.items():
            if len(buf) < n_frames:
                print(f"Not enough data to calibrate for device {_id}.")
                continue
            self.calibration_quats[_id] = Q.quat_mean(np.array(buf)[-n_frames:])

    def get_orientation(self, device_id: int) -> np.ndarray:
        return self.raw_ori_buffer[device_id][-1]

    def get_acceleration(self, device_id: int) -> np.ndarray:
        return self.raw_acc_buffer[device_id][-1]

    def update_virtual(self, device_id: int, glb_acc, glb_ori) -> None:
        self.virtual_acc[device_id] = np.asarray(glb_acc).reshape(1, 3)
        self.virtual_ori[device_id] = np.asarray(glb_ori)


def process_message(message: bytes):
    """Parse one `device;type:floats` packet (reference:
    sensor_utils.py:77-121). Returns (send_str, device_slot, acc [1,3],
    ori_quat_xyzw [1,4], timestamps [2]) or None for invalid/stop packets."""
    message = message.strip()
    if not message:
        return None
    try:
        text = message.decode("utf-8")
    except UnicodeDecodeError:
        return None
    if text == STOP or SEP not in text:
        return None
    try:
        device_id, raw = text.split(";")
        device_type, data_str = raw.split(":")
    except ValueError:
        return None
    data = []
    for d in data_str.strip().split(" "):
        try:
            data.append(float(d))
        except ValueError:
            continue
    if len(data) not in (len(KEYS), len(KEYS) - 3):
        return None
    name = f"{device_id.capitalize()}_{device_type}"
    if name not in DEVICE_IDS:
        return None
    slot = DEVICE_IDS[name]
    send_str = f"w{data[8]}wa{data[5]}ab{data[6]}bc{data[7]}c"
    curr_acc = np.array(data[2:5]).reshape(1, 3)
    curr_ori = np.array(data[5:9]).reshape(1, 4)
    timestamps = data[:2]

    if device_type.lower() in HEADPHONE_TYPES:
        # headphone axes are remapped into the phone convention
        # (reference: sensor_utils.py:115-119)
        e = Q.euler_xyz_from_quat(curr_ori[0])
        fixed = np.array([[-e[0], e[2], e[1]]])
        curr_ori = Q.quat_from_euler_xyz(fixed).reshape(1, 4)
        curr_acc = np.array([[-curr_acc[0, 0], curr_acc[0, 2], curr_acc[0, 1]]])
    return send_str, slot, curr_acc, curr_ori, timestamps


def sensor2global(ori_quat: np.ndarray, acc: np.ndarray,
                  calibration_quats: Dict[int, np.ndarray], device_id: int):
    """Rotate one device's measurement into its calibrated global inertial
    frame (reference: sensor_utils.py:124-136)."""
    og_mat = Q.quat_to_matrix(np.asarray(ori_quat).reshape(4))
    frame = Q.quat_to_matrix(np.asarray(calibration_quats[device_id]).reshape(4))
    global_mat = frame.T @ og_mat
    global_ori = Q.matrix_to_quat(global_mat)
    acc = np.asarray(acc).reshape(3)
    global_acc = frame.T @ (og_mat @ acc)
    return global_ori, global_acc


def encode_packet(device: str, device_type: str, timestamps, acc, quat) -> bytes:
    """Inverse of process_message — used by the fake-sensor replayer."""
    vals = list(timestamps) + list(np.asarray(acc).flatten()) + \
        list(np.asarray(quat).flatten()) + [0.0, 0.0, 0.0]
    return f"{device};{device_type}:{' '.join('%g' % v for v in vals)}".encode()
