"""Fake-sensor replayer: substitutes for real phones in tests/benchmarks
(the port's copy of `mobileposer_tpu/stream/replayer.py`).

The reference has no test fixture for its sensor path (SURVEY §4); this
replayer closes that gap. It can inject at two levels:

  * raw device level — sends `device;type:floats` packets to the frontend's
    ports 8001+ (exercising parsing, ring buffers, calibration, rebroadcast)
  * aligned frame level — sends 'acc#quat$' frames straight to :7777
    (exercising IMUSet + the live loop)

Sources: synthetic smooth motion, or a processed dataset sequence whose
virtual IMU channels are converted back to wire format.
"""

from __future__ import annotations

import socket
import time
from typing import Iterable, Optional, Sequence

import numpy as np

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.stream import quat_np as Q
from mobileposer_tpu_torch.stream.pacing import Pacer
from mobileposer_tpu_torch.stream.receiver import encode_rebroadcast
from mobileposer_tpu_torch.stream.sensor import PORTS, encode_packet


def synthetic_device_stream(n_frames: int, seed: int = 0, fps: float = 30.0):
    """Yield (slot, packet_bytes) raw packets for the 5 devices.

    The sensor timestamp is the stream's own clock, seconds since its
    first frame, as a device's sensor clock counts. The wire format
    prints 6 significant digits ('%g'), so a unix time there moves in
    steps of 10 s: the JAX package's stream sends the unix time in both
    fields, and the frontend, which paces its rebroadcast by the sensor
    timestamp, then forwards one frame per 10 s."""
    rng = np.random.default_rng(seed)
    names = list(C.sensor.id_map.keys())
    t0 = time.time()
    quats = np.tile(np.array([0.0, 0, 0, 1]), (5, 1))
    for f in range(n_frames):
        ts = t0 + f / fps
        for slot, name in enumerate(names):
            device, dtype = name.split("_")
            # small random walk on orientation
            d = rng.normal(0, 0.01, 3)
            dq = Q.quat_from_euler_xyz(d)
            m = Q.quat_to_matrix(dq) @ Q.quat_to_matrix(quats[slot])
            quats[slot] = Q.matrix_to_quat(m)
            acc = rng.normal(0, 0.02, 3)
            yield slot, encode_packet(device.lower(), dtype, [ts, f / fps],
                                      acc, quats[slot])


class DeviceReplayer:
    """Send raw device packets to the frontend ports (default loopback)."""

    def __init__(self, host: str = "127.0.0.1", ports: Sequence[int] = PORTS):
        self.host = host
        self.ports = list(ports)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, slot: int, packet: bytes) -> None:
        self.sock.sendto(packet, (self.host, self.ports[slot % len(self.ports)]))

    def replay(self, stream: Iterable, fps: Optional[float] = None) -> int:
        n = 0
        # absolute-deadline pacing (stream/pacing.py): re-anchoring at
        # each send adds every sleep overshoot to the packet period
        pacer = Pacer(1.0 / (fps * 5)) if fps else None
        for slot, packet in stream:
            self.send(slot, packet)
            n += 1
            if pacer is not None:
                pacer.wait()
        return n


class FrameReplayer:
    """Send aligned 'acc#quat$' frames to :7777 (IMUSet's input)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7777):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send_frame(self, acc5: np.ndarray, quat5_xyzw: np.ndarray) -> None:
        virtual_acc = {i: np.asarray(acc5[i]) for i in range(5)}
        virtual_ori = {i: np.asarray(quat5_xyzw[i]) for i in range(5)}
        self.sock.sendto(encode_rebroadcast(virtual_acc, virtual_ori), self.addr)

    def replay(self, acc: np.ndarray, quat_xyzw: np.ndarray,
               fps: Optional[float] = 30.0) -> int:
        """acc [T,5,3], quat [T,5,4] xyzw."""
        # absolute schedule: frame t due at t0 + t/fps, so the live loop
        # downstream actually receives fps frames/s (relative pacing fed
        # it ~29 fps at a 30 fps target and capped the measured loop rate)
        pacer = Pacer(1.0 / fps) if fps else None
        for t in range(acc.shape[0]):
            self.send_frame(acc[t], quat_xyzw[t])
            if pacer is not None:
                pacer.wait()
        return acc.shape[0]
