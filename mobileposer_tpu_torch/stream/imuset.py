"""IMUSet: the aligned-frame consumer of the sensor frontend's :7777 feed
(the port's copy of `mobileposer_tpu/stream/imuset.py`, host code).

Behavioral parity target: reference `mobileposer/live_demo.py:26-131`
(IMUSet) including the `-9.8 *` accel unit conversion and the
'acc#quat$' packet format (quats arrive wxyz after the frontend's reorder,
socket_utils.py:22-28).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional, Tuple

import numpy as np


class Clock:
    """Frame-rate limiter + FPS estimate (pygame.time.Clock stand-in)."""

    def __init__(self):
        self._last = time.perf_counter()
        self._ticks = []

    def tick(self, fps: Optional[float] = None) -> float:
        now = time.perf_counter()
        if fps:
            target = self._last + 1.0 / fps
            while now < target:
                time.sleep(min(target - now, 0.002))
                now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._ticks.append(now)
        self._ticks = self._ticks[-60:]
        return dt

    def get_fps(self) -> float:
        if len(self._ticks) < 2:
            return 0.0
        span = self._ticks[-1] - self._ticks[0]
        return (len(self._ticks) - 1) / span if span > 0 else 0.0


def decode_frame_packet(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """'a0,..#q0,..$' -> (quat wxyz [N,4], acc [N,3]); accel scaled by -9.8
    (g -> m/s^2 sign convention, reference: live_demo.py:74)."""
    text = data.decode("utf-8")
    a_str, q_str = text.split("#")
    a = np.array(a_str.split(","), dtype=np.float64)
    q = np.array(q_str.strip("$").split(","), dtype=np.float64)
    return q.reshape(-1, 4), -9.8 * a.reshape(-1, 3)


class IMUSet:
    """Threaded reader of the aligned sensor feed (reference:
    live_demo.py:26-131)."""

    def __init__(self, imu_host: str = "127.0.0.1", imu_port: int = 7777,
                 buffer_len: int = 26):
        self.imu_host = imu_host
        self.imu_port = imu_port
        self.clock = Clock()
        self._imu_socket: Optional[socket.socket] = None
        self._buffer_len = buffer_len
        self._quat_buffer: list = []
        self._acc_buffer: list = []
        self._is_reading = False
        self._read_thread: Optional[threading.Thread] = None

    def _read(self) -> None:
        while self._is_reading:
            try:
                data, _ = self._imu_socket.recvfrom(1024)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                quat, acc = decode_frame_packet(data)
            except (ValueError, IndexError):
                continue
            trunc = int(len(self._quat_buffer) == self._buffer_len)
            # whole-list replacement keeps readers race-free under the GIL
            self._quat_buffer = self._quat_buffer[trunc:] + [quat]
            self._acc_buffer = self._acc_buffer[trunc:] + [acc]
            self.clock.tick()

    def start_reading(self) -> None:
        if self._read_thread is not None:
            return
        self._is_reading = True
        self._quat_buffer = []
        self._acc_buffer = []
        self._imu_socket = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._imu_socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._imu_socket.bind((self.imu_host, self.imu_port))
        self._imu_socket.settimeout(0.2)
        self._read_thread = threading.Thread(target=self._read, daemon=True)
        self._read_thread.start()

    def stop_reading(self) -> None:
        if self._read_thread is not None:
            self._is_reading = False
            self._read_thread.join()
            self._read_thread = None
            self._imu_socket.close()

    def get_current_buffer(self) -> Tuple[np.ndarray, np.ndarray]:
        q = np.array(self._quat_buffer, dtype=np.float32)
        a = np.array(self._acc_buffer, dtype=np.float32)
        return q, a

    def get_mean_measurement_of_n_second(self, num_seconds: float = 3,
                                         buffer_len: int = 120):
        """Blocking capture; returns mean (quat [N,4], acc [N,3])
        (reference: live_demo.py:117-131)."""
        save = self._buffer_len
        self._buffer_len = buffer_len
        self.start_reading()
        time.sleep(num_seconds)
        self.stop_reading()
        q, a = self.get_current_buffer()
        self._buffer_len = save
        return q.mean(axis=0), a.mean(axis=0)
