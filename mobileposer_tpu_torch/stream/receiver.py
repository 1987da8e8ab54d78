"""Sensor frontend: UDP ingest on 5 ports, frame alignment, rate-limited
rebroadcast, performance logging (the port's copy of
`mobileposer_tpu/stream/receiver.py`, host code: no device runs here).

Behavioral parity target: reference `mobileposer/calibration.py` (the
headless data path: DataReceiver thread, calibration.py:62-102; main loop
105-182; PerformanceLogger 24-58) and `utils/socket_utils.py:8-35`. The
pygame cube visualizer is intentionally out of the hot path (viz/ has an
offline equivalent).

The reference uses a select loop + queue; here the ingest is selectors-based
with the same queue contract, so it runs on any platform without asyncio
event-loop setup costs at 25-150 Hz packet rates.
"""

from __future__ import annotations

import queue
import selectors
import socket
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from mobileposer_tpu_torch.stream.sensor import (
    CHUNK, HOST, MIN_TIME_DIFF, OUT_UDP_IP, OUT_UDP_PORT, PORTS, SensorData,
    process_message, sensor2global)


def init_sockets(host: str = HOST, ports: Iterable[int] = PORTS) -> List[socket.socket]:
    """Bind one UDP socket per sensor port (reference: socket_utils.py:8-16)."""
    socks = []
    for port in ports:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.setblocking(False)
        socks.append(sock)
    return socks


def encode_rebroadcast(virtual_acc: Dict[int, np.ndarray],
                       virtual_ori: Dict[int, np.ndarray]) -> bytes:
    """'a0,..#q0,..$' frame packet; quats reordered xyzw->wxyz
    (reference: socket_utils.py:19-35)."""
    acc = [np.asarray(virtual_acc[i]).flatten() for i in range(5)]
    ori = [np.asarray(virtual_ori[i]).flatten()[[3, 0, 1, 2]] for i in range(5)]
    s = ",".join("%g" % v for v in np.concatenate(acc)) + "#" + \
        ",".join("%g" % v for v in np.concatenate(ori)) + "$"
    return s.encode("utf8")


class PerformanceLogger:
    """Per-device Hz + mean delay, printed once per second
    (reference: calibration.py:24-58)."""

    def __init__(self, num_devices: int = 5, log_interval: float = 1.0):
        self.num_devices = num_devices
        self.log_interval = log_interval
        self.counts = defaultdict(int)
        self.delays = defaultdict(list)
        self.last_log = time.time()

    def update(self, device_id: int, delay: float) -> None:
        self.counts[device_id] += 1
        self.delays[device_id].append(delay)

    def snapshot(self) -> Dict[int, Tuple[float, float]]:
        """{device: (hz, mean_delay_s)} since the last log tick."""
        now = time.time()
        dt = max(now - self.last_log, 1e-9)
        out = {}
        for d in range(self.num_devices):
            hz = self.counts[d] / dt
            delay = float(np.mean(self.delays[d])) if self.delays[d] else 0.0
            out[d] = (hz, delay)
        return out

    def log(self) -> Optional[Dict[int, Tuple[float, float]]]:
        now = time.time()
        if now - self.last_log < self.log_interval:
            return None
        snap = self.snapshot()
        for d, (hz, delay) in snap.items():
            print(f"device {d}: {hz:6.1f} Hz  delay {delay * 1000:6.1f} ms")
        self.counts.clear()
        self.delays.clear()
        self.last_log = now
        return snap


class DataReceiver:
    """Selectors-based multi-socket reader thread feeding a queue
    (reference: calibration.py:62-102)."""

    def __init__(self, sockets: List[socket.socket], chunk: int = CHUNK):
        self.sockets = sockets
        self.chunk = chunk
        self.queue: "queue.Queue" = queue.Queue()
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        sel = selectors.DefaultSelector()
        for sock in self.sockets:
            sel.register(sock, selectors.EVENT_READ)
        while self._running:
            for key, _ in sel.select(timeout=0.1):
                try:
                    data, addr = key.fileobj.recvfrom(self.chunk)
                    self.queue.put((data, addr, time.time()))
                except BlockingIOError:
                    continue
        sel.close()

    def start(self) -> None:
        if self._thread is None:
            self._running = True
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def get_data(self, timeout: float = 0.1):
        try:
            return self.queue.get(timeout=timeout)
        except queue.Empty:
            return None


class SensorFrontend:
    """Headless calibration-app data path (reference: calibration.py:105-182
    minus the pygame UI): ingest -> parse -> ring buffers -> global frame ->
    25.6 Hz rebroadcast to :7777.

    With native=True the UDP receive loop + packet parsing run in the C++
    library (mobileposer_tpu_torch/native, GIL-free lock-free rings); Python only
    does the per-frame calibration math and rebroadcast. Falls back to the
    pure-Python selectors path when the library can't be built."""

    def __init__(self, host: str = HOST, ports: Iterable[int] = PORTS,
                 out_addr: Tuple[str, int] = (OUT_UDP_IP, OUT_UDP_PORT),
                 log: bool = False, native: bool = False):
        self.send_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.out_addr = out_addr
        self.sensor_data = SensorData()
        self.logger = PerformanceLogger() if log else None
        self.prev_timestamp = 0.0
        self._stop = threading.Event()
        self.native = None
        self._native_seqs = [0] * 5
        if native:
            try:
                from mobileposer_tpu_torch.native import NativeIngest
                self.native = NativeIngest(host=host, ports=list(ports))
            except Exception as e:
                print(f"native ingest unavailable ({e}); using Python path")
        if self.native is None:
            self.sockets = init_sockets(host, ports)
            self.receiver = DataReceiver(self.sockets)
        else:
            self.sockets = []
            self.receiver = None

    def _handle(self, device_id, curr_acc, curr_ori, timestamps,
                receive_time) -> None:
        sd = self.sensor_data
        curr_timestamp = sd.update(device_id, curr_acc, curr_ori, timestamps)
        glb_ori, glb_acc = sensor2global(
            sd.get_orientation(device_id), sd.get_acceleration(device_id),
            sd.calibration_quats, device_id)
        sd.update_virtual(device_id, glb_acc, glb_ori)
        if self.logger:
            self.logger.update(device_id, receive_time - timestamps[0])
            self.logger.log()
        if curr_timestamp - self.prev_timestamp >= MIN_TIME_DIFF:
            self.send_sock.sendto(
                encode_rebroadcast(sd.virtual_acc, sd.virtual_ori),
                self.out_addr)
            self.prev_timestamp = curr_timestamp

    def step(self, timeout: float = 0.1) -> bool:
        """Process pending packets; returns True if any were handled."""
        if self.native is not None:
            handled = False
            now = time.time()
            for slot in range(5):
                frames, last = self.native.read_since(
                    slot, self._native_seqs[slot])
                self._native_seqs[slot] = last
                for f in frames:
                    self._handle(slot, f[2:5], f[5:9], [f[0], f[1]], now)
                    handled = True
            if not handled:
                time.sleep(min(timeout, 0.005))
            return handled
        pkt = self.receiver.get_data(timeout=timeout)
        if pkt is None:
            return False
        data, addr, receive_time = pkt
        parsed = process_message(data)
        if parsed is None:
            return False
        _, device_id, curr_acc, curr_ori, timestamps = parsed
        self._handle(device_id, curr_acc, curr_ori, timestamps, receive_time)
        return True

    def run(self, duration: Optional[float] = None,
            on_tick=None, tick_interval: float = 0.1) -> None:
        """Main loop. `on_tick(sensor_data)` fires at most every
        `tick_interval` seconds on this thread — the hook the live
        orientation-cube viewer (viz/live_viewer.py) and other observers
        attach to."""
        if self.native is not None:
            self.native.start()
        else:
            self.receiver.start()
        t0 = time.time()
        last_tick = 0.0
        try:
            while not self._stop.is_set():
                self.step()
                if (on_tick is not None
                        and time.time() - last_tick >= tick_interval):
                    try:
                        on_tick(self.sensor_data)
                    except StopIteration:
                        break          # observer window closed: clean stop
                    last_tick = time.time()
                if duration is not None and time.time() - t0 > duration:
                    break
        finally:
            if self.native is not None:
                self.native.stop()
            else:
                self.receiver.stop()

    def stop(self) -> None:
        self._stop.set()

    def calibrate(self) -> None:
        self.sensor_data.calibrate()
