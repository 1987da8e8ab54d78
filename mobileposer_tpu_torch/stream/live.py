"""Live streaming runtime: calibration procedure + 30 Hz inference loop
(counterpart of `mobileposer_tpu/stream/live.py`).

Behavioral parity target: reference `mobileposer/live_demo.py:146-264`. The
interactive prompts are explicit methods so the same runtime drives real
sensors, the fake replayer, and headless runs; the model step is the
port's single-stream `forward_online` (models/net.py), called eagerly on
the net's device: on the card it runs the layer kernels #1 and #2
(`ops/lstm_cuda.py`), 6 + 2 launches a frame.

Output side: optional Unity TCP export (pose axis-angle '#' tran '$',
reference live_demo.py:256-260) and session recording in the reference's
dev-data schema (live_demo.py:266-280).
"""

from __future__ import annotations

import collections
import socket
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.device import device_context
from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.stream.calibration import (
    Calibration, calibrate_frames, compute_device_calibration,
    compute_smpl2imu, normalize_frames)
from mobileposer_tpu_torch.stream.imuset import Clock, IMUSet


def stack_recording(recorded: dict) -> dict:
    """Stack per-frame recording lists into arrays (tolerates live dicts
    salvaged mid-run)."""
    return {k: np.stack(v) if v else np.zeros(0)
            for k, v in recorded.items()}


class UnityExporter:
    """TCP server streaming pose+tran strings to a Unity viewer
    (reference: live_demo.py:185-190, 256-260)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8889):
        self.server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.server.bind((host, port))
        self.server.listen(1)
        self.conn = None

    def accept(self) -> None:
        self.conn, _ = self.server.accept()

    def send(self, pose_aa: np.ndarray, tran: np.ndarray) -> None:
        if self.conn is None:
            return
        s = ",".join("%g" % v for v in pose_aa.flatten()) + "#" + \
            ",".join("%g" % v for v in tran.flatten()) + "$"
        self.conn.send(s.encode("utf8"))

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
        self.server.close()


class LivePoser:
    """End-to-end streaming estimator on the net's device."""

    #: frames whose step and fetch times `stats()` keeps
    TIMING_FRAMES = 4096

    def __init__(self, net, params, imu_set: Optional[IMUSet] = None,
                 combo: str = "lw_rp"):
        """net: a `MobilePoserNet` (its device is the step's); params: the
        port's modules (`nn.convert.params_from_jax`), placed on the net's
        device once, here."""
        self.net = net
        self.device = net.device
        self.params = params.to(self.device)
        self.imu_set = imu_set or IMUSet(buffer_len=1)
        self.combo = combo
        self.calibration: Optional[Calibration] = None
        self._state = net.init_online_state()
        self._stage = None               # pinned frame staging (card only)
        self._stage_done = None
        self.step_ms: collections.deque = collections.deque(
            maxlen=self.TIMING_FRAMES)
        self.fetch_ms: collections.deque = collections.deque(
            maxlen=self.TIMING_FRAMES)
        self.frames_out = 0
        self.run_seconds = 0.0

    # -- calibration (reference: live_demo.py:159-174) ---------------------
    def calibrate_body_frame(self, num_seconds: float = 3.0) -> np.ndarray:
        """Step 1: reference IMU held aligned with the body frame."""
        oris, _ = self.imu_set.get_mean_measurement_of_n_second(
            num_seconds=num_seconds, buffer_len=40)
        self._smpl2imu = compute_smpl2imu(oris[0])
        return self._smpl2imu

    def calibrate_tpose(self, num_seconds: float = 3.0) -> Calibration:
        """Step 2: all devices worn, subject in T-pose."""
        oris, accs = self.imu_set.get_mean_measurement_of_n_second(
            num_seconds=num_seconds, buffer_len=40)
        self.calibration = compute_device_calibration(
            self._smpl2imu, oris, accs)
        return self.calibration

    def set_calibration(self, cal: Calibration) -> None:
        self.calibration = cal

    def reset(self) -> None:
        self._state = self.net.init_online_state()

    # -- device helpers (called under `device_context(self.device)`) -------
    def _upload(self, imu60: np.ndarray) -> torch.Tensor:
        """The frame's 60 features to the device in one copy. On the card
        through a pinned staging buffer and a non-blocking copy, as the
        server uploads (stream/server.py `_upload`): the buffer is
        rewritten only once the previous frame's copy out of it is done."""
        if self.device.type != "cuda":
            return torch.from_numpy(imu60.copy())
        if self._stage is None:
            self._stage = torch.empty(imu60.shape, dtype=torch.float32,
                                      pin_memory=True)
            self._stage_done = torch.cuda.Event()
        else:
            self._stage_done.synchronize()
        self._stage.numpy()[:] = imu60
        out = self._stage.to(self.device, non_blocking=True)
        self._stage_done.record()
        return out

    def _issue_fetch(self, need: dict):
        """Start one frame's device-to-host copy of `need` (name -> device
        tensor) as one flat float32 buffer: on the card a non-blocking
        copy into pinned memory and one CUDA event that marks it done; on
        the CPU a plain copy. Returns (host buffer, event or None,
        layout)."""
        layout = [(k, tuple(v.shape)) for k, v in need.items()]
        flat = torch.cat([v.reshape(-1).float() for v in need.values()])
        if self.device.type != "cuda":
            return flat, None, layout
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event, layout

    @staticmethod
    def _finish_fetch(issued) -> dict:
        """Wait for a copy `_issue_fetch` started; the frame's outputs as
        numpy arrays of their own (the pinned buffer is not kept)."""
        host, event, layout = issued
        if event is not None:
            event.synchronize()
        flat = host.numpy()
        out, i = {}, 0
        for k, shape in layout:
            n = int(np.prod(shape))
            out[k] = flat[i:i + n].reshape(shape).copy()
            i += n
        return out

    # -- per-frame inference ----------------------------------------------
    def step_frame(self, quat_wxyz5: np.ndarray, acc5: np.ndarray):
        """One raw aligned frame -> (pose [24,3,3], joints [24,3], tran [3],
        contact [2]), tensors on the net's device."""
        if self.calibration is None:
            raise RuntimeError("calibrate first")
        imu60 = normalize_frames(self.calibration, quat_wxyz5[None],
                                 acc5[None], self.combo)[0]
        with device_context(self.device), torch.no_grad():
            (pose, joints, tran, contact), self._state = \
                self.net.forward_online(self.params, self._state,
                                        self._upload(imu60))
        return pose, joints, tran, contact

    def stats(self) -> dict:
        """Timing of the frames of the last `run`: `step_ms` is the host
        time from a frame's pickup to its copy issued (normalization,
        upload, the step's launches; synchronous runs also wait for the
        device there), `fetch_ms` the wait for that copy; percentiles
        over the last TIMING_FRAMES frames, and the frames delivered per
        second of the run."""
        def pct(d):
            a = np.asarray(d, np.float64)
            return ({"p50": float(np.percentile(a, 50)),
                     "p99": float(np.percentile(a, 99))} if a.size
                    else {"p50": None, "p99": None})
        return {"frames": self.frames_out, "seconds": self.run_seconds,
                "output_fps": (self.frames_out / self.run_seconds
                               if self.run_seconds > 0 else 0.0),
                "step_ms": pct(self.step_ms), "fetch_ms": pct(self.fetch_ms)}

    def run(self, duration: Optional[float] = None, fps: int = C.datasets.fps,
            on_frame: Optional[Callable] = None,
            unity: Optional[UnityExporter] = None,
            record: bool = False, debug: bool = False,
            pipelined: bool = True):
        """Main loop (reference: live_demo.py:207-264).

        Every frame's host consumers (unity, `on_frame`, the recording)
        read one device-to-host copy of the frame's outputs, as numpy
        arrays: `on_frame(pose, joints, tran, contact)`.

        pipelined=True (default) defers each frame's fetch by one tick,
        as the server's pipelined tick does (stream/server.py): frame N's
        step is launched and its copy issued, then frame N-1's copy is
        waited for and delivered while frame N runs on the card. Content
        is identical one frame later; the final frame is flushed on exit.
        pipelined=False restores the synchronous loop.
        """
        if self.calibration is None:
            raise RuntimeError("calibrate first")
        self.imu_set.start_reading()
        clock = Clock()
        recorded = ({"acc": [], "ori": [], "raw_acc": [], "raw_ori": [],
                     "pose": [], "tran": []} if record else None)
        # expose the live buffers so callers can salvage a recording when an
        # interrupt escapes run() itself (e.g. lands in stop_reading)
        self.last_recording = recorded
        self.step_ms.clear()
        self.fetch_ms.clear()
        self.frames_out = 0
        consumers = (unity is not None or recorded is not None
                     or on_frame is not None)

        def fetch(issued) -> dict:
            if issued is None:
                return {}
            t = time.perf_counter()
            out = self._finish_fetch(issued)
            self.fetch_ms.append((time.perf_counter() - t) * 1e3)
            return out

        def deliver(fetched, frame, record_only=False):
            """Send one frame's results to every consumer. Raises
            StopIteration when the viewer asks to close. Recording runs
            FIRST (it cannot raise StopIteration), so a frame whose viewer
            delivery closes the window is still recorded; record_only=True
            skips the viewer/unity delivery entirely (used to flush the
            in-flight pipelined frame when the viewer closes)."""
            quat1, acc1 = frame
            self.frames_out += 1
            if recorded is not None:
                # reference dev-data schema (live_demo.py:266-275):
                # 'acc'/'ori' are CALIBRATED global accel + rotation
                # matrices in device slot order; raw wire values are
                # kept under raw_*
                glb_acc, glb_ori = calibrate_frames(
                    self.calibration, quat1[None], acc1[None])
                recorded["acc"].append(glb_acc[0])
                recorded["ori"].append(glb_ori[0])
                recorded["raw_acc"].append(acc1)
                recorded["raw_ori"].append(quat1)
                recorded["pose"].append(fetched["pose"])
                recorded["tran"].append(fetched["tran"])
            if record_only:
                return
            if unity is not None:
                unity.send(fetched["aa"], fetched["tran"])
            if on_frame is not None:
                on_frame(fetched["pose"], fetched["joints"], fetched["tran"],
                         fetched["contact"])

        pending = None                       # (issued copy, frame snapshot)
        t0 = time.time()
        try:
            while duration is None or time.time() - t0 < duration:
                try:
                    clock.tick(fps)
                    quat, acc = self.imu_set.get_current_buffer()
                    if quat.size == 0:
                        continue
                    t_step = time.perf_counter()
                    pose, joints, tran, contact = self.step_frame(
                        quat[-1], acc[-1])
                    issued = None
                    if consumers:
                        need = {"pose": pose, "joints": joints, "tran": tran,
                                "contact": contact}
                        with device_context(self.device):
                            if unity is not None:
                                need["aa"] = R.rotation_matrix_to_axis_angle(
                                    pose).reshape(72)
                            issued = self._issue_fetch(need)
                    frame = (quat[-1], acc[-1])
                    try:
                        if pipelined:
                            self.step_ms.append(
                                (time.perf_counter() - t_step) * 1e3)
                            prev, pending = pending, (issued, frame)
                            if prev is not None:
                                deliver(fetch(prev[0]), prev[1])
                        else:
                            fetched = fetch(issued)
                            self.step_ms.append(
                                (time.perf_counter() - t_step) * 1e3)
                            deliver(fetched, frame)
                    except StopIteration:
                        # viewer window closed: clean stop, but the
                        # recording keeps the in-flight pipelined frame too
                        if pipelined and pending is not None:
                            deliver(fetch(pending[0]), pending[1],
                                    record_only=True)
                        pending = None
                        break
                    if debug:
                        print(f"\rSensor FPS {self.imu_set.clock.get_fps():5.1f}"
                              f"  Output FPS {clock.get_fps():5.1f}", end="")
                except KeyboardInterrupt:
                    break          # stop requested: keep everything recorded
            # flush the deferred final frame so a recording keeps every frame
            if pending is not None:
                try:
                    deliver(fetch(pending[0]), pending[1])
                except StopIteration:
                    pass
        finally:
            self.run_seconds = time.time() - t0
            self.imu_set.stop_reading()
        if recorded is not None:
            return stack_recording(recorded)
        return None


def save_session(data: dict, calibration: Calibration,
                 out_dir=None) -> Path:
    """Persist a recorded session (reference: live_demo.py:266-280)."""
    out_dir = Path(out_dir or C.paths.dev_data)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"dev_{int(time.time())}.npz"
    np.savez(path, **data, smpl2imu=calibration.smpl2imu,
             device2bone=calibration.device2bone,
             acc_offsets=calibration.acc_offsets)
    return path
