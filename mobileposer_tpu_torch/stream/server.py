"""Multi-stream pose inference server on PyTorch (counterpart of
`mobileposer_tpu/stream/server.py`).

Serves many concurrent IMU streams from one CUDA card: clients send
`(stream_id, imu60)` datagrams; the server assembles one batch per tick,
advances every stream with one batched step (`forward_online_batched`,
the exact window semantics on the LSTM kernels, or
`forward_carry_batched`, the carry-mode approximation), and replies to
each client with the frame's pose (axis-angle), translation and contact.
Wire format (little-endian):

  request:  stream_id:uint32 | imu60:float32[60]            (244 bytes)
  reply:    stream_id:uint32 | pose_aa:float32[72] |
            tran:float32[3] | contact:float32[2]            (312 bytes)

With `wire="f16"` the reply's pose and contact fields are IEEE half
floats and translation stays float32 (an f16 translation would quantize
by 1.5 cm past 16 m):

  reply16:  stream_id:uint32 | pose_aa:float16[72] |
            tran:float32[3] | contact:float16[2]            (164 bytes)

The cast runs on the card before the copy to the host, so it halves the
device-to-host reply bytes as well as the UDP egress.

Streams are slots: the first `max_streams` distinct ids are admitted;
idle slots recycle after `idle_timeout` seconds.

Reply path. Each tick runs the step and the post step (rotation matrix
to axis-angle, the wire casts) on the card, all on the current stream of
the server's device. Synchronous serving copies the replies to the host
and sends them inside the tick. Pipelined serving issues a
`non_blocking` copy into pinned host memory and records one CUDA event
per tick, then hands the tick to fetcher threads, which wait on the
event and send; the server thread goes on to the next tick meanwhile.
While the fetch queue is at least half full the tick issues no copy (its
fetcher copies when it gets to it), so an overloaded reply path spends
its transfers on ticks that are still sent.

Slot resets are out of place: the reply of a tick holds the step's
`last_root_pos` itself, and a reset made while a fetcher has not copied
it yet must not change what that fetcher sends.
"""

from __future__ import annotations

import contextlib
import os
import queue
import socket
import struct
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.stream.pacing import Pacer

REQUEST_STRUCT = struct.Struct("<I60f")
REPLY_STRUCT = struct.Struct("<I72f3f2f")
REPLY_STRUCT_F16 = struct.Struct("<I72e3f2e")


def _params_dtype(net, params) -> torch.dtype:
    """The dtype the server runs in: the params' float dtype, float32 or
    bfloat16, as the JAX server's `self.dtype` is. An int8 direction's
    float32 scales and pre-summed `b` are left out: a tree quantized from
    a bf16 cast holds them beside its bf16 linears. The params must sit
    on the net's device."""
    from mobileposer_tpu_torch.nn.lstm import LSTMDirectionInt8, check_dtype
    dtypes = set()
    for mod_name, mod in params.named_modules():
        int8 = isinstance(mod, LSTMDirectionInt8)
        for name, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if t.device != net.device:
                raise ValueError(f"params {mod_name}.{name} is on "
                                 f"{t.device}, the net on {net.device}")
            if t.dtype.is_floating_point and not int8:
                check_dtype(t.dtype)
                dtypes.add(t.dtype)
    if len(dtypes) > 1:
        raise ValueError(f"params mix the float dtypes {sorted(map(str, dtypes))}")
    return dtypes.pop() if dtypes else torch.float32


class PoseServer:
    """UDP batched-inference server over the batched streaming step."""

    #: ticks the reply queue holds before the oldest is dropped
    FETCH_QUEUE_SIZE = 8

    def __init__(self, net, params, host: str = "0.0.0.0", port: int = 9000,
                 max_streams: int = 64, tick_hz: float = 30.0,
                 idle_timeout: float = 30.0, mode: str = "exact",
                 mesh=None, pipelined: bool = False,
                 quantize: Optional[str] = None, wire: str = "f32",
                 fetch_workers: int = 1):
        """mode='exact' serves the reference window semantics
        (`forward_online_batched`: the LSTM kernels #1 and #2, or #4 and
        #6 on int8 params); mode='carry' serves the opt-in carry-mode
        approximation (`models/streaming.py`: batched cell steps, no LSTM
        kernel).

        quantize='int8' quantizes the LSTM matmuls to W8A8
        (`ops.quant.quantize_params_int8`) once, here, after the dtype is
        taken: on bf16 params that is int8 on bf16 params (the JAX
        server's order), the W8A8 kernels #4 and #6 with bf16 I/O.

        pipelined=True overlaps the reply copy and send with the next
        tick (see the module docstring); reply content is the
        synchronous server's, one tick later. If the fetchers fall
        behind, the oldest queued tick is dropped and counted.

        wire='f16' switches replies to the compact half-float format
        (REPLY_STRUCT_F16).

        fetch_workers (pipelined): fetcher threads. Replies stay fresh per
        stream under reordering: a tick whose fetch completes after a
        newer tick was sent is dropped whole and counted.

        mesh: sharding the slots over several devices is not ported
        (ROADMAP.md queue A item 16); pass None."""
        if mesh is not None:
            raise NotImplementedError(
                "serving over a device mesh is not ported (data-parallel "
                "serving, ROADMAP.md queue A item 16)")
        if wire not in ("f32", "f16"):
            raise ValueError(f"unknown wire format {wire!r}")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize {quantize!r}")
        if mode not in ("exact", "carry"):
            raise ValueError(f"unknown serving mode {mode!r}")
        if fetch_workers < 1:
            raise ValueError(f"fetch_workers must be >= 1, got {fetch_workers}")
        # serve in the weights' dtype: the state, the frames and the step
        # in bf16 on bf16 params; the fusion accumulators stay float32
        # (the state factories), and replies go out as float32 or f16
        self.dtype = _params_dtype(net, params)
        if quantize == "int8":
            from mobileposer_tpu_torch.ops.quant import quantize_params_int8
            params = quantize_params_int8(params)
        self.net = net
        self.device = net.device
        self.params = params
        self.wire = wire
        self.quantize = quantize
        self.mode = mode
        self.max_streams = max_streams
        self.tick_period = 1.0 / tick_hz
        self.idle_timeout = idle_timeout

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # the default receive buffer holds about one burst of a few hundred
        # requests once the kernel charges each datagram's truesize; a
        # tick that drains late would drop the next burst whole
        for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, opt, 4 << 20)
            except OSError:
                pass                        # platform cap; keep default
        self.sock.bind((host, port))
        # non-blocking: the drain must never stall the serving tick
        self.sock.setblocking(False)
        self.port = self.sock.getsockname()[1]

        # Batched GIL-free UDP syscalls (native/sensor_ingest.cpp
        # udp_drain_requests / udp_send_batch); reply content is the same
        # either way. MP_NATIVE_UDP=0 forces the Python drain and send.
        # Addresses are opaque uint64 tokens in native mode, tuples in
        # Python mode, never mixed: the mode is fixed per server.
        self._native_udp = None
        if os.environ.get("MP_NATIVE_UDP", "1") != "0":
            try:
                from mobileposer_tpu_torch.native import ServingUDP
                self._native_udp = ServingUDP()
            except Exception:                # noqa: BLE001
                self._native_udp = None
        self.rejected_frames = 0

        # slot state (host side)
        self.slot_of: Dict[int, int] = {}           # stream_id -> slot
        self.id_of: Dict[int, int] = {}             # slot -> stream_id
        self.addr_of: Dict[int, Tuple] = {}         # slot -> last client addr
        self.last_seen = np.zeros(max_streams)
        self.pending = np.zeros((max_streams, 60), np.float32)
        self.has_frame = np.zeros(max_streams, bool)

        self._feet = torch.as_tensor(np.asarray(net.feet_pos, np.float32),
                                     device=self.device)
        self._stage = None               # pinned frame staging (card only)
        if mode == "carry":
            self.states = net.init_carry_state_batched(max_streams,
                                                       self.dtype)
            self._step = net.forward_carry_batched
        else:
            self.states = net.init_online_state_batched(max_streams,
                                                        self.dtype)
            self._step = net.forward_online_batched
        self._reply_struct = (REPLY_STRUCT if wire == "f32"
                              else REPLY_STRUCT_F16)
        self._reply_dtype = (self._REPLY_DTYPE if wire == "f32"
                             else self._REPLY_DTYPE_F16)

        self._stop = threading.Event()
        self.frames_served = 0
        # tick-latency ring for SLO observability (stats()); fixed-size so
        # a long-running server never grows host memory
        self._tick_ms = np.zeros(1024, np.float32)
        self._tick_n = 0

        # reply pipeline (pipelined=True): tick() enqueues the tick's
        # device outputs, its host copies (or None) and a slot snapshot;
        # fetcher threads wait for the copy and reply
        self.pipelined = pipelined
        self.fetch_workers = fetch_workers
        self._drain_deadline = 2.0       # s of post-stop reply flushing
        self._fetch_q: queue.Queue = queue.Queue(
            maxsize=self.FETCH_QUEUE_SIZE)
        self.deferred_copies = 0         # ticks whose copy the gate deferred
        # Every field below is written by the fetcher threads (and the
        # drop-oldest path of the tick) under _send_lock: with more than
        # one worker an unlocked `+= 1` loses counts.
        self._send_lock = threading.Lock()
        self._fetch_ms = np.zeros(1024, np.float32)
        self._fetch_n = 0
        # end-to-end reply lag: tick dispatch -> reply send
        self._lag_ms = np.zeros(1024, np.float32)
        self._lag_n = 0
        self.dropped_replies = 0
        self.fetch_errors = 0
        self._last_fetch_error: Optional[str] = None
        # freshness gate for the worker pool: fetches can complete out of
        # order; only the newest tick may be sent
        self._dispatch_seq = 0
        self._max_sent_seq = -1
        self._fetchers: list = []
        if pipelined:
            self._start_fetcher()

    # -- device helpers -----------------------------------------------------
    def _device_ctx(self):
        """The server's CUDA device as the current one (a no-op on the
        CPU): threads other than the constructor's start on device 0."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _post(self, pose, root, contact):
        """Reply post step on the device: rotation matrices to axis-angle
        (in the server's dtype, as the JAX server computes it), and the
        wire casts before the copy (that is where the bytes are): f16, or
        float32 for a bf16 server."""
        aa = R.rotation_matrix_to_axis_angle(
            pose.reshape(-1, 3, 3)).reshape(pose.shape[0], 72)
        if self.wire == "f16":
            return aa.half(), root.float(), contact.half()
        return aa.float(), root.float(), contact.float()

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        """Frames to the device. On the card through a pinned staging
        buffer, so the copy is queued behind the previous tick's work
        instead of waiting for it (a copy from pageable memory may
        synchronize); the buffer is rewritten only once the previous
        tick's copy out of it has completed (its event)."""
        if self.device.type != "cuda":
            return torch.from_numpy(frames.copy()).to(self.dtype)
        if self._stage is None:
            self._stage = torch.empty(frames.shape, dtype=torch.float32,
                                      pin_memory=True)
            self._stage_done = torch.cuda.Event()
        else:
            self._stage_done.synchronize()
        self._stage.numpy()[:] = frames
        out = self._stage.to(self.device, non_blocking=True)
        self._stage_done.record()
        return out.to(self.dtype)

    def _issue_copy(self, outs):
        """Start the tick's device-to-host copy: (host tensors, the CUDA
        event that marks them complete, or None on the CPU)."""
        if self.device.type != "cuda":
            return [o.clone() for o in outs], None
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in outs]
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _fetch(self, outs, host, event):
        """The tick's replies as host numpy arrays: wait for the copy the
        tick issued, or copy now when it issued none."""
        if host is None:
            host = [o.to("cpu", copy=True) for o in outs]
        elif event is not None:
            event.synchronize()
        return [h.numpy() for h in host]

    # -- reply pipeline -----------------------------------------------------
    def _start_fetcher(self) -> None:
        self._fetchers = [t for t in self._fetchers if t.is_alive()]
        for _ in range(self.fetch_workers - len(self._fetchers)):
            t = threading.Thread(target=self._fetch_loop, daemon=True)
            t.start()
            self._fetchers.append(t)

    def _fetch_loop(self) -> None:
        """Fetcher thread: one wait (or copy) per dispatched tick, then the
        UDP replies. Exits only once stopped and drained, so trailing
        replies are flushed on shutdown, within a bounded drain window.

        A failed fetch must not kill the thread (every later reply would
        be a silent drop while tick stats stay green): its replies are
        dropped and counted, and the loop keeps serving."""
        with self._device_ctx():
            stop_seen = None
            while True:
                if self._stop.is_set():
                    if stop_seen is None:
                        stop_seen = time.perf_counter()
                    if self._fetch_q.empty():
                        break
                    if time.perf_counter() - stop_seen > self._drain_deadline:
                        while True:
                            try:
                                self._fetch_q.get_nowait()
                            except queue.Empty:
                                break
                            with self._send_lock:
                                self.dropped_replies += 1
                        break
                try:
                    seq, (outs, host, event), snapshot = self._fetch_q.get(
                        timeout=0.05)
                except queue.Empty:
                    continue
                try:
                    t0 = time.perf_counter()
                    host_np = self._fetch(outs, host, event)
                    fetch_ms = (time.perf_counter() - t0) * 1e3
                    # the fetch runs outside the lock (it is what workers
                    # exist to overlap); the gate and the send serialize
                    with self._send_lock:
                        self._fetch_ms[self._fetch_n % self._fetch_ms.size] = (
                            fetch_ms)
                        self._fetch_n += 1
                        # freshness gate: a newer tick already went out, so
                        # sending this one would regress every client's pose
                        if seq <= self._max_sent_seq:
                            self.dropped_replies += 1
                            continue
                        self._max_sent_seq = seq
                        self._send_replies(host_np, snapshot)
                except Exception as e:       # noqa: BLE001 — must not die
                    with self._send_lock:
                        self.dropped_replies += 1
                        self.fetch_errors += 1
                        self._last_fetch_error = repr(e)

    def _enqueue_replies(self, item, snapshot) -> None:
        """Hand a tick to the fetchers; if they have fallen behind, drop
        the oldest queued tick (a stale real-time pose is useless) and
        count it."""
        seq, self._dispatch_seq = self._dispatch_seq, self._dispatch_seq + 1
        while True:
            try:
                self._fetch_q.put_nowait((seq, item, snapshot))
                return
            except queue.Full:
                try:
                    self._fetch_q.get_nowait()
                except queue.Empty:
                    continue
                with self._send_lock:
                    self.dropped_replies += 1

    # wire-identical to REPLY_STRUCT ("<I72f3f2f", 312 bytes/row): all
    # fields are 4-byte so the packed structured dtype has no padding
    _REPLY_DTYPE = np.dtype([("id", "<u4"), ("pose", "<f4", (72,)),
                             ("tran", "<f4", (3,)), ("contact", "<f4", (2,))])
    assert _REPLY_DTYPE.itemsize == REPLY_STRUCT.size
    # wire-identical to REPLY_STRUCT_F16 ("<I72e3f2e", 164 bytes/row): a
    # list-of-fields dtype is packed and struct '<' is unaligned, so the
    # mixed 2/4-byte fields line up byte for byte
    _REPLY_DTYPE_F16 = np.dtype([("id", "<u4"), ("pose", "<f2", (72,)),
                                 ("tran", "<f4", (3,)),
                                 ("contact", "<f2", (2,))])
    assert _REPLY_DTYPE_F16.itemsize == REPLY_STRUCT_F16.size

    def _send_replies(self, host_outs, snapshot) -> int:
        """Pack and send one tick's replies, one vectorized structured
        array. snapshot is ([(slot, stream_id, addr)], dispatch_time),
        taken at dispatch: slot ownership may change before the fetch.
        Called under _send_lock."""
        entries, t_dispatch = snapshot
        if not entries:
            return 0
        pose_aa, root_np, contact_np = host_outs
        slots = np.fromiter((e[0] for e in entries), np.int64, len(entries))
        rec = np.empty(len(entries), dtype=self._reply_dtype)
        rec["id"] = np.fromiter((e[1] for e in entries), np.uint32,
                                len(entries))
        rec["pose"] = pose_aa[slots]
        rec["tran"] = root_np[slots]
        rec["contact"] = contact_np[slots]
        raw = rec.tobytes()
        sz = self._reply_struct.size
        if self._native_udp is not None:
            # one GIL-free sendmmsg batch; addrs are the drain's tokens
            tokens = np.fromiter((e[2] for e in entries), np.uint64,
                                 len(entries))
            sent = self._native_udp.send(self.sock.fileno(), raw,
                                         len(entries), sz, tokens)
        else:
            sent = 0
            for i, (_, _, addr) in enumerate(entries):
                try:
                    self.sock.sendto(raw[i * sz:(i + 1) * sz], addr)
                    sent += 1
                except OSError:
                    pass
        self.frames_served += sent
        self._lag_ms[self._lag_n % self._lag_ms.size] = (
            (time.perf_counter() - t_dispatch) * 1e3)
        self._lag_n += 1
        return sent

    # -- slot management ----------------------------------------------------
    def _slot_for(self, stream_id: int) -> Optional[int]:
        slot = self.slot_of.get(stream_id)
        if slot is not None:
            return slot
        now = time.time()
        for s in range(self.max_streams):
            owner = self.id_of.get(s)
            if owner is None or now - self.last_seen[s] > self.idle_timeout:
                if owner is not None:
                    del self.slot_of[owner]
                self.slot_of[stream_id] = s
                self.id_of[s] = stream_id
                # always reset: tick() advances every slot each step, so
                # even a never-owned slot has accumulated state
                self._reset_slot(s)
                return s
        return None                                  # server full

    def _reset_slot(self, slot: int) -> None:
        """Fresh streaming state for a claimed slot, out of place: new
        tensors replace the state's fields, and a tick's outputs that
        alias the old ones (its `root` is the old `last_root_pos`) keep
        their values until a fetcher has copied them."""
        with self._device_ctx():
            st = self.states
            idx = torch.tensor([slot], device=self.device)
            fields = dict(
                initialized=st.initialized.index_fill(0, idx, False),
                last_lfoot=st.last_lfoot.index_copy(0, idx, self._feet[:1]),
                last_rfoot=st.last_rfoot.index_copy(0, idx, self._feet[1:]),
                current_root_y=st.current_root_y.index_fill(0, idx, 0.0),
                last_root_pos=st.last_root_pos.index_fill(0, idx, 0.0))
            if self.mode == "exact":
                # carry steps re-derive rings and carries from scratch while
                # initialized is False; the exact state's window and
                # velocity carry are cleared as the JAX server clears them
                fields.update(imu=st.imu.index_fill(0, idx, 0.0),
                              vel_h=st.vel_h.index_fill(1, idx, 0.0),
                              vel_c=st.vel_c.index_fill(1, idx, 0.0))
            self.states = st._replace(**fields)

    # -- main loop ----------------------------------------------------------
    def _drain_requests_native(self) -> int:
        """One GIL-free recvmmsg drain (validation and the finite check in
        C), then vectorized slot assembly. Semantics match the Python
        drain: wrong-size and non-finite datagrams rejected, later
        duplicates of a stream win, unknown streams claim slots through
        the same admission."""
        ids, frames, addrs, rej = self._native_udp.drain(
            self.sock.fileno(), self.max_streams * 4)
        self.rejected_frames += rej
        if ids.size == 0:
            return 0
        now = time.time()
        slots = np.empty(ids.size, np.int64)
        keep = np.zeros(ids.size, bool)
        n = 0
        for i, sid in enumerate(ids.tolist()):
            slot = self._slot_for(sid)
            if slot is None:                         # server full
                continue
            slots[i] = slot
            keep[i] = True
            self.addr_of[slot] = int(addrs[i])       # opaque token
            # stamp at once: a slot claimed earlier in this loop must not
            # look idle to a later datagram's admission
            self.last_seen[slot] = now
            n += 1
        if n:
            sl = slots[keep]
            self.pending[sl] = frames[keep]
            self.has_frame[sl] = True
        return n

    def _drain_requests(self) -> int:
        if self._native_udp is not None:
            return self._drain_requests_native()
        n = 0
        # hard iteration cap: dropped (malformed/non-finite) datagrams also
        # count toward the per-tick budget, so a garbage flood cannot keep
        # this loop spinning and stall the tick for healthy streams
        for _ in range(self.max_streams * 8):
            try:
                data, addr = self.sock.recvfrom(REQUEST_STRUCT.size)
            except (BlockingIOError, socket.timeout):
                break
            except OSError:
                break
            if len(data) != REQUEST_STRUCT.size:
                self.rejected_frames += 1
                continue
            unpacked = REQUEST_STRUCT.unpack(data)
            stream_id = unpacked[0]
            frame = np.asarray(unpacked[1:], np.float32)
            if not np.isfinite(frame).all():
                # a NaN/inf frame would poison the slot's carried LSTM
                # state until the idle-timeout reset
                self.rejected_frames += 1
                continue
            slot = self._slot_for(stream_id)
            if slot is None:
                continue
            self.pending[slot] = frame
            self.has_frame[slot] = True
            self.addr_of[slot] = addr
            self.last_seen[slot] = time.time()
            n += 1
            if n >= self.max_streams * 4:            # bound per tick
                break
        return n

    def tick(self) -> int:
        """One batch step: drain requests, advance all streams, reply.

        Slots without a new frame repeat their last frame (the model's
        sliding window absorbs it); replies go only to slots that sent
        one. Returns the number of replies sent (synchronous) or handed to
        the fetchers (pipelined).
        """
        t0 = time.perf_counter()
        self._drain_requests()
        active = np.nonzero(self.has_frame)[0]
        if active.size == 0:
            return 0
        with self._device_ctx(), torch.no_grad():
            frames = self._upload(self.pending)
            (pose, _, root, contact), self.states = self._step(
                self.params, self.states, frames)
            outs = self._post(pose, root, contact)
            # dispatch-time snapshot: slot ownership can change before the
            # (possibly deferred) fetch
            snapshot = ([(int(s), self.id_of[int(s)], self.addr_of[int(s)])
                         for s in active
                         if self.addr_of.get(int(s)) is not None],
                        time.perf_counter())
            if self.pipelined:
                # The copy gate: while the fetch queue is at least half
                # full the fetchers are behind, and a copy issued now may
                # be for a tick the drop-oldest policy discards; its
                # fetcher copies when it reaches it. Below half, a backlog
                # of a tick or two is a blip, and deferring its copies
                # would lengthen it.
                if self._fetch_q.qsize() < self._fetch_q.maxsize // 2:
                    host, event = self._issue_copy(outs)
                else:
                    host, event = None, None
                    self.deferred_copies += 1
                self._enqueue_replies((outs, host, event), snapshot)
                sent = len(snapshot[0])
            else:
                host_np = self._fetch(outs, None, None)
                with self._send_lock:
                    sent = self._send_replies(host_np, snapshot)
        self.has_frame[active] = False
        self._tick_ms[self._tick_n % self._tick_ms.size] = (
            (time.perf_counter() - t0) * 1e3)
        self._tick_n += 1
        return sent

    def stats(self) -> dict:
        """Serving SLO snapshot: tick-latency percentiles over the last
        <= 1024 active ticks (drain, batch step and, synchronous, the
        replies) plus cumulative counters. The tick ring is written by
        the serving thread alone; the fetch counters are read under the
        lock their writers hold."""
        n = min(self._tick_n, self._tick_ms.size)
        lat = self._tick_ms[:n].copy() if n else np.zeros(1)
        p50, p90, p99 = np.percentile(lat, [50, 90, 99])
        now = time.time()
        active = sum(1 for slot in self.slot_of.values()
                     if now - self.last_seen[slot] <= self.idle_timeout)
        out = {
            "frames_served": self.frames_served,
            "mode": self.mode,
            "quantize": self.quantize,
            "wire": self.wire,
            "device": str(self.device),
            "native_udp": self._native_udp is not None,
            "rejected_frames": self.rejected_frames,
            "active_streams": active,
            "ticks_measured": int(n),
            "tick_ms_p50": round(float(p50), 3),
            "tick_ms_p90": round(float(p90), 3),
            "tick_ms_p99": round(float(p99), 3),
            "tick_budget_ms": round(self.tick_period * 1e3, 3),
        }
        if self.pipelined:
            # fetch latency runs on the fetcher threads; it bounds reply
            # LAG, while tick_ms bounds the serving RATE
            with self._send_lock:
                m = min(self._fetch_n, self._fetch_ms.size)
                fl = self._fetch_ms[:m].copy() if m else np.zeros(1)
                k = min(self._lag_n, self._lag_ms.size)
                ll = self._lag_ms[:k].copy() if k else np.zeros(1)
                counters = {"dropped_replies": self.dropped_replies,
                            "fetch_errors": self.fetch_errors}
                last_error = self._last_fetch_error
            f50, f99 = np.percentile(fl, [50, 99])
            l50, l99 = np.percentile(ll, [50, 99])
            out.update({
                "pipelined": True,
                "fetch_workers": self.fetch_workers,
                "fetch_ms_p50": round(float(f50), 3),
                "fetch_ms_p99": round(float(f99), 3),
                "reply_lag_ms_p50": round(float(l50), 3),
                "reply_lag_ms_p99": round(float(l99), 3),
                "reply_queue_depth": self._fetch_q.qsize(),
                "deferred_copies": self.deferred_copies,
                **counters,
                **({"last_fetch_error": last_error} if last_error else {}),
            })
        return out

    def run(self, duration: Optional[float] = None) -> None:
        if self.pipelined:
            self._start_fetcher()
        t0 = time.time()
        # absolute-deadline pacing: a relative sleep(period - work) adds
        # every sleep overshoot to the period (stream/pacing.py)
        pacer = Pacer(self.tick_period)
        while not self._stop.is_set():
            self.tick()
            if duration is not None and time.time() - t0 > duration:
                break
            pacer.wait()

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self._stop.set()
        for t in self._fetchers:
            if t.is_alive():
                # the drain deadline plus one in-flight fetch
                t.join(timeout=self._drain_deadline + 8)
        self.sock.close()


class PoseClient:
    """Minimal client for PoseServer (also the test fixture)."""

    def __init__(self, stream_id: int, host: str = "127.0.0.1",
                 port: int = 9000, timeout: float = 2.0, wire: str = "f32"):
        """wire must match the server's reply format ('f32' or 'f16');
        requests are always float32."""
        self.stream_id = stream_id
        self.addr = (host, port)
        if wire not in ("f32", "f16"):
            raise ValueError(f"unknown wire format {wire!r}")
        self.wire = wire
        self._reply_struct = (REPLY_STRUCT if wire == "f32"
                              else REPLY_STRUCT_F16)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.settimeout(timeout)

    def send_frame(self, imu60: np.ndarray) -> None:
        self.sock.sendto(REQUEST_STRUCT.pack(
            self.stream_id, *np.asarray(imu60, np.float32).tolist()),
            self.addr)

    def recv_pose(self):
        """(pose_aa [72], tran [3], contact [2]) or None on timeout.

        Raises ValueError on a reply whose length is not this wire
        format's (a client and a server on different wire formats) or
        that names another stream."""
        try:
            # a buffer larger than either reply, so a reply of the other
            # format shows its own length instead of being truncated
            data, _ = self.sock.recvfrom(2048)
        except socket.timeout:
            return None
        if len(data) != self._reply_struct.size:
            raise ValueError(
                f"reply of {len(data)} bytes; wire={self.wire!r} replies "
                f"are {self._reply_struct.size} (does the server use "
                "another wire format?)")
        u = self._reply_struct.unpack(data)
        if u[0] != self.stream_id:
            raise ValueError(f"reply for stream {u[0]}, this client is "
                             f"stream {self.stream_id}")
        vals = np.asarray(u[1:], np.float32)
        return vals[:72], vals[72:75], vals[75:77]

    def close(self) -> None:
        self.sock.close()
