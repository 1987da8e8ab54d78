"""Native (C++) runtime components, loaded via ctypes (the port's copy of
the JAX package's `native/`).

`ServingUDP` batches the serving tick's UDP syscalls (recvmmsg /
sendmmsg, GIL-free); `NativeIngest` wraps the GIL-free sensor receive
loop with per-device lock-free rings; `parse_packet` runs the device
wire-format parser. They wrap `sensor_ingest.cpp`, which is host code
(no GPU), built with g++ at first use through the checked-in Makefile
into this directory, under a name that carries a hash of the source and
the Makefile, so an edited source is rebuilt and a stale library never
loads. Without a compiler, callers fall back to their Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_DIR = Path(__file__).parent
_SOURCES = ("sensor_ingest.cpp", "Makefile")


def library_path() -> Path:
    """Where the library built from this directory's sources lives."""
    digest = hashlib.sha256(b"".join(
        (_DIR / f).read_bytes() for f in _SOURCES)).hexdigest()[:16]
    return _DIR / f"libsensor_ingest-{digest}.so"


def build_library() -> Optional[Path]:
    """Build the library with make/g++ unless it exists. Returns its path,
    or None when the build fails (no toolchain). The build writes a
    temporary name and renames it, so a concurrent loader never sees half
    a file."""
    out = library_path()
    if out.exists():
        return out
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    try:
        subprocess.run(["make", "-C", str(_DIR), f"TARGET={tmp.name}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except Exception as e:                        # noqa: BLE001
        tmp.unlink(missing_ok=True)
        print(f"native library build failed: {e}", file=sys.stderr)
        return None
    return out


def load_library() -> Optional[ctypes.CDLL]:
    path = build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.ingest_create.restype = ctypes.c_void_p
    lib.ingest_create.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.ingest_start.argtypes = [ctypes.c_void_p]
    lib.ingest_stop.argtypes = [ctypes.c_void_p]
    lib.ingest_destroy.argtypes = [ctypes.c_void_p]
    lib.ingest_packet_count.restype = ctypes.c_uint64
    lib.ingest_packet_count.argtypes = [ctypes.c_void_p]
    lib.ingest_reject_count.restype = ctypes.c_uint64
    lib.ingest_reject_count.argtypes = [ctypes.c_void_p]
    lib.ingest_latest.restype = ctypes.c_uint64
    lib.ingest_latest.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_double)]
    lib.ingest_read_since.restype = ctypes.c_int
    lib.ingest_read_since.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.ingest_parse.restype = ctypes.c_int
    lib.ingest_parse.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_double)]
    lib.udp_drain_requests.restype = ctypes.c_int
    lib.udp_drain_requests.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.udp_send_batch.restype = ctypes.c_int
    lib.udp_send_batch.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.udp_drain_count.restype = ctypes.c_int
    lib.udp_drain_count.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


class NativeIngest:
    """GIL-free multi-port UDP sensor ingest (see sensor_ingest.cpp)."""

    NUM_SLOTS = 5
    FRAME_DIM = 9  # [unix_ts, sensor_ts, acc xyz, quat xyzw]

    def __init__(self, host: str = "0.0.0.0",
                 ports: Sequence[int] = (8001, 8002, 8003, 8004, 8005),
                 lib: Optional[ctypes.CDLL] = None):
        self.lib = lib or load_library()
        if self.lib is None:
            raise RuntimeError("native ingest library unavailable")
        arr = (ctypes.c_int * len(ports))(*ports)
        self.handle = self.lib.ingest_create(host.encode(), arr, len(ports))
        if not self.handle:
            raise OSError(f"failed to bind UDP ports {list(ports)}")
        self._started = False

    def start(self) -> None:
        if not self._started:
            self.lib.ingest_start(self.handle)
            self._started = True

    def stop(self) -> None:
        if self._started:
            self.lib.ingest_stop(self.handle)
            self._started = False

    def close(self) -> None:
        if self.handle:
            self.lib.ingest_destroy(self.handle)
            self.handle = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        self.close()

    @property
    def packet_count(self) -> int:
        return int(self.lib.ingest_packet_count(self.handle))

    @property
    def reject_count(self) -> int:
        return int(self.lib.ingest_reject_count(self.handle))

    def latest(self, slot: int) -> Optional[Tuple[int, np.ndarray]]:
        """Newest frame of a device slot: (seq, [ts, ts, acc3, quat4])."""
        buf = (ctypes.c_double * self.FRAME_DIM)()
        seq = self.lib.ingest_latest(self.handle, slot, buf)
        if seq == 0:
            return None
        return int(seq), np.frombuffer(buf, np.float64).copy()

    def read_since(self, slot: int, after_seq: int,
                   max_frames: int = 64) -> Tuple[np.ndarray, int]:
        """Frames of `slot` newer than after_seq: ([n, 9], last_seq)."""
        buf = (ctypes.c_double * (self.FRAME_DIM * max_frames))()
        last = ctypes.c_uint64()
        n = self.lib.ingest_read_since(self.handle, slot, after_seq, buf,
                                       max_frames, ctypes.byref(last))
        frames = np.frombuffer(buf, np.float64)[:n * self.FRAME_DIM]
        return frames.reshape(n, self.FRAME_DIM).copy(), int(last.value)


class ServingUDP:
    """Batched UDP syscalls for the serving tick (recvmmsg/sendmmsg,
    GIL-free; sensor_ingest.cpp `udp_*`).

    One `drain` call replaces S recvfrom + struct.unpack + isfinite
    Python iterations; one `send` call replaces S sendto calls, which at
    hundreds of streams x 30 Hz hold the GIL for tens of thousands of
    syscalls a second. Addresses are opaque uint64 tokens
    ((ipv4_be << 16) | port_be) round-tripped from drain to send; Python
    never parses them."""

    REQ_DIM = 60

    def __init__(self, lib: Optional[ctypes.CDLL] = None):
        self.lib = lib or load_library()
        if self.lib is None:
            raise RuntimeError("native library unavailable")

    def drain(self, fd: int, max_n: int, max_total: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Drain up to max_n valid requests from the non-blocking socket
        `fd`: (ids uint32[n], frames float32[n,60], addr_tokens
        uint64[n], rejected). Wrong-size and non-finite datagrams are
        rejected in C, matching PoseServer._drain_requests — and like it,
        `max_total` (default 2*max_n) bounds total datagrams PROCESSED so
        a garbage flood cannot spin the drain."""
        ids = np.empty(max_n, np.uint32)
        frames = np.empty((max_n, self.REQ_DIM), np.float32)
        addrs = np.empty(max_n, np.uint64)
        rej = ctypes.c_int(0)
        n = self.lib.udp_drain_requests(
            fd, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            addrs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            max_n, max_total if max_total is not None else 2 * max_n,
            ctypes.byref(rej))
        return ids[:n], frames[:n], addrs[:n], rej.value

    def send(self, fd: int, payload: bytes, n: int, size: int,
             addr_tokens: np.ndarray) -> int:
        """Send n contiguous `size`-byte payloads to per-row addresses.
        Returns the number sent: a datagram the kernel refuses is skipped
        and the rest still go out, like the Python path's per-datagram
        OSError drop."""
        addr_tokens = np.ascontiguousarray(addr_tokens, np.uint64)
        return self.lib.udp_send_batch(
            fd, payload, n, size,
            addr_tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))

    def drain_count(self, fd: int, max_n: int) -> int:
        """Drain and count datagrams of any size (benchmark drivers)."""
        return self.lib.udp_drain_count(fd, max_n)

    @staticmethod
    def addr_token(host: str, port: int) -> int:
        """Build the uint64 address token for a known destination (the
        same encoding udp_drain_requests emits: C reads sin_addr.s_addr /
        sin_port — network-byte-order fields — as host integers)."""
        ip = int.from_bytes(socket.inet_aton(host), sys.byteorder)
        pt = int.from_bytes(port.to_bytes(2, "big"), sys.byteorder)
        return (ip << 16) | pt


def parse_packet(data: bytes, lib: Optional[ctypes.CDLL] = None
                 ) -> Optional[Tuple[int, np.ndarray]]:
    """Parse one wire packet with the native parser (unit-test hook)."""
    lib = lib or load_library()
    if lib is None:
        return None
    buf = (ctypes.c_double * NativeIngest.FRAME_DIM)()
    slot = lib.ingest_parse(data, len(data), buf)
    if slot < 0:
        return None
    return slot, np.frombuffer(buf, np.float64).copy()
