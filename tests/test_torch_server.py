"""The port's multi-stream pose server (`stream/server.py`), its native UDP
helpers (`native/`) and `cli.serve`, on the CPU (`device="cpu"`), over
loopback UDP: the cases of tests/test_server.py that one device can run,
the JAX server against the port's on the same frames, and the repairs the
port makes to the JAX server's reply path (the reply-length check, the
copy gate read from the queue's size, the locked fetch counters, the
native send that skips a refused datagram, the out-of-place slot reset).

Weights: the port's `init_all_modules` from a seeded generator, or a JAX
tree through `nn.convert.params_from_jax`. Frames are made with numpy
from a seed. Most tests drive `tick()` in lockstep (send, tick, receive),
so every reply is the reply to a known frame.
"""

import errno
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.models import MobilePoserNet as JaxNet
from mobileposer_tpu.models import init_all_modules as jax_init_all_modules
from mobileposer_tpu.native import parse_packet as jax_parse_packet
from mobileposer_tpu.stream import PoseServer as JaxPoseServer
from mobileposer_tpu.stream import encode_packet
from mobileposer_tpu_torch.cli import serve as serve_cli
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.kinematics import rotation as R
from mobileposer_tpu_torch.models import MobilePoserNet, init_all_modules
from mobileposer_tpu_torch.native import ServingUDP, parse_packet
from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax
from mobileposer_tpu_torch.nn.torch_convert import save_torch_checkpoint
from mobileposer_tpu_torch.ops.quant import quantize_params_int8
from mobileposer_tpu_torch.parallel import make_mesh
from mobileposer_tpu_torch.stream import (REPLY_STRUCT, REPLY_STRUCT_F16,
                                          REQUEST_STRUCT, Pacer, PoseClient,
                                          PoseServer)
from mobileposer_tpu_torch.stream import server as server_mod

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "demo_checkpoint_f16.npz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: one torch thread beside other busy test
    processes, as tests/test_torch_eval.py runs them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def net():
    return MobilePoserNet(ParametricModel.synthetic(num_vertices=240),
                          device="cpu")


@pytest.fixture(scope="module")
def params():
    return init_all_modules(torch.Generator().manual_seed(0), device="cpu")


def _server(net, params, **kw):
    kw.setdefault("max_streams", 8)
    kw.setdefault("tick_hz", 240.0)
    return PoseServer(net, params, host="127.0.0.1", port=0, **kw)


def _frames(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.randn(60) * 0.1).astype(np.float32) for _ in range(n)]


def _lockstep(srv, client, frames, timeout=30.0):
    """Send each frame, tick, wait for its reply: [concatenated reply]."""
    out = []
    for f in frames:
        client.send_frame(f)
        time.sleep(0.005)                   # loopback delivery
        srv.tick()
        r = None
        deadline = time.time() + timeout
        while r is None and time.time() < deadline:
            r = client.recv_pose()
        assert r is not None, "no reply"
        out.append(np.concatenate(r))
    return np.stack(out)


def _close(srv, *clients, thread=None):
    for c in clients:
        c.close()
    srv.stop()
    if thread is not None:
        thread.join(timeout=10)
    srv.close()


@pytest.fixture(scope="module")
def running(net, params):
    """A server ticking in its own thread (`run`), 8 slots."""
    srv = _server(net, params, tick_hz=120.0)
    thread = threading.Thread(target=srv.run, daemon=True)
    thread.start()
    yield srv
    _close(srv, thread=thread)


def test_multi_client_round_trip(running):
    rng = np.random.RandomState(0)
    clients = [PoseClient(stream_id=100 + i, port=running.port)
               for i in range(3)]
    try:
        replies = {c.stream_id: 0 for c in clients}
        for _ in range(5):
            for c in clients:
                c.send_frame(rng.randn(60).astype(np.float32) * 0.1)
            for c in clients:
                out = c.recv_pose()
                if out is None:
                    continue
                pose_aa, tran, contact = out
                assert pose_aa.shape == (72,) and contact.shape == (2,)
                assert np.all(np.isfinite(pose_aa))
                assert np.all(np.isfinite(tran))
                replies[c.stream_id] += 1
        assert all(v >= 3 for v in replies.values()), replies
        assert running.frames_served >= 9
        stats = running.stats()
        assert stats["device"] == "cpu" and stats["ticks_measured"] > 0
        assert 0 < stats["tick_ms_p50"] <= stats["tick_ms_p99"]
    finally:
        for c in clients:
            c.close()


def test_stream_state_isolation(running):
    """Two streams fed different data produce different outputs."""
    a = PoseClient(stream_id=200, port=running.port)
    b = PoseClient(stream_id=201, port=running.port)
    try:
        fa, fb = _frames(1, 2)
        a.send_frame(fa)
        b.send_frame(fb)
        pa, pb = a.recv_pose(), b.recv_pose()
        assert pa is not None and pb is not None
        assert not np.allclose(pa[0], pb[0])
    finally:
        a.close()
        b.close()


def test_server_full_rejects_gracefully(running):
    """Earlier tests hold 5 of the 8 slots (100-102, 200-201): 3 more
    fit, a 9th stream gets no slot, and an admitted stream still gets
    replies."""
    extras = [PoseClient(stream_id=300 + i, port=running.port, timeout=0.5)
              for i in range(4)]
    try:
        for c in extras:
            c.send_frame(np.zeros(60, np.float32))
        got = sum(1 for c in extras if c.recv_pose() is not None)
        assert got <= 3
        probe = PoseClient(stream_id=200, port=running.port)
        probe.send_frame(np.zeros(60, np.float32))
        assert probe.recv_pose() is not None
        probe.close()
    finally:
        for c in extras:
            c.close()


def test_late_join_gets_fresh_state(net, params):
    """A stream that claims a slot after the server has ticked other
    streams sees a fresh state: its first reply is `forward_online` on a
    fresh single-stream state."""
    srv = _server(net, params, max_streams=2)
    warm = PoseClient(stream_id=400, port=srv.port)
    late = PoseClient(stream_id=401, port=srv.port)
    try:
        _lockstep(srv, warm, [np.zeros(60, np.float32)] * 4)
        frame = _frames(5, 1)[0]
        got = _lockstep(srv, late, [frame])[0]
        with torch.no_grad():
            (pose, _, root, contact), _ = net.forward_online(
                params, net.init_online_state(), torch.from_numpy(frame))
        want = np.concatenate([
            R.rotation_matrix_to_axis_angle(pose).reshape(72).numpy(),
            root.numpy(), contact.numpy()])
        np.testing.assert_allclose(got, want, atol=1e-5)
    finally:
        _close(srv, warm, late)


@pytest.mark.parametrize("mode,quantize", [("exact", "int8"),
                                           ("carry", None),
                                           ("carry", "int8")])
def test_modes_reply_the_direct_step(net, params, mode, quantize):
    """Carry mode, int8, and both: replies equal the step the server runs
    called directly on the same frames (one stream in slot 0, the other
    slots repeating their zero frame) and the post step, exactly."""
    srv = _server(net, params, max_streams=2, mode=mode, quantize=quantize)
    client = PoseClient(stream_id=7, port=srv.port)
    frames = _frames(11, 5)
    try:
        got = _lockstep(srv, client, frames)
        assert srv.stats()["mode"] == mode
        assert srv.stats()["quantize"] == quantize
    finally:
        _close(srv, client)
    p = quantize_params_int8(params) if quantize else params
    if mode == "carry":
        st, step = net.init_carry_state_batched(2), net.forward_carry_batched
    else:
        st, step = net.init_online_state_batched(2), net.forward_online_batched
    want = []
    with torch.no_grad():
        for f in frames:
            batch = torch.zeros(2, 60)
            batch[0] = torch.from_numpy(f)
            (pose, _, root, contact), st = step(p, st, batch)
            aa = R.rotation_matrix_to_axis_angle(pose.reshape(-1, 3, 3))
            want.append(np.concatenate([aa.reshape(2, 72)[0].numpy(),
                                        root[0].numpy(),
                                        contact[0].numpy()]))
    np.testing.assert_array_equal(got, np.stack(want))


def test_nonfinite_frames_dropped(net, params):
    """NaN frames are dropped at ingestion and never answered; the healthy
    stream keeps finite replies."""
    srv = _server(net, params, max_streams=4)
    good = PoseClient(stream_id=700, port=srv.port)
    bad = PoseClient(stream_id=701, port=srv.port, timeout=0.2)
    try:
        for f in _frames(7, 4):
            bad.send_frame(np.full(60, np.nan, np.float32))
            r = _lockstep(srv, good, [f])[0]
            assert np.isfinite(r).all()
        assert bad.recv_pose() is None
        assert srv.stats()["rejected_frames"] == 4
    finally:
        _close(srv, good, bad)


@pytest.mark.parametrize("kwargs", [dict(pipelined=True),
                                    dict(pipelined=True, fetch_workers=4)],
                         ids=["pipelined", "pool"])
def test_pipelined_replies_match_synchronous(net, params, kwargs):
    """Pipelining changes when replies arrive, never what they hold; a
    fetcher pool in lockstep never reorders, so nothing is dropped."""
    frames = _frames(23, 6)
    replies = {}
    for name, kw in (("sync", {}), ("pipelined", kwargs)):
        srv = _server(net, params, max_streams=4, **kw)
        client = PoseClient(stream_id=9, port=srv.port)
        try:
            replies[name] = _lockstep(srv, client, frames)
            if kw:
                stats = srv.stats()
                assert stats["pipelined"] is True
                assert stats["fetch_workers"] == kw.get("fetch_workers", 1)
                assert stats["dropped_replies"] == 0
                assert stats["deferred_copies"] == 0
                assert stats["reply_lag_ms_p99"] >= stats[
                    "reply_lag_ms_p50"] >= 0
                assert all(t.is_alive() for t in srv._fetchers)
        finally:
            _close(srv, client)
    np.testing.assert_array_equal(replies["pipelined"], replies["sync"])


def test_pipelined_fetcher_survives_fetch_errors(net, params, monkeypatch):
    """A failed fetch does not kill the fetcher: its tick's replies are
    dropped and counted, and the next tick's go out."""
    srv = _server(net, params, max_streams=2, pipelined=True)
    client = PoseClient(stream_id=4, port=srv.port, timeout=30.0)
    real = srv._fetch
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated transport failure")
        return real(*a)

    monkeypatch.setattr(srv, "_fetch", flaky)
    try:
        client.send_frame(np.zeros(60, np.float32))
        time.sleep(0.005)
        srv.tick()
        deadline = time.time() + 30
        while srv.fetch_errors == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert srv.fetch_errors == 1
        assert any(t.is_alive() for t in srv._fetchers)
        client.sock.settimeout(0.5)
        assert client.recv_pose() is None          # the first was dropped
        client.sock.settimeout(30.0)
        _lockstep(srv, client, [np.zeros(60, np.float32)])
        stats = srv.stats()
        assert stats["fetch_errors"] == 1
        assert "simulated transport failure" in stats["last_fetch_error"]
        assert stats["dropped_replies"] >= 1
    finally:
        _close(srv, client)


def test_pipelined_flushes_on_close(net, params):
    """Replies dispatched but not yet fetched still go out on shutdown."""
    srv = _server(net, params, max_streams=2, pipelined=True)
    client = PoseClient(stream_id=5, port=srv.port, timeout=30.0)
    try:
        client.send_frame(np.zeros(60, np.float32))
        time.sleep(0.005)
        srv.tick()
        srv.stop()
        srv.close()
        assert client.recv_pose() is not None
    finally:
        client.close()


def test_fetch_freshness_gate_drops_stale_tick(net, params, monkeypatch):
    """A tick whose fetch completes after a newer tick was sent is dropped
    whole: clients never see a pose regress."""
    srv = _server(net, params, max_streams=2, pipelined=True,
                  fetch_workers=2)
    client = PoseClient(stream_id=2, port=srv.port, timeout=30.0)
    real = srv._fetch
    first_entered, release_first = threading.Event(), threading.Event()
    calls = {"n": 0}

    def stalling(*a):
        calls["n"] += 1
        if calls["n"] == 1:
            first_entered.set()
            release_first.wait(timeout=30)
        return real(*a)

    try:
        monkeypatch.setattr(srv, "_fetch", stalling)
        client.send_frame(np.ones(60, np.float32) * 0.01)   # tick A stalls
        time.sleep(0.005)
        srv.tick()
        assert first_entered.wait(timeout=30)
        rb = _lockstep(srv, client, [np.ones(60, np.float32) * 0.02])
        assert rb.shape == (1, 77)                          # tick B went out
        dropped = srv.dropped_replies
        release_first.set()                                  # A completes
        deadline = time.time() + 30
        while srv.dropped_replies == dropped and time.time() < deadline:
            time.sleep(0.01)
        assert srv.dropped_replies == dropped + 1
        client.sock.settimeout(0.5)
        assert client.recv_pose() is None                    # A never sent
    finally:
        release_first.set()
        _close(srv, client)


def _blocked_fetch(srv, monkeypatch):
    """Make every fetch wait until the returned event is set."""
    real = srv._fetch
    release = threading.Event()

    def slow(*a):
        release.wait(timeout=60)
        return real(*a)

    monkeypatch.setattr(srv, "_fetch", slow)
    return release


@pytest.mark.parametrize("queue_size", [8, 4])
def test_copy_gate_engages_at_half_the_queue(net, params, monkeypatch,
                                             queue_size):
    """A slow fetcher: the fetcher holds one tick, the queue fills, and
    from half the queue's size on each tick defers its copy. The gate
    reads the queue it is given, not a fixed depth."""
    srv = _server(net, params, max_streams=2, pipelined=True)
    monkeypatch.setattr(srv, "_fetch_q", server_mod.queue.Queue(queue_size))
    release = _blocked_fetch(srv, monkeypatch)
    client = PoseClient(stream_id=3, port=srv.port, timeout=30.0)
    depths = []
    try:
        client.send_frame(np.zeros(60, np.float32))
        time.sleep(0.005)
        srv.tick()                              # the fetcher takes it, waits
        deadline = time.time() + 30
        while srv._fetch_q.qsize() and time.time() < deadline:
            time.sleep(0.005)
        for f in _frames(3, queue_size):
            client.send_frame(f)
            time.sleep(0.005)
            depths.append(srv._fetch_q.qsize())
            srv.tick()
        # a copy is issued while fewer than half the queue's ticks wait
        want = sum(d >= queue_size // 2 for d in depths)
        assert want == queue_size - queue_size // 2
        assert srv.stats()["deferred_copies"] == want
        release.set()
        got = [client.recv_pose() for _ in range(queue_size + 1)]
        assert all(r is not None for r in got)      # every tick still sent
        assert srv.stats()["dropped_replies"] == 0
    finally:
        release.set()
        _close(srv, client)


def test_slot_reset_during_fetch_keeps_the_fetched_root(net, params,
                                                        monkeypatch):
    """A tick's `root` is the step's `last_root_pos` itself. With the
    fetcher slow and the tick's copy deferred by the gate, a slot reset
    made before the fetch must not change the root that fetch sends: the
    reset replaces the state's tensors, it does not write into them."""
    srv = _server(net, params, max_streams=2, pipelined=True)
    release = _blocked_fetch(srv, monkeypatch)
    client = PoseClient(stream_id=6, port=srv.port, timeout=30.0)
    frames = _frames(13, srv.FETCH_QUEUE_SIZE // 2 + 2)
    try:
        for f in frames:
            client.send_frame(f)
            time.sleep(0.005)
            srv.tick()
        assert srv.stats()["deferred_copies"] >= 1   # the last tick's copy
        root = srv.states.last_root_pos[0].clone()
        assert float(root.abs().max()) > 0
        srv._reset_slot(0)
        assert float(srv.states.last_root_pos[0].abs().max()) == 0.0
        release.set()
        replies = [client.recv_pose() for _ in frames]
        assert all(r is not None for r in replies)
        np.testing.assert_array_equal(replies[-1][1], root.numpy())
    finally:
        release.set()
        _close(srv, client)


class _LockCheckedServer(PoseServer):
    """Records every write of a fetch counter made without _send_lock
    held (after construction)."""

    GUARDED = {"fetch_errors", "dropped_replies", "_fetch_n", "_lag_n",
               "frames_served", "_last_fetch_error", "_max_sent_seq"}

    def __setattr__(self, name, value):
        if (name in self.GUARDED and self.__dict__.get("armed")
                and not self._send_lock.locked()):
            self.__dict__["unlocked_writes"].append(name)
        super().__setattr__(name, value)


def test_fetch_counters_written_under_the_lock(net, params, monkeypatch):
    """Four fetchers, every other fetch failing, a switch interval short
    enough to interleave them anywhere: each counter write happens with
    _send_lock held, and the counts add up (a lost update breaks them)."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_lock_checked(net, params, monkeypatch)
    finally:
        sys.setswitchinterval(interval)


def _run_lock_checked(net, params, monkeypatch):
    srv = _LockCheckedServer(net, params, host="127.0.0.1", port=0,
                             max_streams=2, pipelined=True, fetch_workers=4)
    srv.__dict__.update(armed=True, unlocked_writes=[])
    real = srv._fetch
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] % 2:
            raise RuntimeError("odd fetch")
        return real(*a)

    monkeypatch.setattr(srv, "_fetch", flaky)
    client = PoseClient(stream_id=1, port=srv.port, timeout=0.5)
    try:
        for f in _frames(17, 12):
            client.send_frame(f)
            time.sleep(0.002)
            srv.tick()
        srv.stop()
        srv.close()
        assert srv.unlocked_writes == []
        assert srv.fetch_errors == (calls["n"] + 1) // 2
        sent = srv.frames_served
        assert sent + srv.dropped_replies == 12
    finally:
        client.close()


@pytest.mark.parametrize("server_wire,client_wire", [("f32", "f16"),
                                                     ("f16", "f32")])
def test_client_rejects_the_other_wire_format(net, params, server_wire,
                                              client_wire):
    srv = _server(net, params, max_streams=2, wire=server_wire)
    client = PoseClient(stream_id=1, port=srv.port, wire=client_wire)
    try:
        client.send_frame(np.zeros(60, np.float32))
        time.sleep(0.005)
        srv.tick()
        with pytest.raises(ValueError, match="wire"):
            client.recv_pose()
    finally:
        _close(srv, client)


def test_f16_wire_matches_f32_within_half_precision(net, params):
    """wire='f16' changes the encoding, not the computation: poses and
    contacts within an f16 ulp of the f32 server's (|aa| <= pi: 2e-3),
    translation bitwise (it stays f32); the 164-byte layout."""
    assert REPLY_STRUCT_F16.size == 164 and REPLY_STRUCT.size == 312
    assert PoseServer._REPLY_DTYPE_F16.itemsize == REPLY_STRUCT_F16.size
    frames = _frames(17, 4)
    replies = {}
    for wire in ("f32", "f16"):
        srv = _server(net, params, max_streams=4, wire=wire)
        client = PoseClient(stream_id=5, port=srv.port, wire=wire)
        try:
            replies[wire] = _lockstep(srv, client, frames)
            assert srv.stats()["wire"] == wire
        finally:
            _close(srv, client)
    a, b = replies["f32"], replies["f16"]
    np.testing.assert_allclose(b[:, :72], a[:, :72], atol=2e-3)
    np.testing.assert_array_equal(b[:, 72:75], a[:, 72:75])
    np.testing.assert_allclose(b[:, 75:], a[:, 75:], atol=1e-3)


def test_native_udp_replies_match_python(net, params, monkeypatch):
    """The recvmmsg/sendmmsg path changes how datagrams move, never what
    the replies hold."""
    frames = _frames(19, 4)
    replies = {}
    for name, env in (("python", "0"), ("native", "1")):
        monkeypatch.setenv("MP_NATIVE_UDP", env)
        srv = _server(net, params, max_streams=4)
        assert srv.stats()["native_udp"] == (name == "native")
        client = PoseClient(stream_id=3, port=srv.port)
        try:
            replies[name] = _lockstep(srv, client, frames)
        finally:
            _close(srv, client)
    np.testing.assert_array_equal(replies["native"], replies["python"])


def test_native_udp_rejects_malformed_and_nonfinite(net, params):
    srv = _server(net, params, max_streams=4)
    assert srv.stats()["native_udp"] is True
    client = PoseClient(stream_id=21, port=srv.port)
    raw = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        addr = ("127.0.0.1", srv.port)
        raw.sendto(b"garbage", addr)
        bad = np.zeros(60, np.float32)
        bad[0] = np.inf
        raw.sendto(REQUEST_STRUCT.pack(21, *bad.tolist()), addr)
        r = _lockstep(srv, client, [np.zeros(60, np.float32)])
        assert np.all(np.isfinite(r))
        assert srv.stats()["rejected_frames"] == 2
    finally:
        raw.close()
        _close(srv, client)


def test_native_send_skips_a_refused_datagram():
    """A datagram the kernel refuses (the broadcast address on a socket
    without SO_BROADCAST: EACCES) is skipped; the ones after it in the
    same batch are still sent."""
    udp = ServingUDP()
    rx = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(2)]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for s in rx:
            s.bind(("127.0.0.1", 0))
            s.settimeout(2.0)
        with pytest.raises(OSError) as e:
            tx.sendto(b"x", ("255.255.255.255", rx[0].getsockname()[1]))
        assert e.value.errno == errno.EACCES
        tokens = np.array([
            ServingUDP.addr_token("127.0.0.1", rx[0].getsockname()[1]),
            ServingUDP.addr_token("255.255.255.255", 9),
            ServingUDP.addr_token("127.0.0.1", rx[1].getsockname()[1])],
            np.uint64)
        payload = b"aaaa" + b"bbbb" + b"cccc"
        assert udp.send(tx.fileno(), payload, 3, 4, tokens) == 2
        assert rx[0].recv(16) == b"aaaa"
        assert rx[1].recv(16) == b"cccc"
        # a refused first datagram of the batch, too
        assert udp.send(tx.fileno(), payload[4:], 2, 4, tokens[1:]) == 1
        assert rx[1].recv(16) == b"cccc"
    finally:
        for s in rx + [tx]:
            s.close()


def test_native_parser_matches_the_jax_library():
    """The port's copy of the sensor parser answers as the JAX package's
    library does, on valid and garbage packets."""
    rng = np.random.RandomState(0)
    pkts = [b"", b"stop", b"left;phone:1 2 3"]
    for device, dtype in (("left", "phone"), ("right", "watch"),
                          ("left", "headphone")):
        quat = rng.randn(4)
        pkts.append(encode_packet(device, dtype, [123.5, 4.25], rng.randn(3),
                                  quat / np.linalg.norm(quat)))
    for pkt in pkts:
        got, want = parse_packet(pkt), jax_parse_packet(pkt)
        assert (got is None) == (want is None), pkt
        if got is not None:
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])


def test_pacer_keeps_an_absolute_schedule():
    """One slow sleep does not move later deadlines; a loop that falls
    behind realigns instead of bursting."""
    now = [0.0]
    sleeps = []

    def sleep(dt):
        sleeps.append(dt)
        now[0] += dt + 0.004                  # every sleep overshoots 4 ms

    pacer = Pacer(0.1, clock=lambda: now[0], sleep=sleep)
    for _ in range(3):
        pacer.wait()
    np.testing.assert_allclose(sleeps, [0.1, 0.096, 0.096])
    now[0] += 1.0                              # a stall
    pacer.wait()
    assert len(sleeps) == 3                    # no sleep, realigned
    with pytest.raises(ValueError):
        Pacer(0.0)


def test_server_matches_jax_server():
    """The JAX server and the port's, exact float32 mode, the same
    weights and frames in lockstep: decoded replies within the JAX
    package's own server-equality bound (1e-4, tests/test_server.py)."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_init_all_modules(jax.random.PRNGKey(0)))
    jsrv = JaxPoseServer(JaxNet(JaxBody.synthetic(num_vertices=240)), tree,
                         host="127.0.0.1", port=0, max_streams=4)
    net = MobilePoserNet(ParametricModel.synthetic(num_vertices=240),
                         device="cpu")
    srv = _server(net, params_from_jax(tree, device="cpu"), max_streams=4)
    frames = _frames(29, 5)
    replies = {}
    for name, s in (("jax", jsrv), ("port", srv)):
        clients = [PoseClient(stream_id=10 + i, port=s.port, timeout=120.0)
                   for i in range(2)]
        try:
            out = []
            for f in frames:
                for k, c in enumerate(clients):
                    c.send_frame(f * (k + 1))
                time.sleep(0.01)
                s.tick()
                out.append([np.concatenate(c.recv_pose()) for c in clients])
            replies[name] = np.asarray(out)
        finally:
            _close(s, *clients)
    np.testing.assert_allclose(replies["port"], replies["jax"], atol=1e-4)


def test_options_the_port_does_not_serve_raise(net, params):
    with pytest.raises(ValueError, match="mode"):
        _server(net, params, mode="bogus")
    with pytest.raises(ValueError, match="wire"):
        _server(net, params, wire="f8")
    with pytest.raises(ValueError, match="wire"):
        PoseClient(stream_id=1, wire="f64")
    with pytest.raises(ValueError, match="quantize"):
        _server(net, params, quantize="fp4")
    with pytest.raises(ValueError, match="fetch_workers"):
        _server(net, params, fetch_workers=0)
    # a mesh is served (tests/test_torch_parallel_serve.py holds the sharded
    # server to the unsharded one); its slots must divide over it
    mesh = make_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="divide"):
        _server(net, params, max_streams=5, mesh=mesh)
    srv = _server(net, params, max_streams=4, mesh=mesh)
    try:
        assert srv.stats()["shards"] == 2 and len(srv.states) == 2
    finally:
        srv.close()
    # bf16 params are served (tests/test_torch_bf16.py); float16 is not a
    # dtype the port runs
    f16 = init_all_modules(torch.Generator().manual_seed(0),
                           device="cpu").to(torch.float16)
    with pytest.raises(NotImplementedError, match="float32 and bfloat16"):
        _server(net, f16)
    other = MobilePoserNet(ParametricModel.synthetic(num_vertices=240),
                           device="cpu")
    other.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="on cpu"):
        PoseServer(other, params, host="127.0.0.1", port=0)


@pytest.mark.parametrize("flags", [[], ["--carry"], ["--int8"],
                                   ["--wire", "f16", "--no-pipeline"],
                                   ["--carry", "--int8", "--fetch-workers",
                                    "2"]],
                         ids=["exact", "carry", "int8", "f16-sync",
                              "carry-int8"])
def test_cli_serve_runs_on_cpu(flags, capsys):
    stats = serve_cli.main(["--model", _FIXTURE, "--host", "127.0.0.1",
                            "--port", "0", "--max-streams", "4",
                            "--duration", "0.1", "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert "Pose server on udp://" in out and '"frames_served": 0' in out
    assert stats["mode"] == ("carry" if "--carry" in flags else "exact")
    assert stats["quantize"] == ("int8" if "--int8" in flags else None)
    assert stats["wire"] == ("f16" if "f16" in flags else "f32")
    assert stats.get("pipelined", False) == ("--no-pipeline" not in flags)


def test_cli_serve_out_of_slice_options_raise(monkeypatch, tmp_path):
    """--data-parallel over more than one CUDA device builds the mesh of
    every card and refuses streams that do not divide over it; a .pth (the reference's checkpoint) serves the weights
    it holds; `--int8 --bf16` serves: the server takes the bf16 cast and
    quantizes it (int8 on bf16 params)."""
    base = ["--model", _FIXTURE, "--port", "0", "--duration", "0.1",
            "--device", "cpu"]
    built = []

    class Recorded(PoseServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append((self.dtype,
                          self.params["joints"].lstm[0]["fwd"].w_ih.dtype))

    with monkeypatch.context() as mp:
        mp.setattr(serve_cli, "PoseServer", Recorded)
        stats = serve_cli.main(base + ["--int8", "--bf16"])
    assert stats["quantize"] == "int8" and stats["frames_served"] == 0
    assert built == [(torch.bfloat16, torch.int8)]
    pth = tmp_path / "model.pth"
    save_torch_checkpoint(load_npz(_FIXTURE), pth)
    with monkeypatch.context() as mp:
        mp.setattr(serve_cli, "PoseServer", Recorded)
        served = serve_cli.main(["--model", str(pth), "--port", "0",
                                 "--duration", "0.1", "--device", "cpu"])
    assert served["frames_served"] == 0
    assert built[-1] == (torch.float32, torch.float32)
    # --data-parallel with one device serves on it, as the JAX CLI does
    assert serve_cli.main(base + ["--data-parallel"])["frames_served"] == 0
    monkeypatch.setattr(serve_cli, "data_parallel_mesh",
                        lambda d: make_mesh(devices=["cpu"] * 2))
    with pytest.raises(SystemExit, match="must divide over 2 devices"):
        serve_cli.main(base + ["--data-parallel", "--max-streams", "5"])
    stats = serve_cli.main(base + ["--data-parallel", "--max-streams", "4"])
    assert stats["shards"] == 2 and stats["frames_served"] == 0


def test_cli_serve_needs_a_device_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--model", _FIXTURE, "--port", "0"])
