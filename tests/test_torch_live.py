"""The port's live runtime (`mobileposer_tpu_torch/stream/`: sensor ingest,
calibration, `LivePoser`; `viz/`; `cli/live_demo.py`, `cli/calibration.py`)
against the JAX package's, on the CPU (`device="cpu"`).

The numpy modules (quaternions, wire parsing and encoding, calibration,
input normalization) are held to the JAX package's bit for bit on inputs
drawn with numpy from a seed, and their wire formats are crossed (one
package encodes, the other parses). `LivePoser.step_frame` is held to the
JAX `LivePoser` at 2e-5 (the pin of tests/test_torch_serving_export.py)
on the trained fixture's weights under a non-identity calibration. The
JAX package's own live tests (tests/test_live.py, tests/test_stream.py,
tests/test_native.py, tests/test_live_viewer.py) are replayed on the
port over loopback sockets on free ports.
"""

import functools
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax

import mobileposer_tpu.stream as jstream
from mobileposer_tpu.kinematics import ParametricModel as JaxBody
from mobileposer_tpu.models import MobilePoserNet as JaxNet
from mobileposer_tpu.stream import quat_np as JQ
from mobileposer_tpu.viz.orientation_monitor import \
    OrientationMonitor as JaxMonitor
import mobileposer_tpu_torch.stream as tstream
from mobileposer_tpu_torch import config as C
from mobileposer_tpu_torch.cli import calibration as calibration_cli
from mobileposer_tpu_torch.cli import live_demo as live_cli
from mobileposer_tpu_torch.kinematics import ParametricModel
from mobileposer_tpu_torch.models import MobilePoserNet
from mobileposer_tpu_torch.native import load_library
from mobileposer_tpu_torch.nn.convert import load_npz, params_from_jax
from mobileposer_tpu_torch.stream import quat_np as Q
from mobileposer_tpu_torch.stream.calibration import DEVICE_TO_MODEL_ORDER
from mobileposer_tpu_torch.viz import OrientationMonitor

ATOL_JAX = 2e-5
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
def tree():
    """The trained fixture's weights as the JAX params tree (numpy)."""
    return load_npz(_FIXTURE)


def _poser(net, tree, port=None, buffer_len=2):
    imu_set = (tstream.IMUSet(imu_host="127.0.0.1", imu_port=port,
                              buffer_len=buffer_len) if port else None)
    return tstream.LivePoser(net, params_from_jax(tree, device="cpu"),
                             imu_set=imu_set)


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _rand_quats(rng, *shape):
    q = rng.randn(*shape, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _calibration_inputs(seed):
    """(reference quat wxyz [4], T-pose quats wxyz [5,4], accs [5,3])."""
    rng = np.random.RandomState(seed)
    return _rand_quats(rng), _rand_quats(rng, 5), rng.randn(5, 3)


def _raw_frames(seed, T):
    """T raw aligned frames: quats wxyz [T,5,4], accs [T,5,3]."""
    rng = np.random.RandomState(seed)
    return _rand_quats(rng, T, 5), rng.randn(T, 5, 3) * 5.0


def _walk_frames(seed, T, quats0, accs0):
    """T raw frames of a body near its calibration pose, as the replayer's
    synthetic stream moves: each device's orientation a random walk of
    0.05 rad steps from quats0 (wxyz [5,4]), accelerations about accs0."""
    rng = np.random.RandomState(seed)
    cur, quats = np.array(quats0, np.float64), np.zeros((T, 5, 4))
    for t in range(T):
        for d in range(5):
            m = Q.quat_to_matrix(Q.quat_from_euler_xyz(
                rng.normal(0, 0.05, 3))) @ Q.quat_to_matrix(cur[d, [1, 2, 3, 0]])
            cur[d] = Q.matrix_to_quat(m)[[3, 0, 1, 2]]
        quats[t] = cur
    return quats, accs0[None] + rng.randn(T, 5, 3) * 0.5


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# numpy modules, bit for bit
# ---------------------------------------------------------------------------

def test_sensor_ids_match():
    assert C.sensor.id_map == jstream.sensor.C.sensor.id_map
    assert tstream.PORTS == jstream.PORTS and tstream.KEYS == jstream.KEYS
    assert (tstream.BUFFER_SIZE, tstream.MIN_TIME_DIFF, tstream.OUT_UDP_IP,
            tstream.OUT_UDP_PORT) == (
        jstream.BUFFER_SIZE, jstream.MIN_TIME_DIFF, jstream.OUT_UDP_IP,
        jstream.OUT_UDP_PORT)


@pytest.mark.parametrize("fn", ["quat_to_matrix", "matrix_to_quat",
                                "quat_mean", "euler_xyz_from_quat",
                                "quat_from_euler_xyz"])
def test_quat_np_bitwise(fn):
    rng = np.random.RandomState(3)
    q = _rand_quats(rng, 64)
    q[0] = [0.0, 0, 0, 1]                  # identity
    q[1] = [1.0, 0, 0, 0]                  # a half turn: the x pivot
    arg = {"quat_to_matrix": q, "quat_mean": q[:20],
           "euler_xyz_from_quat": q,
           "matrix_to_quat": JQ.quat_to_matrix(q),
           "quat_from_euler_xyz": rng.uniform(-np.pi, np.pi, (64, 3))}[fn]
    _same(getattr(Q, fn)(arg.copy()), getattr(JQ, fn)(arg.copy()))


@pytest.mark.parametrize("name", sorted(C.sensor.id_map))
def test_packets_crossed(name):
    """A packet encoded by one package parses the same in the other, for
    every device (the headphone's axis remap included)."""
    rng = np.random.RandomState(len(name))
    device, dtype = name.split("_")
    for _ in range(5):
        ts = [rng.uniform(1e9, 2e9), rng.uniform(0, 1e4)]
        acc, quat = rng.randn(3), _rand_quats(rng)
        pkt = tstream.encode_packet(device.lower(), dtype, ts, acc, quat)
        assert pkt == jstream.encode_packet(device.lower(), dtype, ts, acc,
                                            quat)
        got, want = tstream.process_message(pkt), jstream.process_message(pkt)
        assert got[0] == want[0] and got[1] == want[1]
        for a, b in zip(got[2:], want[2:]):
            _same(a, b)
    for bad in (b"", b"stop", b"left;phone", b"left;phone:1 2 3",
                b"nobody;phone:" + b" ".join([b"1"] * 12), b"\xff\xfe"):
        assert tstream.process_message(bad) is None
        assert jstream.process_message(bad) is None


def test_sensor_data_and_sensor2global():
    """SensorData.update / calibrate and sensor2global on the same stream
    of measurements in both packages."""
    rng = np.random.RandomState(5)
    sd, jsd = tstream.SensorData(), jstream.SensorData()
    for f in range(60):
        for dev in range(5):
            acc = rng.randn(1, 3)
            ori = _rand_quats(rng, 1) * 0.1 + np.array([0.0, 0, 0, 1])
            ts = [1000.0 + f / 30, 5.0 + f / 30 + 0.001 * dev]
            assert sd.update(dev, acc, ori, ts) == jsd.update(dev, acc, ori,
                                                              ts)
    sd.calibrate()
    jsd.calibrate()
    for dev in range(5):
        _same(sd.calibration_quats[dev], jsd.calibration_quats[dev])
        got = tstream.sensor2global(sd.get_orientation(dev),
                                    sd.get_acceleration(dev),
                                    sd.calibration_quats, dev)
        want = jstream.sensor2global(jsd.get_orientation(dev),
                                     jsd.get_acceleration(dev),
                                     jsd.calibration_quats, dev)
        _same(got[0], want[0])
        _same(got[1], want[1])


def test_rebroadcast_crossed():
    rng = np.random.RandomState(6)
    for _ in range(5):
        acc = {i: rng.randn(1, 3) for i in range(5)}
        ori = {i: _rand_quats(rng) for i in range(5)}
        pkt = tstream.encode_rebroadcast(acc, ori)
        assert pkt == jstream.encode_rebroadcast(acc, ori)
        for a, b in zip(tstream.decode_frame_packet(pkt),
                        jstream.decode_frame_packet(pkt)):
            _same(a, b)


@pytest.mark.parametrize("combo", sorted(C.COMBOS))
def test_calibration_math_bitwise(combo):
    """compute_smpl2imu, compute_device_calibration, calibrate_frames and
    normalize_frames: the same bytes, for every combo."""
    assert C.COMBOS == jstream.calibration.C.COMBOS
    _same(DEVICE_TO_MODEL_ORDER, jstream.calibration.DEVICE_TO_MODEL_ORDER)
    ref, tq, ta = _calibration_inputs(7)
    s2i = tstream.compute_smpl2imu(ref)
    _same(s2i, jstream.compute_smpl2imu(ref))
    cal = tstream.compute_device_calibration(s2i, tq, ta)
    jcal = jstream.compute_device_calibration(s2i, tq, ta)
    for k in ("smpl2imu", "device2bone", "acc_offsets"):
        _same(getattr(cal, k), getattr(jcal, k))
    quats, accs = _raw_frames(8, 16)
    for a, b in zip(tstream.calibrate_frames(cal, quats, accs),
                    jstream.calibrate_frames(jcal, quats, accs)):
        _same(a, b)
    got = tstream.normalize_frames(cal, quats, accs, combo)
    want = jstream.normalize_frames(jcal, quats, accs, combo)
    assert got.dtype == want.dtype == np.float32 and got.shape == (16, 60)
    assert got.tobytes() == want.tobytes()
    _same(tstream.identity_calibration().device2bone,
          jstream.identity_calibration().device2bone)


def test_calibration_save_load_crossed(tmp_path):
    ref, tq, ta = _calibration_inputs(9)
    cal = tstream.compute_device_calibration(tstream.compute_smpl2imu(ref),
                                             tq, ta)
    cal.save(tmp_path / "port.npz")
    jstream.Calibration.load(tmp_path / "port.npz").save(tmp_path / "jax.npz")
    back = tstream.Calibration.load(tmp_path / "jax.npz")
    for k in ("smpl2imu", "device2bone", "acc_offsets"):
        _same(getattr(back, k), getattr(cal, k))


# ---------------------------------------------------------------------------
# LivePoser.step_frame against the JAX LivePoser
# ---------------------------------------------------------------------------

def test_step_frame_matches_jax(net, tree):
    """12 frames of a body moving about its T-pose, after a non-identity
    calibration. (On frames whose orientations are drawn afresh each
    frame the pose is 3.9e-5 from the JAX step's: the joints module of
    the JAX package on the CPU is then 1.8e-5 from float64, the port's
    under 1e-6, see the next test.)"""
    ref, tq, ta = _calibration_inputs(10)
    cal = tstream.compute_device_calibration(tstream.compute_smpl2imu(ref),
                                             tq, ta)
    jposer = jstream.LivePoser(JaxNet(JaxBody.synthetic(num_vertices=240)),
                               tree)
    jposer.set_calibration(jstream.Calibration(cal.smpl2imu, cal.device2bone,
                                               cal.acc_offsets))
    poser = _poser(net, tree)
    with pytest.raises(RuntimeError, match="calibrate first"):
        poser.step_frame(*_raw_frames(0, 1))
    poser.set_calibration(cal)
    quats, accs = _walk_frames(11, 12, tq, ta)
    for t in range(12):
        got = poser.step_frame(quats[t], accs[t])
        want = jposer.step_frame(quats[t], accs[t])
        for name, g, w in zip(("pose", "joints", "tran", "contact"), got,
                              want):
            assert g.device.type == "cpu"
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=ATOL_JAX,
                                       err_msg=f"frame {t} {name}")
    # reset starts a fresh stream: the first frame's outputs again
    poser.reset()
    first = _poser(net, tree)
    first.set_calibration(cal)
    for a, b in zip(poser.step_frame(quats[0], accs[0]),
                    first.step_frame(quats[0], accs[0])):
        _same(a, b)


def test_joints_module_against_float64(net, tree):
    """The port's joints module on a live window (a frame with fresh
    random orientations, repeated 45 times as a stream's first window)
    against a float64 numpy evaluation of the same weights."""
    from mobileposer_tpu_torch.models.modules import module_apply
    ref, tq, ta = _calibration_inputs(10)
    cal = tstream.compute_device_calibration(tstream.compute_smpl2imu(ref),
                                             tq, ta)
    imu60 = tstream.normalize_frames(cal, *_raw_frames(11, 1))
    x = np.repeat(imu60[None], 45, axis=0)              # [T, B=1, 60]
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                               tree["joints"])

    def direction(xs, d):
        h = np.zeros((xs.shape[1], d["w_hh"].shape[0]))
        c, ys = np.zeros_like(h), []
        for xt in xs:
            i, f, g, o = np.split(xt @ d["w_ih"] + h @ d["w_hh"] + d["b_ih"]
                                  + d["b_hh"], 4, axis=-1)
            c = c / (1 + np.exp(-f)) + np.tanh(g) / (1 + np.exp(-i))
            h = np.tanh(c) / (1 + np.exp(-o))
            ys.append(h)
        return np.stack(ys)

    h = np.maximum(x @ p["linear1"]["w"] + p["linear1"]["b"], 0.0)
    for layer in p["lstm"]:
        h = np.concatenate([direction(h, layer["fwd"]),
                            direction(h[::-1], layer["bwd"])[::-1]], -1)
    want = h @ p["linear2"]["w"] + p["linear2"]["b"]
    with torch.no_grad():
        got, _ = module_apply("joints", params_from_jax(tree, device="cpu")[
            "joints"], torch.from_numpy(x), None, time_major=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


# ---------------------------------------------------------------------------
# the JAX package's live tests, on the port
# ---------------------------------------------------------------------------

def _replay_in_thread(port, acc, quat, fps=60):
    rep = tstream.FrameReplayer(port=port)
    sender = threading.Thread(
        target=lambda: (time.sleep(0.3), rep.replay(acc, quat, fps=fps)),
        daemon=True)
    sender.start()
    return sender


def test_live_poser_loopback(net, tree):
    """tests/test_live.py:28-56 on the port."""
    [port] = _free_ports(1)
    poser = _poser(net, tree, port)
    poser.set_calibration(tstream.identity_calibration())
    T = 12
    rng = np.random.RandomState(0)
    acc = rng.normal(0, 0.05, (T, 5, 3))
    quat = np.tile(np.array([0.0, 0, 0, 1.0]), (T, 5, 1))
    sender = _replay_in_thread(port, acc, quat)
    frames = []
    poser.run(duration=2.0, fps=60,
              on_frame=lambda p, j, t, c: frames.append((p, j, t, c)))
    sender.join(timeout=10)
    assert not sender.is_alive()
    assert len(frames) >= 1, "live loop produced no frames"
    pose, joints, tran, contact = frames[-1]
    assert pose.shape == (24, 3, 3) and joints.shape == (24, 3)
    assert tran.shape == (3,) and contact.shape == (2,)
    for x in frames[-1]:
        assert isinstance(x, np.ndarray) and np.all(np.isfinite(x))
    st = poser.stats()
    assert st["frames"] == len(frames) and st["output_fps"] > 0
    assert st["step_ms"]["p50"] > 0 and st["fetch_ms"]["p50"] is not None


@pytest.mark.parametrize("pipelined", [True, False])
def test_live_recording_schema(net, tree, pipelined):
    """tests/test_live.py:82-112 on the port, pipelined and synchronous."""
    [port] = _free_ports(1)
    poser = _poser(net, tree, port)
    poser.set_calibration(tstream.identity_calibration())
    T = 8
    rng = np.random.RandomState(1)
    acc = rng.normal(0, 0.05, (T, 5, 3))
    quat = np.tile(np.array([0.0, 0, 0, 1.0]), (T, 5, 1))
    sender = _replay_in_thread(port, acc, quat)
    recorded = poser.run(duration=2.0, fps=60, record=True,
                         pipelined=pipelined)
    sender.join(timeout=10)
    assert recorded is not None and recorded["pose"].shape[0] >= 1
    n = recorded["pose"].shape[0]
    assert recorded["acc"].shape == (n, 5, 3)
    assert recorded["ori"].shape == (n, 5, 3, 3)
    assert recorded["raw_ori"].shape == (n, 5, 4)
    assert recorded["raw_acc"].shape == (n, 5, 3)
    assert recorded["pose"].shape == (n, 24, 3, 3)
    assert recorded["tran"].shape == (n, 3)
    np.testing.assert_allclose(recorded["ori"][0, 0], np.eye(3), atol=1e-6)
    assert all(np.isfinite(v).all() for v in recorded.values())


class _FakeIMUSet:
    """Serves one new frame per read; after the last, the read raises
    KeyboardInterrupt, which stops `run` as Ctrl-C does (the pending
    frame is flushed)."""

    def __init__(self, quats, accs):
        self.quats, self.accs = quats, accs
        self.reads = 0
        self.clock = tstream.Clock()

    def start_reading(self):
        pass

    def stop_reading(self):
        pass

    def get_current_buffer(self):
        if self.reads == len(self.quats):
            raise KeyboardInterrupt
        t = self.reads
        self.reads += 1
        return (self.quats[t:t + 1].astype(np.float32),
                self.accs[t:t + 1].astype(np.float32))


def test_pipelined_delivers_synchronous_frames_one_tick_later(net, tree):
    quats, accs = _raw_frames(12, 6)
    ref, tq, ta = _calibration_inputs(13)
    cal = tstream.compute_device_calibration(tstream.compute_smpl2imu(ref),
                                             tq, ta)
    runs = {}
    for pipelined in (False, True):
        poser = _poser(net, tree)
        poser.imu_set = fake = _FakeIMUSet(quats, accs)
        poser.set_calibration(cal)
        got = []
        rec = poser.run(fps=1000, pipelined=pipelined, record=True,
                        on_frame=lambda *o: got.append((fake.reads, o)))
        runs[pipelined] = got, rec
    (sync, rec_s), (pipe, rec_p) = runs[False], runs[True]
    assert len(sync) == len(pipe) == len(quats)
    # delivered after its own read, or after the next frame's read
    assert [r for r, _ in sync] == list(range(1, 7))
    assert [r for r, _ in pipe] == [2, 3, 4, 5, 6, 6]
    for (_, a), (_, b) in zip(sync, pipe):
        for x, y in zip(a, b):
            _same(x, y)
    for k in rec_s:
        _same(rec_s[k], rec_p[k])


def test_viewer_close_keeps_the_in_flight_frame(net, tree):
    """A viewer that closes (StopIteration) stops the loop; the pipelined
    frame already stepped is still recorded."""
    quats, accs = _raw_frames(14, 6)
    poser = _poser(net, tree)
    poser.imu_set = _FakeIMUSet(quats, accs)
    poser.set_calibration(tstream.identity_calibration())
    shown = []

    def on_frame(*o):
        shown.append(o)
        if len(shown) == 2:
            raise StopIteration

    rec = poser.run(fps=1000, record=True, on_frame=on_frame)
    assert len(shown) == 2 and rec["pose"].shape[0] == 3


def _frontend_pipeline(native):
    """Raw packets -> SensorFrontend -> :out -> IMUSet frames
    (tests/test_stream.py:160-189, tests/test_native.py:143-172)."""
    ports = _free_ports(6)
    in_ports, out_port = ports[:5], ports[5]
    fe = tstream.SensorFrontend(host="127.0.0.1", ports=in_ports,
                                out_addr=("127.0.0.1", out_port),
                                native=native)
    assert (fe.native is not None) == native
    imu_set = tstream.IMUSet(imu_host="127.0.0.1", imu_port=out_port,
                             buffer_len=8)
    imu_set.start_reading()
    (fe.native or fe.receiver).start()
    rep = tstream.DeviceReplayer(ports=in_ports)
    try:
        for slot, pkt in tstream.synthetic_device_stream(n_frames=30):
            rep.send(slot, pkt)
            while fe.step(timeout=0.01):
                pass
        deadline = time.time() + 5.0
        q = np.zeros((0, 5, 4))
        while time.time() < deadline and q.shape[0] == 0:
            fe.step(timeout=0.01)
            q, a = imu_set.get_current_buffer()
    finally:
        if native:
            fe.native.stop()
            fe.native.close()
        else:
            fe.receiver.stop()
        imu_set.stop_reading()
    assert q.shape[0] >= 1, "no frames made it through the pipeline"
    assert q.shape[1:] == (5, 4) and a.shape[1:] == (5, 3)
    assert np.all(np.isfinite(q)) and np.all(np.isfinite(a))


def test_frontend_loopback_pipeline():
    _frontend_pipeline(native=False)


def test_native_frontend_pipeline():
    if load_library() is None:
        pytest.skip("no C++ toolchain to build the native ingest")
    _frontend_pipeline(native=True)


def test_frame_replayer_to_imuset():
    """tests/test_stream.py:192-209 on the port."""
    [port] = _free_ports(1)
    imu_set = tstream.IMUSet(imu_host="127.0.0.1", imu_port=port,
                             buffer_len=4)
    imu_set.start_reading()
    rep = tstream.FrameReplayer(port=port)
    try:
        rep.replay(np.zeros((6, 5, 3)),
                   np.tile(np.array([0.0, 0, 0, 1.0]), (6, 5, 1)), fps=200)
        time.sleep(0.3)
        q, a = imu_set.get_current_buffer()
    finally:
        imu_set.stop_reading()
    assert q.shape[0] >= 1
    np.testing.assert_allclose(q[-1, 0], [1, 0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(a[-1], 0.0, atol=1e-6)


def test_synthetic_device_stream_matches_jax():
    """The replayer's synthetic packets: the same measurements in both
    packages. The sensor timestamp differs on purpose: the port sends
    seconds since the stream's start (the JAX package the unix time,
    which '%g' rounds to 10 s)."""
    got = list(tstream.synthetic_device_stream(n_frames=4, seed=3))
    want = list(jstream.synthetic_device_stream(n_frames=4, seed=3))
    assert [s for s, _ in got] == [s for s, _ in want]
    for i, ((_, a), (_, b)) in enumerate(zip(got, want)):
        pa, pb = tstream.process_message(a), jstream.process_message(b)
        assert pa[1] == pb[1]
        _same(pa[2], pb[2])
        _same(pa[3], pb[3])
        assert pa[4][1] == pytest.approx((i // 5) / 30.0, abs=1e-5)


def test_frontend_forwards_the_synthetic_stream():
    """30 frames at 30 Hz through the frontend reach :out at its
    rebroadcast rate, not once: the frontend paces by the sensor
    timestamp, which the synthetic stream must advance."""
    ports = _free_ports(6)
    fe = tstream.SensorFrontend(host="127.0.0.1", ports=ports[:5],
                                out_addr=("127.0.0.1", ports[5]))
    out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    out.bind(("127.0.0.1", ports[5]))
    out.settimeout(0.5)
    sender = threading.Thread(target=tstream.DeviceReplayer(
        ports=ports[:5]).replay, args=(tstream.synthetic_device_stream(30),),
        kwargs={"fps": 30}, daemon=True)
    try:
        sender.start()
        fe.run(duration=1.5)
        sender.join(timeout=10)
        frames = 0
        while True:
            try:
                tstream.decode_frame_packet(out.recvfrom(4096)[0])
                frames += 1
            except socket.timeout:
                break
    finally:
        out.close()
        for s in fe.sockets:
            s.close()
    assert not sender.is_alive()
    assert frames >= 10, f"{frames} frames forwarded from 30"


def test_performance_logger(capsys):
    pl = tstream.PerformanceLogger(num_devices=2, log_interval=0.0)
    pl.update(0, 0.01)
    pl.update(0, 0.03)
    snap = pl.snapshot()
    np.testing.assert_allclose(snap[0][1], 0.02, atol=1e-9)
    assert snap[1][0] == 0.0
    assert pl.log() is not None and "device 0:" in capsys.readouterr().out
    assert not pl.counts


def test_unity_exporter_same_string_as_jax():
    rng = np.random.RandomState(15)
    aa = (rng.randn(72) * 2).astype(np.float32)
    tran = (rng.randn(3) * 10).astype(np.float32)
    received = []
    for mod in (tstream, jstream):
        ex = mod.UnityExporter(host="127.0.0.1", port=0)
        client = socket.create_connection(ex.server.getsockname(),
                                          timeout=5)
        try:
            ex.accept()
            ex.send(aa, tran)
            data = b""
            while not data.endswith(b"$"):
                data += client.recv(65536)
            received.append(data)
        finally:
            client.close()
            ex.close()
    assert received[0] == received[1]
    a_str, t_str = received[0].decode().rstrip("$").split("#")
    np.testing.assert_allclose(np.array(a_str.split(","), np.float32), aa,
                               rtol=1e-5)
    assert len(t_str.split(",")) == 3


def test_save_session_keys(tmp_path):
    rec = {"pose": np.zeros((2, 24, 3, 3)), "tran": np.zeros((2, 3))}
    cal = tstream.identity_calibration()
    a = np.load(tstream.save_session(rec, cal, tmp_path / "port"))
    b = np.load(jstream.save_session(rec, cal, tmp_path / "jax"))
    assert sorted(a.files) == sorted(b.files)


def test_orientation_monitor_matches_jax():
    rng = np.random.RandomState(16)
    sd = tstream.SensorData()
    for dev in range(5):
        sd.update_virtual(dev, rng.randn(3), _rand_quats(rng))
    got = OrientationMonitor(interval=0.0).render(sd)
    assert got == JaxMonitor(interval=0.0).render(sd)
    assert len(got.splitlines()) == 5


# ---------------------------------------------------------------------------
# viewers under the SDL dummy driver (tests/test_live_viewer.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def pygame_dummy(monkeypatch):
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    return pytest.importorskip("pygame")


def test_skeleton_viewer_draws(pygame_dummy, net):
    from mobileposer_tpu_torch.viz import LiveSkeletonViewer
    j, _ = net.body_model.get_zero_pose_joint_and_vertex()
    j = np.asarray(j, np.float32)
    v = LiveSkeletonViewer(net.body_model, size=(320, 240))
    try:
        v.update(j)
        solo = int((v.pixels().sum(axis=2) > 60).sum())
        assert v.pixels().shape == (320, 240, 3) and solo > 0
        v.update(j, joints_gt=j + np.array([0.0, 0.05, 0.0], np.float32))
        assert int((v.pixels().sum(axis=2) > 60).sum()) > solo
        v.on_frame(None, j + 0.3, None, None)
        assert v.frames_drawn == 3
        assert v.play(np.stack([j] * 3), fps=1000) == 3
    finally:
        v.close()


def test_orientation_cubes_draw(pygame_dummy):
    from mobileposer_tpu_torch.viz import OrientationCubeViewer
    v = OrientationCubeViewer(n_devices=5, size=(500, 150))
    try:
        v.update(np.tile(np.eye(3, dtype=np.float32), (5, 1, 1)),
                 accelerations=np.ones((5, 3)) * 3.0)
        a = v.pixels().copy()
        v.render_sensor_data(tstream.SensorData())
        v.update(np.tile(JQ.quat_to_matrix(np.array([0.0, 0.34, 0, 0.94])),
                         (5, 1, 1)))
        assert a.sum() > 0 and (a != v.pixels()).any()
        assert v.frames_drawn == 3
    finally:
        v.close()


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_live_demo_cli_saves_a_session(tmp_path, monkeypatch):
    [port] = _free_ports(1)
    monkeypatch.setattr(live_cli, "IMUSet", functools.partial(
        tstream.IMUSet, imu_host="127.0.0.1", imu_port=port))
    monkeypatch.setattr(C, "paths", C.Paths(root_dir=tmp_path))
    monkeypatch.setenv("MP_SMPL_FILE", str(tmp_path / "no_smpl.pkl"))
    ref, tq, ta = _calibration_inputs(17)
    cal = tstream.compute_device_calibration(tstream.compute_smpl2imu(ref),
                                             tq, ta)
    cal.save(tmp_path / "cal.npz")
    quats, accs = _raw_frames(18, 30)
    sender = _replay_in_thread(port, accs, quats[..., [1, 2, 3, 0]], fps=30)
    path = live_cli.main(["--model", _FIXTURE, "--calibration",
                          str(tmp_path / "cal.npz"), "--duration", "2",
                          "--save", "--device", "cpu"])
    sender.join(timeout=10)
    assert path is not None and path.parent == tmp_path / "data" / "dev"
    z = np.load(path)
    assert {"acc", "ori", "raw_acc", "raw_ori", "pose", "tran", "smpl2imu",
            "device2bone", "acc_offsets"} == set(z.files)
    assert z["pose"].shape[0] >= 1 and np.isfinite(z["pose"]).all()
    _same(z["device2bone"], cal.device2bone)


def test_live_demo_cli_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        live_cli.main(["--model", _FIXTURE, "--duration", "1"])


def test_calibration_cli_runs(monkeypatch, capsys):
    ports = _free_ports(6)
    monkeypatch.setattr(calibration_cli, "SensorFrontend", functools.partial(
        tstream.SensorFrontend, host="127.0.0.1", ports=ports[:5],
        out_addr=("127.0.0.1", ports[5])))
    t0 = time.time()
    calibration_cli.main(["--duration", "1", "--log",
                          "--calibrate-after", "0.2"])
    assert 1.0 <= time.time() - t0 < 10
    assert "rebroadcasting to :7777" in capsys.readouterr().out


def test_live_path_imports_no_pygame():
    """The card's path (the stream package, the live demo, the viz
    package) imports no pygame: the chip machine has none."""
    import subprocess
    import sys
    code = ("import sys\n"
            "import mobileposer_tpu_torch.cli.live_demo\n"
            "import mobileposer_tpu_torch.cli.calibration\n"
            "import mobileposer_tpu_torch.viz\n"
            "print('pygame' in sys.modules)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
