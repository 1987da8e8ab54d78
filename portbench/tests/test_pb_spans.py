"""The readers of the port's spans (`spans.py`) on canned records made as
`test_pb_metrics.py` makes them, with launch-type host operations and
spans among the host operations."""

import pytest

from portbench import spans
from portbench.tests.test_pb_metrics import (BWD, COPY, DW, ELEM, FWD, GEMM,
                                             MAN, SCAN, _rec, read)

STREAM = ("ik_ns_per_frame", "fusion_ns_per_frame")
TRAIN = ("train_fwd_issue_ms", "train_bwd_issue_ms", "flag_sync_ms",
         "optimizer_issue_ms", "optimizer_launches_per_step",
         "optimizer_idle_ms")
PAIRED = ("ik_ns_per_frame", "fusion_ns_per_frame",
          "optimizer_launches_per_step")


def _launch(name, t):
    return (name, t, t + 2.0)


def stream_rec():
    """Two ticks of 1000 us: an upload, a scan, a product, two IK
    kernels, one fusion kernel and a download each, launched through
    every kind of launch call."""
    host, ops = [], []
    for t0 in (0.0, 1000.0):
        host += [_launch("cudaMemcpyAsync", t0 + 10),
                 _launch("cudaLaunchKernelExC_v11060", t0 + 100),
                 _launch("cuLaunchKernel", t0 + 150),
                 ("mp.decode_ik", t0 + 200, t0 + 300),
                 ("aten::mul", t0 + 205, t0 + 215),
                 _launch("cudaLaunchKernel", t0 + 210),
                 _launch("cudaLaunchKernel", t0 + 220),
                 ("mp.fusion", t0 + 300, t0 + 350),
                 _launch("cuLaunchKernelEx", t0 + 310),
                 ("cudaEventRecord", t0 + 360, t0 + 362),
                 _launch("cudaMemcpyAsync", t0 + 400)]
        ops += [(COPY, t0 + 20, t0 + 30), (SCAN, t0 + 110, t0 + 600),
                (GEMM, t0 + 600, t0 + 700), (ELEM, t0 + 700, t0 + 730),
                (ELEM, t0 + 730, t0 + 750), (ELEM, t0 + 750, t0 + 760),
                (COPY, t0 + 760, t0 + 800)]
    return _rec("stream", "mobileposer-f32", {"streams": 256}, ops,
                [(0.0, 1000.0), (1000.0, 2000.0)], host=host)


def train_rec():
    """Two steps of 1100 us: the forward (two sets, one of them with
    nothing to set), the backward (its launches inside the main thread's
    span, as autograd's thread makes them), the flags' fetch, Adam and
    AdamW, and one launch outside every span."""
    host, ops = [], []
    for o in (0.0, 1100.0):
        host += [("mp.train.forward", o, o + 300),
                 ("Optimizer.zero_grad#Adam.zero_grad", o + 5, o + 8),
                 _launch("cudaLaunchKernelExC", o + 50),
                 _launch("cudaLaunchKernel", o + 100),
                 # cuBLAS's set with nothing to set, and a real one
                 _launch("cudaMemsetAsync", o + 120),
                 _launch("cudaMemsetAsync", o + 130),
                 ("mp.train.backward", o + 300, o + 800),
                 _launch("cudaLaunchKernelExC", o + 400),
                 _launch("cudaLaunchKernel", o + 500),
                 _launch("cudaLaunchKernel", o + 600),
                 ("mp.train.finite_flags", o + 800, o + 900),
                 _launch("cudaMemcpyAsync", o + 810),
                 ("cudaStreamSynchronize", o + 812, o + 880),
                 ("Optimizer.step#Adam.step", o + 900, o + 1000),
                 _launch("cudaLaunchKernel", o + 910),
                 _launch("cudaLaunchKernel", o + 930),
                 _launch("cudaLaunchKernel", o + 950),
                 ("Optimizer.step#AdamW.step", o + 1000, o + 1050),
                 _launch("cudaLaunchKernel", o + 1005),
                 _launch("cudaLaunchKernel", o + 1020),
                 _launch("cudaLaunchKernel", o + 1060)]
        ops += [(FWD, o + 60, o + 250), (GEMM, o + 250, o + 300),
                ("Memset (Device)", o + 300, o + 302),
                (BWD, o + 420, o + 700), (DW, o + 700, o + 750),
                (ELEM, o + 750, o + 800), (COPY, o + 812, o + 815),
                (ELEM, o + 920, o + 930), (ELEM, o + 940, o + 950),
                (ELEM, o + 960, o + 990), (ELEM, o + 1015, o + 1020),
                (ELEM, o + 1025, o + 1030), (ELEM, o + 1065, o + 1070)]
    return _rec("train", "mobileposer-f32", {"batch": 256, "window": 125},
                ops, [(0.0, 1100.0), (1100.0, 2200.0)], host=host)


def test_stream_span_readers():
    r = stream_rec()
    assert read("ik_ns_per_frame", r) == pytest.approx(1e3 * 100 / 512)
    assert read("fusion_ns_per_frame", r) == pytest.approx(1e3 * 20 / 512)
    for name in TRAIN:
        assert read(name, r) is None, name


def test_train_span_readers():
    r = train_rec()
    assert read("train_fwd_issue_ms", r) == pytest.approx(0.3)
    assert read("train_bwd_issue_ms", r) == pytest.approx(0.5)
    assert read("flag_sync_ms", r) == pytest.approx(0.1)
    assert read("optimizer_issue_ms", r) == pytest.approx(0.15)
    assert read("optimizer_launches_per_step", r) == 5.0
    # Adam's 100 us hold 50 of device work, AdamW's 50 hold 10
    assert read("optimizer_idle_ms", r) == pytest.approx(0.09)
    for name in STREAM:
        assert read(name, r) is None, name


def test_each_operation_goes_to_its_launchs_innermost_span():
    own = [o for _, o in spans.owners(train_rec()["trace"])]
    step = ["mp.train.forward"] * 2 + ["mp.train.backward"] * 3 + [
        "mp.train.finite_flags"] + ["Optimizer.step#Adam.step"] * 3 + [
        "Optimizer.step#AdamW.step"] * 2 + [None]
    assert own == step * 2
    tr = train_rec()["trace"]
    tr["host_ops"].append(("mp.decode_ik", 45.0, 60.0))
    assert [o for _, o in spans.owners(tr)[:2]] == ["mp.decode_ik",
                                                    "mp.train.forward"]


@pytest.mark.parametrize("offset_us,rate", [(-9720.0, -0.006), (35.0, 0.0)])
def test_span_readers_hold_when_device_time_drifts(offset_us, rate):
    """The profiler's device timestamps may drift from its host clock
    (milliseconds over a traced window on the H100): pairing goes by
    order, and no reader sets a device time against a host time."""
    r = train_rec()
    want = {n: read(n, r) for n in TRAIN}
    r["trace"]["device_ops"] = [
        (n, s * (1 + rate) + offset_us, e * (1 + rate) + offset_us)
        for n, s, e in r["trace"]["device_ops"]]
    for n in TRAIN:
        assert read(n, r) == pytest.approx(want[n], rel=0.02), n


@pytest.mark.parametrize("rec", [stream_rec, train_rec])
@pytest.mark.parametrize("drop", ["launch", "device"])
def test_paired_readers_read_none_when_the_counts_differ(rec, drop):
    r = rec()
    tr = r["trace"]
    if drop == "launch":
        i = next(i for i, h in enumerate(tr["host_ops"])
                 if spans.LAUNCH.match(h[0]))
        del tr["host_ops"][i]
    else:
        del tr["device_ops"][-1]
    assert spans.owners(tr) is None
    for name in PAIRED:
        assert read(name, r) is None, name
    if rec is train_rec:   # the host's spans need no pairing
        assert read("train_fwd_issue_ms", r) == pytest.approx(0.3)


@pytest.mark.parametrize("rec", [stream_rec, train_rec])
def test_span_readers_find_nothing_without_spans(rec):
    """A program that opens no span (an older tree): nothing to read,
    except torch's own optimizer ranges."""
    r = rec()
    r["trace"]["host_ops"] = [h for h in r["trace"]["host_ops"]
                              if not h[0].startswith("mp.")]
    for name in STREAM + TRAIN:
        if not name.startswith("optimizer_"):
            assert read(name, r) is None, name
    r["trace"] = {"device_ops": [], "host_ops": [], "calls": []}
    for name in STREAM + TRAIN:
        assert read(name, r) is None, name


def test_the_span_metrics_are_declared():
    got = {m["name"]: m for m in MAN.data["per_layer"]
           if m["source"] == "program_span"}
    assert set(got) == set(STREAM + TRAIN)
    for name in STREAM:
        assert got[name]["workloads"] == ["f32.stream512"]
    for name in TRAIN:
        assert got[name]["workloads"] == ["f32.train256", "bf16.train256"]
