"""Each per-layer reader on a canned trace record, and the breakdown."""

import pytest

from portbench import manifest, roofline, trace

MAN = manifest.Manifest()
SCAN = "void lstm_scan_kernel<2, 8, 1, float>(Dir<float>, Dir<float>, int)"
GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x16"
ELEM = "void at::native::vectorized_elementwise_kernel<4, Add>(int, ...)"
FWD = "void lstm_train_fwd_kernel<12, float, float, float>(...)"
BWD = "void lstm_train_bwd_kernel<18, float, float, float>(...)"
DW = "void lstm_train_dw_kernel<float>(...)"
COPY = "Memcpy DtoH (Device -> Pinned)"


def _rec(kind, cfg, traffic, ops, calls, host=(), issue=(1.0, 3.0, 2.0)):
    return {"kind": kind, "cfg": MAN.config(cfg), "traffic": traffic,
            "frames_per_call": (traffic["streams"] if kind == "stream"
                                else traffic["batch"] * traffic["window"]),
            "issue_ms": list(issue),
            "trace": {"device_ops": sorted(ops, key=lambda o: o[1]),
                      "host_ops": list(host), "calls": calls}}


def stream_rec():
    # two ticks of 1000 us each, 100 us idle at each tick's start
    ops = []
    for t0 in (0.0, 1000.0):
        ops += [(SCAN, t0 + 100, t0 + 600), (GEMM, t0 + 600, t0 + 800),
                (ELEM, t0 + 800, t0 + 950), (COPY, t0 + 950, t0 + 1000)]
    return _rec("stream", "mobileposer-f32", {"streams": 256}, ops,
                [(0.0, 1000.0), (1000.0, 2000.0)],
                host=[("aten::copy_", 0.0, 100.0),
                      ("cudaEventSynchronize", 1000.0, 1100.0)])


def train_rec(cfg="mobileposer-f32"):
    ops = [(FWD, 0.0, 400.0), (BWD, 400.0, 900.0), (DW, 900.0, 1000.0),
           (GEMM, 1000.0, 1500.0), (ELEM, 1600.0, 2000.0)]
    return _rec("train", cfg, {"batch": 256, "window": 125}, ops,
                [(0.0, 2000.0)])


def read(name, rec):
    return MAN.reader(name).read(rec)


def test_stream_readers():
    r = stream_rec()
    assert read("tick_issue_ms", r) == 2.0
    assert read("launches_per_tick", r) == 4.0
    assert read("matmul_ns_per_frame", r) == pytest.approx(
        1e3 * 400 / 512)
    assert read("stream_other_ns_per_frame", r) == pytest.approx(
        1e3 * 300 / 512)
    assert read("idle_share", r) == pytest.approx(10.0)
    cfg = MAN.config("mobileposer-f32")
    bound = roofline.stream_scan_bound_ms(cfg, 256)
    assert read("scan_roofline", r) == pytest.approx(
        100 * bound * 2 / 1.0)
    mfu = (roofline.model_flops_per_frame(cfg) * 45 * 512 / 2e-3 / 67e12
           * 100)
    assert read("stream_mfu", r) == pytest.approx(mfu)
    for name in ("step_issue_ms", "launches_per_step", "train_idle_share",
                 "train_matmul_ns_per_frame", "train_other_ns_per_frame",
                 "train_fwd_roofline", "train_bwd_roofline", "train_mfu"):
        assert read(name, r) is None, name


@pytest.mark.parametrize("cfg,peak", [("mobileposer-f32", 67e12),
                                      ("mobileposer-bf16", 989e12)])
def test_train_readers(cfg, peak):
    r = train_rec(cfg)
    assert read("step_issue_ms", r) == 2.0
    assert read("launches_per_step", r) == 5.0
    assert read("train_matmul_ns_per_frame", r) == pytest.approx(
        1e3 * 500 / 32000)
    assert read("train_other_ns_per_frame", r) == pytest.approx(
        1e3 * 400 / 32000)
    assert read("train_idle_share", r) == pytest.approx(5.0)
    for name in ("tick_issue_ms", "launches_per_tick", "idle_share",
                 "matmul_ns_per_frame", "stream_other_ns_per_frame",
                 "scan_roofline", "stream_mfu"):
        assert read(name, r) is None, name
    c = MAN.config(cfg)
    fwd = roofline.train_bound_ms(c, 256, 125, "fwd")
    bwd = roofline.train_bound_ms(c, 256, 125, "bwd")
    assert read("train_fwd_roofline", r) == pytest.approx(100 * fwd / 0.4)
    assert read("train_bwd_roofline", r) == pytest.approx(100 * bwd / 0.6)
    assert read("train_mfu", r) == pytest.approx(
        100 * roofline.model_flops_per_frame(c) * 3 * 32000 / 2e-3 / peak)


@pytest.mark.parametrize("rec", [stream_rec, train_rec])
def test_readers_find_nothing_in_an_empty_trace(rec):
    r = rec()
    r["trace"] = {"device_ops": [], "host_ops": [], "calls": []}
    for m in MAN.data["per_layer"]:
        if m["name"] in ("tick_issue_ms", "step_issue_ms"):
            continue
        assert read(m["name"], r) is None, m["name"]


def test_busy_is_a_union():
    rec = {"device_ops": [("a", 0.0, 10.0), ("b", 5.0, 15.0),
                          ("c", 20.0, 30.0)], "host_ops": [],
           "calls": [(0.0, 40.0)]}
    assert trace.busy_us(rec) == 25.0
    assert trace.window_us(rec) == (0.0, 40.0)


def test_breakdown():
    b = trace.breakdown(stream_rec()["trace"])
    names = [n for n, _ in b["device_ops"]]
    assert names[0] == "lstm_scan (#1, #2)"
    assert b["device_ops"][0][1] == pytest.approx(1e-3)
    assert len(b["device_ops"]) <= 10
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(1e-4)
    assert gaps["cudaEventSynchronize"] == pytest.approx(1e-4)
