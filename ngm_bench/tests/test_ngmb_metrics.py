"""The per-layer readers, the trace's arithmetic and the yardstick, on
hand-made inputs."""

import pytest

from ngmb import manifest, trace, yardstick
from ngmb.trace import DeviceOp, HostOp

WORK = yardstick.Work(reads=4096, read_len=150, band=56, kmers=69, cmrs=32,
                      score_slots=600.0, score_cells=600.0 * 150 * 56,
                      aligned=4096.0, align_cells=4096.0 * 150 * 56,
                      valid_kmers=4096 * 69.0, hits=4096 * 180.0)


def ctx(**kw):
    ops = [DeviceOp("void sw_align_kernel<16>", 0.0, 120.0),
           DeviceOp("void cand_search_kernel<32>", 130.0, 140.0),
           DeviceOp("void at::elementwise", 135.0, 150.0),
           DeviceOp("Memcpy DtoD", 180.0, 181.0)]
    c = {"cell": "chr20_se150.wgs", "K": 8, "batch": 4096, "replays": 1,
         "batches": 1, "reads": 4096, "replay_ms": [1.0, 1.0],
         "captures": [{"seconds": 0.25}], "window_s": 400e-6,
         "busy_s": trace.busy_us(ops) / 1e6, "device_ops": ops,
         "counters": {"score_slots": 600}, "work": WORK,
         "index_build_s": 0.2}
    c.update(kw)
    return c


def test_merged_busy_and_gaps():
    ops = ctx()["device_ops"]
    assert trace.merged(ops) == [(0.0, 120.0), (130.0, 150.0),
                                 (180.0, 181.0)]
    assert trace.busy_us(ops) == 141.0
    host = [HostOp("cudaGraphLaunch", 110.0, 160.0),
            HostOp("aten::add_", 150.0, 155.0)]
    gaps = trace.idle_gaps(ops, host)
    assert gaps[0] == ["host:aten::add_", 30e-6]
    assert gaps[1] == ["host:cudaGraphLaunch", 10e-6]
    assert trace.idle_gaps(ops, [])[0][0] == "host:no_profiled_op"
    assert trace.kernel_us(ops, r"sw_align") == (120.0, 1)
    assert trace.top_ops(ops)[0][0].startswith("void_sw_align_kernel")


def test_readers():
    c = ctx()
    read = {m["name"]: manifest.metric_reader(m["name"])
            for m in manifest.load_manifest()["per_layer"]}
    assert read["replay_ms"](c) == 1.0
    assert read["capture_s"](c) == 0.25
    assert read["device_idle_pct"](c) == pytest.approx(100 * (1 - 141 / 400))
    assert read["score_slots_per_read"](c) == 600 / 4096
    assert read["index_build_s"](c) == 0.2
    k4 = read["traceback_roofline_pct"](c)
    assert k4 == pytest.approx(100 * yardstick.k4_s(WORK) / 120e-6)
    k6 = read["candidates_roofline_pct"](c)
    assert k6 == pytest.approx(100 * yardstick.k6_s(WORK) / 10e-6)
    step = read["step_roofline_pct"](c)
    assert step == pytest.approx(100 * yardstick.step_s(WORK) / (1e-3 / 8))
    assert all(0 < v < 100 for v in (k4, k6, step))


def test_readers_with_nothing_to_read_return_nothing():
    c = ctx(device_ops=[], replay_ms=[], captures=[])
    for name in ("replay_ms", "capture_s", "device_idle_pct",
                 "traceback_roofline_pct", "candidates_roofline_pct",
                 "step_roofline_pct"):
        assert manifest.metric_reader(name)(c) is None, name


def test_yardstick_bounds():
    # K4 at [4096, 150] x W56: 20 ops a cell over 132 x 64 x 1.98 GHz
    assert yardstick.PEAK_INT_OPS == pytest.approx(16.727e12, rel=1e-3)
    assert yardstick.k4_s(WORK) == pytest.approx(
        20 * 4096 * 150 * 56 / yardstick.PEAK_INT_OPS)
    # K6 is bound by bytes
    assert yardstick.k6_s(WORK) == pytest.approx(
        (4096 * (9 * 69 + 4) + 8 * 4096 * 69 + 4 * 4096 * 180
         + 4096 * (12 * 32 + 8)) / 3.35e12)
    assert yardstick.step_s(WORK) > yardstick.k4_s(WORK) + yardstick.k6_s(WORK)
