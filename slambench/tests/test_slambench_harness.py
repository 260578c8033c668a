"""The harness's pure parts on the CPU: the tiny copy's cuts, read from the
drivers' files, give each cell the sizes it had when they were written in
``tiny.py``; and the traced record's arithmetic over hand-made profiler
events (the busy union, the program's spans)."""

from __future__ import annotations

import json
import os

import pytest

from slambench.harness import trace

from . import tiny

CAMERA = {"width": 80, "height": 60, "fx": 65.625, "fy": 65.625,
          "cx": 39.5, "cy": 29.5}
TSDF = {"voxels_per_side": 8, "grid_dim": 32, "max_blocks": 512,
        "max_touched_blocks": 256}
# every value the CPU copy sets, file by file, as the cuts held in
# tiny.py by name of driver and configuration set them
CUT = {
    "configs/client_vga.json": {
        "camera": CAMERA, "tsdf": TSDF,
        "mapper": {"max_submaps": 4, "submap_interval": 20 / 30}},
    "configs/cvg_two_client.json": {
        "camera": CAMERA, "tsdf": TSDF,
        "mapper": {"max_submaps": 6, "submap_interval": 2.0},
        "server": {"max_submaps": 12, "refuse_interval": 4.0},
        "registration": {"max_points": 256, "max_reg_blocks": 128}},
    "traffic/stream.json": {
        "window_frames": 10, "lap_frames": 20, "mission_submaps": 3,
        "max_frames": 3000, "trace_windows": 2},
    "traffic/serve.json": {
        "window_frames": 10, "lap_frames": 20, "mission_submaps": 3,
        "max_frames": 3000, "rate_hz": 10, "serve_period_s": 0.5,
        "trace_seconds": 1.0},
    "traffic/solve.json": {
        "lap_frames": 60, "submaps_per_robot": 6, "trace_optimizes": 1,
        "fusion": {"interval": 4.0, "to_offset": 1.0}},
}


@pytest.mark.parametrize("path", sorted(CUT))
def test_tiny_copy_sizes_as_before(tmp_path, path):
    b = tiny.make(str(tmp_path))
    with open(os.path.join(tiny.BENCH, path)) as f:
        want = json.load(f)
    for k, v in CUT[path].items():
        if isinstance(v, dict):
            want[k].update(v)
        else:
            want[k] = v
    with open(os.path.join(b, path)) as f:
        assert json.load(f) == want


def test_tiny_cut_conflict_raises(tmp_path):
    """Two cells' drivers that cut one configuration two ways."""
    def add(b):
        with open(os.path.join(b, "drivers", "other.py"), "w") as f:
            f.write('TINY = {"config": {"mapper": {"max_submaps": 5}}}\n')
        with open(os.path.join(b, "traffic", "other.json"), "w") as f:
            json.dump({"driver": "other"}, f)
        with open(os.path.join(b, "workloads", "client_vga.other.json"),
                  "w") as f:
            json.dump({"config": "client_vga", "traffic": "other"}, f)

    with pytest.raises(ValueError, match="max_submaps"):
        tiny.make(str(tmp_path), add=add)


E = trace.Event
NS = 1e-9


def _spans_trace():
    """Thread 1: span a holds span b; a launch in b, one in a alone, one
    outside both, each with its kernel; span a's device-side annotation
    and the driver's. Thread 2, inside a's time: a launch and a copy
    outside any span of its own, and span c with a launch."""
    return [
        E("slambench.step", False, 0, 100, 1, 0, 0),
        E("cox.a", False, 10, 60, 1, 0, 0),
        E("cox.b", False, 20, 30, 1, 0, 0),
        E("cudaLaunchKernel", False, 22, 23, 1, 5, 0),
        E("cudaLaunchKernel", False, 40, 41, 1, 6, 0),
        E("cudaLaunchKernel", False, 70, 71, 1, 7, 0),
        E("kernel_one", True, 40, 50, 9, 5, 0),
        E("kernel_two", True, 50, 52, 9, 6, 0),
        E("kernel_three", True, 80, 90, 9, 7, 0),
        E("cox.a", True, 40, 90, 9, 0, 0),           # annotations: no work
        E("slambench.step", True, 30, 95, 9, 0, 0),
        E("cudaLaunchKernel", False, 25, 26, 2, 8, 0),
        E("cudaMemcpyAsync", False, 27, 28, 2, 9, 0),
        E("cox.c", False, 31, 39, 2, 0, 0),
        E("cudaLaunchKernel", False, 32, 33, 2, 10, 0),
        E("kernel_four", True, 52, 56, 9, 8, 0),
        E("Memcpy DtoH", True, 56, 57, 9, 9, 0),
        E("kernel_five", True, 57, 60, 9, 10, 0),
    ]


def test_busy_leaves_out_annotations():
    busy_ns, gaps = trace.busy(_spans_trace())
    # work 40-60 and 80-90; the annotations would fill 30-95
    assert busy_ns == 30
    assert gaps == [(60, 80)]


def test_spans_charged_to_the_innermost_on_the_calling_thread():
    s = trace.attribute(_spans_trace())
    assert set(s) == {"a", "b", "c", trace.NONE}
    a, b, c, none = s["a"], s["b"], s["c"], s[trace.NONE]
    assert (a["n"], b["n"], c["n"], none["n"]) == (1, 1, 1, 0)
    # nested: b's launch is b's alone; a keeps its own
    assert (b["launches"], a["launches"]) == (1, 1)
    assert b["device_s"] == pytest.approx(10 * NS)
    assert b["kernels"] == {"kernel_one": pytest.approx(10 * NS)}
    assert a["kernels"] == {"kernel_two": pytest.approx(2 * NS)}
    # thread 2 inside a's time: its own span, else none; the copy too
    assert c["launches"] == 1 and set(c["kernels"]) == {"kernel_five"}
    assert none["launches"] == 2
    assert set(none["kernels"]) == {"kernel_three", "kernel_four",
                                    "Memcpy DtoH"}
    assert none["device_s"] == pytest.approx(15 * NS)
    # every launch and every piece of work charged once
    assert sum(r["launches"] for r in s.values()) == 5
    total = sum(r["device_s"] for r in s.values())
    assert total == pytest.approx(30 * NS)
    assert total <= trace.busy(_spans_trace())[0] * NS + 1e-18


def test_spans_without_program_tracing():
    evs = [e for e in _spans_trace() if not e.name.startswith("cox.")]
    s = trace.attribute(evs)
    assert set(s) == {trace.NONE}
    assert s[trace.NONE]["launches"] == 5
    assert s[trace.NONE]["device_s"] == pytest.approx(30 * NS)


def test_gap_labels_name_the_program_span():
    cpu = [(e.start, e.end, e.name) for e in _spans_trace()
           if not e.device]
    assert trace._label(cpu, 22.5) == "step/b/cudaLaunchKernel"
    assert trace._label(cpu, 75) == "step/host"
