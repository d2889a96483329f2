"""The result line has exactly the keys of the result format, the compared
numbers last."""
import json

from benchmark import harness


def line(breakdown=None):
    return json.loads(harness.result_line(
        True, 3, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
        {"platform": "gpu", "kind": "x", "count": 1,
         "memory_peak_bytes": 1}, [("loss", 1e-3, 2e-3)], breakdown))


def test_untraced_line_keys():
    out = line()
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["checks"] == {"loss": {"value": 1e-3, "limit": 2e-3}}


def test_traced_line_keys():
    out = line({"device_ops": [["k", 0.1]], "idle_gaps": [["g", 0.2]]})
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]


def test_check_lines_name_value_and_limit():
    assert harness.check_lines([("rel_rms", 0.25, 0.5)]) == [
        "check rel_rms: 0.25 (limit 0.5)"]


def test_trace_arithmetic():
    win = harness.Window(calls=2, kinds={"frame": 2})
    t = harness.Trace([("sra_attention_kernel_bf16", 0.0, 0.1),
                       ("elementwise", 0.05, 0.2),
                       ("elementwise", 0.5, 0.6)], 1.0, win, {}, {},
                      harness.kernel_families(), {})
    assert abs(t.busy_s() - 0.3) < 1e-12
    assert t.is_kernel("sra_attention_kernel_bf16")
    assert not t.is_kernel("elementwise")
    assert abs(t.family_s("K1") - 0.1) < 1e-12
    gaps = t.idle_gaps()
    assert gaps[0][0] == "after the last operation"
    assert abs(gaps[0][1] - 0.4) < 1e-12
    assert gaps[1][0] == "before elementwise"


def roofline_of(counted, events):
    """The kernel roofline reading of a window of two frames whose table
    has one K1 call a frame, with the port's counter at ``counted``."""
    win = harness.Window(calls=2, kinds={"frame": 2})
    cell = {"kernel_calls": {"frame": [
        {"kernel": "K1", "shape": [1, 4096, 256, 1], "dtype": "bfloat16",
         "calls": 1}]}}
    launches = {f: 0 for f in harness.kernel_families()["families"]}
    launches["K1"] = counted
    t = harness.Trace([("sra_attention_kernel_bf16", 0.1 * i, 0.1 * i + 0.05)
                       for i in range(events)], 1.0, win, cell, {},
                      harness.kernel_families(), launches)
    return harness.metric_reader("kernel_roofline_pct.infer")(
        {"trace": t}), t


def test_roofline_read_where_the_table_describes_the_window():
    value, t = roofline_of(2, 2)
    assert value is not None and value > 0
    assert t.kernel_count_faults() == []


def test_roofline_left_out_where_the_port_calls_differ_from_the_table():
    for counted, events in ((3, 3), (1, 2), (2, 1)):
        value, t = roofline_of(counted, events)
        assert value is None, (counted, events)
        assert t.kernel_count_faults()
