"""Every file the manifest names loads by name, and the manifest keeps to
the shape the harness reads."""
import pytest

from benchmark import harness

MAN = harness.manifest()


def test_manifest_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_loads(cfg):
    c = harness.config(cfg["name"])
    assert c["name"] == cfg["name"]
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert c["reduced"] == cfg["reduced"] == []


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_workload_loads(cell):
    w = harness.workload(cell["name"])
    assert w["name"] == cell["name"]
    assert w["config"] == cell["config"]
    assert w["why"] == cell["why"] and len(w["why"]) <= 200
    assert w["chips"] == cell["chips"] == 1
    drv = harness.driver(w["driver"])
    for fn in ("run", "control", "flops"):
        assert callable(getattr(drv, fn))
    for kind, calls in w["kernel_calls"].items():
        assert kind in w["traffic"]["kinds"]
        for c in calls:
            assert c["kernel"] in harness.kernel_families()["families"]


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_loads(m):
    assert callable(harness.metric_reader(m["name"]))
    cells = {c["name"] for c in MAN["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_enough():
    for cell in MAN["workloads"]:
        e2e = harness.cell_metrics(MAN, cell["name"], "end_to_end")
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        per = harness.cell_metrics(MAN, cell["name"], "per_layer")
        assert per
        for m in per:
            assert m["moves"] in names


def test_kernel_families_load():
    fams = harness.kernel_families()["families"]
    assert set(fams) == {"K1", "K1-bwd", "K2", "K2-bwd", "K3", "K3-bwd"}
    assert all(f["patterns"] for f in fams.values())
