"""The harness finds every file of a cell by name, and a cell, a
configuration, a traffic mix and a metric are added as new files only;
the result line keeps the benchmark's schema; the specification keeps the
contract's limits on names and keys."""
from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import harness
from portbench.run import Ctx, execute
from portbench.tests import tiny

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.load_cell(name)
    assert cell.config["name"] == next(
        w["config"] for w in SPEC["workloads"] if w["name"] == name)
    assert os.path.exists(os.path.join(harness.HERE, "loops",
                                       cell.traffic["loop"] + ".py"))
    assert harness.counts_module(cell).work
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
    assert set(cell.limits) and all(
        isinstance(v, (int, float)) for v in cell.limits.values())


def test_spec_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert harness.load_json(os.path.join(harness.ROOT, c["file"]))[
            "reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) < 64 * 1024


def test_new_cell_is_new_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell, as files and entries only, and runs the cell."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    conf = harness.load_json(os.path.join(harness.HERE, "configs",
                                          "tgn-reddit.json"))
    conf.update(name="tgn-small", dim_time=100)
    (root / "portbench/configs/tgn-small.json").write_text(json.dumps(conf))
    traffic = harness.load_json(os.path.join(harness.HERE, "traffic",
                                             "offline-epochs.json"))
    traffic["check_steps"] = 2
    (root / "portbench/traffic/offline-short.json").write_text(
        json.dumps(traffic))
    (root / "portbench/limits/tgn-small-train.json").write_text(
        json.dumps({"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}))
    (root / "portbench/metrics/steps_done.train.py").write_text(
        "def read(trace):\n    return float(trace.steps) or None\n")
    spec["configs"].append({"name": "tgn-small", "source": "test",
                            "file": "portbench/configs/tgn-small.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tgn-small-train",
                              "config": "tgn-small",
                              "traffic": "offline-short", "chips": 1,
                              "why": "test"})
    spec["end_to_end"][0]["workloads"].append("tgn-small-train")
    spec["per_layer"].append({"name": "steps_done.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "trainer dispatch (train.py)",
                              "moves": "train_edges_per_s",
                              "workloads": ["tgn-small-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = tiny.cell("tgn-small-train", str(root))
    assert cell.traffic["check_steps"] == 2
    res = execute(Ctx(cell, 7, 0.5, True, "cpu"))
    assert res["correct"]
    assert res["metrics"]["steps_done.train"]["value"] >= 1


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(trace):
    res = execute(Ctx(tiny.cell("tgn-train"), 2 ** 31 + 5, 0.5, trace,
                      "cpu"))
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"train_edges_per_s", "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_trace_readers_on_a_synthetic_window():
    """The readers over a made-up trace: idle share, launches, a kernel's
    roofline share by the program's kernel names, span medians."""
    tr = harness.Trace(window_s=1.0, steps=4)
    tr.ops = [("void (anonymous namespace)::gru_fused_fwd_kernel<float>()",
               0, 200_000_000),
              ("Memcpy HtoD (Pageable -> Device)", 300_000_000,
               100_000_000),
              ("void at::native::vectorized_elementwise_kernel<4>()",
               350_000_000, 150_000_000)]
    tr.spans = [("train_step", 0, 900_000_000)]
    tr.work = {"flops": 6.7e12, "gru_least_s": 0.05, "peak_flops": 67e12}
    tr.span_ms = {"ingest": [1.0, 3.0, 2.0]}
    from portbench import readers
    assert readers.idle_pct(tr) == pytest.approx(100 * (1 - 0.4))
    assert readers.launches_per_step(tr) == 0.5
    assert readers.mfu_pct(tr) == pytest.approx(10.0)
    assert readers.roofline_pct(tr, "gru_fused.cu", "gru_least_s") \
        == pytest.approx(25.0)
    assert readers.roofline_pct(tr, "attention_fused.cu",
                                "attn_least_s") is None
    assert readers.span_p50_ms(tr, "ingest") == 2.0
    gaps = tr.idle_gaps()
    assert gaps[0] == ["train_step", 0.1]
