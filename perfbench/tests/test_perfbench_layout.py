"""The benchmark is driven by data: a cell, a configuration or a per-layer
metric is added by adding a file (and its entry in BENCHMARK.json), with
no file of the harness edited.  Also: the contract's shape of
BENCHMARK.json, and what a run does without a card."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness, run

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"config": {"n": 120, "capacity": 144,
                    "acquisition": {"ucb_alpha": 0.5, "restarts": 4,
                                    "steps": 2, "sweep": 16},
                    "cache": {"lite": False, "mirror_dtype": "bfloat16",
                              "defer_m": 8}},
         "traffic": {"trace_after": 1, "trace_units": 2}}


def copy_tree(tmp: Path) -> Path:
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


def test_added_files_are_found(tmp_path):
    root = copy_tree(tmp_path)
    base = root / "perfbench"
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs/se_ard8_n16k.json").read_text())
    cfg.update(name="se_ard4_small", dim=4)
    (base / "configs/se_ard4_small.json").write_text(json.dumps(cfg))
    wl = json.loads((base / "workloads/bo_loop_n16k.json").read_text())
    wl["config"] = "se_ard4_small"
    (base / "workloads/bo_loop_small.json").write_text(json.dumps(wl))
    (base / "metrics/restores_seen.py").write_text(
        "def read(ctx):\n"
        "    return sum(r['restored'] for r in ctx.records)\n")
    (base / "metrics/never_read.py").write_text(
        "def read(ctx):\n    return None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "se_ard4_small", "source": "x",
                             "file": "perfbench/configs/se_ard4_small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "bo_loop_small",
                               "config": "se_ard4_small",
                               "traffic": "bo_loop", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "bo_iters_per_s":
            m["workloads"].append("bo_loop_small")
    bench["per_layer"] += [
        {"name": "restores_seen", "unit": "count", "better": "lower",
         "source": "program_counter", "layer": "BO loop",
         "moves": "bo_iters_per_s", "workloads": ["bo_loop_small"]},
        {"name": "never_read", "unit": "count", "better": "lower",
         "source": "program_counter", "layer": "BO loop",
         "moves": "bo_iters_per_s", "workloads": ["bo_loop_small"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    res = run.run_cell("bo_loop_small", 5, 1.0, trace=False, device="cpu",
                       base=base, root=root, overrides=SMALL)
    assert set(res["metrics"]) == {"bo_iters_per_s", "setup_s"}
    res = run.run_cell("bo_loop_small", 5, 1.0, trace=True, device="cpu",
                       base=base, root=root, overrides=SMALL)
    # the reader that finds nothing leaves its metric out of the line
    assert "never_read" not in res["metrics"]
    assert res["metrics"]["restores_seen"]["unit"] == "count"
    assert res["checks"]["L"]["value"] < res["checks"]["L"]["limit"]
    # no file the harness had was edited
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_cell_metrics_selection():
    bench = harness.benchmark()
    names = {w["name"] for w in bench["workloads"]}
    for cell in names:
        e2e = {m["name"] for m in harness.cell_metrics(bench, cell, False)}
        layer = harness.cell_metrics(bench, cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer and all(m["moves"] in e2e for m in layer)
    assert {m["name"] for m in harness.cell_metrics(
        bench, "hp_learn_n16k", True)} == {"device_idle_share.hp",
                                           "hp_step_mfu"}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_benchmark_json_shape():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
        wl = harness.workload(w["name"])
        assert wl["config"] == w["config"]
        assert wl["traffic"]["driver"] == w["traffic"]
        assert (ROOT / "perfbench/traffic" / f"{w['traffic']}.py").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"])
        assert (ROOT / "perfbench/metrics" / f"{m['name']}.py").is_file()
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(bench)) < 64 * 1024


def test_run_without_a_card_exits_2_and_prints_nothing(tmp_path):
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "bo_loop_n16k",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""


def test_run_in_a_bare_copy_fails(tmp_path):
    root = copy_tree(tmp_path)
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "bo_loop_n16k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """A whole run of the first cell, on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = run.run_cell("bo_loop_n16k", 4294967311, 2.0, trace=False)
    assert res["correct"], res["checks"]
