"""BENCHMARK.json against the benchmark's contract of names and files, and
a cell, a configuration, a traffic mix and a per-layer metric added as
files of their own, found by name."""
from __future__ import annotations

import json
import re

import pytest
import torch

from portbench.lib import manifest
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in metrics] + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files(workload):
    cell = manifest.cell(workload)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(manifest.reader(m["name"]))
    assert set(cell.limits)


def test_a_new_cell_is_found_by_name(tmp_path):
    """A configuration, a traffic mix, a metric and a cell's limits added as
    new files, with entries added to BENCHMARK.json, run without an edit to
    any file that was there."""
    from portbench import run
    root = tiny.tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    pb = root / "portbench"
    (pb / "configs" / "tiny-extra.json").write_text(
        (pb / "configs" / "segclip-vitb16.json").read_text())
    mix = json.loads((pb / "traffic" / "pretrain-b256.json").read_text())
    (pb / "traffic" / "pretrain-extra.json").write_text(json.dumps(dict(mix, batch=4)))
    (pb / "metrics" / "steps_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.get('step_s') or [])) or None\n")
    (pb / "limits" / "train-extra.json").write_text(
        (pb / "limits" / f"{tiny.TRAIN_CELL}.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-extra", "source": "https://arxiv.org/abs/2211.14813",
                             "file": "portbench/configs/tiny-extra.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "train-extra", "config": "tiny-extra",
                               "traffic": "pretrain-extra", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_s" or m["name"] == "train_peak_gib":
            m["workloads"].append("train-extra")
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "train/step",
                               "moves": "train_img_s", "workloads": ["train-extra"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run.run(tiny.args("train-extra", seconds=1.0, trace=1), root=root,
                   device=torch.device("cpu"))
    assert line["correct"], line["checks"]
    assert line["metrics"]["steps_seen"]["value"] >= 1
    after = {p: p.read_bytes() for p in before}
    assert after == before
