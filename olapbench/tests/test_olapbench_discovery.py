"""A configuration, a traffic mix, a cell and a metric added as new files
(and entries of BENCHMARK.json) are found by name: no file the benchmark
already has is edited."""

import hashlib
import json
import shutil
import subprocess
import sys

from conftest import ROOT

NEW_METRIC = '''"""Statements the window's clients sent."""


def read(run):
    return len(run.records)
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "olapbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "olapbench", copy / "olapbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = _digests(copy)

    cfg = json.loads((copy / "olapbench/configs/ssb_sf1.json").read_text())
    cfg["name"] = "ssb_small"
    cfg["context"]["sdot.sharedscan.max.queries"] = 4
    (copy / "olapbench/configs/ssb_small.json").write_text(json.dumps(cfg))
    (copy / "olapbench/traffic/pair.json").write_text(json.dumps(
        {"pattern": "refresh", "clients": 2,
         "templates": ["q1_1", "q2_1"]}))
    (copy / "olapbench/metrics/stmt_count.py").write_text(NEW_METRIC)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="ssb_small",
                                 file="olapbench/configs/ssb_small.json"))
    bench["workloads"].append({"name": "ssb_small.pair",
                               "config": "ssb_small", "traffic": "pair",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "stmt_count", "unit": "stmt", "better": "higher",
        "source": "host_clock", "layer": "server", "moves": "stmt_per_s",
        "workloads": ["ssb_small.pair"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import sys, json; sys.path.insert(0, '.')\n"
            f"sys.path.append({str(ROOT)!r})\n"
            "from olapbench import catalog, run\n"
            f"assert run.__file__.startswith({str(copy)!r})\n"
            "line = run.run_cell(catalog.benchmark(), 'ssb_small.pair', 9,"
            " 1.0, False, device='cpu', scale=0.005)\n"
            "print(json.dumps(line))")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy,
                         capture_output=True, text=True, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    assert "stmt_per_s" in line["metrics"]
    assert _digests(copy).items() >= before.items()

    from olapbench import catalog
    metric = catalog.metric("stmt_count", copy / "olapbench")
    assert metric.read(type("R", (), {"records": [1, 2, 3]})) == 3
    assert [m["name"] for m in catalog.metrics_for(bench, "ssb_small.pair",
                                                   True)][-1] == "stmt_count"
