"""The entry point refuses to run without what a cell needs, and a run on
a card prints a result line of the contract's shape."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

ARGS = ["--workload", "ssb_sf1.dashboard", "--seed", "5", "--seconds", "3"]


def _run(cwd, extra_env=None, args=ARGS):
    env = dict(os.environ, **(extra_env or {}))
    return subprocess.run([sys.executable, "olapbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_no_card_no_result():
    r = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copytree(ROOT / "olapbench", tmp_path / "olapbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "olapbench/run.py", *ARGS],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.card
def test_traced_run_on_card(card):
    r = _run(ROOT, args=ARGS + ["--trace", "1"])
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert 0 < line["metrics"]["device_idle"]["value"] < 100
    assert list(line)[-1] == "checks"
