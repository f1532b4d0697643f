"""Each cell of BENCHMARK.json, run for 2 seconds at a tiny scale on the
CPU, prints a result line of the contract's shape and comes out correct."""

import json

import pytest

from conftest import ROOT, SEED
from olapbench import catalog, run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_on_cpu(bench, workload):
    line = run.run_cell(bench, workload, SEED, 2.0, False, device="cpu",
                        scale=0.01)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in catalog.metrics_for(bench, workload, False)}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    for v in line["checks"].values():
        assert v["value"] <= v["limit"]
    assert line["device"]["platform"] == "cpu"
