"""The correctness control: the plain reference in float32 in the program's
place, held to the same comparison as a run's answers.

    python3 olapbench/control.py --workload ssb_sf1.dashboard \
        --seeds 11,12,13 [--scale 0.05]

For each seed it generates the cell's data at the configuration's scale
(or ``--scale``), takes the statements the cell's clients would send in
a window (``--statements`` of them, the first batches of every client),
draws the sample a run compares (``compare.sample_texts``), answers each
sampled statement with the reference computed in float32 (values,
products and accumulators, summed in row order) and judges those answers
against the float64 reference. It prints one JSON line per seed with the
numbers and limits of ``compare.check``; ``correct`` has to come out
false. Runs on the host alone: it needs no card and imports nothing of
the program.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if sys.path[0] != str(ROOT):
    sys.path.insert(0, str(ROOT))

from olapbench import catalog, compare, traffic  # noqa: E402


def window_statements(mix, tpls, seed: int, n: int) -> dict:
    """``n`` statements of the cell's clients, as a run's results hold
    them, every one answered."""
    gens = [traffic.batches(mix, tpls, seed, c)
            for c in range(int(mix["clients"]))]
    records, texts = [], {}
    while len(records) < n:
        for c, g in enumerate(gens):
            for name, params in next(g):
                sql = traffic.sql(tpls[name], params)
                tid = texts.setdefault(sql, len(texts))
                records.append({"client": c, "template": name,
                                "params": params, "text": tid,
                                "status": 200})
    return {"records": records,
            "texts": sorted(texts, key=texts.get), "bodies": {}}


def control(bench: dict, workload: str, seed: int, n: int,
            scale=None) -> dict:
    w, centry = catalog.cell(bench, workload)
    cfg = catalog.config(centry)
    mix = catalog.traffic(w["traffic"])
    tpls = catalog.templates(cfg)
    gen = importlib.import_module(f"olapbench.data.{cfg['generator']}")
    table = gen.generate(scale or cfg["scale_factor"], seed)
    results = window_statements(mix, tpls, seed, n)
    return compare.check(table, tpls, results, seed, cfg["guarantees"],
                         float_dtype=np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--statements", type=int, default=1000)
    ap.add_argument("--scale", type=float)
    args = ap.parse_args(argv)
    bench = catalog.benchmark(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        v = control(bench, args.workload, seed, args.statements, args.scale)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": v["correct"], "compared": v["compared"],
                          "numbers": v["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
