"""Finds the benchmark's parts by the names ``BENCHMARK.json`` gives them.

A configuration is ``configs/<name>.json`` (named by the ``file`` of its
entry); its statement templates are the modules of ``templates/<dir>/``
that the configuration names; a traffic mix is ``traffic/<name>.json``; a
metric is ``metrics/<name>.py`` with a ``read(run)`` function. Adding a
configuration, a mix, a template or a metric adds files and touches none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, prefix: str) -> ModuleType:
    """Import the Python file ``path`` under a name made from ``prefix``
    and its stem (file names may hold dots)."""
    name = f"{prefix}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Optional[Path] = None) -> dict:
    return json.loads(((root or ROOT) / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> Tuple[dict, dict]:
    """The workload's entry and its configuration's entry."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return w, configs[w["config"]]


def config(entry: dict) -> dict:
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def templates(cfg: dict) -> Dict[str, ModuleType]:
    """The configuration's statement templates by name, in file order."""
    d = HERE / "templates" / cfg["templates"]
    return {p.stem: load_module(p, f"olapbench_tpl_{cfg['templates']}")
            for p in sorted(d.glob("*.py")) if not p.stem.startswith("_")}


def metric(name: str, here: Optional[Path] = None) -> ModuleType:
    return load_module((here or HERE) / "metrics" / f"{name}.py",
                       "olapbench_metric")


def metrics_for(bench: dict, workload: str, trace: bool):
    """The metric entries this cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]
