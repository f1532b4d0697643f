"""Runs one cell of the port's benchmark and prints its result line.

    python3 olapbench/run.py --workload ssb_sf1.dashboard --seed 7 \
        --seconds 20 --trace 0

A run, in one process on one card:

1. generates the configuration's flat star from ``--seed``
   (``olapbench/data``), starts the port's ``Context`` with the
   configuration's settings, ingests the star and registers its schema;
2. serves it with the port's ``SqlServer`` on loopback and starts the
   closed-loop clients in a child process (``client.py``), which send the
   warm-up statements (every template once alone, then one round of the
   mix's own concurrency) and then the window's;
3. with ``--trace 1``, records the window with ``torch.profiler``;
4. once the window has closed and every statement in flight has been
   answered, reads the card's peak memory, stops the server, frees the
   context, and holds a sample of the answers against the plain
   reference (``compare.py``);
5. prints the numbers compared, each beside its limit, as the last lines
   of its standard error, and one JSON line as the last line of its
   standard output: the cell's end-to-end metrics, or with ``--trace 1``
   its per-layer metrics, each read by ``metrics/<name>.py``.

It exits with another code than 0, and prints no result, without CUDA or
with fewer cards than the cell asks for, and when ``jax``, ``jaxlib``,
``flax`` or the JAX package are loaded in this process once the window
has closed. Every cache of the program's builds lies inside the checkout
(``build/``).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path[0] == str(HERE):
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "spark_druid_olap_tpu")
CHILD_WAIT_S = 120.0     # beyond the window: the drain and the results


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    since_boot = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    offset = time.clock_gettime(time.CLOCK_BOOTTIME) - time.perf_counter()
    return since_boot - offset


def cache_env(root: Path) -> None:
    """Keep every build and kernel cache inside the checkout, and keep
    libraries from loading JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def usage(who) -> dict:
    """CPU seconds in user and in system mode of
    ``resource.getrusage(who)``."""
    r = resource.getrusage(who)
    return {"user_s": r.ru_utime, "system_s": r.ru_stime}


def host_probe_s() -> float:
    """Seconds this interpreter takes for a fixed pure-Python loop on one
    thread: the host's pace at the time, to set beside a run's rate."""
    t0 = time.perf_counter()
    x = 0
    for i in range(3_000_000):
        x += i * i
    return time.perf_counter() - t0


def window_summary(history) -> dict:
    """The window's statements by route, its shared-scan groups, and the
    mean milliseconds of each program phase per statement."""
    routes, groups, phases = {}, {}, {}
    for h in history:
        st = h.stats
        r = str(st.get("route"))
        routes[r] = routes.get(r, 0) + 1
        g = (st.get("sharedscan") or {}).get("group")
        if g is not None:
            groups[g] = groups.get(g, 0) + 1
        for k, v in (st.get("phases") or {}).items():
            phases[k] = phases.get(k, 0.0) + float(v)
    n = max(1, len(history))
    return {"routes": routes, "groups": len(groups),
            "group_members_mean": round(sum(groups.values())
                                        / max(1, len(groups)), 3),
            "phase_ms_mean": {k: round(v / n, 3) for k, v in
                              sorted(phases.items(), key=lambda kv: -kv[1])}}


def kernels_loaded() -> set:
    """The program's kernel libraries loaded so far (each built at its
    first use): one loaded inside the window was built there."""
    from spark_druid_olap_tpu_torch.ops import cuda_build
    from spark_druid_olap_tpu_torch.segment import native
    return {Path(k).name for k in cuda_build._built} \
        | ({"segment_encoder"} if native._module is not None else set())


def compile_ms(records) -> float:
    """Milliseconds of the program's ``compile`` phase over ``records``."""
    return sum((r.stats.get("phases") or {}).get("compile", 0.0)
               for r in records)


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Run:
    """What the metric readers read of one run."""

    def __init__(self, cfg, tpls, table, results, seconds):
        self.cfg, self.tpls, self.table = cfg, tpls, table
        self.seconds = seconds
        self.deadline = results["deadline"]
        texts = results["texts"]
        self.records = [dict(r, sql=texts[r["text"]])
                        for r in results["records"]]
        self.bodies = results["bodies"]
        self.statements = []
        self.setup_s = self.ingest_s = None
        self.trace = self.peak = None
        self.widths = cfg["widths"]
        self._time_index = None

    def answered_per(self, step_s: float):
        """Statements answered in each ``step_s`` of the window."""
        t0 = min(r["t_send"] for r in self.records)
        counts = [0] * (int((self.deadline - t0) // step_s) + 1)
        for r in self.records:
            if r["status"] == 200 and r["t_done"] <= self.deadline:
                counts[int((r["t_done"] - t0) // step_s)] += 1
        return counts

    def latencies_ms(self):
        return [(r["t_done"] - r["t_send"]) * 1e3 for r in self.records]

    def columns(self, s):
        return self.tpls[s["template"]].COLUMNS

    def time_range(self, s):
        return self.tpls[s["template"]].time_range(s["params"])

    @property
    def time_index(self):
        if self._time_index is None:
            from olapbench.roofline import TimeIndex
            self._time_index = TimeIndex(
                self.table.col(self.cfg["time_column"]))
        return self._time_index

    def join_history(self, history, with_work: bool) -> None:
        """The window's ``ctx.history`` records, each with the template and
        parameters of its text and, for the rooflines, its work."""
        from olapbench.roofline import work
        by_text = {}
        for r in self.records:
            if r["status"] == 200:
                by_text.setdefault(r["sql"], r)
        cells = {}
        for h in history:
            rec = by_text.get(h.sql)
            if rec is None:
                continue
            st = h.stats
            s = {"sql": h.sql, "template": rec["template"],
                 "params": rec["params"], "route": st.get("route"),
                 "group": (st.get("sharedscan") or {}).get("group"),
                 "total_ms": float(st.get("total_ms", 0.0)),
                 "phases": dict(st.get("phases") or {})}
            if with_work:
                if h.sql not in cells:
                    body = json.loads(self.bodies[rec["body"]])
                    cells[h.sql] = len(body["rows"]) * len(body["columns"])
                s["answer_cells"] = cells[h.sql]
                s["work"] = work(self.widths, self.columns(s),
                                 self.time_index.rows([self.time_range(s)]),
                                 s["answer_cells"])
            self.statements.append(s)


def star_schema(spec: dict, datasource: str):
    from spark_druid_olap_tpu_torch.metadata.star import (StarRelation,
                                                           StarSchema)
    return StarSchema(spec["fact"], datasource, [
        StarRelation(a, b, tuple(tuple(p) for p in on))
        for a, b, on in spec["relations"]])


def load(cfg: dict, seed: int, scale: Optional[float], device: str,
         stages: dict):
    """Generate the configuration's table from ``seed``, start the port's
    context and ingest it; ``(table, ctx, ingest_s)``."""
    import spark_druid_olap_tpu_torch as sdt
    gen = importlib.import_module(f"olapbench.data.{cfg['generator']}")
    t0 = time.perf_counter()
    table = gen.generate(scale or cfg["scale_factor"], seed)
    frame = table.frame()
    stages["generate_s"] = time.perf_counter() - t0
    ctx = sdt.Context(dict(cfg["context"]), device=device)
    t0 = time.perf_counter()
    ctx.ingest_dataframe(cfg["datasource"], frame,
                         time_column=cfg["time_column"],
                         target_rows=int(cfg["segment_rows"]))
    ingest_s = time.perf_counter() - t0
    ctx.register_star_schema(star_schema(cfg["star_schema"],
                                         cfg["datasource"]))
    return table, ctx, ingest_s


def drive(ctx, config_file: Path, traffic: str, seed: int, seconds: float,
          trace: bool, device: str, stages: dict):
    """Serve ``ctx`` over HTTP to the clients' process: its warm-up, then
    the window, traced with ``--trace``. Returns the clients' results, the
    ``ctx.history`` records of the warm-up and of the window, the profile
    (or None) and the window's seconds."""
    import torch
    from spark_druid_olap_tpu_torch.server.http import SqlServer
    server = SqlServer(ctx, port=0).start()
    t_warm = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="olapbench-"))
    out = tmp / "client.json"
    child = subprocess.Popen(
        [sys.executable, str(HERE / "client.py")], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True, cwd=str(ROOT))
    prof = None
    try:
        child.stdin.write(json.dumps({
            "port": server.port, "config_file": str(config_file),
            "traffic": traffic, "seed": seed, "seconds": seconds,
            "out": str(out)}) + "\n")
        child.stdin.flush()
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the clients' warm-up failed")
        stages["warm_up_s"] = time.perf_counter() - t_warm
        built = kernels_loaded()
        n0 = len(ctx.history.entries())
        if device == "cuda":
            torch.cuda.synchronize()
        if trace:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t_go = time.perf_counter()
        use0 = usage(resource.RUSAGE_SELF)
        child.stdin.write("go\n")
        child.stdin.flush()
        if child.stdout.readline().strip() != "end":
            raise RuntimeError("the clients did not finish the window")
        if device == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t_go
        if trace:
            prof.__exit__(None, None, None)
        stages["kernels_loaded_in_window"] = sorted(kernels_loaded() - built)
        use1 = usage(resource.RUSAGE_SELF)
        stages["server_cpu_per_s"] = {k: (use1[k] - use0[k]) / window_s
                                      for k in use0}
        child.stdin.close()
        if child.wait(CHILD_WAIT_S) != 0:
            raise RuntimeError(f"the clients exited {child.returncode}")
        results = json.loads(out.read_text())
        stages["unanswered_after_drain"] = results["stuck_statements"]
        stages["client_cpu_s"] = usage(resource.RUSAGE_CHILDREN)
        stages["host_probe_s"] = host_probe_s()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        out.unlink(missing_ok=True)
        tmp.rmdir()
        server.stop()
    everything = ctx.history.entries()
    return results, everything[:n0], everything[n0:], prof, window_s


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             scale: Optional[float] = None,
             t_start: Optional[float] = None) -> dict:
    """One run of ``workload``; returns its result object. ``device`` and
    ``scale`` other than the cell's are for the CPU tests alone."""
    import torch
    from olapbench import catalog, compare
    t_start = time.perf_counter() if t_start is None else t_start
    w, centry = catalog.cell(bench, workload)
    cfg = catalog.config(centry)
    tpls = catalog.templates(cfg)
    stages = {}
    table, ctx, ingest_s = load(cfg, seed, scale, device, stages)
    results, warm, history, prof, window_s = drive(
        ctx, ROOT / centry["file"], w["traffic"], seed, seconds, trace,
        device, stages)
    stages["compile_ms_warm_up"] = compile_ms(warm)
    stages["compile_ms_window"] = compile_ms(history)
    stages["window"] = window_summary(history)
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    run = Run(cfg, tpls, table, results, seconds)
    run.ingest_s = ingest_s
    run.setup_s = min(r["t_send"] for r in run.records) - t_start
    if trace:
        from olapbench import roofline
        from olapbench import trace as T
        t0 = time.perf_counter()
        run.trace = T.reduce(prof, window_s)
        stages["trace_s"] = time.perf_counter() - t0
        run.peak = roofline.peaks(dev["kind"])
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
    run.join_history(history, with_work=trace)
    ctx.close()
    del ctx, warm, history, prof
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    verdict = compare.check(table, tpls, results, seed, cfg["guarantees"])
    stages["reference_s"] = time.perf_counter() - t0
    metrics = {}
    for m in catalog.metrics_for(bench, workload, trace):
        value = catalog.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": verdict["correct"], "attempted": len(run.records),
            "failed": sum(1 for r in run.records if r["status"] != 200),
            "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = {"device_ops": run.trace["ops"][:10],
                             "idle_gaps": run.trace["gaps"][:10]}
    stages["ingest_s"], stages["setup_s"] = ingest_s, run.setup_s
    stages["answered_per_5s"] = run.answered_per(5.0)
    print("stages " + json.dumps(stages), file=sys.stderr)
    for f in verdict["faults"]:
        print(f"fault: {f}", file=sys.stderr)
    print(f"compared {verdict['compared']} answers of "
          f"{line['attempted']} statements", file=sys.stderr)
    for name, v in verdict["numbers"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    line["checks"] = verdict["numbers"]
    return line


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    from olapbench import catalog
    bench = catalog.benchmark(ROOT)
    w, _ = catalog.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(w["chips"]):
        print(f"needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
