"""The port's sdlint (``spark_druid_olap_tpu_torch/tools/sdlint``): the CI
gate over the port's tree and the self-tests, the counterpart of
``tests/test_lint.py``.

1. **The gate** — every pass over the port's package: no finding the
   port's baseline does not cover, every baseline entry justified and
   live; the CLI's exit codes.
2. **Carried-over passes** (locks, contracts, mergeclosure, keys, leaks,
   ordering) run on the JAX package's seeded fixture trees under
   ``tests/lint_fixtures/`` (read, never written) and give the same
   ``(pass, rule, path, symbol)`` findings as the JAX package's sdlint on
   the same tree, both tools run here.
3. **Retargeted rules** (purity over ``make_fx``, the CUDA kernel
   contract, the slot / rank merges) and the port's additions fire on
   fixture sources written to ``tmp_path``.
4. **The two repaired faults**: fixtures in their pattern (a fused
   program signature without the sketch widths its build reads, an
   unlocked ``clear_caches``) are caught by the ``keys`` and ``locks``
   passes and clean once repaired; the port's real lock graph and the
   repaired rules stay pinned.

Everything is pure ``ast``: no module under analysis is imported.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

import spark_druid_olap_tpu_torch
from spark_druid_olap_tpu_torch.tools.sdlint import PASSES
from spark_druid_olap_tpu_torch.tools.sdlint.core import (Baseline, Project,
                                                          report_json,
                                                          run_passes)
from spark_druid_olap_tpu_torch.tools.sdlint.locks import LockAnalysis

PKG_ROOT = os.path.dirname(os.path.abspath(spark_druid_olap_tpu_torch.__file__))
REPO = os.path.dirname(PKG_ROOT)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lint_fixtures")
BASELINE = os.path.join(PKG_ROOT, "tools", "sdlint", "baseline.json")
CARRIED = ("locks", "contracts", "mergeclosure", "keys", "leaks",
           "ordering")
FIXTURE_TREES = ("deadlock", "purity", "contracts", "phases",
                 "mergeclosure", "keys", "leaks", "ordering", "kernels",
                 "mesh")
#: the pass each JAX fixture tree seeds (its findings must be non-empty)
SEEDED = {("deadlock", "locks"), ("contracts", "contracts"),
          ("phases", "contracts"), ("mergeclosure", "mergeclosure"),
          ("keys", "keys"), ("leaks", "leaks"), ("ordering", "ordering")}


@pytest.fixture(scope="module")
def port_project():
    return Project(PKG_ROOT)


@pytest.fixture(scope="module")
def port_findings(port_project):
    return run_passes(port_project)


def _write(root, files):
    for rel, src in files.items():
        path = os.path.join(str(root), rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        src = textwrap.dedent(src).lstrip("\n")
        if rel.endswith(".py"):
            ast.parse(src)      # a fixture that does not parse is skipped
        with open(path, "w", encoding="utf-8") as f:
            f.write(src)
    return Project(str(root), package="fixture")


def _got(findings):
    return {(f.rule, f.symbol) for f in findings}


def _sdlint(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", "spark_druid_olap_tpu_torch.tools.sdlint",
         *args], capture_output=True, text=True, env=env, cwd=REPO)


# -- 1. the gate ----------------------------------------------------------------

def test_port_has_no_unbaselined_findings(port_findings):
    baseline = Baseline.load(BASELINE)
    fresh = [f for f in port_findings if not baseline.matches(f)]
    assert not fresh, \
        "sdlint findings not covered by the port's baseline.json (fix " \
        "them, or baseline WITH a justification):\n" \
        + "\n".join(f.render() for f in fresh)


def test_baseline_entries_are_justified_and_live(port_findings):
    baseline = Baseline.load(BASELINE)
    assert not baseline.missing_justifications()
    assert not baseline.unmatched(port_findings), \
        "stale baseline entries: delete them"


def test_cli_exit_codes(tmp_path):
    clean = _sdlint()
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "0 finding(s)" in clean.stdout
    dirty = _sdlint("--root", os.path.join(FIXTURES, "deadlock"),
                    "--package", "fixture", "--baseline", "none")
    assert dirty.returncode == 1, dirty.stdout + dirty.stderr
    assert "deadlock-cycle" in dirty.stdout
    bad = tmp_path / "baseline.json"
    bad.write_text(json.dumps({"findings": [
        {"pass": "locks", "rule": "deadlock-cycle", "path": "app.py",
         "symbol": "x"}]}))
    unjust = _sdlint("--root", os.path.join(FIXTURES, "deadlock"),
                     "--package", "fixture", "--baseline", str(bad))
    assert unjust.returncode == 2, unjust.stdout + unjust.stderr
    assert "missing justification" in unjust.stderr


def test_json_report_is_schema_versioned_and_sorted(port_findings):
    doc = json.loads(report_json(port_findings, Baseline.load(BASELINE)))
    assert doc["schema_version"] == 2
    assert doc["new"] == 0 and doc["stale_baseline"] == []
    keys = [(f["pass_name"], f["path"], f["rule"], f["symbol"], f["line"])
            for f in doc["findings"]]
    assert keys == sorted(keys)


def test_the_default_scan_skips_the_lint_itself(port_project):
    assert not any(m.relpath.startswith(os.path.join("tools", "sdlint"))
                   for m in port_project.modules.values())
    assert "parallel.sharedscan" in port_project.modules


# -- 2. the carried-over passes against the JAX package's sdlint ---------------

@pytest.mark.parametrize("pass_name", CARRIED)
@pytest.mark.parametrize("tree", FIXTURE_TREES)
def test_carried_pass_equals_jax_sdlint_on_its_fixture(tree, pass_name):
    """The same ``(pass, rule, path, symbol)`` findings as the JAX
    package's sdlint on the same fixture tree; non-empty on the tree that
    seeds the pass."""
    from spark_druid_olap_tpu.tools.sdlint.core import Project as JProject
    from spark_druid_olap_tpu.tools.sdlint.core import (
        run_passes as jrun_passes)
    root = os.path.join(FIXTURES, tree)
    want = {f.key() for f in jrun_passes(
        JProject(root, package="fixture"), (pass_name,))}
    got = {f.key() for f in run_passes(Project(root, package="fixture"),
                                       (pass_name,))}
    assert got == want, (sorted(got ^ want))
    assert bool(got) == ((tree, pass_name) in SEEDED), sorted(got)


# -- 3. the retargeted rules fire on their seeded violations -------------------

PURITY_TREE = {
    "ops/cuda_wave.py": '''
        import time

        import torch
        from torch.fx.experimental.proxy_tensor import make_fx


        def _lane_parts(ctx, tile):
            base = torch.ne(tile, 0)
            if base.any():
                time.sleep(0)
            n = base.sum().item()
            return base, n


        def _untraced(tile):
            base = torch.ne(tile, 0)
            if base.any():
                time.sleep(0)
            return base.sum().item()


        def compile_wave(tiles):
            def probe(*ts):
                outs = [_lane_parts(None, t)[0] for t in ts]
                if ts[0].sum() > 0:
                    outs.append(ts[0])
                return outs

            return make_fx(probe, tracing_mode="fake")(*tiles)
        ''',
}


def test_purity_fires_under_make_fx(tmp_path):
    """A ``.item()``, a host call and a branch on a tensor inside a
    ``make_fx``-traced function (and on the traced root's own argument)
    fire; the same code outside the trace does not."""
    found = run_passes(_write(tmp_path, PURITY_TREE), ("purity",))
    assert _got(found) == {
        ("traced-branch", "_lane_parts:if"),
        ("host-call", "_lane_parts:time.sleep"),
        ("concretize", "_lane_parts:.item"),
        ("traced-branch", "compile_wave.probe:if"),
    }, [f.render() for f in found]


KERNEL_TREE = {
    "csrc/dense_groupby.cu": '''
        // the kernel's caps
        constexpr int kMaxAggs = 16;
        constexpr int kThreads = 256;
        constexpr int kWarps = kThreads / 32;

        extern "C" {
        int sdot_dense_groupby_max_aggs() { return kMaxAggs; }
        int sdot_dense_groupby(const int* key, long long n) {
          const long long smem = sdot_dense_groupby_max_aggs();
          return smem > 0 ? 0 : 1;
        }
        }  // extern "C"
        ''',
    "ops/cuda_groupby.py": '''
        import ctypes

        MAX_AGGS = 8
        THREADS = 256
        SMEM_LIMIT = 240 * 1024


        def library():
            lib = ctypes.CDLL("libdense.so")
            lib.sdot_dense_groupby.restype = ctypes.c_int
            lib.sdot_dense_groupby_min_aggs.restype = ctypes.c_int
            return lib


        def dense_groupby_reference(key, n_keys, inputs):
            return {}


        def dense_groupby_kernel(key, n_keys, inputs):
            if key.device.type != "cuda":
                return dense_groupby_reference(key, n_keys, inputs)
            lib = library()
            lib.sdot_dense_groupby(key.data_ptr(), key.numel())
            return {}


        def groupby_with_fallback(key, n_keys, inputs):
            try:
                return dense_groupby_kernel(key, n_keys, inputs)
            except RuntimeError:
                return dense_groupby_reference(key, n_keys, inputs)


        def groupby_ungated(key, n_keys, inputs):
            return dense_groupby_reference(key, n_keys, inputs)
        ''',
    "ops/cuda_wave.py": '''
        THETA_KERNEL_MAX_ROWS = 512
        ''',
    "utils/config.py": '''
        CUDA_WAVE_SCRATCH_BYTES = _entry(
            "sdot.cuda.wave.scratch.bytes", 250 * 1024, "scratch budget")
        ''',
}


def test_kernels_fire_on_the_cuda_contract(tmp_path):
    """A ``MAX_AGGS`` that disagrees with ``kMaxAggs``, a shared-memory
    limit past Hopper's and a scratch default past it, a theta cap other
    than the reference's, a bound symbol no ``extern "C"`` block defines,
    an ``except`` that answers from the plain version and a plain call
    outside a CPU test all fire; ``THREADS`` (equal to ``kThreads``), the
    gated plain call and the defined symbols stay quiet."""
    found = run_passes(_write(tmp_path, KERNEL_TREE), ("kernels",))
    assert _got(found) == {
        ("mirror-mismatch", "MAX_AGGS"),
        ("smem-budget", "SMEM_LIMIT"),
        ("smem-budget", "sdot.cuda.wave.scratch.bytes"),
        ("theta-cap-mismatch", "THETA_KERNEL_MAX_ROWS"),
        ("unbound-symbol", "sdot_dense_groupby_min_aggs"),
        ("fallback-hides-card",
         "groupby_with_fallback:dense_groupby_reference"),
        ("plain-not-cpu-gated", "groupby_ungated:dense_groupby_reference"),
    }, [f.render() for f in found]


MESH_TREE = {
    "ops/agg_registry.py": '''
        AGG_CLOSURE = {
            "cardinality": {"route": None, "sketch": "hll", "merge": "max"},
            "thetasketch": {"route": None, "sketch": "theta",
                            "merge": "min"},
        }
        ''',
    "ops/hll.py": '''
        import torch


        def merge_registers(parts):
            return _fold(parts, torch.maximum)
        ''',
    "ops/theta.py": '''
        def merge_registers(parts):
            return sum(parts)
        ''',
    "ops/groupby.py": '''
        import torch


        def merge_partials(parts, routes):
            out = {}
            for name in parts[0]:
                r = routes.get(name)
                vals = [p[name] for p in parts]
                if r is not None and r.kind == "min":
                    out[name] = _fold(vals, torch.add)
                elif r is not None and r.kind == "max":
                    out[name] = _fold(vals, torch.maximum)
                else:
                    out[name] = _fold(vals, torch.add)
            return out
        ''',
    "parallel/multihost.py": '''
        import torch.distributed as dist


        def initialize(rank, world):
            dist.init_process_group("gloo", rank=rank, world_size=world)
            dist.all_gather_object([None] * world, rank)


        def is_multihost():
            return dist.is_initialized()


        def _all_gather_bytes(out, buf):
            dist.all_gather_into_tensor(out, buf)
            return out


        def exchange_block(local):
            return _all_gather_bytes(local, local)


        class Sequencer:
            def turn(self, key):
                return exchange_block(key)


        SEQUENCER = Sequencer()
        ''',
    "parallel/statement.py": '''
        from fixture.parallel import multihost as MH


        class QueryEngine:
            def execute(self, q):
                if not MH.is_multihost():
                    return self._local(q)
                with MH.SEQUENCER.turn(1):
                    return self._local(q)

            def _local(self, q):
                return MH.exchange_block(q)

            def page(self, q):
                return MH.exchange_block(q)

            def drain(self, q):
                for blk in zip(MH.exchange_block(q), q):
                    yield blk
        ''',
}


def test_mesh_fires_on_the_slot_and_rank_merges(tmp_path):
    """Theta registers merged through ``sum``, a ``kind == "min"`` branch
    folding with ``torch.add`` and collectives issued by entries that
    hold no SEQUENCER turn (one nested in a loop's iterable) fire; the HLL max merge, the max branch, the
    turn-covered and single-process calls and ``initialize`` stay quiet."""
    found = run_passes(_write(tmp_path, MESH_TREE), ("mesh",))
    assert _got(found) == {
        ("sketch-merge-mismatch", "theta.merge_registers"),
        ("merge-op-mismatch", "merge_partials:min"),
        ("collective-outside-turn", "QueryEngine.page:exchange_block"),
        ("collective-outside-turn", "QueryEngine.drain:exchange_block"),
    }, [f.render() for f in found]


def test_leaks_fire_on_an_unclosed_wave_pin_scope(tmp_path):
    found = run_passes(_write(tmp_path, {"parallel/executor.py": '''
        class Binder:
            def build(self, store, segs):
                scope = store.wave_pins(2)
                scope.__enter__()
                fill(segs)
                scope.__exit__(None, None, None)

            def build_ok(self, store, segs):
                with store.wave_pins(2):
                    fill(segs)

            def handle(self, store):
                return store.wave_pins(1)
        '''}), ("leaks",))
    assert _got(found) == {("unclosed-wave-pins", "Binder.build:wave-pins")}


def test_mergeclosure_demux_gap_follows_the_generic_dispatch(tmp_path):
    """A sketch family missing from ``ops/sketch.SKETCH_KINDS`` is the
    gap; the families in it need no literal in the shared scan."""
    found = run_passes(_write(tmp_path, {
        "ops/agg_registry.py": '''
            AGG_CLOSURE = {
                "cardinality": {"route": None, "sketch": "hll",
                                "merge": "max"},
                "quantile": {"route": None, "sketch": "kll",
                             "merge": "minsum"},
            }
            ''',
        "ops/sketch.py": '''
            SKETCH_KINDS = ("hll", "theta")
            ''',
        "parallel/sharedscan.py": '''
            from fixture.ops.sketch import SKETCH_KINDS


            def sketches(plans):
                return [p for p in plans if p.kind in SKETCH_KINDS]
            ''',
    }), ("mergeclosure",))
    assert _got(found) == {("demux-gap", "quantile")}


RETARGETED = {"purity": PURITY_TREE, "kernels": KERNEL_TREE,
              "mesh": MESH_TREE}


@pytest.mark.parametrize("own", sorted(RETARGETED))
def test_retargeted_fixture_is_quiet_to_the_other_passes(tmp_path, own):
    """Liveness: on each retargeted fixture the other passes find nothing
    (contracts aside: the trees declare no config registry), so disabling
    the pass makes its seeded violations invisible."""
    project = _write(tmp_path, RETARGETED[own])
    others = tuple(p for p in PASSES if p not in (own, "contracts"))
    found = run_passes(project, others)
    assert not found, [f.render() for f in found]


# -- 4. the two repaired faults -------------------------------------------------

def _fused_tree(keyed: bool):
    widths = "eng.config.get(HLL_LOG2M), eng.config.get(QUANTILE_LANES)," \
        if keyed else ""
    return {
        "utils/config.py": '''
            HLL_LOG2M = _entry("sdot.engine.hll.log2m", 11, "hll width")
            QUANTILE_LANES = _entry("sdot.quantile.lanes", 256, "kll lanes")
            TZ_ID = _entry("sdot.engine.tz", "UTC", "zone")
            ''',
        "parallel/sharedscan.py": f'''
            from fixture.utils.config import HLL_LOG2M, QUANTILE_LANES, TZ_ID


            class SharedScanCoalescer:
                def __init__(self, engine):
                    self.engine = engine

                def _run_fused(self, ds, lanes):
                    eng = self.engine
                    sig = ("aggmulti", ds.name, eng.config.get(TZ_ID),
                           {widths} len(lanes))

                    def _build():
                        return self._build_fused_program(ds, lanes)

                    return eng._cached_program(sig, _build)

                def _build_fused_program(self, ds, lanes):
                    eng = self.engine
                    log2m = eng.config.get(HLL_LOG2M)
                    kll_lanes = eng.config.get(QUANTILE_LANES)
                    return log2m, kll_lanes
            ''',
    }


@pytest.mark.parametrize("keyed", [False, True])
def test_keys_catch_a_fused_program_without_its_sketch_widths(tmp_path,
                                                              keyed):
    """The stale-storm fault's pattern: the fused program's build reads
    the HLL and KLL widths and its signature omits them — two findings;
    the repaired signature is clean."""
    found = run_passes(_write(tmp_path, _fused_tree(keyed)), ("keys",))
    want = set() if keyed else {
        ("compile-sig-missing-config",
         "SharedScanCoalescer._run_fused:HLL_LOG2M"),
        ("compile-sig-missing-config",
         "SharedScanCoalescer._run_fused:QUANTILE_LANES")}
    assert _got(found) == want, [f.render() for f in found]


def _engine_tree(locked: bool):
    body = '''
                with self._compile_lock:
                    self._programs.clear()
                with self._bind_lock:
                    self._device_arrays.clear()
                    self._device_bytes = 0''' if locked else '''
                self._programs.clear()
                self._device_arrays.clear()
                self._device_bytes = 0'''
    return {"parallel/executor.py": '''
        import threading


        class QueryEngine:
            def __init__(self):
                self._programs = {}
                self._device_arrays = {}
                self._device_bytes = 0
                self._compile_lock = threading.Lock()
                self._bind_lock = threading.Lock()

            def _cached_program(self, sig, build):
                with self._compile_lock:
                    self._programs[sig] = build()
                return self._programs[sig]

            def _bind(self, key, t):
                with self._bind_lock:
                    self._device_arrays[key] = t
                    self._device_bytes += 1

            def _mark_backend_lost(self):
                threading.Thread(target=self.clear_caches).start()

            def clear_caches(self):''' + body + "\n"}


@pytest.mark.parametrize("locked", [False, True])
def test_locks_catch_an_unlocked_cache_clear(tmp_path, locked):
    """The unlocked-clear fault's pattern: ``clear_caches``, reachable
    from a thread, clears dicts their fill paths write under a lock —
    one finding per dict; the repaired clear is clean."""
    found = run_passes(_write(tmp_path, _engine_tree(locked)), ("locks",))
    cls = "parallel.executor.QueryEngine"
    want = set() if locked else {
        ("unguarded-write", f"{cls}.{a}@QueryEngine.clear_caches")
        for a in ("_programs", "_device_arrays", "_device_bytes")}
    assert _got(found) == want, [f.render() for f in found]


def test_live_tree_stays_clean_of_the_repaired_rules(port_findings):
    """The rules that found the two faults, and the retargeted families,
    stay at zero on the port's tree (the one baselined finding aside), so
    a reintroduction fails by name."""
    baseline = Baseline.load(BASELINE)
    for rule in ("compile-sig-missing-config", "unguarded-write",
                 "deadlock-cycle", "demux-gap", "sketch-merge-mismatch",
                 "merge-op-mismatch", "mirror-mismatch", "smem-budget",
                 "unbound-symbol", "fallback-hides-card",
                 "plain-not-cpu-gated", "traced-branch", "concretize",
                 "collective-outside-turn"):
        hits = [f.render() for f in port_findings
                if f.rule == rule and not baseline.matches(f)]
        assert not hits, hits


def test_purity_reaches_the_lane_builders(port_project):
    """The wave kernel's lane probe is the one root, and the trace is
    followed into the scan context, the CSE cache, the filter and
    expression lowerings and the lane plans' value / mask builders."""
    from spark_druid_olap_tpu_torch.tools.sdlint.purity import _Purity
    p = _Purity(port_project)
    assert set(p.roots) == {("ops.cuda_wave", "compile_wave.probe")}
    reached = {fid[0] for fid in p.reachable}
    assert {"ops.cuda_wave", "ops.scan", "planner.fusion", "ops.filters",
            "ops.expr_compile"} <= reached, sorted(reached)
    assert ("parallel.executor", "AggPlan.build_values") in p.reachable


def _edge_present(edges, held_suffix, acq_suffix):
    return any(h.endswith(held_suffix) and a.endswith(acq_suffix)
               for (h, a) in edges)


def test_real_lock_graph_shape(port_project):
    """Pin the port's lock graph: the engine's cache locks, the process-
    wide lane-trace lock, the multihost sequencer, WLM and persist are
    modeled; the documented orders (WLM lane lock -> shared-scan group
    lock, persist manager lock -> history lock) stay; the two cache locks
    never nest (``clear_caches`` and ``reshard`` take them one after the
    other), the trace lock is a leaf, and the graph is acyclic."""
    la = LockAnalysis(port_project)
    for lock, kind in (
            ("parallel.executor.QueryEngine._compile_lock", "Lock"),
            ("parallel.executor.QueryEngine._bind_lock", "Lock"),
            ("ops.cuda_wave._trace_lock", "Lock"),
            ("parallel.multihost.Sequencer._cv", "Condition"),
            ("wlm.admit.WorkloadManager._lock", "Lock"),
            ("persist.manager.PersistManager.lock", "RLock"),
            ("parallel.sharedscan.SharedScanCoalescer._lock", "Lock")):
        assert la.lock_kinds.get(lock) == kind, (lock, sorted(la.lock_kinds))
    assert len(la.lock_kinds) >= 25, sorted(la.lock_kinds)
    edges = set(la.edges)
    assert _edge_present(edges, "WorkloadManager._lock",
                         "SharedScanCoalescer._lock"), sorted(edges)
    assert _edge_present(edges, "PersistManager.lock",
                         "QueryHistory._lock"), sorted(edges)
    assert not _edge_present(edges, "_compile_lock", "_bind_lock")
    assert not _edge_present(edges, "_bind_lock", "_compile_lock")
    assert not any(h.endswith("_trace_lock") for h, _ in edges)
    assert la.cycles == [], la.cycles
    ep_names = {fid[1].split(".")[-1] for fid in la.entrypoints}
    for name in ("_bg_loop", "do_GET", "do_POST", "do_get", "work"):
        assert name in ep_names, sorted(ep_names)
    assert len(la.entrypoints) >= 8, sorted(la.entrypoints)
