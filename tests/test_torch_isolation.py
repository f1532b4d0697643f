"""The port stands alone: it imports neither JAX nor the JAX package, its
entry point refuses to run without the card unless asked for the CPU, and
its copied TPC-H generator gives the JAX generator's frames.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import ast
import pathlib
import subprocess
import sys

import pandas as pd
import pytest
import torch

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu.tools.tpch import generate as jax_generate
from spark_druid_olap_tpu_torch.tools.tpch import generate as port_generate

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "spark_druid_olap_tpu_torch"
TABLES = ["region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem"]


@pytest.fixture(scope="module")
def both_tpch():
    return jax_generate(0.01), port_generate(0.01)


@pytest.mark.parametrize("table", TABLES)
def test_tpch_generator_matches_jax(table, both_tpch):
    jax_tables, port_tables = both_tpch
    pd.testing.assert_frame_equal(port_tables[table], jax_tables[table])


def _forbidden_imports(path: pathlib.Path):
    """Top-level names imported by one source file that belong to JAX or
    to the JAX package (exact module names: the port's own name starts
    with the JAX package's)."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            root = n.split(".")[0]
            if root in ("jax", "jaxlib", "spark_druid_olap_tpu"):
                bad.append(f"{path.relative_to(REPO)}: {n}")
    return bad


def test_no_jax_imports_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [b for f in files for b in _forbidden_imports(f)]
    assert not bad, bad


# the shared-scan slice's modules, by exact name: each must be found by the
# package walk below and import nothing of JAX or of the JAX package
SHAREDSCAN_MODULES = ["planner.fusion", "ops.cuda_build", "ops.cuda_wave",
                      "parallel.sharedscan"]


# the SQL front end's modules, by exact name (the ``sql``, ``planner``,
# ``metadata`` prefixes are shared with the JAX package's own modules)
SQL_MODULES = ["sql.lexer", "sql.ast", "sql.parser", "sql.session",
               "planner.builder", "planner.scoping", "planner.plans",
               "planner.host_exec", "planner.decorrelate",
               "planner.viewmerge", "planner.composite", "planner.joinplan",
               "metadata.star", "metadata.fd", "metadata.catalog",
               "metadata.history", "ir.intervals", "ir.transforms",
               "utils.phases"]


# the wide-key aggregation path's modules, by exact name
HASHED_MODULES = ["ops.hash_groupby", "ops.sorted_groupby", "parallel.cost"]


# the native encoder, the join and the window tiers, by exact name (``join``
# and ``window`` are package names in the JAX package too)
JOIN_WINDOW_MODULES = ["segment.native", "ops.hash_join", "join.broadcast",
                       "join.partitioned",
                       "window.plan", "window.exec"]


# the result cache, WLM and the in-flight registry, by exact name (``cache``
# and ``wlm`` are package names in the JAX package too)
SERVING_MODULES = ["cache", "cache.keys", "cache.result_cache",
                   "cache.subsume", "wlm", "wlm.lanes", "wlm.quota",
                   "wlm.admit"]


# the extension modules, the raw-query wire, rollups and the rest of ingest,
# by exact name (``mv`` is a package name in the JAX package too)
INGEST_ROLLUP_MODULES = ["ir.serde", "utils.modules", "mv", "mv.registry",
                         "mv.match", "segment.append",
                         "segment.stream_ingest", "tools.ssb"]


# persistence, its codecs and fault injection, by exact name (``persist``,
# ``encode`` and ``fault`` are package names in the JAX package too)
PERSIST_MODULES = ["persist", "persist.wal", "persist.snapshot",
                   "persist.compact", "persist.manager", "encode",
                   "encode.codecs", "encode.chooser", "fault", "fault.plan"]


# the cold tier, the encoded-domain helpers, the retry and the
# calibration, by exact name (``tier`` is a package name in the JAX package
# too)
TIER_MODULES = ["tier", "tier.store", "tier.handles", "tier.loader",
                "encode.exec", "utils.retry", "tools.calibrate"]


# the serving layer and the cluster tier, by exact name (``server`` and
# ``cluster`` are package names in the JAX package too)
SERVER_CLUSTER_MODULES = ["server", "server.http", "server.flight",
                          "server.__main__", "cluster", "cluster.wire",
                          "cluster.merge", "cluster.assign", "cluster.epoch",
                          "cluster.breaker", "cluster.subqcache",
                          "cluster.autoscale", "cluster.historical",
                          "cluster.broker", "cluster.__main__",
                          "ops.agg_registry", "parallel.multihost"]
# the single-process mesh
MESH_MODULES = ["parallel.mesh", "parallel.meshexec"]
# the multi-process mesh (``parallel.multihost`` is listed above): its rank
# rig, which must not import the JAX package by the name both share
MULTIHOST_MODULES = ["tools.multihost_worker"]


@pytest.mark.parametrize("module",
                         SHAREDSCAN_MODULES + SQL_MODULES + HASHED_MODULES
                         + JOIN_WINDOW_MODULES + SERVING_MODULES
                         + INGEST_ROLLUP_MODULES + PERSIST_MODULES
                         + TIER_MODULES + SERVER_CLUSTER_MODULES
                         + MESH_MODULES + MULTIHOST_MODULES)
def test_sharedscan_slice_modules_are_checked(module):
    import pkgutil
    prefix = "spark_druid_olap_tpu_torch."
    name = prefix + module
    walked = {m.name for m in pkgutil.walk_packages(tsdot.__path__, prefix)}
    assert name in walked
    path = PORT.joinpath(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert not _forbidden_imports(path)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import spark_druid_olap_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'spark_druid_olap_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_context_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsdot.Context()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsdot.Context(device="cuda")
    ctx = tsdot.Context(device="cpu")
    assert ctx.engine.device.type == "cpu"


def test_tpch_flatten_stream_matches_jax(both_tpch, tmp_path):
    """The port's out-of-core flatten (over its streaming ingest) writes
    the JAX package's flat Parquet row for row, from the same lineitem
    Parquet file streamed in several batches."""
    from spark_druid_olap_tpu.tools.tpch import flatten_stream as jflatten
    from spark_druid_olap_tpu_torch.tools.tpch import flatten_stream
    jax_tables, port_tables = both_tpch
    src = tmp_path / "lineitem.parquet"
    port_tables["lineitem"].to_parquet(src, index=False)
    drop = ["l_comment"]
    n_jax = jflatten(jax_tables, str(src), str(tmp_path / "jax.parquet"),
                     batch_rows=20000, drop_columns=drop)
    n_port = flatten_stream(port_tables, str(src),
                            str(tmp_path / "port.parquet"),
                            batch_rows=20000, drop_columns=drop)
    want = pd.read_parquet(tmp_path / "jax.parquet")
    got = pd.read_parquet(tmp_path / "port.parquet")
    assert n_port == n_jax == len(got) == len(port_tables["lineitem"])
    assert "l_comment" not in got.columns
    pd.testing.assert_frame_equal(got, want)
