"""The port stands alone: it imports neither JAX nor the JAX package, its
entry point refuses to run without the card unless asked for the CPU, and
its copied TPC-H generator gives the JAX generator's frames.
"""

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


@pytest.mark.parametrize("module", SHAREDSCAN_MODULES + SQL_MODULES)
def test_sharedscan_slice_modules_are_checked(module):
    import pkgutil
    prefix = "spark_druid_olap_tpu_torch."
    name = prefix + module
    walked = {m.name for m in pkgutil.walk_packages(tsdot.__path__, prefix)}
    assert name in walked
    path = PORT.joinpath(*module.split(".")).with_suffix(".py")
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
