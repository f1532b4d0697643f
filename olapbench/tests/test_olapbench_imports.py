"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference, traffic and client modules import nothing of the port. Module
names are compared by their whole top-level name: the port's name begins
with the JAX package's."""

import ast
import json
import subprocess
import sys

from conftest import ROOT

PKG = ROOT / "olapbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "spark_druid_olap_tpu"}
PORT = "spark_druid_olap_tpu_torch"
# the modules that may not import the port: the reference, the traffic and
# the clients, and what they import
HOST_ONLY = ["olapbench.client", "olapbench.traffic", "olapbench.plain",
             "olapbench.compare", "olapbench.control", "olapbench.roofline",
             "olapbench.catalog", "olapbench.data.ssb", "olapbench.data.tpch"]


def _top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    for path in PKG.rglob("*.py"):
        assert not set(_top_imports(path)) & FORBIDDEN, path


def test_templates_and_readers_import_no_port():
    for sub in ("templates", "data", "metrics"):
        for path in (PKG / sub).rglob("*.py"):
            assert PORT not in set(_top_imports(path)), path


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_host_modules_load_no_port():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import importlib\n"
            f"for m in {HOST_ONLY!r}: importlib.import_module(m)\n"
            "from olapbench import catalog\n"
            "for c in ('ssb_sf1', 'tpch_sf1'):\n"
            "    catalog.templates(catalog.config("
            "{'file': f'olapbench/configs/{c}.json'}))")
    loaded = _loaded_after(code)
    assert PORT not in loaded and not loaded & FORBIDDEN


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from olapbench import catalog, run\n"
            "line = run.run_cell(catalog.benchmark(), 'ssb_sf1.dashboard', 5, 1.0,"
            " False, device='cpu', scale=0.005)\n"
            "assert line['correct'], line\n"
            "assert not run.forbidden_modules()")
    loaded = _loaded_after(code)
    assert PORT in loaded and not loaded & FORBIDDEN
