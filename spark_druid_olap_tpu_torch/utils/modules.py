"""Pluggable extension modules.

Port counterpart of ``spark_druid_olap_tpu/utils/modules.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.
``load_module`` accepts instances of this package's :class:`Module` only.

≈ the reference's module system (``SparklineDataModule.scala:70-151``):
``BaseModule`` exposes ``registerFunctions`` / logical rules / physical
rules / parser extensions, and ``ModuleLoader`` reflectively instantiates
classes named in conf ``spark.sparklinedata.modules``. Here a ``Module``
can contribute:

- **SQL scalar functions** (host tier always; single-string-arg functions
  additionally vectorize on device through the dictionary string-function
  path, so grouping/filtering on them still pushes down),
- **query-spec rewrite rules** (run by the spec transform executor after
  the builder, alongside the built-in topN/timeseries rules),
- **statement handlers** (front-parsed commands tried before the SQL
  parser, like the reference's ``SPLParser`` command grammar).

Modules are named in conf ``sdot.modules`` as comma-separated
``package.module:ClassName`` entries and installed at ``Context`` creation;
``Context.install_module`` installs one programmatically.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Optional, Tuple


class Module:
    """Base extension module. Override any subset of the three providers."""

    def functions(self) -> Dict[str, Callable]:
        """name -> scalar python callable (applied elementwise on host; on
        device via the dictionary path when the single argument is a string
        dimension)."""
        return {}

    def spec_rules(self) -> List[Callable]:
        """Extra ``(QuerySpec, Config) -> Optional[QuerySpec]`` rewrite
        rules (≈ DruidLogicalOptimizer extra batches)."""
        return []

    def statement_handlers(self) -> List[Callable]:
        """Extra ``(ctx, sql) -> Optional[QueryResult]`` front handlers
        tried before SQL parsing (≈ SPLParser commands)."""
        return []

    def install(self, ctx) -> None:
        for name, fn in self.functions().items():
            ctx.functions[name.lower()] = fn
        ctx.spec_rules.extend(self.spec_rules())
        ctx.statement_handlers.extend(self.statement_handlers())


def load_module(spec: str) -> Module:
    """Instantiate ``package.module:ClassName`` (≈ ModuleLoader's reflective
    ``Class.forName``, SparklineDataModule.scala:120-150)."""
    modname, _, clsname = spec.partition(":")
    if not clsname:
        raise ValueError(
            f"module spec {spec!r} must be 'package.module:ClassName'")
    cls = getattr(importlib.import_module(modname), clsname)
    mod = cls()
    if not isinstance(mod, Module):
        raise TypeError(f"{spec} is not a Module")
    return mod


def install_from_config(ctx, csv: str) -> List[Module]:
    out = []
    for spec in [s.strip() for s in csv.split(",") if s.strip()]:
        mod = load_module(spec)
        mod.install(ctx)
        out.append(mod)
    return out
