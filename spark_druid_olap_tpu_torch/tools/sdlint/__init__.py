"""sdlint for the port: domain-aware static analysis of the
``spark_druid_olap_tpu_torch`` package's own invariants.

Port of the JAX package's ``tools/sdlint/`` (``docs/LINT.md`` of this
package lists what changed). Nine AST-based passes (no imports, no
execution, so fixtures with seeded violations never need their
dependencies installed):

- ``locks`` — interprocedural lock-acquisition graph over
  ``threading.Lock/RLock/Condition`` attributes: potential deadlock
  cycles, plus attributes mutated from thread entrypoints without the
  guarding lock that protects them elsewhere.
- ``purity`` — functions reachable from a ``make_fx`` trace (the wave
  kernel's lane probe) must not call host-only APIs, branch on tensor
  values or concretize a tensor: under fake tracing each raises, and the
  storm quietly leaves the wave kernel.
- ``contracts`` — every ``sdot.*`` config key read anywhere must be
  declared with a default in ``utils/config.py`` and vice versa; every
  emitted ``stats[...]`` key must be documented in the port's
  ``docs/STATS.md``.
- ``mergeclosure`` — every aggregate registered in the engine must be
  declared in ``ops/agg_registry.py`` and handled by ``ops/groupby.py``,
  the rollup derivation table (``mv/match.py``) and the shared scan's
  generic sketch dispatch (``ops/sketch.SKETCH_KINDS``).
- ``keys`` — canonical cache keys (cache/keys.py, compile signatures,
  ``Config.fingerprint``) must cover exactly the result-affecting
  state.
- ``leaks`` — acquired resources (lane slots, quota tokens, tickets,
  inflight entries, tier and wave pins, WAL handles, snapshot temp
  dirs) must be released on ALL paths of the exception-edge CFG.
- ``ordering`` — happens-before on persist paths: fsync before
  ``os.replace`` publish, directory fsync after it, WAL commit append
  before ``store.register``, ``truncate_through`` only after a
  completed checkpoint.
- ``kernels`` — the CUDA kernel contract (docs/KERNELS.md), checked
  statically: Python mirrors equal the sources' ``constexpr``, the
  shared-memory budgets fit Hopper, every bound ``sdot_*`` symbol is
  defined, and no plain version answers for a CUDA tensor.
- ``mesh`` — the slot and rank merges: sketch registers fold with their
  declared register algebra, min/max branches with the matching
  extremum, and every cross-process collective runs inside a
  ``multihost.SEQUENCER`` turn.

Run as ``python -m spark_druid_olap_tpu_torch.tools.sdlint``; CI runs
the same passes via ``tests/test_torch_lint.py``. Known-and-justified
findings live in ``tools/sdlint/baseline.json``; line-level escapes use
``# sdlint: disable=<pass>``.
"""

from spark_druid_olap_tpu_torch.tools.sdlint.core import (  # noqa: F401
    Baseline,
    Finding,
    Project,
    run_passes,
)

PASSES = ("locks", "purity", "contracts", "mergeclosure", "keys",
          "leaks", "ordering", "kernels", "mesh")
