"""The declared merge-closure of every aggregate the engine registers.

Port of ``spark_druid_olap_tpu/ops/agg_registry.py``, copied whole: the
cluster broker's merge (``cluster/merge.py``) derives its mergeable kinds
and sketch register algebra from :data:`AGG_CLOSURE`. The sites it names
below are the JAX package's; the port's counterparts sit at the same
paths under ``spark_druid_olap_tpu_torch/``.

Adding an aggregation kind touches four places that must stay mutually
consistent or waves / multi-host shards / rollups / shared-scan quietly
break: the executor's kind table (``parallel/executor.py:_AGG_KIND``),
the cross-chip merge (``ops/groupby.py:merge_partials``), the rollup
re-aggregation table (``mv/match.py``), and the shared-scan demux
(``parallel/sharedscan.py``). This module is the single declaration the
``mergeclosure`` sdlint pass cross-checks against all four — register
the new kind HERE first and the linter will point at every site that
still needs teaching.

Fields per druid-level kind:

- ``route``  — the internal lowered kind (``ops/groupby.py`` Route
  vocabulary: count/sum/min/max) or the sketch name for sketches.
- ``dtype``  — accumulator dtype name as ``numpy`` spells it.
- ``reagg``  — the kind literal ``mv/match.py`` re-aggregates stored
  partials with (losslessly merge-closed), or None when rollup must
  reject it (sketch registers are not closed over stored partials).
- ``sketch`` — "hll"/"theta" for register-valued aggregates that need
  their own shared-scan demux + wave-merge handling, else None.
- ``merge``  — for sketches, the register algebra cross-chip merges
  must use: "max" (HLL rho registers), "min" (theta k-min hashes), or
  "minsum" (KLL lane lex-minima + exact level-count sums). Summing
  min-valued registers double-counts silently; the ``mesh`` sdlint pass
  checks ``ops/<sketch>.py:merge_registers`` against this field, and
  the ``mergeclosure`` pass cross-checks it against the runtime merge
  table (``ops/groupby.py:SKETCH_MERGE_OPS``).

Kept import-free and ``ast.literal_eval``-parseable on purpose: sdlint
reads this file without importing it (and so without jax installed).
"""

AGG_CLOSURE = {
    "count":       {"route": "count", "dtype": "int64",
                    "reagg": "count", "sketch": None},
    "longsum":     {"route": "sum", "dtype": "int64",
                    "reagg": "longsum", "sketch": None},
    "doublesum":   {"route": "sum", "dtype": "float64",
                    "reagg": "doublesum", "sketch": None},
    "longmin":     {"route": "min", "dtype": "int64",
                    "reagg": "longmin", "sketch": None},
    "longmax":     {"route": "max", "dtype": "int64",
                    "reagg": "longmax", "sketch": None},
    "doublemin":   {"route": "min", "dtype": "float64",
                    "reagg": "doublemin", "sketch": None},
    "doublemax":   {"route": "max", "dtype": "float64",
                    "reagg": "doublemax", "sketch": None},
    "cardinality": {"route": "hll", "dtype": "int64",
                    "reagg": None, "sketch": "hll", "merge": "max"},
    "thetasketch": {"route": "theta", "dtype": "int64",
                    "reagg": None, "sketch": "theta", "merge": "min"},
    "quantile":    {"route": "kll", "dtype": "float64",
                    "reagg": None, "sketch": "kll", "merge": "minsum"},
    "anyvalue":    {"route": "max", "dtype": "float64",
                    "reagg": "anyvalue", "sketch": None},
}
