"""Compressed columns and dictionary predicates (port of
``spark_druid_olap_tpu/encode``).

- :mod:`codecs` — bit-exact encode/decode (raw, bitpack, rle, fordelta)
- :mod:`chooser` — per-column codec choice at checkpoint time
- :mod:`predicates` — dictionary-predicate rewrite (string filters ->
  code-domain tests; consumed by ops/filters.py)
- :mod:`exec` — encoded-domain aggregation and pruning (RLE run
  aggregation, header zone maps, FoR-domain interval pruning)

The snapshot writer (persist/snapshot.py) is the codecs' caller; the
tiered store (tier/) decodes chunks on fault and reads zone maps from
their headers through :mod:`exec`.
"""

from spark_druid_olap_tpu_torch.encode import (  # noqa: F401
    chooser, codecs, exec, predicates)
