"""Compressed columns and dictionary predicates (port of
``spark_druid_olap_tpu/encode``).

- :mod:`codecs` — bit-exact encode/decode (raw, bitpack, rle, fordelta)
- :mod:`chooser` — per-column codec choice at checkpoint time
- :mod:`predicates` — dictionary-predicate rewrite (string filters ->
  code-domain tests; consumed by ops/filters.py)

The snapshot writer (persist/snapshot.py) is the codecs' caller. The JAX
package's ``exec`` (encoded-domain aggregation over the tiered store)
comes with the tiered store (ROADMAP A.9).
"""

from spark_druid_olap_tpu_torch.encode import chooser, codecs, predicates  # noqa: F401
