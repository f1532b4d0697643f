"""spark_druid_olap_tpu_torch — the PyTorch / CUDA port of
``spark_druid_olap_tpu`` for NVIDIA Hopper GPUs.

The package mirrors the JAX package's module layout (each module's
docstring names its counterpart) and imports nothing of it. This slice
covers the main aggregate path::

    import spark_druid_olap_tpu_torch as sdt
    ctx = sdt.Context()                  # device="cuda"; raises without one
    ctx.ingest_dataframe("lineitem", df, time_column="l_shipdate")
    ctx.execute(<ir.spec QuerySpec>).to_pandas()

``Context.execute`` -> ``parallel/executor.py`` -> ``ops/filters.py`` +
``ops/expr_compile.py`` -> ``ops/groupby.py`` -> the fused dense group-by
kernel ``csrc/dense_groupby.cu`` (via ``ops/cuda_groupby.py``).
"""

from spark_druid_olap_tpu_torch.context import Context
from spark_druid_olap_tpu_torch.utils.config import Config

__all__ = ["Context", "Config"]
