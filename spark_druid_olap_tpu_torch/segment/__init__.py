from spark_druid_olap_tpu_torch.segment.column import (  # noqa: F401
    ColumnKind,
    DimColumn,
    MetricColumn,
    TimeColumn,
)
from spark_druid_olap_tpu_torch.segment.store import (  # noqa: F401
    Datasource,
    Segment,
    SegmentStore,
    datasource_from_arrays,
)
from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe  # noqa: F401
