"""Device-side window-function post-pass.

Port of ``spark_druid_olap_tpu/window/__init__.py``: ``plan.extract`` strips
``OVER (...)`` calls out of a SELECT statement so the base query runs
through the normal engine path untouched; ``exec.apply`` then computes the
window columns over the result frame as segment-sorted torch functions on
the context's device (partition-boundary masks plus segmented scans, no
host loop over rows).
"""

from spark_druid_olap_tpu_torch.window.plan import extract  # noqa: F401
from spark_druid_olap_tpu_torch.window.exec import apply  # noqa: F401
