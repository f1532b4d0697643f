from spark_druid_olap_tpu_torch.ir import expr as E  # noqa: F401
from spark_druid_olap_tpu_torch.ir.spec import *  # noqa: F401,F403
