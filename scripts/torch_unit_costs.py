"""Measure the port's ``cuda`` unit costs: the group-by tiers and the
late-materialization gate.

    python3 scripts/torch_unit_costs.py

Runs ``spark_druid_olap_tpu_torch.parallel.cost.measure_unit_costs`` on
the first card (SF1 lineitem's 6,001,465 rows of uniform random keys):
the sorted-run tier's time per row for one more float64 sum, the scatter
tier's time per update at each rows-per-slot ratio of
``cost.PROBE_SCATTER_SLOTS`` and into a table far past the L2
(``scatter.big``), the compaction's time per scanned row (``sort``), one
compacted gather's time per probe (``gather``) and the dense group-by
kernel's time per row (``fused``). Prints one JSON line with the card's
name and power limit beside the values ``parallel/cost.py`` holds and the
ones measured now. Needs one NVIDIA GPU (it builds the dense group-by
kernel) and imports nothing of JAX.
"""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from spark_druid_olap_tpu_torch.parallel import cost  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_unit_costs: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    measured = cost.measure_unit_costs(torch.device("cuda"))
    print(json.dumps({"nvidia_smi": smi, "held": cost._CUDA_MEASURED,
                      "measured": measured}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
