"""Run ``chip_smoke.py``'s phase ``mesh`` alone.

    python3 scripts/torch_mesh_probe.py

Builds the two kernels, generates TPC-H at ``chip_smoke.SF`` and
ingests lineitem and supplier as ``chip_smoke.py`` does, then runs phase
``mesh``
(every card, else two slots on the one card) exactly as
``chip_smoke.py`` runs it. Prints the card's name and power
limit and the phase's JSON line (also appended to
``chiprun_out/chip_smoke.jsonl``); exits non-zero on any failed check.
Needs an NVIDIA GPU and imports nothing of JAX.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mesh_probe: no CUDA device", file=sys.stderr)
        return 1
    import spark_druid_olap_tpu_torch as sdt
    from spark_druid_olap_tpu_torch.ir import expr as E
    from spark_druid_olap_tpu_torch.ir import spec as S
    from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG
    from spark_druid_olap_tpu_torch.ops import cuda_wave as CW
    from spark_druid_olap_tpu_torch.tools import tpch
    t0 = time.perf_counter()
    smi = CS.nvidia_smi()
    CS.say(smi)
    for m in (CG, CW):
        m.library()
    tables = tpch.generate(CS.SF, seed=CS.SEED)
    df = tables["lineitem"]
    ctx = sdt.Context(CS.ENGINE_TIMED)
    ctx.ingest_dataframe("lineitem", df, time_column="l_shipdate")
    ctx.ingest_dataframe("supplier", tables["supplier"],
                         target_rows=1 << 20)
    CS.say(json.dumps({"setup_s": time.perf_counter() - t0}))
    mesh = CS.mesh_phase(sdt, S, E, ctx.store.get("lineitem"), ctx, df, CG,
                         CW, smi, ctx.store.get("supplier"))
    CS.emit("mesh", **mesh)
    CS.say(json.dumps({"total_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
