"""Run ``chip_smoke.py``'s phases ``append`` and ``persist`` alone.

    python3 scripts/torch_persist_probe.py

Builds the two kernels, generates TPC-H SF1 lineitem, ingests it, then
runs phase ``append`` (4 in-memory batches of 250,000 rows, whose ms
phase ``persist`` reports beside its journaled ones) and phase
``persist`` (checkpoints raw and encoded, recovery, the same roots
recovered as tiered datasources under a hot-set budget (the tier leg),
journaled appends and their replay in a fresh context, a kill -9 of a
child, a real device loss in a child and a restart over its root (the
device-loss leg), compaction, the SQL surface), exactly as
``chip_smoke.py`` runs them, in a few minutes instead of the whole run.
Prints the card's name and power limit, then each phase's JSON line (also
appended to ``chiprun_out/chip_smoke.jsonl``); exits non-zero on any
failed check. Needs one NVIDIA GPU and imports nothing of JAX.
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
        print("torch_persist_probe: no CUDA device", file=sys.stderr)
        return 1
    import spark_druid_olap_tpu_torch as sdt
    from spark_druid_olap_tpu_torch.ir import expr as E
    from spark_druid_olap_tpu_torch.ir import spec as S
    from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG
    from spark_druid_olap_tpu_torch.ops import cuda_wave as CW
    from spark_druid_olap_tpu_torch.tools.tpch import generate
    t0 = time.perf_counter()
    loss_guard = CS.LossGuard()
    smi = CS.nvidia_smi()
    CS.say(smi)
    for m in (CG, CW):
        m.library()
    df = generate(CS.SF, seed=CS.SEED)["lineitem"]
    ctx = sdt.Context(CS.ENGINE_TIMED)
    ctx.ingest_dataframe("lineitem", df, time_column="l_shipdate")
    ds = ctx.store.get("lineitem")
    CS.say(json.dumps({"setup_s": time.perf_counter() - t0}))
    append = CS.append_phase(sdt, S, E, ds, df, CG, CW, smi)
    CS.emit("append", **append)
    persist = CS.persist_phase(sdt, S, E, ds, df, append, CG, CW, smi)
    CS.emit("persist", **persist)
    loss_guard.check("torch_persist_probe")
    CS.say(json.dumps({"total_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
