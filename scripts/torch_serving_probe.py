"""Run ``chip_smoke.py``'s phases ``cluster`` and ``server`` alone.

    python3 scripts/torch_serving_probe.py [--flat-sf SF] [--no-server]

Builds the two kernels, generates TPC-H SF1, ingests lineitem and
checkpoints it raw into a temporary persist root (as phase ``persist``'s
step (a) does), ingests orders and customer as phase ``sql`` does, then
runs phase ``cluster`` (3 historicals and a broker on the card over that
root, its partitioned join leg over orders and customer included)
exactly as ``chip_smoke.py`` runs it; then, unless ``--no-server``,
flattens the TPC-H star at ``--flat-sf`` (1.0 as in ``chip_smoke.py``;
smaller is quicker) and runs phase ``server`` over it. Prints the card's
name and power limit, then each phase's JSON line (also appended to
``chiprun_out/chip_smoke.jsonl``); exits non-zero on any failed check.
Needs one NVIDIA GPU and imports nothing of JAX.
"""

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--flat-sf", type=float, default=CS.SF)
    ap.add_argument("--no-server", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_probe: no CUDA device", file=sys.stderr)
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
    ds = ctx.store.get("lineitem")
    # phase sql's base tables of the join leg, ingested as it ingests them
    ctx.ingest_dataframe("orders", tables["orders"],
                         time_column="o_orderdate", target_rows=1 << 20)
    ctx.ingest_dataframe("customer", tables["customer"], target_rows=1 << 20)
    join_ds = {n: ctx.store.get(n) for n in ("orders", "customer")}
    with tempfile.TemporaryDirectory(prefix="sdot_serving_probe_") as tmp:
        root = str(pathlib.Path(tmp) / "raw")
        c = sdt.Context({**CS.ENGINE_TIMED, "sdot.persist.path": root})
        c.store.register(ds)
        c.checkpoint("lineitem")
        c.close()
        CS.say(json.dumps({"setup_s": time.perf_counter() - t0}))
        cluster = CS.cluster_phase(sdt, root, S, E, df, tables, join_ds,
                                   CG, CW, smi)
        CS.emit("cluster", **cluster)
    if args.no_server:
        CS.say(json.dumps({"total_s": time.perf_counter() - t0}))
        return 0
    flat_tables = tables if args.flat_sf == CS.SF \
        else tpch.generate(args.flat_sf, seed=CS.SEED)
    fctx = sdt.Context(CS.ENGINE_TIMED)
    fctx.ingest_dataframe("tpch_flat", tpch.flatten(flat_tables),
                          time_column="l_shipdate", target_rows=1 << 20)
    fli = ds
    fdf = df
    if args.flat_sf != CS.SF:
        fdf = flat_tables["lineitem"]
        fctx.ingest_dataframe("lineitem", fdf, time_column="l_shipdate")
        fli = fctx.store.get("lineitem")
    server = CS.server_phase(sdt, fctx.store.get("tpch_flat"), fli, S, E,
                             fdf, CG, CW, smi)
    CS.emit("server", **server)
    CS.say(json.dumps({"total_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
