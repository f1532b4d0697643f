"""Run ``chip_smoke.py``'s phase ``multihost`` alone, and the census.

    python3 scripts/torch_multihost_probe.py [--census]

Builds the two kernels, generates TPC-H at ``chip_smoke.SF`` and ingests
lineitem as ``chip_smoke.py`` does, then runs phase ``multihost``: on one
card two ranks over gloo, exactly as ``chip_smoke.py`` runs it; on four
cards two ranks of two cards each over NCCL. ``--census`` also runs the
JAX package's multi-host census (``multihost_worker`` mode ``census``:
TPC-H 22 + SSB 13 and the multi-host shapes over SF 0.02 partial flat
stores) on the same ranks, and holds every answer against a one-device
context over the complete stores (floats rtol 1e-6, else exact), with
each statement's host wall ms on both. Prints the card's name and power
limit and one JSON line per phase (also appended to
``chiprun_out/chip_smoke.jsonl``); exits non-zero on any failed check.
Needs an NVIDIA GPU and imports nothing of JAX.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402

CENSUS_RTOL = 1e-6


def layout():
    """(device argument, backend) of the ranks: two ranks on one card
    over gloo, else two ranks of half the cards each over NCCL."""
    n = torch.cuda.device_count()
    if n < 2:
        return "cuda:0", "gloo"
    half = n // 2
    return ";".join(",".join(f"cuda:{r * half + i}" for i in range(half))
                    for r in range(2)), "nccl"


def rows_equal(name, g, r):
    if g["columns"] != r["columns"] or len(g["rows"]) != len(r["rows"]):
        raise AssertionError(f"census {name}: shape {g['columns']} "
                             f"{len(g['rows'])} vs {r['columns']} "
                             f"{len(r['rows'])}")
    for grow, rrow in zip(g["rows"], r["rows"]):
        for gv, rv in zip(grow, rrow):
            if isinstance(gv, float) or isinstance(rv, float):
                if gv is None or rv is None or abs(gv - rv) > \
                        CENSUS_RTOL * max(abs(rv), 1e-9):
                    raise AssertionError(f"census {name}: {grow} vs {rrow}")
            elif gv != rv:
                raise AssertionError(f"census {name}: {grow} vs {rrow}")


def census(device, backend, smi) -> dict:
    """The census on the ranks against one device over complete stores."""
    from spark_druid_olap_tpu_torch.tools import multihost_worker as W
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = W.spawn(2, f"{tmp}/census", "census", device=device,
                      backend=backend, timeout_s=1500)
    ranks_s = time.perf_counter() - t0
    ctx, cssb = W.census_contexts(1, 0, "cuda:0", None)
    ref = W.run_census(ctx, cssb)
    out = {"card": smi, "device": device, "backend": backend,
           "ranks_wall_s": ranks_s, "statements": {}}
    for name, r in ref.items():
        g = res[0][name]
        if res[1][name]["digest"] != g["digest"]:
            raise AssertionError(f"census {name}: the ranks differ")
        rows_equal(name, g, r)
        out["statements"][name] = {
            "mode": g.get("mode"), "sharded": g.get("sharded"),
            "waves": g.get("waves"), "ms": g.get("ms"),
            "single_ms": r.get("ms"),
            "collective_bytes": (g.get("multihost") or {}).get(
                "collective_bytes")}
    modes = [v["mode"] for k, v in out["statements"].items()
             if k.startswith(("tpch_q", "ssb_q"))]
    if len(modes) != 35 or any(m != "engine" for m in modes):
        raise AssertionError(f"census: modes {modes}")
    if not out["statements"]["host_gather"]["mode"].startswith("host"):
        raise AssertionError("census: host_gather did not gather")
    if min(out["statements"][f"waved_{n}"]["waves"]
           for n in ("dense", "hashed")) < 2:
        raise AssertionError("census: forced waves ran in one wave")
    out["sharded"] = sum(bool(v["sharded"])
                         for v in out["statements"].values())
    out["rows_held"] = [r["_store"]["local_rows"] for r in res]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_multihost_probe: no CUDA device", file=sys.stderr)
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
    device, backend = layout()
    df = tpch.generate(CS.SF, seed=CS.SEED)["lineitem"]
    ctx = sdt.Context(CS.ENGINE_TIMED)
    ctx.ingest_dataframe("lineitem", df, time_column="l_shipdate")
    CS.say(json.dumps({"setup_s": time.perf_counter() - t0}))
    CS.emit("multihost", **CS.multihost_phase(
        sdt, S, E, ctx, df, smi, device=device, backend=backend))
    del ctx, df
    if "--census" in sys.argv:
        CS.emit("census", **census(device, backend, smi))
    CS.say(json.dumps({"total_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
