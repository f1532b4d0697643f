"""HLL estimates of TPC-H lineitem's l_orderkey per (l_returnflag,
l_linestatus) group with the engine's hash (the murmur3 finalizer alone,
``ops/hll.py``, bit-equal to the JAX package's) and with a splitmix64
control hash of the same keys into the same 2^11 registers and estimator.

    python3 -m spark_druid_olap_tpu_torch.tools.hll_bias [--sf 1.0]

Runs on the CPU (~1 min at SF1) over ``tools/tpch.generate``'s tables
from ``--seed`` (``chip_smoke.py``'s seed by default). Prints one JSON
line per group: the exact distinct count and each hash's relative error.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

LOG2M = 11


def splitmix64_low32(x: np.ndarray) -> torch.Tensor:
    x = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return torch.from_numpy((x & np.uint64(0xFFFFFFFF)).astype(np.int64))


def registers_of_hash(h: torch.Tensor) -> np.ndarray:
    """``ops/hll.hll_registers``' register and rho steps over a given
    uint32 hash (held in int64), one group."""
    m = 1 << LOG2M
    w = h >> LOG2M
    clz = 32 - torch.frexp(w.to(torch.float64)).exponent.to(torch.int64)
    rho = torch.where(w == 0, 32 - LOG2M + 1, clz - LOG2M + 1)
    regs = torch.zeros(m, dtype=torch.int32)
    regs.scatter_reduce_(0, h & (m - 1), rho.to(torch.int32), "amax")
    return regs.numpy()[None]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=20260729)
    args = ap.parse_args()
    from spark_druid_olap_tpu_torch.ops import hll as HLL
    from spark_druid_olap_tpu_torch.tools import tpch
    li = tpch.generate(args.sf, seed=args.seed)["lineitem"]
    for k, g in li.groupby(["l_returnflag", "l_linestatus"]):
        v = g["l_orderkey"].to_numpy()
        exact = int(g["l_orderkey"].nunique())
        n = len(v)
        engine = HLL.estimate(HLL.hll_registers(
            torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
            torch.from_numpy(v.astype(np.int64)), 1, LOG2M).numpy())[0]
        control = HLL.estimate(registers_of_hash(splitmix64_low32(v)))[0]
        print(json.dumps({"group": list(k), "distinct": exact,
                          "engine_rel_err": (engine - exact) / exact,
                          "control_rel_err": (control - exact) / exact}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
