"""The sketch aggregations' register stage, shared by the dense route
(``parallel/executor.py``), the lane-by-lane storm program
(``parallel/sharedscan.py``) and the wave kernel's epilogue
(``ops/cuda_wave.py``), and their host decode.

The JAX package writes this stage out at each of those sites
(``executor.py`` :2594-2613, ``sharedscan.py`` :656-686,
``pallas_wave.py`` :478-494) and decodes at two (``executor.py``
:1397-1418, ``sharedscan.py`` :858-876); the port keeps one copy.
"""

from __future__ import annotations

import numpy as np

from spark_druid_olap_tpu_torch.ops import hll as HLL
from spark_druid_olap_tpu_torch.ops import kll as KLL
from spark_druid_olap_tpu_torch.ops import theta as TH

#: plan kinds whose outputs are register blocks, not route finals
SKETCH_KINDS = ("hll", "theta", "kll")


def sketch_registers(p, ctx, cse, base, key, n_keys: int, *, log2m: int,
                     kll_lanes: int):
    """One sketch aggregate's registers over a scan: the plan's values
    and mask over ``ctx`` (``cse``, a ``planner/fusion.CSECache`` over it,
    or None), the rows ``base & mask`` grouped by ``key`` into ``n_keys``
    groups."""
    vals = p.build_values(ctx)
    am = p.build_mask(ctx, cse=cse)
    m = base if am is None else (base & am)
    if p.kind == "hll":
        return HLL.hll_registers(key, m, vals, n_keys, log2m)
    if p.kind == "theta":
        return TH.theta_registers(key, m, vals, n_keys)
    # the time column joins the content salt, so equal values in distinct
    # rows keep distinct survivor draws
    ds = ctx.ds
    tcol = ctx.col(ds.time.name) if ds.time is not None else None
    return KLL.kll_registers(key, m, vals, tcol, n_keys, kll_lanes)


def decode_sketch(p, regs: np.ndarray) -> np.ndarray:
    """A sketch's output column from the selected groups' ``[G, width]``
    registers: the KLL quantile estimate, or the rounded HLL / theta
    distinct count."""
    if p.kind == "kll":
        return KLL.estimate(regs, p.spec.fraction or 0.5)
    est = HLL.estimate(regs) if p.kind == "hll" else TH.estimate(regs)
    return np.round(est).astype(np.int64)
