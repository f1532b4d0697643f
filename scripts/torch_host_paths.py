"""Time the port's three host paths that take another way than the JAX
package to the same bits, each beside the JAX package's way on the same
inputs.

    python3 scripts/torch_host_paths.py [--ssb-sf 0.1 1] \
        [--append SF:ROWS ...] [--cube-sf 0.02] [--seed N]

Each leg runs the JAX package's way first (the port's function with one
name swapped for the JAX formulation, written out here, since nothing of
the JAX package is imported), then the port's way, and checks that both
give the same store or frame:

- ``ingest``: ``ingest_parquet_stream`` of the SSB flat table (generated
  by ``tools/ssb.generate_stream`` and ``flatten_stream`` into a temporary
  Parquet file). The JAX way reads each Arrow string column through
  pandas object arrays (``np.unique`` in pass A, ``searchsorted`` in
  pass B); the port uses Arrow's ``unique`` and ``index_in``.
- ``append``: ``append_dataframe`` of a batch of ROWS lineitem rows (from
  ``tools/tpch.generate`` with another seed, its ``l_comment`` numbered on
  past the base's, so every one is new and sorts among the old ones) into
  SF lineitem. The JAX way merges each dictionary with
  ``np.sort(np.concatenate([old, np.setdiff1d(fresh, old)]))`` and a
  ``searchsorted`` of every old value; the port inserts the new values.
- ``cube``: ``CREATE ROLLUP`` of the SSB cube (15 dimensions, on the host
  tier) over SSB at ``--cube-sf``. The JAX way deep-copies a grouped
  frame's ORDER BY helpers at every column access, as pandas does with
  values held in ``DataFrame.attrs``; the port holds them by reference.

These are host paths: the script runs on the CPU (``device="cpu"``) and
needs no GPU. It prints one JSON line per leg, then a line with the host's
CPU model, the numpy / pandas / pyarrow versions and, where ``nvidia-smi``
answers, the card's name and power limit. It exits 1 if a leg's two ways
disagree. It imports nothing of JAX.
"""

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import spark_druid_olap_tpu_torch as sdt  # noqa: E402
from spark_druid_olap_tpu_torch.planner import host_exec  # noqa: E402
from spark_druid_olap_tpu_torch.segment import append  # noqa: E402
from spark_druid_olap_tpu_torch.segment import stream_ingest  # noqa: E402
from spark_druid_olap_tpu_torch.segment.ingest import (  # noqa: E402
    ingest_dataframe)
from spark_druid_olap_tpu_torch.tools import ssb, tpch  # noqa: E402

SSB_CUBE = (
    "create rollup ssb_cube on ssb_flat dimensions ("
    "d_year, d_yearmonthnum, d_weeknuminyear, d_yearmonth, "
    "c_city, c_nation, c_region, s_city, s_nation, s_region, "
    "p_mfgr, p_category, p_brand1, lo_discount, lo_quantity) "
    "aggregations (sum(lo_extendedprice * lo_discount), sum(lo_revenue), "
    "sum(lo_revenue - lo_supplycost), count(*))")


class swapped:
    """Set ``owner.name`` to ``value`` inside the ``with`` block."""

    def __init__(self, owner, name, value):
        self.owner, self.name, self.value = owner, name, value

    def __enter__(self):
        self.old = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.old)


def jax_merge_dictionary(old, fresh):
    """The JAX package's dictionary merge (``segment/append.py``
    ``_append_dim``), under the port's ``_merge_dictionary`` contract."""
    extra = np.setdiff1d(fresh, old)
    if not len(extra):
        return None, None
    dictionary = np.sort(np.concatenate([old, extra]))
    return dictionary, np.searchsorted(dictionary, old)


def jax_deepcopy_helpers(self, memo):
    """A grouped frame's ORDER BY helpers copied as the JAX package's
    four ``attrs`` values are: deeply, at every column access."""
    return host_exec._OrderHelpers(*copy.deepcopy(
        (self.agg_cols, self.grp_cols, self.genv, self.keep), memo))


def timed(fn):
    t = time.perf_counter()
    out = fn()
    return time.perf_counter() - t, out


def same_store(a, b) -> bool:
    if [s.__dict__ for s in a.segments] != [s.__dict__ for s in b.segments]:
        return False
    for k, d in a.dims.items():
        e = b.dims[k]
        if list(d.dictionary) != list(e.dictionary) \
                or d.codes.dtype != e.codes.dtype \
                or not np.array_equal(d.codes, e.codes) \
                or (d.validity is None) != (e.validity is None) \
                or (d.validity is not None
                    and not np.array_equal(d.validity, e.validity)):
            return False
    for k, m in a.metrics.items():
        if m.values.dtype != b.metrics[k].values.dtype \
                or not np.array_equal(m.values, b.metrics[k].values):
            return False
    if a.time is not None:
        return np.array_equal(a.time.days, b.time.days) \
            and np.array_equal(a.time.ms_in_day, b.time.ms_in_day)
    return True


def ingest_leg(sf, seed):
    with tempfile.TemporaryDirectory(prefix="sdot_host_paths_") as tmp:
        lo = os.path.join(tmp, "lineorder.parquet")
        flat = os.path.join(tmp, "ssb_flat.parquet")
        dims, n_lo = ssb.generate_stream(sf, lo, seed=seed)
        ssb.flatten_stream(dims, lo, flat)

        def run():
            return stream_ingest.ingest_parquet_stream(
                "ssb_flat", flat, time_column="lo_orderdate")
        with swapped(stream_ingest, "_is_arrow_string", lambda arr: False):
            jax_s, jax_ds = timed(run)
        port_s, port_ds = timed(run)
    return {"leg": "ingest", "ssb_sf": sf, "rows": n_lo,
            "string_dims": sum(1 for d in port_ds.dims.values()
                               if d.dictionary.dtype == object),
            "jax_way_s": jax_s, "port_s": port_s,
            "same_store": same_store(jax_ds, port_ds)}


def append_leg(sf, rows, seed):
    base = tpch.generate(sf, seed)["lineitem"]
    batch = tpch.generate(max(sf, rows / 6.0e6), seed + 1)["lineitem"] \
        .head(rows).reset_index(drop=True)
    batch["l_comment"] = [f"line comment {len(base) + i}"
                          for i in range(rows)]
    ds = ingest_dataframe("lineitem", base, time_column="l_shipdate")

    def run():
        return append.append_dataframe(ds, batch)
    with swapped(append, "_merge_dictionary", jax_merge_dictionary):
        jax_s, jax_ds = timed(run)
    port_s, port_ds = timed(run)
    return {"leg": "append", "lineitem_sf": sf, "base_rows": len(base),
            "batch_rows": rows,
            "l_comment_values": len(ds.dims["l_comment"].dictionary),
            "l_comment_after": len(port_ds.dims["l_comment"].dictionary),
            "jax_way_s": jax_s, "port_s": port_s,
            "same_store": same_store(jax_ds, port_ds)}


def cube_leg(sf, seed):
    def run():
        ctx = sdt.Context(device="cpu")
        ssb.setup_context(ctx, sf=sf, seed=seed, flat_only=True)
        t, _ = timed(lambda: ctx.sql(SSB_CUBE))
        return t, ctx.store.get("__rollup_ssb_cube")
    with swapped(host_exec._OrderHelpers, "__deepcopy__",
                 jax_deepcopy_helpers):
        jax_s, jax_ds = run()
    port_s, port_ds = run()
    return {"leg": "cube", "ssb_sf": sf, "rollup_rows": port_ds.num_rows,
            "jax_way_s": jax_s, "port_s": port_s,
            "same_store": same_store(jax_ds, port_ds)}


def host_line():
    cpu = None
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((ln.split(":", 1)[1].strip() for ln in f
                        if ln.startswith("model name")), None)
    except OSError:
        pass
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip() or None
    except OSError:
        smi = None
    import pandas
    import pyarrow
    return {"cpu": cpu, "cpus": os.cpu_count(), "nvidia_smi": smi,
            "numpy": np.__version__, "pandas": pandas.__version__,
            "pyarrow": pyarrow.__version__}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ssb-sf", type=float, nargs="*", default=[0.1])
    p.add_argument("--append", nargs="*", default=["0.01:3000"],
                   help="SF:ROWS pairs")
    p.add_argument("--cube-sf", type=float, nargs="*", default=[0.02])
    p.add_argument("--seed", type=int, default=20260729)
    a = p.parse_args()
    ok = True
    for sf in a.ssb_sf:
        r = ingest_leg(sf, a.seed)
        ok &= r["same_store"]
        print(json.dumps(r), flush=True)
    for pair in a.append:
        sf, rows = pair.split(":")
        r = append_leg(float(sf), int(rows), a.seed)
        ok &= r["same_store"]
        print(json.dumps(r), flush=True)
    for sf in a.cube_sf:
        r = cube_leg(sf, a.seed)
        ok &= r["same_store"]
        print(json.dumps(r), flush=True)
    print(json.dumps(host_line()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
