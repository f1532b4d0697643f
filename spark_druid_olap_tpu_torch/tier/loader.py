"""Build tiered datasources from persist/ snapshots.

Port of ``spark_druid_olap_tpu/tier/loader.py``: a copy kept inside the
PyTorch package, which imports nothing of the JAX package, less
``slice_tiered``: its caller, the cluster historical's tiered boot, is
not ported, and :func:`slice_tiered` raises (ROADMAP A.9).

``load_tiered_snapshot`` is the cold-tier counterpart of
``persist/snapshot.py:load_snapshot``: instead of reading every blob
into memory it performs O(manifest) structural verification (file
present, size matches the manifest, size matches dtype x shape) and
hands back a :class:`TieredDatasource` whose per-segment
:class:`BlobRef` ranges fault on demand. Blob CRC verification moves to
first-fault time (``TieredColumnStore._verify_blob``) — the same
quarantine-on-mismatch semantics, paid only for blobs a query actually
touches. Dictionaries are small JSON and load (and CRC-verify) eagerly:
planning binary-searches them constantly.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from spark_druid_olap_tpu_torch.persist import snapshot as SNAP
from spark_druid_olap_tpu_torch.persist.snapshot import SnapshotCorrupt
from spark_druid_olap_tpu_torch.segment.column import ColumnKind
from spark_druid_olap_tpu_torch.segment.store import Segment
from spark_druid_olap_tpu_torch.tier.handles import (
    RefArray, TieredDatasource, TieredDimColumn, TieredMetricColumn,
    TieredTimeColumn)
from spark_druid_olap_tpu_torch.tier.store import BlobRef, TieredColumnStore


def _ref_array(vdir: str, rel: str, files: dict,
               bounds: List[Tuple[int, int]]) -> RefArray:
    """Per-segment BlobRefs over one column blob, structurally verified
    against the manifest (content CRC stays lazy)."""
    meta = files.get(rel)
    if meta is None:
        raise SnapshotCorrupt(f"blob {rel} not in manifest")
    path = os.path.join(vdir, rel)
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise SnapshotCorrupt(f"missing blob {rel}: {e}") from e
    if size != int(meta["bytes"]):
        raise SnapshotCorrupt(
            f"blob {rel}: {size} bytes on disk, manifest says "
            f"{meta['bytes']}")
    dtype = np.dtype(meta["dtype"])
    total = bounds[-1][1] if bounds else 0
    enc = meta.get("enc")
    if enc is not None:
        # encoded blob: the file holds concatenated per-segment
        # compressed chunks; verify the chunk table covers the file and
        # the segment map exactly, then hand out byte-range refs. The
        # codec header rides each ref as a JSON string so fault-time
        # decode and header-level zone maps never reopen the manifest.
        segs = enc.get("segments", [])
        if len(segs) != len(bounds):
            raise SnapshotCorrupt(
                f"blob {rel}: {len(segs)} encoded chunks, segment map "
                f"says {len(bounds)}")
        rows = sum(int(h["n"]) for _, _, h in segs)
        if rows != total:
            raise SnapshotCorrupt(
                f"blob {rel}: encoded chunks hold {rows} rows, segment "
                f"map says {total}")
        span = (int(segs[-1][0]) + int(segs[-1][1])) if segs else 0
        if span != size:
            raise SnapshotCorrupt(
                f"blob {rel}: chunk table spans {span} bytes, file has "
                f"{size}")
        refs = []
        for (s, e), (off, length, header) in zip(bounds, segs):
            if int(header["n"]) != e - s:
                raise SnapshotCorrupt(
                    f"blob {rel}: chunk at {off} holds {header['n']} "
                    f"rows, segment [{s}, {e}) wants {e - s}")
            refs.append(BlobRef(
                path=path, dtype=dtype.str, start=int(s),
                count=int(e - s), crc=int(meta["crc"]),
                file_bytes=int(meta["bytes"]),
                enc=json.dumps(header, sort_keys=True),
                byte_start=int(off), byte_len=int(length)))
        return RefArray(refs=tuple(refs), dtype=dtype.str)
    shape = meta.get("shape", None)
    n = int(np.prod(shape, dtype=np.int64)) if shape is not None \
        else size // dtype.itemsize
    if n * dtype.itemsize != size:
        raise SnapshotCorrupt(
            f"blob {rel}: {size} bytes is not {n} x {dtype}")
    if n != total:
        raise SnapshotCorrupt(
            f"blob {rel}: {n} elements, segment map says {total}")
    refs = tuple(
        BlobRef(path=path, dtype=dtype.str, start=int(s),
                count=int(e - s), crc=int(meta["crc"]),
                file_bytes=int(meta["bytes"]))
        for s, e in bounds)
    return RefArray(refs=refs, dtype=dtype.str)


def load_tiered_snapshot(ds_root: str, version: int,
                         tier: TieredColumnStore,
                         verify: bool = True):
    """(TieredDatasource, manifest, structural_verify_ms). Raises
    :class:`SnapshotCorrupt` on any structural failure (blob CRC
    failures surface later, on first fault)."""
    t0 = time.perf_counter()
    try:
        manifest = SNAP.load_manifest(ds_root, version)
    except (OSError, ValueError) as e:
        raise SnapshotCorrupt(f"unreadable manifest: {e}") from e
    if int(manifest.get("format", -1)) != SNAP.FORMAT_VERSION:
        raise SnapshotCorrupt(
            f"unknown snapshot format {manifest.get('format')!r}")
    vdir = os.path.join(ds_root, SNAP.version_dirname(version))
    files = manifest.get("files", {})
    segments = [Segment(id=s[0], start_row=int(s[1]), end_row=int(s[2]),
                        min_millis=int(s[3]), max_millis=int(s[4]))
                for s in manifest["segments"]]
    bounds = [(s.start_row, s.end_row) for s in segments]
    total = bounds[-1][1] if bounds else 0
    if total != int(manifest["num_rows"]):
        raise SnapshotCorrupt(
            f"segment map rows {total} != manifest num_rows "
            f"{manifest['num_rows']}")
    name = manifest["datasource"]

    time_col = None
    if manifest["time"] is not None:
        t = manifest["time"]
        time_col = TieredTimeColumn(
            name=t["name"], tier=tier, ns=name,
            days_ra=_ref_array(vdir, t["days"], files, bounds),
            ms_ra=_ref_array(vdir, t["ms"], files, bounds))
    dims = {}
    for e in manifest["dims"]:
        dict_raw = SNAP._read_blob(vdir, e["dictionary"], files, verify)
        try:
            dictionary = np.asarray(json.loads(dict_raw.decode()),
                                    dtype=object)
        except ValueError as ex:
            raise SnapshotCorrupt(
                f"dictionary {e['dictionary']}: {ex}") from ex
        dims[e["name"]] = TieredDimColumn(
            name=e["name"], dictionary=dictionary, tier=tier, ns=name,
            codes_ra=_ref_array(vdir, e["codes"], files, bounds),
            valid_ra=None if e["validity"] is None
            else _ref_array(vdir, e["validity"], files, bounds))
    metrics = {}
    for e in manifest["metrics"]:
        m = TieredMetricColumn(
            name=e["name"], kind=ColumnKind(e["kind"]), tier=tier,
            ns=name,
            values_ra=_ref_array(vdir, e["values"], files, bounds),
            valid_ra=None if e["validity"] is None
            else _ref_array(vdir, e["validity"], files, bounds))
        # manifest-published global bounds (snapshots written before the
        # field existed fall back to a one-time whole-column fault)
        if e.get("min") is not None:
            m._bounds_cache = (np.dtype(m.data_dtype()).type(e["min"]),
                               np.dtype(m.data_dtype()).type(e["max"]))
        metrics[e["name"]] = m
    ds = TieredDatasource(
        name, time_col, dims, metrics, segments,
        spatial={k: tuple(v) for k, v in manifest["spatial"].items()},
        tier=tier)
    ds._index_refs()
    # per-segment zone maps from the manifest (``seg_bounds``, written
    # alongside the global min/max): with these injected, broker and
    # planner pruning over a freshly recovered tiered store never
    # decodes a chunk or faults a cold blob just to bound a segment.
    # None entries are all-null segments -> (inf, -inf), prune-nothing.
    for e in manifest["metrics"]:
        sb = e.get("seg_bounds")
        if sb is not None and len(sb) == len(segments):
            mins = np.array([np.inf if b is None else float(b[0])
                             for b in sb])
            maxs = np.array([-np.inf if b is None else float(b[1])
                             for b in sb])
            ds._bounds_cache[e["name"]] = (mins, maxs)
    return ds, manifest, (time.perf_counter() - t0) * 1000.0


def slice_tiered(ds: TieredDatasource, segment_indexes,
                 name: Optional[str] = None) -> TieredDatasource:
    """A tiered datasource over some segments of another (the JAX
    package's ``slice_tiered``, which only a cluster historical's
    owned-shard boot calls)."""
    raise NotImplementedError(
        "tiered shard slices for cluster historicals not ported yet "
        "(ROADMAP A.9)")
