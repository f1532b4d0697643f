"""Versioned on-disk snapshot format for datasources (deep storage).

Port counterpart of ``spark_druid_olap_tpu/persist/snapshot.py``: a copy
kept inside the PyTorch package, which imports nothing of the JAX
package. The bytes on disk are the JAX package's: a root written by
either package recovers in the other.

Layout under ``<root>/<datasource-dir>/``::

    CURRENT                   # JSON pointer {"version": N}, atomic replace
    v<NNNNNNNNNN>/            # one published snapshot (N = monotone
                              #   publish number; the ingest version it
                              #   captures lives in the manifest)
      manifest.json           # schema, segment map, versions, checksums
      time_days.bin ...       # per-column raw little-endian blobs
      dim_NNNN_dict.json      # sorted global dictionaries (NNNN = dim index)
    wal.log                   # stream-ingest journal (persist/wal.py)
    quarantine/               # checksum-failing versions moved aside

Publish protocol (≈ Druid's segment push to deep storage + metadata
commit): write every blob into a hidden temp dir, fsync each file, then
``os.replace`` the temp dir to its version name and atomically rewrite
CURRENT. The version name is a monotone per-datasource publish number
(max existing + 1), so a publish NEVER replaces an existing directory —
even a re-checkpoint of the same ingest version lands in a fresh dir,
and there is no instant at which CURRENT's directory is missing. A crash
at any point leaves either the old CURRENT (temp dirs are
garbage-collected on the next publish) or the new one — never a
half-published snapshot.

Every blob carries a CRC32 in the manifest; recovery verifies them
(``sdot.persist.verify.checksums``) and quarantines the version on any
mismatch instead of serving silently corrupt columns.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

FORMAT_VERSION = 1
MANIFEST = "manifest.json"
CURRENT = "CURRENT"
QUARANTINE_DIR = "quarantine"


def sanitize(name: str) -> str:
    """Datasource name -> filesystem-safe directory name (dotted database
    prefixes are fine; path separators and leading dots are not)."""
    out = name.replace(os.sep, "%2F").replace("/", "%2F")
    return "_" + out if out.startswith(".") else out


def fsync_dir(path: str) -> None:
    """Flush a directory inode: a rename-publish is only durable once
    the directory entry itself is synced (best-effort — some filesystems
    refuse O_RDONLY fsync on directories)."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


_fsync_dir = fsync_dir    # established internal spelling


def _write_blob(dirpath: str, rel: str, data: bytes,
                files: Dict[str, dict], meta: dict) -> None:
    with open(os.path.join(dirpath, rel), "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    files[rel] = {"crc": zlib.crc32(data), "bytes": len(data), **meta}


def _array_blob(dirpath: str, rel: str, arr: np.ndarray,
                files: Dict[str, dict]) -> None:
    _write_blob(dirpath, rel, arr.tobytes(),
                files, {"dtype": arr.dtype.str, "shape": list(arr.shape)})


def _encoded_blob(dirpath: str, rel: str, arr: np.ndarray, bounds,
                  files: Dict[str, dict], codec: str) -> None:
    """One column blob as concatenated per-SEGMENT encoded chunks, so a
    tiered store can fault any segment's byte range independently. The
    file meta grows a self-describing ``enc`` block — ``codec`` plus one
    ``[byte_off, byte_len, header]`` entry per segment (headers carry
    the chunk's codec, row count, params, and integer value bounds; see
    encode/codecs.py) — while ``dtype``/``shape`` keep describing the
    LOGICAL array, exactly as the raw format does. A chunk the codec
    fails to shrink stays raw inside the same file (encode_chunk's
    fallback), so encoding never inflates a segment."""
    from spark_druid_olap_tpu_torch.encode import codecs as EN
    segs, parts, off = [], [], 0
    for s, e in bounds:
        payload, header = EN.encode_chunk(
            np.ascontiguousarray(arr[s:e]), codec)
        parts.append(payload)
        segs.append([off, len(payload), header])
        off += len(payload)
    _write_blob(dirpath, rel, b"".join(parts), files,
                {"dtype": arr.dtype.str, "shape": list(arr.shape),
                 "enc": {"codec": codec, "segments": segs}})


def version_dirname(version: int) -> str:
    return f"v{int(version):010d}"


def list_versions(ds_root: str) -> List[int]:
    try:
        names = os.listdir(ds_root)
    except OSError:
        return []
    out = []
    for n in names:
        if n.startswith("v") and n[1:].isdigit() \
                and os.path.isdir(os.path.join(ds_root, n)):
            out.append(int(n[1:]))
    return sorted(out)


def current_version(ds_root: str) -> Optional[int]:
    """The published version per CURRENT; falls back to the newest
    on-disk version dir when the pointer is missing or unreadable."""
    try:
        with open(os.path.join(ds_root, CURRENT)) as f:
            v = int(json.load(f)["version"])
        if os.path.isdir(os.path.join(ds_root, version_dirname(v))):
            return v
    except (OSError, ValueError, KeyError):
        pass
    versions = list_versions(ds_root)
    return versions[-1] if versions else None


def write_snapshot(ds_root: str, ds, ingest_version: int,
                   wal_seq: int, keep: int = 2,
                   encode: bool = False) -> dict:
    """Publish one snapshot of a COMPLETE datasource; returns the
    manifest. Atomic: temp dir -> rename -> CURRENT pointer swap. The
    on-disk version is allocated (max existing + 1), never reused: an
    in-place replace of an existing version dir would open a crash
    window with no directory behind CURRENT after the covering WAL
    records were already truncated.

    ``encode`` (``sdot.encode.enabled``; False = raw) turns on per-column compressed blobs: the chooser picks a codec per
    column, columns it declines stay raw, and the manifest's per-file
    ``enc`` blocks make the result self-describing — a reader that
    predates the encoding block only ever sees it on snapshots it never
    wrote, and readers here fall back to the raw path whenever the
    block is absent, so raw and encoded versions interoperate under one
    CURRENT pointer with zero manifest-format churn."""
    ds.require_complete("checkpoint")
    os.makedirs(ds_root, exist_ok=True)
    # collect temp dirs a crashed previous publish left behind
    for n in os.listdir(ds_root):
        if n.startswith(".tmp-"):
            shutil.rmtree(os.path.join(ds_root, n), ignore_errors=True)
    versions = list_versions(ds_root)
    publish_version = (versions[-1] + 1) if versions else 1
    tmp = os.path.join(ds_root, f".tmp-{os.getpid()}-{publish_version}")
    os.makedirs(tmp, exist_ok=True)
    try:
        return _fill_and_publish(ds_root, ds, ingest_version, wal_seq,
                                 keep, publish_version, tmp, encode)
    except BaseException:
        # a failed publish must not strand the temp dir until the next
        # write_snapshot's sweep — a crash-restart loop would otherwise
        # accumulate one orphan per attempt
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _fill_and_publish(ds_root: str, ds, ingest_version: int, wal_seq: int,
                      keep: int, publish_version: int, tmp: str,
                      encode: bool = False) -> dict:
    files: Dict[str, dict] = {}
    enc_cols: Dict[str, str] = {}
    enc_raw_bytes = 0

    def _column_blob(rel: str, arr: np.ndarray) -> None:
        # per-column codec choice at publish time: the chooser measures
        # the actual array (not the ingest-time hint) so a compaction
        # that re-sorts or widens a column re-chooses its codec; columns
        # the chooser declines (floats, high-entropy ints, ratio below
        # chooser.MIN_RATIO) stay raw in the SAME snapshot
        nonlocal enc_raw_bytes
        codec = None
        if encode:
            from spark_druid_olap_tpu_torch.encode import chooser as _chooser
            codec = _chooser.choose_codec(np.asarray(arr))
        if codec is None:
            _array_blob(tmp, rel, arr, files)
        else:
            _encoded_blob(tmp, rel, arr,
                          [(s.start_row, s.end_row) for s in ds.segments],
                          files, codec)
            enc_cols[rel] = codec
            enc_raw_bytes += int(arr.nbytes)

    manifest = {
        "format": FORMAT_VERSION,
        "datasource": ds.name,
        "snapshot_version": int(publish_version),
        "ingest_version": int(ingest_version),
        "wal_seq": int(wal_seq),
        "num_rows": int(ds.num_rows),
        "created_at": time.time(),
        "segments": [[s.id, s.start_row, s.end_row,
                      s.min_millis, s.max_millis] for s in ds.segments],
        "spatial": {k: list(v) for k, v in ds.spatial.items()},
        "time": None,
        "dims": [],
        "metrics": [],
    }
    if ds.time is not None:
        _column_blob("time_days.bin", ds.time.days)
        _column_blob("time_ms.bin", ds.time.ms_in_day)
        manifest["time"] = {"name": ds.time.name,
                            "days": "time_days.bin", "ms": "time_ms.bin"}
    for i, (name, d) in enumerate(ds.dims.items()):
        codes_f = f"dim_{i:04d}_codes.bin"
        dict_f = f"dim_{i:04d}_dict.json"
        _column_blob(codes_f, d.codes)
        _write_blob(tmp, dict_f,
                    json.dumps([str(v) for v in d.dictionary]).encode(),
                    files, {"json": True})
        entry = {"name": name, "codes": codes_f, "dictionary": dict_f,
                 "validity": None}
        if d.validity is not None:
            vf = f"dim_{i:04d}_valid.bin"
            _column_blob(vf, d.validity)
            entry["validity"] = vf
        manifest["dims"].append(entry)
    for i, (name, m) in enumerate(ds.metrics.items()):
        vals_f = f"met_{i:04d}_values.bin"
        _column_blob(vals_f, m.values)
        # global (min, max) over valid rows: the cost model's
        # selectivity input. Publishing it keeps a TIERED recovery from
        # faulting a whole column just to plan (tier/loader.py injects
        # these as the column's bounds cache). Additive — format
        # version unchanged; old manifests simply lack the field.
        mn, mx = m.min, m.max
        entry = {"name": name, "kind": m.kind.value, "values": vals_f,
                 "validity": None,
                 "min": None if mn is None else float(mn),
                 "max": None if mx is None else float(mx)}
        # per-SEGMENT (min, max) zone maps, same additive contract as the
        # global pair above: tiered recovery injects them so broker /
        # planner pruning never faults a cold blob just to bound a
        # segment. None marks a segment with no valid rows (JSON has no
        # +/-inf), which prunes nothing — exactly the in-memory
        # semantics of an all-null segment's (inf, -inf) bounds.
        smin, smax = ds.segment_metric_bounds(name)
        entry["seg_bounds"] = [
            [float(lo), float(hi)] if np.isfinite(lo) and np.isfinite(hi)
            else None for lo, hi in zip(smin, smax)]
        if m.validity is not None:
            vf = f"met_{i:04d}_valid.bin"
            _column_blob(vf, m.validity)
            entry["validity"] = vf
        manifest["metrics"].append(entry)
    manifest["files"] = files
    manifest["bytes"] = sum(e["bytes"] for e in files.values())
    if enc_cols:
        from spark_druid_olap_tpu_torch.encode import codecs as EN
        enc_bytes = sum(files[rel]["bytes"] for rel in enc_cols)
        manifest["encoding"] = {
            "version": EN.ENCODING_VERSION,
            "columns": enc_cols,
            "raw_bytes": int(enc_raw_bytes),
            "encoded_bytes": int(enc_bytes),
        }

    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    final = os.path.join(ds_root, version_dirname(publish_version))
    os.replace(tmp, final)
    _fsync_dir(ds_root)
    _write_current(ds_root, int(publish_version))
    prune(ds_root, keep=keep, current=int(publish_version))
    return manifest


def _write_current(ds_root: str, version: int) -> None:
    tmp = os.path.join(ds_root, CURRENT + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"version": int(version)}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(ds_root, CURRENT))
    _fsync_dir(ds_root)


def prune(ds_root: str, keep: int, current: int) -> None:
    """Retain the newest ``keep`` versions (always including the current
    one); remove the rest."""
    keep = max(1, int(keep))
    versions = list_versions(ds_root)
    retained = set(sorted(versions)[-keep:]) | {int(current)}
    for v in versions:
        if v not in retained:
            shutil.rmtree(os.path.join(ds_root, version_dirname(v)),
                          ignore_errors=True)


def load_manifest(ds_root: str, version: int) -> dict:
    with open(os.path.join(ds_root, version_dirname(version),
                           MANIFEST)) as f:
        return json.load(f)


def datasource_manifests(root: str) -> Dict[str, dict]:
    """Deep-storage catalog scan: datasource name -> current published
    manifest. The cluster shard plan (cluster/assign.py) is a pure
    function of this scan, which is what makes deep storage the
    coordination substrate: every process pointed at the same root
    derives the same plan with no coordinator service. Datasources with
    WAL-only state (never checkpointed) have no manifest and are
    invisible here — the broker serves those locally."""
    out: Dict[str, dict] = {}
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return out
    for n in entries:
        p = os.path.join(root, n)
        if not os.path.isdir(p) or n.startswith("."):
            continue
        cur = current_version(p)
        if cur is None:
            continue
        try:
            m = load_manifest(p, cur)
        except (OSError, ValueError, KeyError):
            continue
        name = m.get("datasource")
        if name is not None:
            out[name] = m
    return out


class SnapshotCorrupt(Exception):
    """A snapshot file failed checksum / structural verification."""


def _read_blob(vdir: str, rel: str, files: dict, verify: bool) -> bytes:
    try:
        with open(os.path.join(vdir, rel), "rb") as f:
            data = f.read()
    except OSError as e:
        raise SnapshotCorrupt(f"missing blob {rel}: {e}") from e
    meta = files.get(rel)
    if meta is None:
        raise SnapshotCorrupt(f"blob {rel} not in manifest")
    if len(data) != int(meta["bytes"]):
        raise SnapshotCorrupt(
            f"blob {rel}: {len(data)} bytes, manifest says {meta['bytes']}")
    if verify and zlib.crc32(data) != int(meta["crc"]):
        raise SnapshotCorrupt(f"blob {rel}: CRC32 mismatch")
    return data


def _read_array(vdir: str, rel: str, files: dict, verify: bool) -> np.ndarray:
    data = _read_blob(vdir, rel, files, verify)
    meta = files[rel]
    enc = meta.get("enc")
    if enc is not None:
        # encoded blob: decode the per-segment chunks back to the
        # logical array (the eager recovery path; tiered recovery keeps
        # the bytes encoded and decodes on fault instead). Manifests
        # without an ``enc`` block — every pre-encoding snapshot —
        # never reach this branch, so the raw path below stays
        # byte-for-byte what it always was.
        from spark_druid_olap_tpu_torch.encode import codecs as EN
        dt = np.dtype(meta["dtype"])
        mv = memoryview(data)
        parts = []
        try:
            for off, length, header in enc["segments"]:
                parts.append(EN.decode_array(mv[off:off + length], header))
        except (EN.EncodingError, KeyError, ValueError, TypeError) as e:
            raise SnapshotCorrupt(f"blob {rel}: bad encoded chunk: {e}") \
                from e
        arr = np.concatenate(parts) if parts else np.empty(0, dtype=dt)
        if arr.dtype != dt:
            raise SnapshotCorrupt(
                f"blob {rel}: decoded dtype {arr.dtype.str}, "
                f"manifest says {meta['dtype']}")
        try:
            arr = arr.reshape(meta.get("shape", [-1]))
        except ValueError as e:
            raise SnapshotCorrupt(
                f"blob {rel}: decoded {arr.size} elements, manifest "
                f"shape {meta.get('shape')}") from e
        if arr.size and not arr.flags.writeable:
            arr = arr.copy()
        return arr
    arr = np.frombuffer(data, dtype=np.dtype(meta["dtype"]))
    # writable copy: Datasource caches mutate nothing, but downstream
    # numpy ops (e.g. in-place sorts in tests) must not hit a read-only
    # frombuffer view
    return arr.reshape(meta.get("shape", [-1])).copy()


def load_snapshot(ds_root: str, version: int,
                  verify: bool = True) -> Tuple[object, dict, float]:
    """(Datasource, manifest, checksum_verify_ms). Raises
    :class:`SnapshotCorrupt` on any checksum/structure failure."""
    from spark_druid_olap_tpu_torch.segment.column import (
        ColumnKind, DimColumn, MetricColumn, TimeColumn)
    from spark_druid_olap_tpu_torch.segment.store import Datasource, Segment

    t0 = time.perf_counter()
    try:
        manifest = load_manifest(ds_root, version)
    except (OSError, ValueError) as e:
        raise SnapshotCorrupt(f"unreadable manifest: {e}") from e
    if int(manifest.get("format", -1)) != FORMAT_VERSION:
        raise SnapshotCorrupt(
            f"unknown snapshot format {manifest.get('format')!r}")
    vdir = os.path.join(ds_root, version_dirname(version))
    files = manifest.get("files", {})

    time_col = None
    if manifest["time"] is not None:
        t = manifest["time"]
        time_col = TimeColumn(
            name=t["name"],
            days=_read_array(vdir, t["days"], files, verify),
            ms_in_day=_read_array(vdir, t["ms"], files, verify))
    dims = {}
    for e in manifest["dims"]:
        dict_raw = _read_blob(vdir, e["dictionary"], files, verify)
        try:
            dictionary = np.asarray(json.loads(dict_raw.decode()),
                                    dtype=object)
        except ValueError as ex:
            raise SnapshotCorrupt(
                f"dictionary {e['dictionary']}: {ex}") from ex
        dims[e["name"]] = DimColumn(
            name=e["name"], dictionary=dictionary,
            codes=_read_array(vdir, e["codes"], files, verify),
            validity=None if e["validity"] is None
            else _read_array(vdir, e["validity"], files, verify))
    metrics = {}
    for e in manifest["metrics"]:
        metrics[e["name"]] = MetricColumn(
            name=e["name"],
            values=_read_array(vdir, e["values"], files, verify),
            validity=None if e["validity"] is None
            else _read_array(vdir, e["validity"], files, verify),
            kind=ColumnKind(e["kind"]))
    segments = [Segment(id=s[0], start_row=int(s[1]), end_row=int(s[2]),
                        min_millis=int(s[3]), max_millis=int(s[4]))
                for s in manifest["segments"]]
    ds = Datasource(name=manifest["datasource"], time=time_col, dims=dims,
                    metrics=metrics, segments=segments,
                    spatial={k: tuple(v)
                             for k, v in manifest["spatial"].items()})
    if ds.num_rows != int(manifest["num_rows"]):
        raise SnapshotCorrupt(
            f"segment map rows {ds.num_rows} != manifest "
            f"num_rows {manifest['num_rows']}")
    return ds, manifest, (time.perf_counter() - t0) * 1000.0


def quarantine_version(ds_root: str, version: int) -> Optional[str]:
    """Move a corrupt snapshot version aside (never deleted — an operator
    may want the evidence) and return its new path."""
    src = os.path.join(ds_root, version_dirname(version))
    if not os.path.isdir(src):
        return None
    qdir = os.path.join(ds_root, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    dst = os.path.join(
        qdir, f"{int(time.time())}-{version_dirname(version)}")
    i = 0
    while os.path.exists(dst):
        i += 1
        dst = os.path.join(
            qdir, f"{int(time.time())}-{version_dirname(version)}.{i}")
    os.replace(src, dst)
    # the corrupt dir must STAY moved after a crash, or recovery retries
    # the same poisoned version forever
    _fsync_dir(ds_root)
    _fsync_dir(qdir)
    return dst
