"""Background compaction: roll a stream-appended tail into
time-partitioned segments.

Port counterpart of ``spark_druid_olap_tpu/persist/compact.py``: a copy
kept inside the PyTorch package, which imports nothing of the JAX
package.

Streaming appends leave a datasource as many small realtime segments
(one or more per batch) whose time ranges interleave — correct, but scan
pruning degrades and per-segment overheads pile up, exactly the problem
Druid solves with its compaction tasks. The compactor rebuilds the
datasource at the COLUMN level: one stable argsort over the time column,
every dim/metric column permuted by it (dictionaries are already global
and sorted — the order-preserving append invariant — so codes permute
untouched), and fresh segment boundaries cut every ``target_rows`` rows.
The result holds bit-identical rows to the input, just globally
time-sorted and evenly partitioned.

Generation swap protocol (the crash-safety contract):

1. build the compacted Datasource value (outside any lock — racing
   appends are detected, not blocked);
2. publish it as a NEW snapshot version through the standard
   tmp + fsync + os.replace + dir-fsync discipline
   (persist/snapshot.py) — a crash at any instant leaves either the old
   or the new generation fully readable under ``CURRENT``, never both,
   never a torn one;
3. truncate the WAL records the new generation covers (only AFTER the
   publish is durable — sdlint ordering rules O4/O5 machine-check this
   file);
4. swap the in-memory value QUIETLY: same rows, same ingest version, so
   result caches stay valid and rollup staleness does not move — a
   rollup fresh before the swap is fresh after it, a stale one stays
   stale (the version-counter contract in persist/manager.py).

A live ``stream_ingest`` racing the build wins: the commit phase
re-checks the datasource identity + ingest version under the build lock
and retries the whole build against the new tail (bounded attempts; the
background cadence picks it up again later).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from spark_druid_olap_tpu_torch.persist import snapshot as SNAP
from spark_druid_olap_tpu_torch.segment.column import (DimColumn, MetricColumn,
                                                 TimeColumn)
from spark_druid_olap_tpu_torch.segment.store import Datasource, Segment

_MS_PER_DAY = 86_400_000


def rebuild_time_partitioned(ds: Datasource,
                             target_rows: int = 1 << 20) -> Datasource:
    """A new Datasource with the same rows globally time-sorted and cut
    into segments of ``target_rows``. Pure value-level transform: ``ds``
    is untouched (immutable-columns contract)."""
    n = ds.num_rows
    if ds.time is not None:
        millis = (ds.time.days.astype(np.int64) * _MS_PER_DAY
                  + ds.time.ms_in_day.astype(np.int64))
        order = np.argsort(millis, kind="stable")
        identity = bool(np.array_equal(order, np.arange(n)))
    else:
        millis = np.zeros(n, dtype=np.int64)
        order = None
        identity = True

    def take(a):
        if a is None or identity:
            return a
        return a[order]

    time_col = None
    if ds.time is not None:
        time_col = TimeColumn(name=ds.time.name,
                              days=take(ds.time.days),
                              ms_in_day=take(ds.time.ms_in_day))
    dims = {k: DimColumn(name=d.name, dictionary=d.dictionary,
                         codes=take(d.codes), validity=take(d.validity))
            for k, d in ds.dims.items()}
    mets = {k: MetricColumn(name=m.name, values=take(m.values),
                            validity=take(m.validity), kind=m.kind)
            for k, m in ds.metrics.items()}
    if not identity:
        millis = millis[order]

    segments = []
    n_seg = max(1, -(-n // max(1, int(target_rows))))
    per = -(-n // n_seg) if n else 0
    for i in range(n_seg):
        s, e = i * per, min((i + 1) * per, n)
        if s >= e:
            break
        segments.append(Segment(
            id=f"{ds.name}_{i:05d}", start_row=s, end_row=e,
            min_millis=int(millis[s]), max_millis=int(millis[e - 1])))
    return Datasource(name=ds.name, time=time_col, dims=dims,
                      metrics=mets, segments=segments,
                      spatial=dict(ds.spatial))


def compact_datasource(manager, name: str, *,
                       target_rows: Optional[int] = None,
                       force: bool = False,
                       retries: int = 3) -> Optional[dict]:
    """Compact one datasource and atomically swap the new generation in.
    Returns a summary dict, or None when skipped (below the segment
    floor, partial, unknown, or starved out by live appends)."""
    store = manager.ctx.store
    if target_rows is None:
        from spark_druid_olap_tpu_torch.utils.config import SEGMENT_ROWS
        target_rows = int(manager.ctx.config.get(SEGMENT_ROWS))
    for _ in range(max(1, retries)):
        with manager._ds_lock(name):
            ds = store._datasources.get(name)
            if ds is None or getattr(ds, "is_partial", False):
                return None
            if not force \
                    and len(ds.segments) < manager.compact_min_segments:
                return None
            if len(ds.segments) <= 1 or ds.num_rows == 0:
                return None     # nothing to roll up
            iv = store.datasource_version(name)
        # -- build outside the lock: live producers keep streaming --------
        new_ds = rebuild_time_partitioned(ds, target_rows=target_rows)
        with manager._ds_lock(name):
            if store._datasources.get(name) is not ds \
                    or store.datasource_version(name) != iv \
                    or name in manager._tail_ds:
                # an append won the race (or its chain is still waiting
                # on a covering fsync) — swapping the base under an
                # in-flight chain could drop its rows from a later
                # build, so rebuild against the new tail instead
                continue
            return _publish_generation(manager, name, ds, new_ds, iv)
    return None


def _publish_generation(manager, name: str, old_ds, new_ds,
                        ingest_version: int) -> dict:
    """Commit phase. Caller holds the datasource build lock, so the
    registered state cannot move under us; the manager lock covers the
    shared bookkeeping."""
    with manager.lock:
        covered = manager._covered_seq(name)
        inj = manager.fault
        if inj is not None:
            # chaos site: a publish-time failure (disk full / fsync
            # error mid-swap). Fired BEFORE the swap starts, and
            # write_snapshot itself cleans up its tmp dir on failure —
            # either way the old generation stays fully readable and
            # the WAL is untouched.
            inj.fire("compact.publish", key=name)
        manifest = SNAP.write_snapshot(
            manager._ds_root(name), new_ds, ingest_version, covered,
            keep=manager.keep, encode=manager.encode)
        # the new generation is durable — only now may the journal
        # records it covers go (a crash here replays nothing onto it;
        # a crash before the replace recovers the old generation + WAL)
        manager._wal_for(name).truncate_through(covered)
        # quiet in-memory swap: identical rows under the SAME ingest
        # version — result caches stay valid and rollup staleness does
        # not move (store.restore pins the version; no register event,
        # no dirty mark)
        manager.ctx.store.restore(new_ds, ingest_version)
        manager._dirty.discard(name)
        manager.counters["compactions"] += 1
        manager.counters["compacted_segments"] += max(
            0, len(old_ds.segments) - len(new_ds.segments))
        return {"datasource": name, "version": ingest_version,
                "segments_before": len(old_ds.segments),
                "segments_after": len(new_ds.segments),
                "rows": int(manifest["num_rows"]),
                "bytes": int(manifest["bytes"]),
                "snapshot_version": int(manifest["snapshot_version"])}
