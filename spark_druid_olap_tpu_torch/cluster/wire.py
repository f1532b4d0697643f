"""Pickle-free wire format for subquery results.

Port of ``spark_druid_olap_tpu/cluster/wire.py``, copied whole (the
partitioned join's ``encode_join_exec`` / ``decode_join_exec`` included):
for the same input its frames are the JAX package's byte for byte.

Layout: ``b"SDW1" + uint32le(header_len) + header_json + buffers +
uint32le(crc32 of everything before it)``.
Numeric / datetime columns travel as raw little-endian buffers described
by ``dtype.str`` + shape in the header (2-D shapes carry partial sketch
register blocks); long-run 1-D integer columns (granular time buckets,
dictionary codes) ship RLE-compressed instead when that shrinks them,
with the codec chunk header inline in the frame header — fully
self-describing, no cross-node config; object columns (decoded strings,
wide ints, None nulls) travel as JSON lists — Python ints survive JSON with arbitrary
precision, which is what keeps exact int128-ish sums exact across the
wire. No pickle anywhere: a historical's RPC port must not be a
remote-code-execution port.

The CRC32 trailer makes a truncated or bit-flipped frame *detectable*:
without it a corrupted raw LE buffer decodes into plausible garbage and
silently poisons the broker merge. ``decode_result`` raises ValueError
on mismatch and the broker treats that as a retryable failure (ask a
replica) rather than trusting the bytes.
"""

from __future__ import annotations

import json
import math
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"SDW1"
_LEN = struct.Struct("<I")


def _jsonable_cell(v: Any):
    if v is None:
        return None
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and not math.isfinite(v):
        # JSON has no NaN/Inf literal worth trusting cross-parser; a
        # non-finite float in an object column is a null cell
        return None
    return v


def _maybe_rle(arr: np.ndarray):
    """RLE chunk for a 1-D integer result column, or None when it would
    not shrink. Broker-bound partials are dominated by granular time
    buckets and dictionary codes — long-run columns — so shipping runs
    instead of rows cuts shard-merge traffic for free. Self-describing:
    the codec header (encode/codecs.py) travels IN the frame header, so
    encoder and decoder can never disagree about the layout and no
    config key has to match across nodes."""
    if arr.ndim != 1 or arr.dtype.kind not in "iub" or len(arr) < 64:
        return None
    from spark_druid_olap_tpu_torch.encode import codecs as EN
    try:
        payload, header = EN.encode_array(arr, EN.RLE)
    except EN.EncodingError:
        return None
    if len(payload) >= arr.nbytes:
        return None
    return payload, header


def encode_result(columns: List[str], data: Dict[str, np.ndarray],
                  stats: Optional[dict] = None) -> bytes:
    n = int(len(data[columns[0]])) if columns else 0
    header: Dict[str, Any] = {"n": n, "stats": stats or {}, "cols": []}
    bufs: List[bytes] = []
    for name in columns:
        arr = np.asarray(data[name])
        if arr.dtype == object:
            header["cols"].append({
                "name": name, "kind": "obj",
                "values": [_jsonable_cell(v) for v in arr.tolist()]})
        else:
            arr = np.ascontiguousarray(arr)
            rle = _maybe_rle(arr)
            if rle is not None:
                payload, eh = rle
                header["cols"].append({
                    "name": name, "kind": "enc", "dtype": arr.dtype.str,
                    "shape": list(arr.shape), "nbytes": len(payload),
                    "enc": eh})
                bufs.append(payload)
                continue
            raw = arr.tobytes()
            header["cols"].append({
                "name": name, "kind": "bin", "dtype": arr.dtype.str,
                "shape": list(arr.shape), "nbytes": len(raw)})
            bufs.append(raw)
    hb = json.dumps(header, separators=(",", ":")).encode("utf-8")
    body = b"".join([MAGIC, _LEN.pack(len(hb)), hb] + bufs)
    return body + _LEN.pack(zlib.crc32(body))


def decode_result(payload: bytes) -> Tuple[List[str], Dict[str, np.ndarray],
                                           dict]:
    """-> (columns, data, stats). Raises ValueError on a malformed frame."""
    if len(payload) < 12 or payload[:4] != MAGIC:
        raise ValueError("bad wire magic")
    (crc,) = _LEN.unpack_from(payload, len(payload) - 4)
    if zlib.crc32(payload[:-4]) != crc:
        raise ValueError("wire CRC mismatch (truncated or corrupt frame)")
    payload = payload[:-4]
    (hlen,) = _LEN.unpack_from(payload, 4)
    off = 8 + hlen
    header = json.loads(payload[8:off].decode("utf-8"))
    columns: List[str] = []
    data: Dict[str, np.ndarray] = {}
    for col in header["cols"]:
        name = col["name"]
        columns.append(name)
        if col["kind"] == "obj":
            vals = col["values"]
            arr = np.empty(len(vals), dtype=object)
            for i, v in enumerate(vals):
                arr[i] = v
            data[name] = arr
        elif col["kind"] == "enc":
            from spark_druid_olap_tpu_torch.encode import codecs as EN
            nb = int(col["nbytes"])
            try:
                arr = EN.decode_array(payload[off:off + nb], col["enc"])
            except (EN.EncodingError, KeyError) as e:
                raise ValueError(f"bad encoded wire column {name}: {e}") \
                    from e
            if arr.dtype.str != col["dtype"] or arr.shape != \
                    tuple(col["shape"]):
                raise ValueError(
                    f"encoded wire column {name}: decoded "
                    f"{arr.dtype.str}{list(arr.shape)}, header says "
                    f"{col['dtype']}{col['shape']}")
            data[name] = arr
            off += nb
        else:
            nb = int(col["nbytes"])
            arr = np.frombuffer(payload[off:off + nb],
                                dtype=np.dtype(col["dtype"]))
            data[name] = arr.reshape(col["shape"]).copy()
            off += nb
    return columns, data, header.get("stats", {})


def patch_subquery(body: bytes, shard_ds: str,
                   epoch: Optional[int] = None) -> bytes:
    """Retarget an encoded subquery at one shard store and stamp the
    broker's plan epoch into the request envelope. Decoding the JSON
    once per shard beats re-running full spec serde per shard.

    ``clusterEpoch`` is an envelope field, not part of the query spec:
    the historical pops it before serde (:func:`split_subquery`) and
    uses it to learn which epoch the requesting broker has swapped to —
    the signal that old-epoch-only shard stores can be retired."""
    d = json.loads(body.decode("utf-8"))
    d["dataSource"] = shard_ds
    if epoch is not None:
        d["clusterEpoch"] = int(epoch)
    return json.dumps(d, separators=(",", ":")).encode("utf-8")


def split_subquery(raw: bytes) -> Tuple[dict, Optional[int]]:
    """Decode a subquery request into (spec dict, clusterEpoch or None),
    removing the envelope field so spec serde sees only the query."""
    d = json.loads(raw.decode("utf-8"))
    ep = d.pop("clusterEpoch", None)
    return d, (int(ep) if ep is not None else None)


_JOIN_MAGIC = b"SDJ1"


def encode_join_exec(spec: dict,
                     sides: Dict[str, Tuple[List[str],
                                            Dict[str, np.ndarray]]]) -> bytes:
    """One partitioned-join exec request: ``b"SDJ1" + uint32le(header_len)
    + header_json + side frames + uint32le(crc32)``. Each side ("probe",
    "build") is a full SDW1 result frame (same codec path as shard
    partials — RLE'd code columns, JSON object columns, CRC per frame),
    concatenated in header order with lengths in the header. ``spec`` is
    the JSON-safe lowered join plan (keys, group-by, aggs, residual as
    serde expr dicts) — no pickle, same RCE posture as subqueries."""
    frames = [(name, encode_result(cols, data))
              for name, (cols, data) in sides.items()]
    header = {"spec": spec,
              "frames": [{"side": name, "nbytes": len(fb)}
                         for name, fb in frames]}
    hb = json.dumps(header, separators=(",", ":")).encode("utf-8")
    body = b"".join([_JOIN_MAGIC, _LEN.pack(len(hb)), hb]
                    + [fb for _, fb in frames])
    return body + _LEN.pack(zlib.crc32(body))


def decode_join_exec(payload: bytes) -> Tuple[dict, Dict[str, Tuple[
        List[str], Dict[str, np.ndarray]]]]:
    """-> (spec, {side: (columns, data)}). ValueError on a bad frame."""
    if len(payload) < 12 or payload[:4] != _JOIN_MAGIC:
        raise ValueError("bad join wire magic")
    (crc,) = _LEN.unpack_from(payload, len(payload) - 4)
    if zlib.crc32(payload[:-4]) != crc:
        raise ValueError("join wire CRC mismatch (truncated or corrupt)")
    payload = payload[:-4]
    (hlen,) = _LEN.unpack_from(payload, 4)
    off = 8 + hlen
    header = json.loads(payload[8:off].decode("utf-8"))
    sides = {}
    for fr in header["frames"]:
        nb = int(fr["nbytes"])
        cols, data, _ = decode_result(payload[off:off + nb])
        sides[str(fr["side"])] = (cols, data)
        off += nb
    return header["spec"], sides


_INGEST_MAGIC = b"SDI1"


def encode_ingest(name: str, shard: str, batch_id: int, kwargs: dict,
                  body: bytes, src: str = "") -> bytes:
    """One pushed ingest batch: ``b"SDI1" + uint32le(header_len) +
    header_json + body + uint32le(crc32 of everything before it)``.
    ``body`` is the batch in the SAME Arrow-IPC encoding the WAL
    journals (persist/wal.py:encode_batch) — the broker pushes the
    exact bytes it committed, so owner and journal can never disagree
    about the rows. ``(src, batch_id)`` identifies the push: ``src`` is
    the broker's boot generation and ``batch_id`` its per-process push
    counter; owners dedup on the pair so a retried push never
    double-applies, and a restarted broker (fresh ``src``) never has
    its counter restart read as a replay."""
    header = {"name": name, "shard": shard, "batch": int(batch_id),
              "src": src, "kwargs": kwargs}
    hb = json.dumps(header, separators=(",", ":")).encode("utf-8")
    frame = b"".join([_INGEST_MAGIC, _LEN.pack(len(hb)), hb, body])
    return frame + _LEN.pack(zlib.crc32(frame))


def decode_ingest(payload: bytes) -> Tuple[dict, bytes]:
    """-> (header dict, body bytes). Raises ValueError on a malformed
    frame — same detectability contract as the subquery wire format."""
    if len(payload) < 12 or payload[:4] != _INGEST_MAGIC:
        raise ValueError("bad ingest wire magic")
    (crc,) = _LEN.unpack_from(payload, len(payload) - 4)
    if zlib.crc32(payload[:-4]) != crc:
        raise ValueError(
            "ingest wire CRC mismatch (truncated or corrupt frame)")
    payload = payload[:-4]
    (hlen,) = _LEN.unpack_from(payload, 4)
    off = 8 + hlen
    header = json.loads(payload[8:off].decode("utf-8"))
    return header, payload[off:]


def encode_error(kind: str, message: str, **extra) -> bytes:
    return json.dumps({"error": kind, "message": message, **extra},
                      separators=(",", ":")).encode("utf-8")


def decode_error(payload: bytes) -> dict:
    try:
        d = json.loads(payload.decode("utf-8", "replace"))
        if isinstance(d, dict) and "error" in d:
            return d
    except ValueError:
        pass
    return {"error": "Unknown", "message": payload[:200].decode(
        "utf-8", "replace")}
