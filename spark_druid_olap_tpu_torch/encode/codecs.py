"""Column codecs: bit-exact encode/decode between raw little-endian
arrays and compressed byte payloads.

Port counterpart of ``spark_druid_olap_tpu/encode/codecs.py``: a copy
kept inside the PyTorch package, which imports nothing of the JAX
package.

Druid segments store compressed columns (LZ4-framed dictionary codes,
RLE bitmaps, delta-packed timestamps); the reference repo delegated all
of that to the external Druid cluster. This module is the in-tree
replacement, restricted to codecs whose DECODED form is bit-identical
to the raw path — compression must never change an answer:

========  ====================================================
codec     layout (all integers little-endian, numpy semantics)
========  ====================================================
raw       ``arr.tobytes()`` — the identity codec (per-segment
          fallback when a chosen codec fails to shrink a chunk)
bitpack   frame-of-reference + fixed-width bit packing:
          ``packbits(arr - ref, bits)`` where ``bits`` covers
          ``max - min``. Dictionary codes, bools (1 bit), and
          narrow-range LONG metrics. Order-preserving — code
          compares stay valid on the decoded form.
rle       run-length runs: ``values[R] || lengths[R]`` (lengths
          int32). Sorted / low-cardinality columns.
fordelta  frame-of-reference + delta for monotone arrays (time
          days): first value + bit-packed ``diff(arr) - dmin``.
========  ====================================================

Every header is a small JSON-able dict carrying the codec name ``c``,
row count ``n``, logical dtype ``dt``, per-codec parameters, and (for
integer codecs) the chunk's value bounds ``vmin``/``vmax`` — zone maps
read straight off the header, so planning never decodes a payload.

Floats are never encoded (raw only): reordering or re-deriving float
payloads risks the bit-exactness contract this engine is built on.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

#: bump when a header/payload layout changes shape (the manifest's
#: ``encoding`` block records it; loaders reject newer versions)
ENCODING_VERSION = 1

RAW = "raw"
BITPACK = "bitpack"
RLE = "rle"
FORDELTA = "fordelta"

CODECS = (RAW, BITPACK, RLE, FORDELTA)

#: run lengths are stored i32 — a single segment never holds 2^31 rows
_LEN_DTYPE = np.dtype("<i4")


class EncodingError(ValueError):
    """A payload/header failed structural validation at decode time."""


# -- fixed-width bit packing (the primitive under bitpack + fordelta) ---------

def _pack_bits(vals: np.ndarray, bits: int) -> bytes:
    """Pack non-negative ints < 2**bits at ``bits`` per value, little
    bit order (value i occupies bits [i*bits, (i+1)*bits))."""
    if len(vals) == 0:
        return b""
    v = vals.astype(np.uint64, copy=False)
    shifts = np.arange(bits, dtype=np.uint64)
    m = ((v[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return np.packbits(m.reshape(-1), bitorder="little").tobytes()


def _unpack_bits(buf, n: int, bits: int) -> np.ndarray:
    """Inverse of :func:`_pack_bits` -> uint64[n]."""
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    total = n * bits
    raw = np.frombuffer(buf, dtype=np.uint8)
    if len(raw) * 8 < total:
        raise EncodingError(
            f"bitpack payload: {len(raw)} bytes < {n} x {bits} bits")
    b = np.unpackbits(raw, count=total, bitorder="little")
    m = b.reshape(n, bits).astype(np.uint64)
    shifts = np.arange(bits, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for j in range(bits):
        out |= m[:, j] << shifts[j]
    return out


def _as_int64(arr: np.ndarray) -> np.ndarray:
    """Lossless view of an int/bool array as int64 work values."""
    if arr.dtype.kind == "b":
        return arr.astype(np.int64)
    if arr.dtype.kind == "u" and arr.dtype.itemsize == 8:
        # uint64 > 2^63-1 would wrap; engine columns never store u8,
        # but refuse loudly rather than corrupt
        if len(arr) and int(arr.max()) > np.iinfo(np.int64).max:
            raise EncodingError("uint64 values exceed int64 range")
    return arr.astype(np.int64)


def _restore_dtype(vals64: np.ndarray, dt: np.dtype) -> np.ndarray:
    if dt.kind == "b":
        return vals64.astype(bool)
    return vals64.astype(dt)


# -- per-codec encode ---------------------------------------------------------

def _header(codec: str, arr: np.ndarray, **params) -> dict:
    h = {"c": codec, "n": int(len(arr)), "dt": arr.dtype.str}
    h.update(params)
    return h


def encode_raw(arr: np.ndarray) -> Tuple[bytes, dict]:
    return arr.tobytes(), _header(RAW, arr)


def encode_bitpack(arr: np.ndarray) -> Tuple[bytes, dict]:
    v = _as_int64(arr)
    if len(v) == 0:
        return b"", _header(BITPACK, arr, ref=0, bits=1, vmin=None,
                            vmax=None)
    vmin, vmax = int(v.min()), int(v.max())
    bits = max(1, int(vmax - vmin).bit_length())
    payload = _pack_bits((v - vmin).astype(np.uint64), bits)
    return payload, _header(BITPACK, arr, ref=vmin, bits=bits,
                            vmin=vmin, vmax=vmax)


def encode_rle(arr: np.ndarray) -> Tuple[bytes, dict]:
    v = _as_int64(arr)
    if len(v) == 0:
        return b"", _header(RLE, arr, runs=0, vmin=None, vmax=None)
    change = np.flatnonzero(np.diff(v)) + 1
    starts = np.concatenate([[0], change])
    lengths = np.diff(np.concatenate([starts, [len(v)]]))
    values = arr[starts]                      # logical dtype run values
    payload = values.tobytes() + lengths.astype(_LEN_DTYPE).tobytes()
    return payload, _header(RLE, arr, runs=int(len(starts)),
                            vmin=int(v.min()), vmax=int(v.max()))


def encode_fordelta(arr: np.ndarray) -> Tuple[bytes, dict]:
    v = _as_int64(arr)
    if len(v) == 0:
        return b"", _header(FORDELTA, arr, first=0, dmin=0, bits=1,
                            vmin=None, vmax=None)
    first = int(v[0])
    d = np.diff(v)
    dmin = int(d.min()) if len(d) else 0
    dmax = int(d.max()) if len(d) else 0
    bits = max(1, int(dmax - dmin).bit_length())
    payload = _pack_bits((d - dmin).astype(np.uint64), bits)
    return payload, _header(FORDELTA, arr, first=first, dmin=dmin,
                            bits=bits, vmin=int(v.min()),
                            vmax=int(v.max()))


_ENCODERS = {RAW: encode_raw, BITPACK: encode_bitpack, RLE: encode_rle,
             FORDELTA: encode_fordelta}


def encode_array(arr: np.ndarray, codec: str) -> Tuple[bytes, dict]:
    """Encode one 1-D array chunk -> (payload bytes, JSON-able header).
    The caller (not this function) decides whether the result is worth
    keeping — see :func:`encode_chunk`."""
    if arr.ndim != 1:
        raise EncodingError(f"encode expects 1-D chunks, got {arr.shape}")
    try:
        enc = _ENCODERS[codec]
    except KeyError:
        raise EncodingError(f"unknown codec {codec!r}") from None
    return enc(arr)


def encode_chunk(arr: np.ndarray, codec: str) -> Tuple[bytes, dict]:
    """Encode with a per-chunk raw fallback: if the chosen codec fails
    to shrink THIS chunk (adversarial cardinality, degenerate runs) the
    chunk stays raw — a column-level choice never inflates a segment."""
    if codec == RAW:
        return encode_raw(arr)
    payload, header = encode_array(arr, codec)
    if len(payload) >= arr.nbytes:
        return encode_raw(arr)
    return payload, header


# -- decode -------------------------------------------------------------------

def decode_array(buf, header: dict) -> np.ndarray:
    """Decode a payload back to its raw little-endian array. Always
    returns a fresh writable array of the header's logical dtype;
    bit-identical to the chunk that was encoded."""
    codec = header.get("c")
    n = int(header["n"])
    dt = np.dtype(header["dt"])
    if codec == RAW:
        out = np.frombuffer(buf, dtype=dt, count=n)
        return out.copy()
    if codec == BITPACK:
        vals = _unpack_bits(buf, n, int(header["bits"])).astype(np.int64)
        vals += int(header["ref"])
        return _restore_dtype(vals, dt)
    if codec == RLE:
        runs = int(header["runs"])
        mv = memoryview(np.frombuffer(buf, dtype=np.uint8))
        vbytes = runs * dt.itemsize
        if len(mv) != vbytes + runs * _LEN_DTYPE.itemsize:
            raise EncodingError(
                f"rle payload: {len(mv)} bytes for {runs} runs of {dt}")
        values = np.frombuffer(mv[:vbytes], dtype=dt)
        lengths = np.frombuffer(mv[vbytes:], dtype=_LEN_DTYPE)
        if runs and int(lengths.sum()) != n:
            raise EncodingError("rle payload: run lengths do not sum to n")
        return np.repeat(values, lengths) if runs \
            else np.empty(0, dtype=dt)
    if codec == FORDELTA:
        if n == 0:
            return np.empty(0, dtype=dt)
        d = _unpack_bits(buf, n - 1, int(header["bits"])).astype(np.int64)
        d += int(header["dmin"])
        out = np.empty(n, dtype=np.int64)
        out[0] = int(header["first"])
        np.cumsum(d, out=out[1:]) if n > 1 else None
        out[1:] += int(header["first"])
        return _restore_dtype(out, dt)
    raise EncodingError(f"unknown codec {codec!r}")


def decoded_nbytes(header: dict) -> int:
    """Logical (decoded) byte size of a chunk, from its header alone."""
    return int(header["n"]) * np.dtype(header["dt"]).itemsize


def header_bounds(header: dict) -> Optional[Tuple[int, int]]:
    """(vmin, vmax) of an integer chunk without touching the payload —
    the encoded-domain zone map. None when the codec carries no bounds
    (raw/float) or the chunk is empty."""
    vmin, vmax = header.get("vmin"), header.get("vmax")
    if vmin is None or vmax is None:
        return None
    return int(vmin), int(vmax)


def rle_runs(buf, header: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(run values, run lengths) of an RLE chunk WITHOUT expanding to
    rows — the encoded form ``ops/groupby.py:run_weighted_partials``
    aggregates directly (count partials are the run lengths; sum
    partials multiply run values by run length)."""
    if header.get("c") != RLE:
        raise EncodingError(f"not an rle chunk: {header.get('c')!r}")
    dt = np.dtype(header["dt"])
    runs = int(header["runs"])
    mv = memoryview(np.frombuffer(buf, dtype=np.uint8))
    vbytes = runs * dt.itemsize
    values = np.frombuffer(mv[:vbytes], dtype=dt).copy()
    lengths = np.frombuffer(mv[vbytes:], dtype=_LEN_DTYPE).astype(np.int64)
    return values, lengths


# -- analytic size estimates (the chooser's input; no encode performed) -------

def estimate_sizes(arr: np.ndarray) -> Dict[str, int]:
    """Estimated encoded payload bytes per eligible codec for one whole
    column (one O(n) pass: min/max, run count, monotonicity). Floats
    and empty arrays return {} — raw only."""
    if arr.ndim != 1 or len(arr) == 0 or arr.dtype.kind == "f":
        return {}
    v = _as_int64(arr)
    n = len(v)
    out: Dict[str, int] = {}
    vmin, vmax = int(v.min()), int(v.max())
    bits = max(1, int(vmax - vmin).bit_length())
    out[BITPACK] = (n * bits + 7) // 8
    d = np.diff(v)
    runs = 1 + int(np.count_nonzero(d))
    out[RLE] = runs * (arr.dtype.itemsize + _LEN_DTYPE.itemsize)
    if n > 1 and bool((d >= 0).all()):
        dmin, dmax = int(d.min()), int(d.max())
        dbits = max(1, int(dmax - dmin).bit_length())
        out[FORDELTA] = ((n - 1) * dbits + 7) // 8
    return out
