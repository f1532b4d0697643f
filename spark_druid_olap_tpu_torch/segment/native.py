"""Loader and Python binding of the native string encoder.

Port of ``spark_druid_olap_tpu/segment/native.py`` (``load``, ``_build``,
``encode_strings``, ``_string_col_buffers``, ``encode_json_rows``). ``csrc/segment_encoder.cpp`` (a copy of
``native/segment_encoder.cpp``) is built with g++ into a CPython extension
at first use, never at import, into ``build/torch_ext/`` beside the CUDA
kernels (never beside its source), and rebuilt when the source is newer
than the build. :func:`encode_strings` is the fast path of
``segment.column.build_dim_column``: Arrow turns the column into UTF-8
buffers (C++ inside pyarrow), and the extension sorts, deduplicates and
encodes them with the GIL released, so the ingest thread pool encodes
columns in parallel.

Where g++ or pyarrow is missing, callers take the numpy path (the same
dictionaries and codes, slower), as the JAX package does.
:func:`encode_json_rows` is the HTTP tier's row encoder
(``server/http.py``): the extension writes the ``"rows"`` array of a
result frame with the GIL released; where it declines, the server's
Python encoder writes the same JSON.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("sdot.native")

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "segment_encoder.cpp"
_SO = Path(__file__).resolve().parents[2] / "build" / "torch_ext" \
    / "_sdot_native_torch.so"

_lock = threading.Lock()
_module = None
_tried = False


def _build() -> bool:
    inc = sysconfig.get_path("include")
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           f"-I{inc}", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError) as e:
        log.warning("native build failed (%s); using numpy ingest path", e)
        return False


def load():
    """The native module, or None when it cannot be built or loaded."""
    global _module, _tried
    with _lock:
        if _module is not None or _tried:
            return _module
        _tried = True
        if not _SRC.exists():
            return None
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            import importlib.util
            spec = importlib.util.spec_from_file_location("_sdot_native",
                                                          str(_SO))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _module = mod
        except Exception as e:  # noqa: BLE001
            log.warning("native load failed (%s)", e)
            _module = None
        return _module


def pyarrow_version() -> Optional[str]:
    try:
        import pyarrow as pa
    except ImportError:
        return None
    return pa.__version__


def encode_strings(raw) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Fast path: string column (numpy object array or pandas Series; an
    Arrow-backed Series converts zero-copy) -> (dictionary object array
    sorted ascending, int32 codes). None when unavailable or ineligible
    (nulls, a type Arrow cannot take as strings)."""
    mod = load()
    if mod is None:
        return None
    try:
        import pyarrow as pa
    except ImportError:
        return None
    try:
        if isinstance(raw, np.ndarray):
            arr = pa.array(raw, type=pa.string())
        else:
            arr = pa.Array.from_pandas(raw)
            if pa.types.is_large_string(arr.type):
                if arr.nbytes < (1 << 31) - 1:
                    arr = arr.cast(pa.string())
                else:
                    return None
            elif not pa.types.is_string(arr.type):
                arr = arr.cast(pa.string())
    except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
        return None
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if arr.null_count:
        return None
    if arr.offset != 0:
        arr = pa.concat_arrays([arr])      # realign
    bufs = arr.buffers()                   # [validity, offsets, data]
    offsets = bufs[1]
    data = bufs[2] if bufs[2] is not None else b""
    codes_b, dict_data, dict_off_b = mod.encode_utf8(data, offsets)
    codes = np.frombuffer(codes_b, dtype=np.int32).copy()
    k = len(np.frombuffer(dict_off_b, dtype=np.int32)) - 1
    dict_arr = pa.StringArray.from_buffers(
        k, pa.py_buffer(dict_off_b), pa.py_buffer(dict_data))
    dictionary = np.asarray(dict_arr.to_pandas(), dtype=object)
    return dictionary, codes


def _string_col_buffers(series):
    """object/string column -> (data, offsets, valid_u8) arrow buffers, or
    None when not string-like."""
    import pyarrow as pa
    try:
        arr = pa.array(series, type=pa.string(), from_pandas=True)
    except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
        return None
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if arr.offset != 0:
        arr = pa.concat_arrays([arr])
    valid = None
    if arr.null_count:
        import pyarrow.compute as pc
        valid = np.asarray(pc.is_valid(arr)).astype(np.uint8)
        arr = arr.fill_null("")
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        if arr.offset != 0:
            arr = pa.concat_arrays([arr])
    bufs = arr.buffers()
    data = bufs[2] if bufs[2] is not None else b""
    return data, bufs[1], valid


def encode_json_rows(df) -> Optional[bytes]:
    """Fast path for the serving tier: DataFrame -> JSON rows-array bytes
    (the ``"rows": [...]`` payload), encoded in C++ with the GIL released.
    Returns None when the native module is unavailable or a column type is
    not supported (the caller falls back to the Python json path)."""
    mod = load()
    if mod is None or not hasattr(mod, "encode_json_rows"):
        return None
    try:
        import pyarrow  # noqa: F401 — string columns go through Arrow
    except ImportError:
        return None
    import json as _json
    names = []
    cols = []
    n = len(df)
    for c in df.columns:
        s = df[c]
        dt = s.dtype
        names.append((_json.dumps(str(c)) + ":").encode())
        if dt == object or str(dt).startswith(("string", "str")):
            r = _string_col_buffers(s)
            if r is None:
                return None
            data, offsets, valid = r
            cols.append((2, data, offsets, valid))
            continue
        if not isinstance(dt, np.dtype):
            return None        # extension dtypes (categorical, nullable...)
        if np.issubdtype(dt, np.floating):
            cols.append((0, np.ascontiguousarray(s.to_numpy(np.float64)),
                         None, None))
        elif np.issubdtype(dt, np.bool_):
            cols.append((3, np.ascontiguousarray(
                s.to_numpy()).astype(np.uint8), None, None))
        elif np.issubdtype(dt, np.integer):
            if np.issubdtype(dt, np.unsignedinteger) and dt.itemsize == 8:
                v = s.to_numpy()
                if len(v) and int(v.max()) > np.iinfo(np.int64).max:
                    return None   # would wrap negative through int64
            cols.append((1, np.ascontiguousarray(s.to_numpy(np.int64)),
                         None, None))
        elif np.issubdtype(dt, np.datetime64):
            v = s.to_numpy()
            valid = (~np.isnat(v)).astype(np.uint8)
            ms = v.astype("datetime64[ms]").astype(np.int64)
            cols.append((4, np.ascontiguousarray(ms), None,
                         valid if (valid == 0).any() else None))
        else:
            return None
    try:
        return mod.encode_json_rows(tuple(names), tuple(cols), n)
    except Exception as e:  # noqa: BLE001
        log.warning("native json encode failed (%s)", e)
        return None
