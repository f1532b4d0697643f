"""Build and load the port's hand-written CUDA kernels.

Each kernel source in ``csrc/`` has a plain C interface. It is compiled at
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared
library under ``build/torch_ext/`` (gitignored) and loaded with ``ctypes``:
no PyTorch headers, so a build takes seconds. The library's file name
carries a digest of the source and of every header in ``csrc/``, so an
edited source never loads a stale build. A lock per source serializes its
builds within a process (two engines may race on a first build) while
different sources build at once; the compiler writes to a per-process
temporary file that is renamed into place, so processes that build at once
do not clobber each other.

The JAX package has no counterpart: its Pallas kernels compile through XLA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"

_locks_lock = threading.Lock()
_locks: Dict[str, threading.Lock] = {}
_built: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "csrc/*.cu on a machine with the CUDA toolkit")


def build(source: Path, extra_flags: Sequence[str] = ()
          ) -> Tuple[ctypes.CDLL, dict]:
    """Compile (once per source version) and load one kernel library.

    Returns the loaded library and ``{"seconds", "log", "cached"}`` of the
    build; raises ``RuntimeError`` with the compiler's output when ``nvcc``
    fails.
    """
    with _locks_lock:
        lock = _locks.setdefault(str(source), threading.Lock())
    with lock:
        if str(source) in _built:
            return _built[str(source)]
        h = hashlib.sha256(source.read_bytes())
        for hdr in sorted(CSRC.glob("*.cuh")):
            h.update(hdr.read_bytes())
        h.update(" ".join(extra_flags).encode())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"
        t0 = time.perf_counter()
        log = ""
        cached = so.exists()
        if not cached:
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-Xptxas=-v", *extra_flags,
                   "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC),
                   "-o", str(tmp), str(source)]
            r = subprocess.run(cmd, capture_output=True, text=True)
            log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source.name} "
                                   f"({r.returncode}):\n{log}")
            os.replace(tmp, so)
        out = (ctypes.CDLL(str(so)),
               {"seconds": time.perf_counter() - t0, "log": log,
                "cached": cached})
        _built[str(source)] = out
        return out
