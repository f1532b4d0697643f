"""Whether torch.profiler records the port's own kernels, and when not.

    python3 scripts/torch_profiler_probe.py [--wait SECONDS]

``chip_smoke.py`` reads the card's busy time from torch.profiler, and a
profile that loses a kernel the run launched understates it. This script
builds the dense group-by kernel (B1), launches it on 6,000,000 synthetic
rows (K = 6, a row count and a float sum: one ``dense_groupby_threads``
and one ``dense_groupby_fold`` launch per call) under torch.profiler in
several arrangements, 5 profiles each, and counts the kernel records each
profile shows against the launches made:

- ``alone``: one call, host and card activities (as
  ``chip_smoke.profile_run`` records);
- ``alone_card_only``: one call, card activities only (as
  ``chip_smoke.pass_ms`` records);
- ``after_torch_kernel``: a PyTorch kernel, then the call;
- ``before_torch_kernel``: the call, then a PyTorch kernel;
- ``before_sleep``: the call, then a 2 ms sleep kernel;
- ``three_calls``: three calls in one profile;
- ``new_thread``: one call from a thread started inside the profile;

then ``alone`` again after each of four histories, as a long
``chip_smoke.py`` run builds them up: 200 threads that each launched
PyTorch kernels and ended; 50 earlier profiles of 1,000 PyTorch kernels
each; all but 2 GiB of the card's free memory held by PyTorch (released
after); one ``chip_smoke.device_ms`` timing of the call (CUDA events, L2
flushes, a sleep kernel ahead of each timed call).

With ``--wait``, the process then idles that long on the host and
profiles each of these 10 times: the call and a PyTorch kernel; the
PyTorch kernel alone; a 3 ms sleep kernel, then the call; the call, then
a 3 ms sleep kernel; the call and a PyTorch kernel inside a window
widened by a host sleep of 10 ms, 100 ms and 1 s on either side. They
show whether records go missing as the process ages, whether PyTorch's
own kernels go too, and whether a kernel near the window's edge or
outside it is what is lost.

Prints one JSON line with the card's name and power limit. Needs one
NVIDIA GPU and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

PROFILES = 5


def records(prof) -> dict:
    """Kernel records in a finished profile: the port's B1 by name, and
    PyTorch's own kernels (``torch_kernels``)."""
    out = {"torch_kernels": 0}
    for e in prof.key_averages():
        if not CS.on_device(e) or e.key.startswith("Mem"):
            continue
        m = re.search(r"\bdense_groupby_\w+", e.key)
        k = m.group(0) if m else "torch_kernels"
        out[k] = out.get(k, 0) + e.count
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wait", type=float, default=0.0,
                    help="host seconds to idle before the aged profiles")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profiler_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG
    from spark_druid_olap_tpu_torch.ops.groupby import AggInput
    smi = CS.nvidia_smi()
    CG.library()
    rng = np.random.default_rng(CS.SEED)
    n, n_keys = 6_000_000, 6
    key = torch.from_numpy(
        rng.integers(0, n_keys + 1, n, dtype=np.int32)).cuda()
    vals = torch.from_numpy(rng.random(n, dtype=np.float32)).cuda()
    inputs = [AggInput("n", "count"), AggInput("s", "sum", vals)]
    other = torch.zeros(1 << 20, device="cuda")

    def call():
        CG.dense_groupby_kernel(key, n_keys, inputs, 64)

    def in_thread():
        t = threading.Thread(target=call)
        t.start()
        t.join()

    arrangements = {
        "alone": (call, 1, True),
        "alone_card_only": (call, 1, False),
        "after_torch_kernel": (lambda: (other.add_(1.0), call()), 1, True),
        "before_torch_kernel": (lambda: (call(), other.add_(1.0)), 1, True),
        "before_sleep": (lambda: (call(), torch.cuda._sleep(
            CS.SLEEP_CYCLES)), 1, True),
        "three_calls": (lambda: (call(), call(), call()), 3, True),
        "new_thread": (in_thread, 1, True),
    }
    call()
    torch.cuda.synchronize()
    out = {}
    for name, (fn, calls, host) in arrangements.items():
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                          if host else [])
        seen = []
        for _ in range(PROFILES):
            before = CG.launches
            with profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            seen.append(dict(records(prof),
                             launches=CG.launches - before))
        out[name] = {"calls_per_profile": calls, "profiles": seen}

    def threads():
        for _ in range(200):
            t = threading.Thread(target=lambda: other.add_(1.0))
            t.start()
            t.join()

    def profiles():
        for _ in range(50):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                for _ in range(1000):
                    other.add_(1.0)
                torch.cuda.synchronize()

    held = []

    def memory():
        free = torch.cuda.mem_get_info()[0]
        held.append(torch.empty(max(free - (2 << 30), 0), dtype=torch.uint8,
                                device="cuda"))

    def profiled_calls(fn, profiles=PROFILES):
        seen = []
        for _ in range(profiles):
            before = CG.launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            seen.append(dict(records(prof),
                             launches=CG.launches - before))
        return {"calls_per_profile": 1, "profiles": seen}

    fn = arrangements["alone"][0]
    for name, history in (("after_200_threads", threads),
                          ("after_50_profiles", profiles),
                          ("with_memory_held", memory),
                          ("after_device_ms", lambda: CS.device_ms(call))):
        held.clear()
        history()
        torch.cuda.synchronize()
        out[name] = profiled_calls(fn)
    held.clear()
    if args.wait > 0:
        time.sleep(args.wait)
        sleep = 3 * CS.SLEEP_CYCLES // 2          # ~3 ms
        for name, aged in (
                ("aged_alone", lambda: (call(), other.add_(1.0))),
                ("aged_torch_kernel_alone", lambda: other.add_(1.0)),
                ("aged_sleep_then_call",
                 lambda: (torch.cuda._sleep(sleep), call())),
                ("aged_call_then_sleep",
                 lambda: (call(), torch.cuda._sleep(sleep))),
                *((f"aged_window_widened_{pad}s",
                   lambda pad=pad: (time.sleep(pad), call(),
                                    other.add_(1.0),
                                    torch.cuda.synchronize(),
                                    time.sleep(pad)))
                  for pad in (0.01, 0.1, 1.0))):
            out[name] = profiled_calls(aged, 10)
    print(json.dumps({"probe": "torch_profiler", "card": smi,
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "rows": n, "n_keys": n_keys, "wait_s": args.wait,
                      "arrangements": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
