"""Where the port's wave kernel spends its time, on chip_smoke.py's storm.

    python3 scripts/torch_wave_split.py

Builds TPC-H SF1 lineitem and the 8-query storm's lane program exactly as
``chip_smoke.py`` does, checks the wave kernel against its plain version
once, then times (``chip_smoke.device_ms``: CUDA events, L2 flushed, median
of 7, the host's enqueue hidden behind a sleep kernel):

- the kernel as the main path launches it (two rows from a shared-memory
  register file);
- the kernel with its one-row register file in local memory;
- the interpreter alone: every lane's key count set to 0 in the program
  blob, so no row is live and no fold runs (what is left of the fold is
  one warp vote per lane and stretch);
- every instruction on the generic handler (no specialised handlers);
- programs of the storm's column loads alone and followed by 100 and 200
  chained int32 adds, with no fold: their difference gives the cost of one
  interpreted instruction.

Prints one JSON line with the card's name and power limit. Needs one
NVIDIA GPU and imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402


def patched(CW, program, layout, dev, *, no_fold=False, generic=False):
    """A copy of ``program`` whose device blob has every lane's key count
    set to 0 (``no_fold``) and / or every instruction on the generic
    handler (``generic``)."""
    raw = bytearray(CW.blob_bytes(program, layout))
    ins = np.frombuffer(raw, CW.INSTR, len(program.instrs))
    if generic:
        ins["fast"] = 0
    if no_fold:
        lanes = np.frombuffer(raw, CW.LANE, len(layout.lanes),
                              -(-ins.nbytes // 8) * 8)
        lanes["n_keys"] = 0
    out = dataclasses.replace(program, _blobs={})
    out._blobs[dev] = torch.frombuffer(raw, dtype=torch.uint8).to(dev)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_wave_split: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import spark_druid_olap_tpu_torch as sdt
    from spark_druid_olap_tpu_torch.ir import expr as E
    from spark_druid_olap_tpu_torch.ir import spec as S
    from spark_druid_olap_tpu_torch.ops import cuda_wave as CW
    from spark_druid_olap_tpu_torch.planner import fusion as FU
    from spark_druid_olap_tpu_torch.tools.tpch import generate

    df = generate(CS.SF, seed=CS.SEED)["lineitem"]
    ctx = sdt.Context(dict(CS.STORM_CONFIG))
    ctx.ingest_dataframe("lineitem", df, time_column="l_shipdate")
    program, layout, cols = CS.compile_specs(
        ctx.engine, ctx.store.get("lineitem"),
        list(CS.storm_specs(S, E).values()), CW, FU)
    dev = cols[0].device              # the key of the program's blob cache
    want = CW.wave_reference(program, cols, layout)
    CS.compare_wave("storm", CW.wave_groupby(program, layout, cols), want,
                    layout)

    def ms(prog, file=None):
        return CS.device_ms(lambda: CW.wave_groupby(prog, layout, cols, file))

    loads = [i for i in program.instrs if CW.OPS[i[0]] == "load"]
    src = next(j for j, i in enumerate(loads)
               if CW.DTYPES[i[1]] == torch.int32)
    adds = {}
    for n_add in (0, 100, 200):
        code = [tuple(i[:3]) + (j,) + tuple(i[4:])
                for j, i in enumerate(loads)]
        for k in range(n_add):        # each add reads the one before it
            a = src if k == 0 else len(loads) + (k - 1) % 2
            code.append((CW.OP["add"], CW.DT[torch.int32], 0,
                         len(loads) + k % 2, a, src, CW.NONE, 0))
        synth = dataclasses.replace(program, instrs=code)
        adds[n_add] = ms(patched(CW, synth, layout, dev, no_fold=True))
    print(json.dumps({
        "card": CS.nvidia_smi(), "rows": int(cols[0].numel()),
        "instructions": len(program.instrs), "registers": program.n_regs,
        "lanes": len(layout.lanes),
        "register_file": layout.file,
        "kernel_ms": ms(program),
        "local_file_ms": ms(program, (1, False)),
        "interpreter_only_ms": ms(patched(CW, program, layout, dev,
                                          no_fold=True)),
        "generic_handlers_ms": ms(patched(CW, program, layout, dev,
                                          generic=True)),
        "loads_only_ms": adds[0], "loads_and_100_adds_ms": adds[100],
        "loads_and_200_adds_ms": adds[200],
        "ms_per_interpreted_instruction": (adds[200] - adds[100]) / 100}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
