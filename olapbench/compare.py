"""The comparison that decides ``correct``.

Once the window has closed, a sample of the window's distinct statement
texts, drawn from the seed (``SAMPLE_PER_TEMPLATE`` texts of each
template, or all it sent), is answered again by the plain reference
(each template's ``reference``, numpy over the generated table), and
every answer the window got back for those texts is held against it:

- ``wrong_answers``: answers whose columns, rows, group keys, integer
  values or ORDER BY order differ from the reference's (limit 0);
- ``float_err``, where the configuration's ``guarantees`` state it: the
  largest difference of a float value from the reference's float64
  value, as a share of the sum of the magnitudes of the values it adds up
  (of their mean for an average; of the value itself for a ratio of
  sums) (limit: the configuration's ``guarantees.float_err``);
- ``unanswered``: statements of the whole window that got no answer (no
  HTTP status, or a 5xx) (limit 0);
- ``refused``: statements of the whole window that the deployment's
  admission control refused (HTTP 429) (limit 0: every mix keeps its
  statements in flight within the interactive lane's slots and queue, so
  a refusal departs from the deployment as its configuration states it).

``control`` puts the reference computed in float32 in the program's
place, through the same comparison.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from olapbench.plain import Plain

SAMPLE_PER_TEMPLATE = 4
SAMPLE_STREAM = 1 << 21     # rng stream of the sample


def sample_texts(results: dict, seed: int,
                 per_template: int = SAMPLE_PER_TEMPLATE) -> List[int]:
    """Text ids to compare: up to ``per_template`` answered texts of each
    template, drawn from the seed."""
    by_tpl: Dict[str, set] = defaultdict(set)
    for r in results["records"]:
        if r["status"] == 200:
            by_tpl[r["template"]].add(r["text"])
    rng = np.random.default_rng([seed, SAMPLE_STREAM])
    out = []
    for name in sorted(by_tpl):
        ids = sorted(by_tpl[name])
        k = min(per_template, len(ids))
        out.extend(int(i) for i in rng.choice(ids, k, replace=False))
    return out


def _norm_key(v):
    if isinstance(v, (np.integer, int)) and not isinstance(v, bool):
        return int(v)
    if isinstance(v, (np.floating, float)):
        return float(v)
    return str(v)


def judge(ref: pd.DataFrame, keys: Sequence[str],
          scales: Dict[str, np.ndarray], order: Sequence[Tuple[str, bool]],
          columns: Sequence[str],
          rows: Sequence[dict]) -> Tuple[Optional[str], float]:
    """``(fault, float_err)`` of one answer against the reference: the
    first structural or exact difference found (None when there is none)
    and the largest difference of its float values, each as a share of
    its scale in ``scales`` (of the reference value without one)."""
    if list(columns) != list(ref.columns):
        return f"columns {list(columns)} != {list(ref.columns)}", 0.0
    if len(rows) != len(ref):
        return f"{len(rows)} rows != {len(ref)}", 0.0
    for i in range(1, len(rows)):       # the ORDER BY order
        for col, asc in order:
            a, b = rows[i - 1][col], rows[i][col]
            if a == b:
                continue
            if (a < b) != asc:
                return f"row {i} out of ORDER BY order on {col}", 0.0
            break
    want = {tuple(_norm_key(ref[c].iat[i]) for c in keys): i
            for i in range(len(ref))}
    err = 0.0
    for r in rows:
        k = tuple(_norm_key(r[c]) for c in keys)
        if k not in want:
            return f"group {k} not in the reference", err
        i = want.pop(k)
        for c in ref.columns:
            if c in keys:
                continue
            a, b = r[c], ref[c].iat[i]
            if ref[c].dtype.kind in "iub":
                if a is None or int(a) != int(b):
                    return f"{c} of {k}: {a} != {b}", err
            else:
                if a is None:
                    return f"{c} of {k}: null", err
                a, b = float(a), float(b)
                scale = float(scales[c][i]) if c in scales else abs(b)
                if a != b:
                    err = max(err, abs(a - b) / scale if scale else np.inf)
    return None, err


def check(table, tpls, results: dict, seed: int, guarantees: dict,
          float_dtype=None) -> dict:
    """The numbers compared, each with its limit, and the verdict.

    With ``float_dtype`` the answers judged are not the program's but the
    reference's own in that precision (the control)."""
    texts = results["texts"]
    by_text: Dict[int, List[dict]] = defaultdict(list)
    for r in results["records"]:
        by_text[r["text"]].append(r)
    unanswered = sum(1 for r in results["records"]
                     if r["status"] == 0 or r["status"] >= 500)
    refused = sum(1 for r in results["records"] if r["status"] == 429)
    wrong, err, compared, faults = 0, 0.0, 0, []
    for tid in sample_texts(results, seed):
        rec0 = by_text[tid][0]
        tpl = tpls[rec0["template"]]
        P = Plain(table)
        ref = tpl.reference(table, rec0["params"], P)
        if float_dtype is not None:
            ctl = tpl.reference(table, rec0["params"],
                                Plain(table, float_dtype))
            if tpl.ORDER:
                ctl = ctl.sort_values([c for c, _ in tpl.ORDER],
                                      ascending=[a for _, a in tpl.ORDER],
                                      kind="stable")
            answers = [{"columns": list(ctl.columns),
                        "rows": ctl.to_dict("records")}]
        else:
            answers = [json.loads(results["bodies"][r["body"]])
                       for r in by_text[tid] if r["status"] == 200]
        for a in answers:
            fault, e = judge(ref, P.keys, P.scales, tpl.ORDER,
                             a["columns"], a["rows"])
            compared += 1
            err = max(err, e)
            if fault is not None:
                wrong += 1
                faults.append(f"{rec0['template']}: {fault} "
                              f"[{texts[tid][:200]}]")
    numbers = {"wrong_answers": {"value": wrong, "limit": 0}}
    if "float_err" in guarantees:
        numbers["float_err"] = {"value": err,
                                "limit": guarantees["float_err"]}
    numbers["unanswered"] = {"value": unanswered, "limit": 0}
    numbers["refused"] = {"value": refused, "limit": 0}
    ok = all(v["value"] <= v["limit"] for v in numbers.values())
    return {"correct": ok, "numbers": numbers, "compared": compared,
            "faults": faults[:5]}
