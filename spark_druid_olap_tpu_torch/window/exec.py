"""Device-side window functions over the base query's result frame.

Port of ``spark_druid_olap_tpu/window/exec.py``. Each window call lowers to
torch functions on the context's device over integer partition / order
codes plus the argument column: a stable multi-key sort groups rows into
segment runs, a partition-boundary mask gives each row its segment's start
and end, and the function body is segmented scans or frame gathers; no host
loop over rows. Results scatter back to the original row order through the
permutation. The factorizing (codes from values) stays on the host, as in
the JAX package.

How the JAX primitives map:

- ``jnp.lexsort(keys[::-1] + (pid,))`` (pid primary, then ``keys[0]``, ...)
  is a chain of stable sorts, least significant key first
  (:func:`_lexsort`): the same order, ties in row order, so
  ``row_number`` over tied keys equals the JAX package's bit for bit.
- ``lax.associative_scan`` with reset flags is a segmented doubling scan
  (:func:`_segscan`): log2(n) steps of shift + ``where``; no value crosses
  a partition boundary, so min / max and integer sums are exact, and float
  sums equal the JAX package's to rounding (rtol 1e-6: the association
  order differs).
- ``lax.cummax`` is ``torch.cummax``.

String / object columns take part through sorted factorized codes
(``pd.factorize(sort=True)``): code order equals value order, so min / max
/ lag / lead over codes map back to values exactly.

Null semantics (shared with the pandas references in tests/test_window.py):
ORDER BY treats NULL as the LARGEST value (last ascending, first
descending); aggregate arguments skip NULLs (all-null frame -> NULL);
lag / lead return the stored value inside the partition (NULL included) and
the default only past its edge.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import pandas as pd
import torch

from spark_druid_olap_tpu_torch.window.plan import (OFFSET_FNS, RANKING_FNS,
                                                    WindowCol, WindowPlan,
                                                    WindowUnsupported)

_I64MAX = 2 ** 62     # in-band infinity for int min / max


# -- code building (host: factorize is a host operation) ----------------------

def _order_key(col: pd.Series, ascending: bool) -> np.ndarray:
    """Integer sort key for one ORDER BY column: sorted factorize codes
    with NULL mapped past the largest code, negated for DESC."""
    codes, uniq = pd.factorize(col, sort=True, use_na_sentinel=True)
    key = np.where(codes < 0, len(uniq), codes).astype(np.int64)
    return key if ascending else -key


def _partition_ids(df: pd.DataFrame, cols: Tuple[str, ...]) -> np.ndarray:
    if not cols:
        return np.zeros(len(df), dtype=np.int64)
    mats = []
    for c in cols:
        codes, _ = pd.factorize(df[c], sort=False, use_na_sentinel=False)
        mats.append(codes.astype(np.int64))
    if len(mats) == 1:
        return mats[0]
    _, pid = np.unique(np.stack(mats, axis=1), axis=0, return_inverse=True)
    return pid.reshape(-1).astype(np.int64)


def _prep_arg(col: pd.Series):
    """(values int64 / float64, valid mask, decoder) for an argument
    column. The decoder maps kernel-space values + validity back to the
    column's domain (datetime ticks, factorized object codes)."""
    a = col.to_numpy()
    if a.dtype.kind == "M":
        iv = a.astype("datetime64[ns]").view(np.int64)
        vm = ~np.isnat(a)

        def dec(v, ok):
            out = v.astype(np.int64).view("datetime64[ns]").copy()
            out[~ok] = np.datetime64("NaT")
            return out
        return np.where(vm, iv, 0), vm, dec
    if a.dtype.kind == "f":
        vm = ~np.isnan(a)

        def dec(v, ok):
            return np.where(ok, v, np.nan).astype(np.float64)
        return a.astype(np.float64), vm, dec
    if a.dtype.kind in "iub":
        vm = np.ones(len(a), dtype=bool)

        def dec(v, ok):
            v = np.asarray(v)
            if ok.all():
                return v.astype(np.int64)
            return np.where(ok, v.astype(np.float64), np.nan)
        return a.astype(np.int64), vm, dec
    # object / strings: sorted codes so code order == value order
    codes, uniq = pd.factorize(col, sort=True, use_na_sentinel=True)
    vm = codes >= 0

    def dec(v, ok):
        out = np.empty(len(v), dtype=object)
        vv = np.asarray(v).astype(np.int64)
        for i in range(len(v)):
            out[i] = uniq[vv[i]] if ok[i] else None
        return out
    return np.where(vm, codes, 0).astype(np.int64), vm, dec


# -- device functions ---------------------------------------------------------

def _lexsort(pid: torch.Tensor, keys) -> torch.Tensor:
    """The permutation of ``jnp.lexsort(keys[::-1] + (pid,))``: pid
    primary, then ``keys[0]``, ``keys[1]``, ...; ties keep row order. One
    stable sort per key, least significant first."""
    perm = torch.arange(pid.shape[0], device=pid.device)
    for k in list(keys[::-1]) + [pid]:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _segments(pid, n):
    """``(iota, boundary, seg_start, seg_end)`` over the SORTED pid."""
    iota = torch.arange(n, dtype=torch.int64, device=pid.device)
    head = torch.ones(1, dtype=torch.bool, device=pid.device)
    boundary = torch.cat([head, pid[1:] != pid[:-1]])
    seg_start = torch.cummax(torch.where(boundary, iota, 0), 0).values
    b_end = torch.cat([pid[:-1] != pid[1:], head])
    start_rev = torch.cummax(torch.where(b_end.flip(0), iota, 0), 0).values
    seg_end = (n - 1) - start_rev.flip(0)
    return iota, boundary, seg_start, seg_end


def _segscan(op, vals, boundary, reverse=False):
    """Segmented inclusive scan: ``op`` accumulates within a segment and
    resets at each boundary flag. A doubling scan over the associative
    combine ``(fa, va) . (fb, vb) = (fa | fb, fb ? vb : op(va, vb))``."""
    if reverse:
        return _segscan(op, vals.flip(0), boundary.flip(0)).flip(0)
    v, f = vals, boundary
    n, d = vals.shape[0], 1
    while d < n:
        nv = torch.where(f[d:], v[d:], op(v[:-d], v[d:]))
        nf = f[:-d] | f[d:]
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], nf])
        d *= 2
    return v


def _shift(a, k, fill):
    n = a.shape[0]
    if k == 0:
        return a
    if abs(k) >= n:
        return torch.full_like(a, fill)
    pad = torch.full((abs(k),), fill, dtype=a.dtype, device=a.device)
    if k > 0:
        return torch.cat([pad, a[:-k]])
    return torch.cat([a[-k:], pad])


def _unsort(a, perm):
    out = torch.empty_like(a)
    out[perm] = a
    return out


def _rank_kernel(pid, keys, fn: str):
    n = pid.shape[0]
    perm = _lexsort(pid, keys)
    sp = pid[perm]
    iota, boundary, seg_start, _ = _segments(sp, n)
    if fn == "row_number":
        out_sorted = iota - seg_start + 1
    else:
        head = torch.ones(1, dtype=torch.bool, device=pid.device)
        change = boundary
        for k in keys:
            sk = k[perm]
            change = change | torch.cat([head, sk[1:] != sk[:-1]])
        if fn == "rank":
            out_sorted = torch.cummax(torch.where(change, iota, 0),
                                      0).values - seg_start + 1
        else:                                   # dense_rank
            c = torch.cumsum(change.to(torch.int64), 0)
            c0 = torch.cummax(torch.where(boundary, c, 0), 0).values
            out_sorted = c - c0 + 1
    return _unsort(out_sorted, perm)


def _offset_kernel(pid, keys, vals, vm, k: int):
    """lag (k>0) / lead (k<0): (value, in_partition, value_valid)."""
    perm = _lexsort(pid, keys)
    sp = pid[perm]
    sv, svm = vals[perm], vm[perm]
    shifted = _shift(sv, k, 0)
    pin = _shift(sp, k, -1) == sp
    sok = _shift(svm, k, False)
    return (_unsort(shifted, perm), _unsort(pin, perm),
            _unsort(sok, perm))


def _agg_kernel(pid, keys, vals, vm, fn: str, frame):
    """Framed aggregate: returns (acc, cnt), the op-accumulated value over
    the frame's valid rows and the count of valid rows, both in original
    row order."""
    n = pid.shape[0]
    perm = _lexsort(pid, keys)
    sp = pid[perm]
    sv, svm = vals[perm], vm[perm]
    iota, boundary, seg_start, seg_end = _segments(sp, n)
    is_f = sv.is_floating_point()
    add = torch.add
    if fn in ("sum", "avg", "count"):
        op, identity = add, 0
    elif fn == "min":
        op, identity = torch.minimum, (float("inf") if is_f else _I64MAX)
    else:
        op, identity = torch.maximum, (float("-inf") if is_f else -_I64MAX)
    mv = torch.where(svm, sv, torch.full_like(sv, identity))
    cm = svm.to(torch.int64)
    p, f = frame
    if p is None:
        fwd_v = _segscan(op, mv, boundary)
        fwd_c = _segscan(add, cm, boundary)
        hi = seg_end if f is None else torch.minimum(iota + f, seg_end)
        acc, cnt = fwd_v[hi], fwd_c[hi]
    elif f is None:
        head = torch.ones(1, dtype=torch.bool, device=pid.device)
        b_end = torch.cat([sp[:-1] != sp[1:], head])
        rev_v = _segscan(op, mv, b_end, reverse=True)
        rev_c = _segscan(add, cm, b_end, reverse=True)
        lo = torch.maximum(iota - p, seg_start)
        acc, cnt = rev_v[lo], rev_c[lo]
    elif op is add:
        # a bounded sum subtracts prefix sums inside the segment, as the
        # JAX package does (float results to rounding, not bit for bit)
        fwd_v = _segscan(add, mv, boundary)
        fwd_c = _segscan(add, cm, boundary)
        hi = torch.minimum(iota + f, seg_end)
        lo = torch.maximum(iota - p, seg_start)
        base = torch.clamp(lo - 1, min=0)
        inner = lo > seg_start
        acc = fwd_v[hi] - torch.where(inner, fwd_v[base], 0)
        cnt = fwd_c[hi] - torch.where(inner, fwd_c[base], 0)
    else:
        # bounded min / max: the scan does not invert, so stack shifted
        # lanes across the frame (capped by sdot.window.max.frame)
        acc = torch.full((n,), identity, dtype=mv.dtype, device=mv.device)
        cnt = torch.zeros(n, dtype=torch.int64, device=mv.device)
        for k in range(-f, p + 1):
            skv = _shift(mv, k, identity)
            skc = _shift(cm, k, 0)
            ok = _shift(sp, k, -1) == sp
            acc = op(acc, torch.where(ok, skv, torch.full_like(skv,
                                                               identity)))
            cnt = cnt + torch.where(ok, skc, 0)
    return _unsort(acc, perm), _unsort(cnt, perm)


# -- per-call evaluation ------------------------------------------------------

def _compute(ctx, w: WindowCol, df: pd.DataFrame) -> np.ndarray:
    n = len(df)
    if n == 0:
        if w.fn in RANKING_FNS or w.fn == "count":
            return np.zeros(0, dtype=np.int64)
        return np.zeros(0, dtype=np.float64)
    device = ctx.engine.device

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    pid = dev(_partition_ids(df, w.part_cols))
    keys = tuple(dev(_order_key(df[c], asc)) for c, asc in w.order_cols)

    if w.fn in RANKING_FNS:
        return _rank_kernel(pid, keys, w.fn).cpu().numpy().astype(np.int64)

    if w.fn in OFFSET_FNS:
        vals, vm, dec = _prep_arg(df[w.arg_cols[0]])
        k = w.offset if w.fn == "lag" else -w.offset
        v, pin, ok = (t.cpu().numpy() for t in _offset_kernel(
            pid, keys, dev(vals), dev(vm), k))
        out = dec(v, pin & ok)
        if w.default is not None:
            edge = ~pin
            if out.dtype == object:
                out[edge] = w.default
            elif np.issubdtype(out.dtype, np.datetime64):
                out[edge] = np.datetime64(w.default)
            else:
                out = out.astype(np.float64) \
                    if isinstance(w.default, float) \
                    and out.dtype.kind != "f" else out
                out[edge] = w.default
        return out

    # framed aggregates
    frame = w.frame
    if frame is None:
        frame = (None, 0) if w.order_cols else (None, None)
    p, f = frame
    if p is not None and f is not None:
        from spark_druid_olap_tpu_torch.utils.config import WINDOW_MAX_FRAME
        cap = int(ctx.config.get(WINDOW_MAX_FRAME))
        if p + f + 1 > cap:
            raise WindowUnsupported(
                f"ROWS frame spans {p + f + 1} rows; cap is "
                f"sdot.window.max.frame={cap}")
    if w.fn == "count" and not w.arg_cols:
        vals = np.ones(n, dtype=np.int64)
        vm = np.ones(n, dtype=bool)
        dec = None
    else:
        vals, vm, dec = _prep_arg(df[w.arg_cols[0]])
        if w.fn in ("sum", "avg") and df[w.arg_cols[0]].dtype == object:
            raise WindowUnsupported(
                f"window {w.fn}() over a non-numeric column")
    acc, cnt = (t.cpu().numpy() for t in _agg_kernel(
        pid, keys, dev(vals), dev(vm), w.fn, frame))
    if w.fn == "count":
        return cnt.astype(np.int64)
    ok = cnt > 0
    if w.fn == "avg":
        return np.where(ok, acc.astype(np.float64)
                        / np.maximum(cnt, 1), np.nan)
    if w.fn == "sum":
        if acc.dtype.kind == "f" or not ok.all():
            return np.where(ok, acc.astype(np.float64), np.nan)
        return acc.astype(np.int64)
    # min / max map back through the argument decoder (datetime ticks,
    # object codes) so string and timestamp extremes round-trip exactly
    return dec(acc, ok)


# -- plan application ---------------------------------------------------------

def apply(ctx, plan: WindowPlan, df: pd.DataFrame) -> pd.DataFrame:
    """Compute the window columns over the base result frame and assemble
    the statement's output (deferred ORDER BY / LIMIT / OFFSET
    included)."""
    from spark_druid_olap_tpu_torch.ir import expr as E
    from spark_druid_olap_tpu_torch.utils import host_eval
    env: Dict[str, np.ndarray] = {c: df[c].to_numpy() for c in df.columns}
    for w in plan.windows:
        env[w.slot] = _compute(ctx, w, df)

    out = pd.DataFrame(index=df.index)
    helper = set(plan.aux_cols)
    base_cols = [c for c in df.columns if c not in helper]
    for it in plan.items:
        if it.expr == "*":
            for c in base_cols:
                out[c] = df[c]
            continue
        if isinstance(it.expr, E.Column) and it.expr.name in env:
            v = env[it.expr.name]
        else:
            v = np.asarray(host_eval.eval_expr(it.expr, env))
        out[it.name] = np.broadcast_to(v, (len(df),)) if v.ndim == 0 else v
        env[it.name] = out[it.name].to_numpy()

    if plan.order_by:
        out_cols = list(out.columns)
        skeys = []
        for i, (e, asc) in enumerate(plan.order_by):
            if isinstance(e, E.Literal) and isinstance(e.value, int):
                e = E.Column(out_cols[e.value - 1])      # ordinal
            v = np.asarray(host_eval.eval_expr(e, env))
            sk = f"__wsort{i}"
            out[sk] = np.broadcast_to(v, (len(out),)) if v.ndim == 0 else v
            skeys.append((sk, asc))
        out = out.sort_values([c for c, _ in skeys],
                              ascending=[a for _, a in skeys],
                              kind="mergesort")
        out = out.drop(columns=[c for c, _ in skeys])
    if plan.offset:
        out = out.iloc[plan.offset:]
    if plan.limit is not None:
        out = out.head(plan.limit)
    return out.reset_index(drop=True)
