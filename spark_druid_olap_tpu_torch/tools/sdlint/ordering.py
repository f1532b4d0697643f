"""ordering pass: happens-before on the persist (durability) paths.

Port of the JAX package's ``tools/sdlint/ordering.py``, unchanged.

Crash safety is an ordering property — the bytes hit stable storage in
one order or results diverge after kill -9 — so these rules are CFG
reachability questions, not call presence questions. Scope: modules
whose path contains ``persist`` (the subsystem owns every durable write
in the engine; scoping keeps ``str.replace`` and list ``append`` noise
out of a rule set that keys on method names).

Rules (normal edges only — an exception unwinding *past* a publish is
error propagation, not a missing durability step):

- **O1 rename-before-fsync** — a write (``.write``/``.writelines``/
  ``dump``) can reach an ``os.replace`` without an intervening
  ``*fsync*`` call: the rename can publish bytes the kernel never
  flushed, so a crash serves a torn file under the final name.
- **O2 publish-not-durable** — an ``os.replace`` can reach the function
  exit without a ``*fsync_dir*`` call: the rename itself lives in the
  directory inode; un-fsynced, a crash un-publishes (or worse,
  half-publishes) an already-acknowledged state change.
- **O3 register-before-wal-commit** — a ``store.register``-style call
  can reach a WAL ``append`` afterwards: registration makes data
  servable before its journal record is durable, so a crash between the
  two acknowledges rows that recovery cannot rebuild.
- **O4 truncate-without-checkpoint** — ``truncate_through`` reachable
  from function entry without passing a ``write_snapshot``/checkpoint
  call: truncating the journal before the snapshot that supersedes it
  is durable destroys the only recovery source. (Exception edges count
  here: a failed snapshot must not fall through to the truncate.)
- **O5 swap-before-truncate** — a function that performs a generation
  swap (``os.replace``) but can reach a WAL ``truncate_through`` from
  entry WITHOUT passing the swap: the journal records are destroyed
  while the old generation is still the published one, so a crash
  recovers the old snapshot minus the rows the journal held.
  (Exception edges count: a failed swap must not fall through to the
  truncate.)
- **O6 dir-fsync-after-swap** — an ``os.replace`` can reach a destroy
  step (``truncate_through`` / ``rmtree``) without an intervening
  ``*fsync_dir*``: the rename may still be sitting in an un-synced
  directory inode when its superseded recovery source is destroyed —
  a crash can lose BOTH generations.
- **O7 no-register-before-publish** — a ``store.register``-style call
  from which an ``os.replace`` or ``write_snapshot`` is still
  reachable: rows become servable before the durable publish that
  backs them, so a crash in between acknowledges a generation that
  recovery cannot reproduce (the compaction swap protocol requires
  publish-then-swap-in-memory, never the reverse).
"""

from __future__ import annotations

import ast
from typing import List, Sequence, Set, Tuple

from spark_druid_olap_tpu_torch.tools.sdlint.astutil import call_chain
from spark_druid_olap_tpu_torch.tools.sdlint.core import Finding, Project
from spark_druid_olap_tpu_torch.tools.sdlint.leaks import _header_exprs, \
    _scan_calls, _suffix

WRITE_SEGS = frozenset({"write", "writelines", "dump", "tofile"})


def _chain_nodes(g, pred) -> dict:
    """CFG node -> [call chains] passing ``pred(chain)``. Header-only:
    a ``with``/``if`` node must not swallow its body's calls — the body
    statements have CFG nodes of their own, and attributing them to the
    header would merge before/after into "at the same point"."""
    out = {}
    for n in g.stmt_nodes():
        chains = [call_chain(c.func)
                  for h in _header_exprs(g.nodes[n])
                  for c in _scan_calls(h)]
        hits = [ch for ch in chains if ch and pred(ch)]
        if hits:
            out[n] = hits
    return out


def _line(g, n) -> int:
    p = g.nodes[n]
    return getattr(p, "lineno", 0) if isinstance(p, ast.AST) else 0


def _check_function(project: Project, mod, qual: str,
                    fn) -> List[Finding]:
    out: List[Finding] = []
    g = project.cfg(fn)

    replace = _chain_nodes(g, lambda ch: _suffix(ch, ("os", "replace")))
    fsync_any = _chain_nodes(
        g, lambda ch: any("fsync" in seg for seg in ch))
    dsync = _chain_nodes(
        g, lambda ch: any("fsync_dir" in seg for seg in ch))
    writes = _chain_nodes(g, lambda ch: ch[-1] in WRITE_SEGS)
    wal_append = _chain_nodes(
        g, lambda ch: ch[-1] in ("append", "append_group")
        and any("wal" in seg.lower() for seg in ch[:-1]))
    register = _chain_nodes(
        g, lambda ch: ch[-1] == "register" and len(ch) >= 2)
    truncate = _chain_nodes(g, lambda ch: ch[-1] == "truncate_through")
    ckpt = _chain_nodes(
        g, lambda ch: ch[-1] == "write_snapshot"
        or any("checkpoint" in seg for seg in ch))
    destroy = _chain_nodes(
        g, lambda ch: ch[-1] in ("truncate_through", "rmtree"))
    publish = _chain_nodes(
        g, lambda ch: _suffix(ch, ("os", "replace"))
        or ch[-1] == "write_snapshot")

    def emit(rule: str, n: int, anchor: str, msg: str) -> None:
        out.append(Finding("ordering", rule, mod.relpath, _line(g, n),
                           f"{qual}:{anchor}", msg))

    # O1: some write reaches this replace with no fsync between
    for rn in replace:
        for wn in writes:
            if wn == rn:
                continue
            if g.reachable_avoiding(wn, {rn}, set(fsync_any) - {wn, rn},
                                    normal_only=True):
                emit("rename-before-fsync", rn, "os.replace",
                     "os.replace can publish bytes written here without "
                     "an fsync in between — a crash can expose a torn "
                     "file under the final name")
                break

    # O2: replace reaches exit with no directory fsync after it
    for rn in replace:
        if g.reachable_avoiding(rn, {g.exit}, set(dsync) - {rn},
                                normal_only=True):
            emit("publish-not-durable", rn, "os.replace",
                 "rename publish is not followed by a directory fsync "
                 "(*fsync_dir*) on every normal path — the publish "
                 "itself can be lost on crash")

    # O3: a WAL commit append is reachable AFTER a register
    if wal_append and register:
        for rn in register:
            hit = g.reachable_avoiding(
                rn, set(wal_append) - {rn}, set(), normal_only=True)
            if hit:
                emit("register-before-wal-commit", rn, "register",
                     "datasource registered before its WAL commit "
                     "append — a crash between the two acknowledges "
                     "rows recovery cannot rebuild")

    # O4: truncate reachable without a prior successful checkpoint
    for tn in truncate:
        if g.reachable_avoiding(g.entry, {tn}, set(ckpt) - {tn}):
            emit("truncate-without-checkpoint", tn, "truncate_through",
                 "WAL truncate_through reachable without a completed "
                 "write_snapshot/checkpoint on the same path — the only "
                 "recovery source is destroyed before its replacement "
                 "is durable")

    # O5: the function swaps generations, but a truncate can run first
    # (exception edges count: a failed swap must not fall through)
    if replace:
        for tn in truncate:
            if g.reachable_avoiding(g.entry, {tn},
                                    set(replace) - {tn}):
                emit("swap-before-truncate", tn, "truncate_through",
                     "WAL truncate_through reachable before the "
                     "generation swap (os.replace) completes — the "
                     "journal is destroyed while the OLD generation is "
                     "still published, so a crash loses its rows")

    # O6: swap reaches a destroy step with no directory fsync between
    for rn in replace:
        for dn in destroy:
            if dn == rn:
                continue
            if g.reachable_avoiding(rn, {dn}, set(dsync) - {rn, dn},
                                    normal_only=True):
                emit("dir-fsync-after-swap", rn, "os.replace",
                     "rename publish reaches a destroy step "
                     "(truncate_through/rmtree) without a directory "
                     "fsync in between — a crash can lose both the new "
                     "generation and its superseded recovery source")
                break

    # O7: rows registered while their durable publish is still ahead
    for rn in register:
        if g.reachable_avoiding(rn, set(publish) - {rn}, set(),
                                normal_only=True):
            emit("no-register-before-publish", rn, "register",
                 "datasource registered before the durable publish "
                 "(write_snapshot/os.replace) that backs it — a crash "
                 "in between acknowledges a generation recovery cannot "
                 "reproduce")
    return out


def run(project: Project) -> List[Finding]:
    idx = project.index()
    out: List[Finding] = []
    for (mod_name, qual), fn in sorted(idx.functions.items()):
        mod = project.modules[mod_name]
        if "persist" not in mod.relpath:
            continue
        out.extend(_check_function(project, mod, qual, fn))
    return out
