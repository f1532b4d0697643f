"""leaks pass: acquired resources must be released on ALL paths.

The port of the JAX package's ``tools/sdlint/leaks.py``, with the port's
per-wave tier pin scopes (``wave_pins``) added to the registry.

A registry of acquire/release pairs the engine actually uses (WLM quota
tokens and lane wait-queue entries, admission tickets, inflight-registry
entries, cancel-flag refcounts, WAL file handles, snapshot temp dirs,
device-pin style pairs) is checked over the exception-edge CFG from
``cfg.py``: from each acquire site, is any function exit — normal or
exceptional — reachable without passing a release?

Scope rules that keep this sound-ish without interprocedural ownership
tracking:

- *Pair* resources (quota, waiter, ticket, inflight, cancel-flag,
  tmpdir, pins) are only checked in functions that attempt a release (or
  construct the resource's carrier) at all — a function that acquires
  and never releases is transferring ownership to object state (e.g. a
  session holding a cancel-flag refcount until ``close()``), which a
  per-function pass cannot judge.
- *Constructor* resources (WAL handles) are the opposite: an unbound or
  never-escaping construction with no ``close()`` is flagged even with
  zero releases present — ``WriteAheadLog(p).replay()`` drops the
  handle. Storing into ``self.x``/a container or returning it is an
  ownership transfer and skips the site.
- Branch headers carry their whole AST subtree, so a release nested
  under ``if tok is not None:`` marks the header node too. This is a
  deliberate over-approximation: conditionally-guarded releases are
  accepted; the pass targets *paths with no release attempt at all*.
- The acquire node's own exception edge is exempt ("the acquire itself
  failed" acquires nothing).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_druid_olap_tpu_torch.tools.sdlint.astutil import call_chain, \
    walk_shallow
from spark_druid_olap_tpu_torch.tools.sdlint.core import Finding, Project


@dataclasses.dataclass(frozen=True)
class Resource:
    kind: str
    #: call-chain suffixes that acquire (empty for ctor kinds)
    acquires: Tuple[Tuple[str, ...], ...]
    #: call-chain suffixes that release / transfer
    releases: Tuple[Tuple[str, ...], ...]
    #: class names whose construction takes ownership (e.g. Ticket)
    carriers: Tuple[str, ...] = ()
    #: constructor-style resource: acquire is `Ctor(...)`, escape analysis
    ctor: Optional[str] = None
    #: tmpdir-style: acquire arg must trace to a ".tmp" string literal,
    #: and releases must reference the same name
    tmp_named: bool = False


REGISTRY: Tuple[Resource, ...] = (
    Resource("quota", (("quotas", "acquire"),),
             (("quotas", "release"), ("_unhook",)), carriers=("Ticket",)),
    Resource("lane-waiter", (("enqueue",),),
             (("remove",), ("release",), ("_unhook",)),
             carriers=("Ticket",)),
    Resource("wlm-ticket", (("wlm", "admit"),),
             (("wlm", "release"), ("release",))),
    Resource("inflight", (("inflight", "begin"),),
             (("inflight", "done"), ("done",))),
    Resource("cancel-flag", (("register_query",),),
             (("release_query",),)),
    Resource("device-pin", (("pin_array",), ("device_pin",)),
             (("unpin_array",), ("device_unpin",))),
    # cold-tier column pins: an unreleased token keeps every chunk a
    # query faulted resident forever, silently growing the hot set past
    # its byte budget (tier/store.py pin protocol)
    Resource("tier-pin", (("acquire_pins",),), (("release_pins",),)),
    # mesh-dispatch partial buffers: the fused wave loop holds every
    # device's packed partial aggregates resident between dispatch and
    # host unpack (parallel/meshexec.py PartialLedger); an unreleased
    # token leaves the gauge permanently non-zero, misreporting device
    # memory pressure to the stats surface
    Resource("mesh-partials", (("acquire_partials",),),
             (("release_partials",),)),
    # fault-injection scopes: an unbalanced begin_scope leaves the named
    # scope refcounted open forever, so every rule gated on it keeps
    # firing after the leg that opened it ends (fault/plan.py)
    Resource("fault-scope", (("begin_scope",),), (("end_scope",),)),
    # circuit-breaker claims: an unsettled claim wedges a half-open
    # breaker — its single probe slot never frees, so the node is
    # skipped forever even after it recovers (cluster/breaker.py)
    Resource("breaker-claim", (("before_attempt",),), (("settle",),)),
    # hedge races: close() marks the race cancelled so the losing leg's
    # thread stands down instead of holding its reply buffer and done-
    # event waiters alive (cluster/broker.py)
    Resource("hedge-race", (), (("close",),), ctor="_HedgeRace"),
    Resource("wal-handle", (), (("close",),), ctor="WriteAheadLog"),
    # per-wave tier pin scopes: ``wave_pins`` is a context manager, and
    # only its ``__exit__`` releases the token — a scope opened by hand
    # and not closed on every path keeps the wave's chunks pinned (out
    # of eviction's reach) for the life of the thread (tier/store.py)
    Resource("wave-pins", (), (("__exit__",), ("close",)),
             ctor="wave_pins"),
    # cluster RPC: every HTTPConnection the broker opens (subquery
    # scatter, readyz probes) must close on all paths — leaked sockets
    # exhaust the historical's accept queue under dashboard storms
    Resource("rpc-conn", (), (("close",),), ctor="HTTPConnection"),
    # scatter pool: a locally-constructed executor dropped without
    # shutdown leaks its worker threads (self.x storage transfers
    # ownership to close())
    Resource("scatter-pool", (), (("shutdown",),),
             ctor="ThreadPoolExecutor"),
    Resource("tmpdir", (("os", "makedirs"),),
             (("os", "replace"), ("rmtree",)), tmp_named=True),
    # epoch publish lock: an unreleased claim wedges topology changes
    # cluster-wide until the stale-lock timeout (cluster/epoch.py)
    Resource("epoch-claim", (("claim_publish",),),
             (("release_publish",),)),
    # drain tokens: an unended begin_subquery keeps wait_drained
    # blocked, so a leaving historical can never fence (historical.py
    # DrainGate protocol)
    Resource("drain-token", (("begin_subquery",),),
             (("end_subquery",),)),
    # broadcast-join build tables: an unreleased build token leaves the
    # device-resident hash table + payload counted as outstanding
    # forever, misreporting join memory pressure and masking real
    # leaks of replicated build state (join/broadcast.py BuildLedger)
    Resource("join-build", (("acquire_build",),),
             (("release_build",),)),
)


def _suffix(chain: Sequence[str], suf: Tuple[str, ...]) -> bool:
    return len(chain) >= len(suf) and tuple(chain[-len(suf):]) == suf


def _scan_calls(payload) -> List[ast.Call]:
    """All calls in a node's subtree, not descending into nested defs;
    synthetic and def/class payloads scan as empty."""
    if not isinstance(payload, ast.AST) or isinstance(
            payload, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return []
    return [n for n in walk_shallow(payload) if isinstance(n, ast.Call)]


def _header_exprs(payload) -> List[ast.AST]:
    """Only the part of a compound statement that executes *at* its CFG
    node (acquire detection must not double-count body statements, which
    have nodes of their own)."""
    if isinstance(payload, (ast.If, ast.While)):
        return [payload.test]
    if isinstance(payload, (ast.For, ast.AsyncFor)):
        return [payload.iter]
    if isinstance(payload, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in payload.items]
    if isinstance(payload, ast.ExceptHandler):
        return [payload.type] if payload.type is not None else []
    if isinstance(payload, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
        return []
    if isinstance(payload, ast.AST):
        return [payload]
    return []


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _has_tmp_literal(expr: ast.AST) -> bool:
    return any(isinstance(n, ast.Constant) and isinstance(n.value, str)
               and ".tmp" in n.value for n in ast.walk(expr))


def _bound_name(payload, call: ast.Call) -> Optional[str]:
    """`x = <call possibly wrapped>` -> "x" (single Name target only)."""
    if isinstance(payload, ast.Assign) and len(payload.targets) == 1 \
            and isinstance(payload.targets[0], ast.Name):
        return payload.targets[0].id
    return None


def _check_function(project: Project, mod, qual: str,
                    fn) -> List[Finding]:
    out: List[Finding] = []
    g = project.cfg(fn)
    nodes = g.stmt_nodes()
    # per-node call lists (full subtree: release/avoid detection) and
    # header-only lists (acquire detection)
    full_calls = {n: _scan_calls(g.nodes[n]) for n in nodes}
    head_calls = {n: [c for h in _header_exprs(g.nodes[n])
                      for c in _scan_calls(h)] for n in nodes}

    ordinal: Dict[str, int] = {}
    for res in REGISTRY:
        # acquire sites -------------------------------------------------
        sites = []   # (node, call, varname)
        for n in nodes:
            for c in head_calls[n]:
                ch = call_chain(c.func)
                if res.ctor is not None:
                    if not (ch and ch[-1] == res.ctor):
                        continue
                elif not any(_suffix(ch, a) for a in res.acquires):
                    continue
                if res.tmp_named:
                    if not c.args:
                        continue
                    arg = c.args[0]
                    traced = _has_tmp_literal(arg)
                    dirname = arg.id if isinstance(arg, ast.Name) else None
                    if dirname and not traced:
                        for p in (g.nodes[m] for m in nodes):
                            if isinstance(p, ast.Assign) \
                                    and len(p.targets) == 1 \
                                    and isinstance(p.targets[0], ast.Name) \
                                    and p.targets[0].id == dirname \
                                    and _has_tmp_literal(p.value):
                                traced = True
                                break
                    if not traced:
                        continue
                    sites.append((n, c, dirname))
                else:
                    sites.append((n, c, _bound_name(g.nodes[n], c)))
        if not sites:
            continue

        # release / carrier / escape nodes ------------------------------
        def _is_release(c: ast.Call, var: Optional[str]) -> bool:
            ch = call_chain(c.func)
            hit = any(_suffix(ch, r) for r in res.releases) \
                or (res.carriers and ch and ch[-1] in res.carriers)
            if not hit:
                return False
            if res.tmp_named and var is not None:
                return var in _names_in(c)
            return True

        for site_n, call, var in sites:
            payload = g.nodes[site_n]
            escapes = False
            if res.ctor is not None and isinstance(
                    payload, (ast.With, ast.AsyncWith)):
                # `with Ctor(...):` — __exit__ releases on every path,
                # including the exception edges this pass walks
                escapes = True
            if res.ctor is not None:
                # ownership transfer: stored into an attribute/container
                # or returned at the acquire itself, or the bound name is
                # later stored/returned/entered by a ``with``
                if isinstance(payload, ast.Assign) and any(
                        not isinstance(t, ast.Name)
                        for t in payload.targets):
                    escapes = True
                if isinstance(payload, ast.Return):
                    escapes = True
                if var is not None:
                    for m in nodes:
                        p = g.nodes[m]
                        if isinstance(p, ast.Assign) \
                                and not isinstance(p, str) \
                                and any(not isinstance(t, ast.Name)
                                        for t in p.targets) \
                                and var in _names_in(p.value):
                            escapes = True
                        if isinstance(p, ast.Return) \
                                and p.value is not None \
                                and var in _names_in(p.value):
                            escapes = True
                        if isinstance(p, (ast.With, ast.AsyncWith)) \
                                and any(var in _names_in(i.context_expr)
                                        for i in p.items):
                            escapes = True
            if escapes:
                continue

            avoid: Set[int] = set()
            any_release = False
            for m in nodes:
                if m == site_n:
                    # the acquire node may also contain a release (e.g.
                    # an `if` header with the whole protocol under it) —
                    # still counts as "release attempted"
                    if any(_is_release(c, var) for c in full_calls[m]
                           if c is not call):
                        any_release = True
                        avoid.add(m)
                    continue
                rel = any(_is_release(c, var) for c in full_calls[m])
                p = g.nodes[m]
                if not rel and var is not None and res.ctor is None \
                        and isinstance(p, ast.Return) \
                        and p.value is not None \
                        and var in _names_in(p.value):
                    rel = True      # resource returned to the caller
                if rel:
                    any_release = True
                    avoid.add(m)
            if res.ctor is None and not any_release:
                # no release attempted anywhere: ownership lives in
                # object state; out of scope for a per-function check
                continue

            path = g.reachable_avoiding(site_n, {g.exit, g.raise_exit},
                                        avoid, skip_start_raise=True)
            if path is None:
                continue
            how = "an exception path" if path[-1] == g.raise_exit \
                else "a normal return path"
            rule = ("unclosed-" if res.ctor is not None
                    else "unreleased-") + res.kind
            k = f"{qual}:{res.kind}"
            ordinal[k] = ordinal.get(k, 0) + 1
            sym = k if ordinal[k] == 1 else f"{k}#{ordinal[k]}"
            out.append(Finding(
                "leaks", rule, mod.relpath, call.lineno, sym,
                f"{res.kind} acquired here can reach {how} without "
                f"release (witness escapes via "
                f"{'raise' if path[-1] == g.raise_exit else 'return'}); "
                f"release in a finally/context manager covering the "
                f"acquire"))
    return out


def run(project: Project) -> List[Finding]:
    idx = project.index()
    out: List[Finding] = []
    for (mod_name, qual), fn in sorted(idx.functions.items()):
        mod = project.modules[mod_name].mod \
            if hasattr(project.modules[mod_name], "mod") \
            else project.modules[mod_name]
        out.extend(_check_function(project, mod, qual, fn))
    return out
