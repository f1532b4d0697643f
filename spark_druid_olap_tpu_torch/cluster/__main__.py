"""Cluster entrypoint.

Port of ``spark_druid_olap_tpu/cluster/__main__.py``. ``historical`` and
``broker`` take ``--device``: ``cuda`` by default, where a process with no
CUDA device refuses to start; ``--device cpu`` serves from the CPU.

Historical (one per node id in the list)::

    python -m spark_druid_olap_tpu_torch.cluster historical \
        --persist /data/sdot --nodes h0:9101,h1:9102 --node-id 0

Broker (fronts the cluster on the ordinary SQL HTTP surface)::

    python -m spark_druid_olap_tpu_torch.cluster broker \
        --persist /data/sdot --nodes h0:9101,h1:9102 --port 8082

Every member must see the same --persist root and the same --nodes
list: the shard plan is recomputed identically from those two inputs.
``scripts/start-sdot-cluster.sh`` wraps the N+1 process spawn.

Topology changes go through plan epochs (cluster/epoch.py) — no
restart of the running members::

    python -m spark_druid_olap_tpu_torch.cluster epoch show --persist /data/sdot
    python -m spark_druid_olap_tpu_torch.cluster epoch add-node h2:9103 \
        --persist /data/sdot
    python -m spark_druid_olap_tpu_torch.cluster epoch remove-node h1:9102 \
        --persist /data/sdot

``add-node`` publishes the record; the new historical process is
started separately (``scripts/start-sdot-cluster.sh add-node`` does
both). ``remove-node`` publishes the shrunken record; the removed
node drains its in-flight subqueries and fences itself once the
survivors cover its shards.
"""

from __future__ import annotations

import argparse


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--persist", required=True,
                   help="deep storage root (sdot.persist.path); the "
                        "coordination substrate")
    p.add_argument("--nodes", required=True,
                   help="comma-separated host:port historical list; "
                        "index order = node id")
    p.add_argument("--replication", type=int, default=2,
                   help="shard copies across historicals (default 2)")
    p.add_argument("--shards", type=int, default=0,
                   help="shards per datasource (0 = one per node)")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="extra sdot.* config overrides (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="this process's device: cuda (default) or cpu")


def _epoch_cmd(ap: argparse.ArgumentParser, args) -> int:
    import json

    from spark_druid_olap_tpu_torch.cluster import epoch as EP

    rec = EP.read_epoch(args.persist)
    if args.action == "show":
        if rec is None:
            print(json.dumps({"epoch": None, "nodes": [],
                              "note": "no epoch record published; "
                                      "members use the static --nodes "
                                      "bootstrap"}))
        else:
            print(json.dumps(rec.to_dict()))
        return 0
    if not args.address:
        ap.error(f"epoch {args.action} needs a host:port address")
    base = rec.nodes if rec is not None else tuple(
        n.strip() for n in args.nodes.split(",") if n.strip())
    if not base and args.action == "add-node":
        ap.error("no epoch record exists yet; pass the current "
                 "membership via --nodes")
    if args.action == "add-node":
        if args.address in base:
            ap.error(f"{args.address} is already a member")
        new_nodes = tuple(base) + (args.address,)
    else:
        if args.address not in base:
            ap.error(f"{args.address} is not a member of {list(base)}")
        new_nodes = tuple(n for n in base if n != args.address)
        if not new_nodes:
            ap.error("refusing to publish an empty cluster")
    out = EP.publish_epoch(args.persist, new_nodes,
                           note=args.note or args.action)
    print(json.dumps(out.to_dict()))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_druid_olap_tpu_torch.cluster")
    sub = ap.add_subparsers(dest="role", required=True)
    h = sub.add_parser("historical", help="serve assigned shards")
    _common(h)
    h.add_argument("--node-id", type=int, required=True,
                   help="this node's index into --nodes")
    b = sub.add_parser("broker", help="scatter/merge front over the nodes")
    _common(b)
    b.add_argument("--host", default="0.0.0.0")
    b.add_argument("--port", type=int, default=8082)
    e = sub.add_parser("epoch", help="show or roll the plan epoch "
                                     "(elastic topology, no restart)")
    e.add_argument("action", choices=["show", "add-node", "remove-node"])
    e.add_argument("address", nargs="?",
                   help="host:port for add-node / remove-node")
    e.add_argument("--persist", required=True,
                   help="deep storage root (the coordination substrate)")
    e.add_argument("--nodes", default="",
                   help="bootstrap host:port list; only needed when no "
                        "epoch record has been published yet")
    e.add_argument("--note", default="",
                   help="free-form note stored in the epoch record")
    args = ap.parse_args(argv)

    if args.role == "epoch":
        return _epoch_cmd(ap, args)

    overrides = {
        "sdot.persist.path": args.persist,
        "sdot.cluster.nodes": args.nodes,
        "sdot.cluster.replication": args.replication,
        "sdot.cluster.shards": args.shards,
    }
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k] = v

    if args.role == "historical":
        from spark_druid_olap_tpu_torch.cluster.historical import HistoricalNode
        node = HistoricalNode(overrides, node_id=args.node_id,
                              device=args.device)
        host, port = node.addresses[node.node_id]
        print(f"sdot historical {node.node_id} booting on "
              f"http://{host}:{port} (readyz flips 200 when shards load)",
              flush=True)
        node.start(background=False)
        return 0

    overrides["sdot.cluster.role"] = "broker"
    import spark_druid_olap_tpu_torch as sdot
    from spark_druid_olap_tpu_torch.server.http import SqlServer
    ctx = sdot.Context(overrides, device=args.device)
    n_ds = len(ctx.cluster.plan.datasources) if ctx.cluster else 0
    print(f"sdot broker on http://{args.host}:{args.port} — "
          f"{len(ctx.cluster.nodes)} nodes, {n_ds} planned datasources",
          flush=True)
    SqlServer(ctx, args.host, args.port).start(background=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
