"""Mean milliseconds a statement spends outside the program's own
statement span: client latency less the ``total_ms`` of its ``ctx.history``
record (HTTP, JSON encoding and decoding, the server's threads).

History records carry no query id, so client statements and records are
paired by statement text; a mean over pairs does not depend on which
statement of one text is paired with which record."""

from collections import defaultdict


def read(run):
    client, prog = defaultdict(list), defaultdict(list)
    for r in run.records:
        if r["status"] == 200:
            client[r["sql"]].append((r["t_done"] - r["t_send"]) * 1e3)
    for s in run.statements:
        prog[s["sql"]].append(s["total_ms"])
    diffs = []
    for text, lat in client.items():
        got = prog.get(text, [])
        n = min(len(lat), len(got))
        diffs.extend(a - b for a, b in zip(lat[:n], got[:n]))
    return sum(diffs) / len(diffs) if diffs else None
