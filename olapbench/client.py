"""Closed-loop HTTP clients of one run, in a process of their own.

``run.py`` starts this file with ``python3 olapbench/client.py`` and
writes one JSON line to its standard input: the server's port, the
configuration file, the traffic mix, the seed, the window's seconds and
the path to write the results to. The process then

1. sends the set-up's warm-up statements (``traffic.warmup``) and prints
   ``ready``;
2. waits for a ``go`` line, runs the mix's clients for the window (each
   sends its next batch when its previous batch has been answered, with
   no think time, and sends none once the window has closed), waits for
   every statement in flight, writes the results and prints ``end``.

Every client is driven by one thread, which multiplexes every statement's
connection with ``selectors``: a ``POST /sql`` on a connection of its own
(the server answers HTTP/1.0 and closes it). Each statement is timed from
before its connection opens to the end of its answer. One thread in a
process of its own keeps the load generator's work off the server's
interpreter lock and its timestamps off any lock of its own. Imports
nothing of the program: only the standard library, numpy and the
benchmark's traffic generator and templates.
"""

from __future__ import annotations

import errno
import hashlib
import json
import selectors
import socket
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path[0] != str(ROOT):
    sys.path.insert(0, str(ROOT))

from olapbench import catalog, traffic  # noqa: E402

TIMEOUT_S = 120.0        # one statement's limit
DRAIN_S = 60.0           # how long the in-flight statements may take


class Statement:
    """One ``POST /sql`` in flight on a non-blocking connection."""

    def __init__(self, port: int, sql: str, qid: str, tag):
        body = json.dumps({"sql": sql, "queryId": qid}).encode()
        self.out = (b"POST /sql HTTP/1.0\r\nHost: 127.0.0.1\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: %d\r\n\r\n" % len(body)) + body
        self.tag, self.chunks = tag, []
        self.t_send = time.perf_counter()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setblocking(False)
        err = self.sock.connect_ex(("127.0.0.1", port))
        if err not in (0, errno.EINPROGRESS):
            raise OSError(err, "connect failed")

    def answer(self):
        """``(t_send, t_done, status, body)``; status 0 when no HTTP answer
        came."""
        raw = b"".join(self.chunks)
        head, sep, body = raw.partition(b"\r\n\r\n")
        try:
            status = int(head.split(b" ", 2)[1]) if sep else 0
        except (IndexError, ValueError):
            status = 0
        return self.t_send, self.t_done, status, body if status else raw


class Driver:
    """Sends batches of statements and calls back as each batch is
    answered, all on the calling thread."""

    def __init__(self, port: int):
        self.port = port
        self.sel = selectors.DefaultSelector()
        self.live = 0

    def send(self, sqls, qids, done) -> None:
        """Send ``sqls`` at once; ``done(answers)`` gets their answers in
        batch order once the last has come."""
        batch = {"left": len(sqls), "answers": [None] * len(sqls),
                 "done": done}
        for i, (sql, qid) in enumerate(zip(sqls, qids)):
            st = Statement(self.port, sql, qid, (batch, i))
            self.sel.register(st.sock, selectors.EVENT_WRITE, st)
            self.live += 1

    def _finish(self, st: Statement) -> None:
        st.t_done = time.perf_counter()
        self.sel.unregister(st.sock)
        st.sock.close()
        self.live -= 1
        batch, i = st.tag
        batch["answers"][i] = st.answer()
        batch["left"] -= 1
        if batch["left"] == 0:
            batch["done"](batch["answers"])

    def step(self, timeout: float) -> None:
        for key, mask in self.sel.select(timeout):
            st = key.data
            try:
                if mask & selectors.EVENT_WRITE:
                    sent = st.sock.send(st.out)
                    st.out = st.out[sent:]
                    if not st.out:
                        self.sel.modify(st.sock, selectors.EVENT_READ, st)
                    continue
                got = st.sock.recv(1 << 20)
                if got:
                    st.chunks.append(got)
                    continue
            except BlockingIOError:
                continue
            except OSError as e:
                st.chunks = [repr(e).encode()]
            self._finish(st)
        now = time.perf_counter()
        for key in list(self.sel.get_map().values()):
            if now - key.data.t_send > TIMEOUT_S:
                key.data.chunks = [b"timed out"]
                self._finish(key.data)

    def abandon(self) -> None:
        """Give every statement still in flight up, with no answer."""
        for key in list(self.sel.get_map().values()):
            key.data.chunks = [b"no answer"]
            self._finish(key.data)


class Recorder:
    """Statements of the window, with their texts and answers kept once."""

    def __init__(self):
        self.records = []
        self.texts = {}
        self.bodies = {}

    def add(self, client, qid, name, params, sql, t0, t1, status, body):
        h = hashlib.sha1(body).hexdigest()
        tid = self.texts.setdefault(sql, len(self.texts))
        self.bodies.setdefault(h, body.decode("utf-8", "replace"))
        self.records.append({"client": client, "qid": qid,
                             "template": name, "params": params,
                             "text": tid, "t_send": t0, "t_done": t1,
                             "status": status, "body": h})


def warm_up(port, mix, tpls, seed) -> None:
    drv = Driver(port)
    for i, batch in enumerate(traffic.warmup(mix, tpls, seed)):
        got = []
        drv.send([traffic.sql(tpls[name], p) for name, p in batch],
                 [f"w{i}-{k}" for k in range(len(batch))], got.extend)
        while drv.live:
            drv.step(1.0)
        for (name, _), (_, _, status, body) in zip(batch, got):
            if status != 200:
                raise RuntimeError(
                    f"warm-up statement {name} answered {status}: "
                    f"{body[:500]!r}")


def run_window(port, mix, tpls, seed, deadline, rec: Recorder) -> int:
    """Every client's closed loop until ``deadline``, then the drain; the
    number of statements still unanswered after it (each recorded with no
    answer)."""
    drv = Driver(port)

    def start(c, gen, n):
        batch = next(gen)
        sqls = [traffic.sql(tpls[name], p) for name, p in batch]
        qids = [f"c{c}-{n + k}" for k in range(len(batch))]

        def done(answers):
            for (name, params), sql, qid, answer in zip(batch, sqls, qids,
                                                        answers):
                rec.add(c, qid, name, params, sql, *answer)
            if time.perf_counter() < deadline:
                start(c, gen, n + len(batch))
        drv.send(sqls, qids, done)

    for c in range(int(mix["clients"])):
        start(c, traffic.batches(mix, tpls, seed, c), 0)
    while drv.live and time.perf_counter() < deadline + DRAIN_S:
        drv.step(0.05)
    stuck = drv.live
    drv.abandon()
    return stuck


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    cfg = json.loads(Path(spec["config_file"]).read_text())
    tpls = catalog.templates(cfg)
    mix = catalog.traffic(spec["traffic"])
    port, seed = int(spec["port"]), int(spec["seed"])
    warm_up(port, mix, tpls, seed)
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    rec = Recorder()
    t_go = time.perf_counter()
    deadline = t_go + float(spec["seconds"])
    stuck = run_window(port, mix, tpls, seed, deadline, rec)
    out = {"t_go": t_go, "deadline": deadline, "stuck_statements": stuck,
           "records": rec.records,
           "texts": sorted(rec.texts, key=rec.texts.get),
           "bodies": rec.bodies}
    Path(spec["out"]).write_text(json.dumps(out))
    print("end", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
