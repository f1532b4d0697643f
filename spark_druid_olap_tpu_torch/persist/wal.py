"""Write-ahead journal for stream-ingest appends.

Port counterpart of ``spark_druid_olap_tpu/persist/wal.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.
Two departures: ``group_commits`` counts a group only when a frame of it
was written (``_write_group``), so ``group_commits <= group_frames``
always holds (ROADMAP §C); and every frame goes through the group-commit
queue with its fsync on, so the original's one-fsync-per-record
``append`` and its ``fsync=False`` switch are left out.

One journal file per datasource. A committed batch survives ``kill -9``:
the commit point is the journal append + fsync, which happens BEFORE the
in-memory store registers the new rows — crash after the fsync replays
the batch at recovery; crash before it loses only the uncommitted batch
(which the caller never saw acknowledged).

Record framing (little-endian):

    [4B magic 'SDWL'][4B u32 header_len][8B u64 body_len]
    [4B u32 crc32(header + body)][header JSON][body bytes]

The header is a small JSON dict (record seq, datasource, kind, ingest
kwargs); the body is the batch itself as an Arrow IPC stream. Replay
reads records until EOF and STOPS at the first short or checksum-failing
record — a torn tail from a crash mid-append is expected, not an error.
Everything before it is intact by CRC.
"""

from __future__ import annotations

import io
import json
import os
import struct
import threading
import zlib
from typing import Iterator, List, Optional, Tuple

_MAGIC = b"SDWL"
_FRAME = struct.Struct("<4sIQI")


def _fsync_dir(path: str) -> None:
    # local copy of snapshot.fsync_dir — this module stays import-free
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def encode_batch(df) -> bytes:
    """pandas DataFrame -> Arrow IPC stream bytes (schema included)."""
    import pyarrow as pa
    table = pa.Table.from_pandas(df, preserve_index=False)
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue()


def decode_batch(body: bytes):
    """Arrow IPC stream bytes -> pandas DataFrame."""
    import pyarrow as pa
    with pa.ipc.open_stream(io.BytesIO(body)) as r:
        return r.read_all().to_pandas()


def _pack_record(header: dict, body: bytes) -> bytes:
    hdr = json.dumps(header, separators=(",", ":")).encode()
    crc = zlib.crc32(hdr)
    crc = zlib.crc32(body, crc)
    return _FRAME.pack(_MAGIC, len(hdr), len(body), crc) + hdr + body


class _Ticket:
    """One producer's frame waiting in the group-commit queue."""

    __slots__ = ("header", "body", "event", "error")

    def __init__(self, header: dict, body: bytes):
        self.header = header
        self.body = body
        self.event = threading.Event()
        self.error: Optional[BaseException] = None


class WriteAheadLog:
    """Append-only framed journal with crash-tolerant replay.

    :meth:`append_group` puts the record on a shared commit queue; one
    producer becomes the flush leader, writes every queued frame in
    enqueue order, and a SINGLE fsync covers the whole batch. The ACK
    (the call returning) is released only after the covering fsync, so
    an ACK implies the record is durable — the fsync cost is just
    amortized across concurrent producers.

    A frame that fails mid-write (fault-injected cut, real I/O error) is
    truncated back out so the journal stays appendable, and only THAT
    producer's append fails; a covering fsync that fails rolls the whole
    un-durable group back and fails every producer in it (none were
    acked).
    """

    def __init__(self, path: str, fault=None):
        self.path = path
        self.fault = fault      # fault injector (docs/CHAOS.md) or None
        self._f = None
        # group commit state: _q_lock guards the pending queue, _io_lock
        # serializes every file mutation (group flush, truncate_through,
        # repair) so a journal rewrite can never race
        # a half-written group. LOCK ORDER: _io_lock before _q_lock.
        self._q_lock = threading.Lock()
        self._io_lock = threading.RLock()
        self._pending: List[_Ticket] = []
        self.group_commits = 0      # covering fsyncs issued
        self.group_frames = 0       # frames those fsyncs covered

    # -- write ----------------------------------------------------------------
    def _file(self):
        if self._f is None or self._f.closed:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._f = open(self.path, "ab")
        return self._f

    # -- group commit ---------------------------------------------------------
    def enqueue(self, header: dict, body: bytes) -> _Ticket:
        """Stage one record on the shared commit queue and return its
        ticket (no blocking, no I/O). Enqueue order is preserved on
        disk, so callers that assign sequence numbers under their own
        lock and enqueue before releasing it get seq-ordered journals
        for free — and by the time any later-enqueued ticket resolves,
        every earlier ticket has resolved too (the leader drains the
        queue in order and settles a whole batch before releasing the
        io lock), which is what lets the persist manager excise a
        failed frame's build from the in-memory append chain before a
        successor registers on top of it."""
        t = _Ticket(header, body)
        with self._q_lock:
            self._pending.append(t)
        return t

    def commit(self, t: _Ticket) -> None:
        """Block until ``t``'s covering fsync made it durable, or raise
        its failure (an error means NOT acked)."""
        while not t.event.is_set():
            # leader election: whoever gets the io lock drains the queue
            # and commits the batch. A producer whose frame was covered
            # by a previous leader's fsync just wakes and returns.
            acquired = self._io_lock.acquire(timeout=0.02)
            if not acquired:
                continue
            try:
                if t.event.is_set():
                    break
                with self._q_lock:
                    batch, self._pending = self._pending, []
                if batch:
                    self._write_group(batch)
            finally:
                self._io_lock.release()
        if t.error is not None:
            raise t.error

    def append_group(self, header: dict, body: bytes) -> None:
        """:meth:`enqueue` + :meth:`commit` in one call, for callers
        with no ordering stake of their own."""
        self.commit(self.enqueue(header, body))

    def _write_group(self, batch: List[_Ticket]) -> None:
        """Write every frame in ``batch``, then one covering fsync.
        Called with the io lock held. Never raises: outcomes are
        delivered per-ticket. A frame that fails mid-write is truncated
        back out (that producer alone fails, the group continues); a
        failing covering fsync rolls the whole un-durable suffix back
        and fails every producer whose frame it covered."""
        inj = self.fault
        try:
            f = self._file()
            group_start = f.seek(0, os.SEEK_END)
        except OSError as e:
            for t in batch:
                t.error = e
                t.event.set()
            return
        pos = group_start
        wrote: List[_Ticket] = []
        for t in batch:
            rec = _pack_record(t.header, t.body)
            try:
                if inj is not None:
                    # a mutate rule tears THIS frame only
                    cut = inj.mutate("wal.append", rec, key=self.path)
                    if cut is not rec:
                        f.write(cut)
                        f.flush()
                        raise OSError("fault-injected torn WAL append")
                f.write(rec)
            except BaseException as e:  # noqa: BLE001 — per-ticket fate
                try:
                    f.flush()
                    f.truncate(pos)
                    f.flush()
                except OSError:
                    pass    # repair() at next recovery trims it
                t.error = e
                t.event.set()
                continue
            pos += len(rec)
            wrote.append(t)
        try:
            f.flush()
            if inj is not None and wrote:
                # chaos sites: "wal.group_commit" and "wal.fsync" both
                # model the covering fsync failing (the WHOLE batch is
                # un-acked and rolled back)
                inj.fire("wal.group_commit", key=self.path)
                inj.fire("wal.fsync", key=self.path)
            os.fsync(f.fileno())
        except BaseException as e:  # noqa: BLE001 — per-ticket fate
            # nothing past group_start is durable: roll it all back so
            # the journal stays appendable, and fail every producer (no
            # ACK was released, so ACK-implies-durable holds)
            try:
                f.truncate(group_start)
                f.flush()
                os.fsync(f.fileno())
            except OSError:
                pass
            for t in wrote:
                t.error = e
                t.event.set()
            return
        if wrote:
            # a group whose every frame tore wrote nothing durable: its
            # covering fsync commits no frame, so it is no group commit
            # (the JAX package counts it, which can leave commits above
            # frames)
            self.group_commits += 1
            self.group_frames += len(wrote)
        for t in wrote:
            t.event.set()

    def close(self) -> None:
        with self._io_lock:
            if self._f is not None and not self._f.closed:
                self._f.close()

    # -- read -----------------------------------------------------------------
    def replay(self) -> Iterator[Tuple[dict, bytes]]:
        """Yield (header, body) for every INTACT record, stopping at the
        first torn/corrupt one (crash tail). Missing file = no records."""
        if not os.path.exists(self.path):
            return
        end = self.size_bytes()
        with open(self.path, "rb") as f:
            while True:
                frame = f.read(_FRAME.size)
                if len(frame) < _FRAME.size:
                    return                      # clean EOF or torn frame
                magic, hlen, blen, crc = _FRAME.unpack(frame)
                if magic != _MAGIC:
                    return                      # corrupt frame boundary
                if hlen + blen > end - f.tell():
                    # lengths from a torn frame can be garbage: bound by
                    # the actual file size before allocating the read
                    return
                hdr = f.read(hlen)
                body = f.read(blen)
                if len(hdr) < hlen or len(body) < blen:
                    return                      # torn tail
                c = zlib.crc32(hdr)
                if zlib.crc32(body, c) != crc:
                    return                      # bit rot / torn overwrite
                try:
                    header = json.loads(hdr.decode())
                except ValueError:
                    return
                yield header, body

    def records(self) -> List[Tuple[dict, bytes]]:
        return list(self.replay())

    def repair(self) -> int:
        """Trim a torn/corrupt tail left by a crash mid-append, so the
        journal is appendable again (a live append after un-trimmed
        garbage would be unreachable to replay). Returns bytes trimmed.
        Called at recovery, before any new appends."""
        if not os.path.exists(self.path):
            return 0
        end = self.size_bytes()
        good = 0
        with open(self.path, "rb") as f:
            while True:
                frame = f.read(_FRAME.size)
                if len(frame) < _FRAME.size:
                    break
                magic, hlen, blen, crc = _FRAME.unpack(frame)
                if magic != _MAGIC:
                    break
                if hlen + blen > end - f.tell():
                    break       # garbage lengths from a torn frame
                hdr = f.read(hlen)
                body = f.read(blen)
                if len(hdr) < hlen or len(body) < blen:
                    break
                c = zlib.crc32(hdr)
                if zlib.crc32(body, c) != crc:
                    break
                good += _FRAME.size + hlen + blen
        torn = self.size_bytes() - good
        if torn > 0:
            with self._io_lock:
                self.close()
                with open(self.path, "r+b") as f:
                    f.truncate(good)
                    f.flush()
                    os.fsync(f.fileno())
        return max(0, torn)

    # -- maintenance ----------------------------------------------------------
    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def truncate_through(self, seq: int) -> None:
        """Drop every intact record with ``header['seq'] <= seq`` (they
        are folded into a published snapshot) by atomically rewriting the
        journal with the surviving tail. The torn tail (if any) is
        discarded too — it was never committed."""
        # the io lock excludes an in-flight group flush: a rewrite under
        # a half-committed group would orphan its frames in the replaced
        # file (acked data lost through a dead fd)
        with self._io_lock:
            keep = [(h, b) for h, b in self.replay()
                    if int(h.get("seq", 0)) > seq]
            self.close()
            if not keep:
                try:
                    os.remove(self.path)
                except OSError:
                    pass
                return
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                for header, body in keep:
                    f.write(_pack_record(header, body))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            # the rewritten journal replaces records a snapshot already
            # owns; if the rename itself is lost on crash, replay
            # re-applies them — harmless for idempotent restores but the
            # dir entry must still be durable before the caller drops
            # the covering snapshot refs
            _fsync_dir(os.path.dirname(self.path) or ".")

    def last_seq(self) -> Optional[int]:
        last = None
        for h, _ in self.replay():
            last = int(h.get("seq", 0))
        return last
