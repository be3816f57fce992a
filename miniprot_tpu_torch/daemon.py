"""Device daemon: one process owns the card and serves the DP batches of
CLI processes over a unix socket (port of miniprot_tpu.daemon).

Every engine that launches its own batches holds a CUDA context of its
own and caps its CIGAR planes at fractions of the whole card
(device.CIG_TB_FRACTION, device.PENDING_TB_FRACTION), so the processes
sharing a card each believe they own it.  A daemon gives them one
context and one plane budget: a client's GpuExtEngine builds its batches
(numpy arrays and Python scalars) as it always does and ships them here;
the daemon stages and launches them on its card, copies their results
to pinned host memory, decodes them on collect and returns only the
per-job result lists.  A client never creates a CUDA context.

There is no fallback: a refused connection, a launch error or a daemon
that dies raises out of the client's engine and its map.

Protocol (8-byte big-endian length prefix + pickle, SOCK_STREAM; the
JAX package's framing, so either side reads the other's messages):
  ("ping",)                  -> ("ok", info_dict)
  ("launch", batch)          -> ("ok", bid)        returns at enqueue; a
                                launcher thread stages and launches
  ("launch_many", [batch..]) -> ("ok", [bid...])   a flush's batches in
                                one round trip
  ("collect", [bid, ...])    -> ("ok", (results, card_s, wait_s)): the
                                per-batch result lists, the wave's
                                seconds on the card (CUDA events) and the
                                daemon-side wait; launch errors surface
                                here
  ("warm", opt_dict|None)    -> ("ok", [shape labels])
  ("bench", kind)            -> ("ok", dict)       benchmarks.run_bench_op
                                on the daemon's device
  ("launchers", n)           -> ("ok", n_launchers)
  ("shutdown",)              -> ("ok", None), then the daemon exits
Any failure returns ("err", repr(e)); the client raises.

The plane budget: launched-but-uncollected CIGAR planes of all clients
together stay within PENDING_TB_FRACTION of the card (a batch alone may
take the whole budget).  Batches are admitted in submission order, a
launch RPC never waits for room, and a collect waits on its batches in
submission order, releasing each one's room as soon as its results have
landed: the batches that hold room are all older than the one waiting
for it, and each is collected without waiting on anything younger, so
room always comes back (PERF.md section 7).

Run it:  python -m miniprot_tpu_torch.daemon [--socket P] [--warm [hot|all]]
         [--idle-exit S] [--device cuda|cpu] | --stop
"""

from __future__ import annotations

import contextlib
import os
import pickle
import socket
import struct
import sys
import tempfile
import threading
import time

import torch

from .device import CIG_TB_FRACTION, PENDING_TB_FRACTION, _memory_bytes

PACKAGE = "miniprot_tpu_torch"

_HDR = struct.Struct(">Q")
# a corrupt length header must not trigger a giant allocation
_MAX_MSG = 1 << 31
# a collect that has waited this long on a batch's launch raises
COLLECT_TIMEOUT_S = 600.0
# launched batches nobody collected for this long are dropped
STALE_S = 900.0


def default_sock_path() -> str:
    env = os.environ.get("MINIPROT_TPU_DAEMON_SOCK")
    if env:
        return env
    return os.path.join(tempfile.gettempdir(),
                        f"miniprot_tpu_torch_daemon-{os.getuid()}.sock")


def _send(conn: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    conn.sendall(_HDR.pack(len(data)) + data)


def _recv(conn: socket.socket):
    hdr = _recv_exact(conn, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    if n > _MAX_MSG:
        raise ValueError(f"oversized message ({n} bytes)")
    data = _recv_exact(conn, n)
    if data is None:
        raise ConnectionError("peer closed mid-message")
    return pickle.loads(data)


def _recv_exact(conn: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            if buf:  # peer died mid-message: an error, not a clean close
                raise ConnectionError(
                    f"peer closed after {len(buf)}/{n} bytes")
            return None
        buf.extend(chunk)
    return bytes(buf)


# the per-problem arrays of the batch classes (nasw_ext, nasw_cigar_scan,
# nasw_cigar_striped): row b holds problem b
_ROW_ARRAYS = ("nt", "leftb", "iov", "als", "alv", "nlv", "prof", "aas",
               "nas", "D", "A", "logpen")


def slim_for_wire(batch) -> None:
    """Trim a batch's per-problem arrays to its first ``n`` rows: a
    batch is allocated at its capacity (a RawExtBatch's nt alone is
    capacity x (nl + 8) bytes), its stage() uploads only the rows in use,
    and the rest would cross the socket as zeros.  ``capacity`` is kept,
    so tb_bytes() is the same on both sides."""
    n = batch.n
    for name in _ROW_ARRAYS:
        a = getattr(batch, name, None)
        if a is not None and len(a) > n:
            setattr(batch, name, a[:n])


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class DaemonClient:
    """Client half: two persistent connections, sequential RPCs on each.

    Collects ride their own connection, so a launch is never queued
    behind a collect's blocking read.  ``info`` is the daemon's ping at
    connect time: its package, device and plane budget."""

    def __init__(self, path: str, conn: socket.socket, info: dict,
                 conn_collect: socket.socket | None = None):
        self.path = path
        self.conn = conn
        self.conn_collect = conn_collect or conn
        self.info = info
        self._lock = threading.Lock()
        self._lock_collect = (threading.Lock() if conn_collect is not None
                              else self._lock)

    @staticmethod
    def _open(path: str, timeout: float):
        """Connect and ping; raises ConnectionError when nothing answers
        and RuntimeError when what answers is not this package's
        daemon."""
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            conn.settimeout(timeout)
            conn.connect(path)
            _send(conn, ("ping",))
            reply = _recv(conn)
        except OSError as e:
            conn.close()
            raise ConnectionError(f"no daemon answers at {path}: {e!r}") \
                from e
        if not (isinstance(reply, tuple) and reply[0] == "ok"
                and isinstance(reply[1], dict)
                and reply[1].get("package") == PACKAGE):
            conn.close()
            raise RuntimeError(f"the daemon at {path} is not a {PACKAGE} "
                               f"daemon (ping: {reply!r})")
        conn.settimeout(None)
        return conn, reply[1]

    @classmethod
    def connect(cls, path: str, timeout: float = 10.0,
                probe_only: bool = False) -> "DaemonClient":
        """Connect to the daemon at ``path`` (both connections unless
        ``probe_only``); raises when it does not answer or is not this
        package's."""
        conn, info = cls._open(path, timeout)
        conn2 = None
        if not probe_only:
            try:
                conn2, _ = cls._open(path, timeout)
            except BaseException:
                conn.close()
                raise
        return cls(path, conn, info, conn_collect=conn2)

    @classmethod
    def maybe_connect(cls, path: str | None = None, timeout: float = 3.0,
                      probe_only: bool = False) -> "DaemonClient | None":
        """connect(), or None when nothing answers at ``path`` (the
        default socket when None).  A daemon that is not this package's
        still raises."""
        path = path or default_sock_path()
        if not os.path.exists(path):
            return None
        try:
            return cls.connect(path, timeout, probe_only)
        except ConnectionError:
            return None

    def _rpc(self, msg, collect_chan: bool = False):
        conn = self.conn_collect if collect_chan else self.conn
        lock = self._lock_collect if collect_chan else self._lock
        with lock:
            _send(conn, msg)
            reply = _recv(conn)
        if reply is None:
            raise ConnectionError("daemon closed the connection")
        status, val = reply
        if status != "ok":
            raise RuntimeError(f"daemon error: {val}")
        return val

    def launch(self, batch) -> int:
        slim_for_wire(batch)
        return self._rpc(("launch", batch))

    def launch_many(self, batches) -> list:
        """One RPC for a whole group of launches."""
        batches = list(batches)
        for b in batches:
            slim_for_wire(b)
        return self._rpc(("launch_many", batches))

    def collect(self, bids: list) -> tuple:
        """(result lists, card s, daemon-side wait s) of launched
        batches, in ``bids`` order."""
        return self._rpc(("collect", list(bids)), collect_chan=True)

    def ping(self) -> dict:
        return self._rpc(("ping",))

    def bench(self, kind: str) -> dict:
        return self._rpc(("bench", kind))

    def set_launchers(self, n: int) -> int:
        """Grow the daemon's launcher pool."""
        return self._rpc(("launchers", int(n)))

    def shutdown(self) -> None:
        self._rpc(("shutdown",))

    def close(self) -> None:
        for c in (self.conn, self.conn_collect):
            try:
                c.close()
            except OSError:
                pass


def attach(device, path: str | None = None) -> "DaemonClient | None":
    """The daemon an engine on ``device`` ships its batches to, or None
    (the engine launches them itself).

    MINIPROT_TPU_DAEMON=0: None.  A socket named by ``path`` or by
    MINIPROT_TPU_DAEMON_SOCK must answer (ConnectionError otherwise).
    Unnamed, an engine on the default card (device "cuda") attaches when
    a daemon answers at default_sock_path(), and an engine on the CPU or
    on a numbered card never does.  A daemon that is not this package's,
    or whose device type is not ``device``'s, raises."""
    if os.environ.get("MINIPROT_TPU_DAEMON") == "0":
        return None
    dev = torch.device("cuda" if device is None else device)
    named = path or os.environ.get("MINIPROT_TPU_DAEMON_SOCK")
    if named:
        client = DaemonClient.connect(named)
    elif dev.type == "cuda" and dev.index is None:
        client = DaemonClient.maybe_connect()
    else:
        return None
    if client is not None and client.info["device_type"] != dev.type:
        client.close()
        raise RuntimeError(
            f"the daemon at {client.path} serves "
            f"{client.info['device_type']}, the engine asked for {dev.type}")
    return client


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _Entry:
    """One launched batch: admitted under the plane budget and launched
    by a launcher thread, its results on their way to pinned host memory
    (``host``) until a collect waits on them.  ``dev`` keeps the batch's
    device tensors alive until then."""

    __slots__ = ("batch", "owner", "seq", "need", "admitted", "dropped",
                 "host", "dev", "span", "err", "ev", "t")

    def __init__(self, batch, owner, need: int):
        self.batch = batch
        self.owner = owner
        self.seq = 0
        self.need = need
        self.admitted = False
        self.dropped = False
        self.host = None
        self.dev = None
        self.span = None
        self.err: BaseException | None = None
        self.ev = threading.Event()
        self.t = time.monotonic()


class _Server:
    def __init__(self, sock_path: str, idle_exit: float = 0.0,
                 device="cuda"):
        from .kernels import resolve_device
        self.device = resolve_device(device)
        self.sock_path = sock_path
        self.idle_exit = idle_exit
        mem = _memory_bytes(self.device)
        self.memory = mem
        self.batch_cap = int(mem * CIG_TB_FRACTION)
        self.pending_cap = int(mem * PENDING_TB_FRACTION)
        self.inflight_tb = 0
        self.peak_tb = 0
        self.budget_waits = 0     # admissions that waited for room
        self.batches: dict[int, _Entry] = {}
        self.next_bid = 1
        self.next_admit = 1
        self.lock = threading.Lock()
        self.room = threading.Condition(self.lock)
        self.last_op = time.monotonic()
        self.stop = threading.Event()
        self.n_launched = 0
        self.n_collected = 0
        self.n_collect_ops = 0   # RPCs, not batches: waves count once
        self.launch_busy_s = 0.0
        self.collect_busy_s = 0.0
        self.t_start = time.monotonic()
        self.warmed: dict | None = None   # main()'s --warm: shapes, s
        import queue
        self.launch_q: queue.Queue = queue.Queue()
        self.launchers: list[threading.Thread] = []
        self._add_launchers(1)

    def _add_launchers(self, target: int) -> int:
        """Grow the launcher pool to ``target`` threads (never shrinks:
        launchers block on the queue and cost nothing idle).  Each runs
        its launches on a stream of its own."""
        while len(self.launchers) < target:
            t = threading.Thread(target=self._launcher, daemon=True,
                                 name=f"daemon-launcher-{len(self.launchers)}")
            t.start()
            self.launchers.append(t)
        return len(self.launchers)

    # -- the plane budget --

    def _admit(self, e: _Entry) -> bool:
        """Wait for ``e``'s turn (submission order) and for room for its
        planes; False when it was dropped meanwhile (nothing admitted)."""
        with self.room:
            counted = False
            while True:
                if self.next_admit == e.seq:
                    fits = (e.dropped or self.inflight_tb == 0
                            or self.inflight_tb + e.need <= self.pending_cap)
                    if fits:
                        break
                    if not counted:
                        self.budget_waits += 1
                        counted = True
                self.room.wait()
            self.next_admit += 1
            self.room.notify_all()
            if e.dropped:
                return False
            e.admitted = True
            self.inflight_tb += e.need
            self.peak_tb = max(self.peak_tb, self.inflight_tb)
            return True

    def _release(self, e: _Entry) -> None:
        """Give back ``e``'s room and its device tensors (once)."""
        with self.room:
            if e.admitted:
                e.admitted = False
                self.inflight_tb -= e.need
                self.room.notify_all()
            e.dev = None

    def _drop(self, e: _Entry) -> None:
        """``e`` will never be collected: release it now if its launch is
        done, else the launcher does when it is."""
        with self.room:
            e.dropped = True
            done = e.ev.is_set()
            self.room.notify_all()   # a launcher may wait on its room
        if done:
            self._release(e)

    def _gc(self, owner=None) -> None:
        """Drop launched-but-uncollected batches whose client closed its
        connection (``owner``), or that nobody collected for STALE_S."""
        now = time.monotonic()
        with self.lock:
            dead = [b for b, e in self.batches.items()
                    if (owner is not None and e.owner is owner)
                    or (now - e.t > STALE_S and e.ev.is_set())]
            entries = [self.batches.pop(b) for b in dead]
        for e in entries:
            self._drop(e)

    # -- ops --

    def op_ping(self):
        from . import kernels
        card = self.device.type == "cuda"
        with self.lock:
            budget = {"pending_cap": self.pending_cap,
                      "batch_cap": self.batch_cap,
                      "inflight_tb": self.inflight_tb,
                      "peak_tb": self.peak_tb,
                      "budget_waits": self.budget_waits,
                      "pending": len(self.batches)}
        return {
            "package": PACKAGE,
            "pid": os.getpid(),
            "device_type": self.device.type,
            "device": str(self.device),
            "name": torch.cuda.get_device_name(self.device) if card
            else "cpu",
            "capability": list(torch.cuda.get_device_capability(
                self.device)) if card else None,
            "memory": self.memory,
            "launches": kernels.launch_counts(),
            **budget,
            "launched": self.n_launched,
            "collected": self.n_collected,
            "collect_ops": self.n_collect_ops,
            "launchers": len(self.launchers),
            "launch_busy_s": self.launch_busy_s,
            "collect_busy_s": self.collect_busy_s,
            "uptime_s": time.monotonic() - self.t_start,
            "warm": self.warmed,
        }

    def _launcher(self) -> None:
        """Admit, stage and launch queued batches in submission order,
        then queue their results' copy to pinned host memory on the same
        stream (kernels.to_host), between two timing events; any error
        surfaces at collect."""
        from .kernels import to_host
        card = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if card else None
        with (torch.cuda.stream(stream) if card
              else contextlib.nullcontext()):
            while True:
                e = self.launch_q.get()
                if e is None:   # serve() ended
                    return
                if not self._admit(e):
                    e.ev.set()
                    continue
                t0 = time.monotonic()
                try:
                    if card:
                        start = torch.cuda.Event(enable_timing=True)
                        start.record()
                    staged = e.batch.stage()
                    handles = e.batch.launch(staged)
                    e.host = to_host(handles)
                    e.dev = (staged, handles)
                    if card:
                        end = torch.cuda.Event(enable_timing=True)
                        end.record()
                        e.span = (start, end)
                except Exception as ex:   # reported to the collect
                    e.err = ex
                with self.lock:   # thread-seconds across all launchers
                    self.launch_busy_s += time.monotonic() - t0
                    e.ev.set()
                    dropped = e.dropped
                if dropped or e.err is not None:
                    self._release(e)

    def op_launch(self, batch, owner=None) -> int:
        need = batch.tb_bytes() if hasattr(batch, "tb_bytes") else 0
        batch.device = self.device
        e = _Entry(batch, owner, need)
        with self.lock:
            # the id is the submission order: queued under the same lock
            e.seq = bid = self.next_bid
            self.next_bid += 1
            self.batches[bid] = e
            self.n_launched += 1
            self.launch_q.put(e)
        return bid

    def op_collect(self, bids: list) -> tuple:
        """Wait on each batch in submission order, release its room once
        its results have landed, decode: (result lists in ``bids``
        order, the wave's card s from the first batch's launch to the
        last one's copy, the seconds waited here)."""
        t_op = time.monotonic()
        with self.lock:
            unknown = [b for b in bids if b not in self.batches]
            if unknown:
                raise KeyError(f"unknown batch ids {unknown}")
            entries = [self.batches.pop(b) for b in bids]
        deadline = time.monotonic() + COLLECT_TIMEOUT_S
        out: list = [None] * len(entries)
        err = None
        wait = 0.0
        spans = []
        for k in sorted(range(len(entries)), key=lambda k: entries[k].seq):
            e = entries[k]
            if err is not None:
                self._drop(e)
                continue
            t0 = time.monotonic()
            try:
                if not e.ev.wait(timeout=max(0.0,
                                             deadline - time.monotonic())):
                    raise TimeoutError(f"batch {e.seq} still not launched "
                                       f"after {COLLECT_TIMEOUT_S:.0f} s")
                if e.err is not None:
                    raise e.err
                e.host.wait()
                if e.span is not None:
                    e.span[1].synchronize()
                    spans.append(e.span)
                wait += time.monotonic() - t0
                self._release(e)
                out[k] = e.batch.collect(e.host)
            except Exception as ex:
                err = ex
                self._drop(e)
        if err is not None:
            raise err
        card_s = (spans[0][0].elapsed_time(spans[-1][1]) / 1e3
                  if spans else 0.0)
        with self.lock:
            self.n_collected += len(bids)
            self.n_collect_ops += 1
            self.collect_busy_s += time.monotonic() - t_op
        return out, card_s, wait

    def op_warm(self, opt_dict) -> list:
        return warm_kernels(opt_dict, device=self.device)

    def op_bench(self, kind: str) -> dict:
        from . import benchmarks
        return benchmarks.run_bench_op(kind, device=self.device)

    def op_launchers(self, n: int) -> int:
        with self.lock:
            return self._add_launchers(int(n))

    # -- plumbing --

    def handle_conn(self, conn: socket.socket) -> None:
        try:
            while not self.stop.is_set():
                try:
                    msg = _recv(conn)
                except (OSError, ValueError):   # the stream is lost
                    break
                except Exception as e:   # a message that does not load here
                    _send(conn, ("err", repr(e)))
                    continue
                if msg is None:
                    break
                self.last_op = time.monotonic()
                op, args = msg[0], msg[1:]
                try:
                    if op == "ping":
                        _send(conn, ("ok", self.op_ping()))
                    elif op == "launch":
                        _send(conn, ("ok", self.op_launch(args[0], conn)))
                    elif op == "launch_many":
                        _send(conn, ("ok", [self.op_launch(b, conn)
                                            for b in args[0]]))
                    elif op == "collect":
                        _send(conn, ("ok", self.op_collect(*args)))
                    elif op == "warm":
                        _send(conn, ("ok", self.op_warm(
                            args[0] if args else None)))
                    elif op == "bench":
                        _send(conn, ("ok", self.op_bench(*args)))
                    elif op == "launchers":
                        _send(conn, ("ok", self.op_launchers(*args)))
                    elif op == "shutdown":
                        _send(conn, ("ok", None))
                        self.stop.set()
                        break
                    else:
                        _send(conn, ("err", f"unknown op {op!r}"))
                except Exception as e:  # op failed; connection stays up
                    try:
                        _send(conn, ("err", repr(e)))
                    except OSError:
                        break
        finally:
            self._gc(owner=conn)
            try:
                conn.close()
            except OSError:
                pass

    def serve(self) -> None:
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.sock_path)
        os.chmod(self.sock_path, 0o600)
        srv.listen(16)
        srv.settimeout(1.0)
        sys.stderr.write(f"[daemon] serving on {self.sock_path} "
                         f"(pid {os.getpid()}, {self.device})\n")
        try:
            while not self.stop.is_set():
                self._gc()
                if (self.idle_exit > 0
                        and time.monotonic() - self.last_op > self.idle_exit
                        and not self.batches):
                    sys.stderr.write("[daemon] idle-exit\n")
                    break
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                threading.Thread(target=self.handle_conn, args=(conn,),
                                 daemon=True).start()
        finally:
            srv.close()
            try:
                os.unlink(self.sock_path)
            except OSError:
                pass
            # the launchers end before the interpreter does: a thread
            # still unwinding out of torch at exit aborts the process
            for _ in self.launchers:
                self.launch_q.put(None)
            for t in self.launchers:
                t.join(timeout=COLLECT_TIMEOUT_S)


def warm_shapes(shapes: str = "hot") -> list[tuple]:
    """The batches warm_kernels launches: (class name, width, nl bucket,
    problems, go 0).  "hot": the engine's forms on the default route at
    the buckets the 200 Mb workload fills (ext al 128 at the three
    smallest nl buckets; scan W=32 / 2048 and W=128 / 2048-8192, W=128
    at one problem and at kernels.SPREAD_BELOW, K2's two geometries);
    "all": every ext bucket and every CIGAR class x bucket on both
    kernels at go >= 1 and go 0, the host-prepped (--spsc) forms and
    B4' (Dp32Batch)."""
    from . import device as dev
    from .kernels import SPREAD_BELOW
    if shapes == "hot":
        return ([("RawExtBatch", 128, nl, 1, False)
                 for nl in dev.NL_BUCKETS[:3]]
                + [("SmallScanCigarBatch", 32, 2048, 1, False)]
                + [("RawScanCigarBatch", 128, nl, 1, False)
                   for nl in (2048, 4096, 8192)]
                + [("RawScanCigarBatch", 128, 4096, SPREAD_BELOW, False)])
    if shapes != "all":
        raise ValueError(f"warm shapes {shapes!r}: 'hot' or 'all'")
    out = []
    for go0 in (False, True):
        out += [("RawExtBatch", al, nl, 1, go0)
                for al in dev.AL_BUCKETS for nl in dev.NL_BUCKETS]
        out.append(("ExtBatch", 128, dev.NL_BUCKETS[0], 1, go0))
        for sc in dev.CIG_SLEN_CLASSES:
            W = sc * 8
            names = (["SmallCigarBatch"] if W == 32 else ["RawCigarBatch"])
            if not go0:
                names.append("SmallScanCigarBatch" if W == 32
                             else "RawScanCigarBatch")
            out += [(name, W, nl, 1, go0) for name in names
                    for nl in dev.CIG_NL_BUCKETS]
        out.append(("CigarBatch", 128, 2048, 1, go0))
        if not go0:
            out.append(("ScanCigarBatch", 128, 2048, 1, go0))
        out.append(("Dp32Batch", 512, 2048, 1, go0))
    return out


def warm_kernels(opt_dict: dict | None = None, shapes: str = "hot",
                 device="cuda") -> list[str]:
    """Build and load the kernel library (on the card), then launch each
    batch of warm_shapes(shapes) once on random problems and wait for
    its results.  Any failure raises.  Returns the shapes' labels."""
    import numpy as np

    from . import tables
    from .align import DpEnv
    from .kernels import lib, resolve_device
    from .kernels import nasw_cigar_scan as csk
    from .kernels import nasw_cigar_striped as cst
    from .kernels import nasw_ext as nk
    from .options import MapOpt

    dev = resolve_device(device)
    if dev.type == "cuda":
        lib()
    classes = {c.__name__: c for c in (
        nk.RawExtBatch, nk.ExtBatch, csk.RawScanCigarBatch,
        csk.SmallScanCigarBatch, csk.ScanCigarBatch, cst.RawCigarBatch,
        cst.SmallCigarBatch, cst.CigarBatch, cst.Dp32Batch)}
    rng = np.random.default_rng(0)
    labels = []
    for name, W, nl, n, go0 in warm_shapes(shapes):
        opt = MapOpt(**opt_dict) if opt_dict else MapOpt()
        if go0:
            opt.go = 0
        env = DpEnv(opt)
        scalars = (opt.go, opt.ge, opt.fs, opt.io, opt.xdrop,
                   opt.end_bonus, opt.ie_coef)
        cls = classes[name]
        raw = name.startswith(("Raw", "Small"))
        kw = dict(sp=env.sp, trans_code=tables._default_code) if raw else {}
        b = cls(W, nl, opt.mat, scalars, device=dev, capacity=n, **kw)
        al = min(W, 100)
        for _ in range(n):
            nt4 = rng.integers(0, 4, size=nl - 8).astype(np.int8)
            aas = rng.integers(0, 20, size=al).astype(np.int8)
            if raw:
                b.add_raw(nt4, aas, io=opt.io)
            else:
                z = np.zeros(nl - 7, np.int16)
                b.add(nt4, aas, z, z, io=opt.io)
        b.collect(b.launch())
        labels.append(f"{name} {W}x{nl}" + (f" n={n}" if n > 1 else "")
                      + (" go=0" if go0 else ""))
    return labels


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m miniprot_tpu_torch.daemon",
        description="device daemon: one process owns the card and serves "
                    "the DP batches of CLI processes")
    p.add_argument("--socket", default=None,
                   help="unix socket path [%(default)s: "
                   "$MINIPROT_TPU_DAEMON_SOCK, else "
                   "$TMPDIR/miniprot_tpu_torch_daemon-UID.sock]")
    p.add_argument("--warm", nargs="?", const="hot", default=None,
                   choices=("hot", "all"),
                   help="launch every kernel form at these shapes before "
                   "serving")
    p.add_argument("--idle-exit", type=float, default=0.0,
                   help="exit after S seconds with no requests (0=never)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: the card (sm_90 required); cpu: the "
                   "kernels' plain PyTorch versions (tests)")
    p.add_argument("--stop", action="store_true",
                   help="shut down a running daemon and exit")
    args = p.parse_args(argv)
    path = args.socket or default_sock_path()
    if args.stop:
        c = DaemonClient.maybe_connect(path, probe_only=True)
        if c is None:
            sys.stderr.write("[daemon] not running\n")
            return 1
        try:
            c.shutdown()
        finally:
            c.close()
        sys.stderr.write("[daemon] stopped\n")
        return 0
    try:
        srv = _Server(path, idle_exit=args.idle_exit, device=args.device)
    except RuntimeError as e:
        sys.stderr.write(f"[daemon] {e}\n")
        return 1
    if args.warm:
        t0 = time.monotonic()
        try:
            labels = warm_kernels(shapes=args.warm, device=srv.device)
        except Exception as e:
            sys.stderr.write(f"[daemon] warm failed: {e!r}\n")
            return 1
        srv.warmed = {"shapes": labels, "s": time.monotonic() - t0}
        sys.stderr.write(f"[daemon] warmed {len(labels)} shapes in "
                         f"{srv.warmed['s']:.1f} s\n")
    srv.serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
