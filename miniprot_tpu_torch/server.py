"""Serving mode: keep the index, the kernel library and the CUDA context
warm behind TCP (port of miniprot_tpu.server).

    python -m miniprot_tpu_torch.server --listen 127.0.0.1:8765 genome.mpi [opts]
    python -m miniprot_tpu_torch.server --query 127.0.0.1:8765 proteins.faa

The options after the genome are the CLI's (``--no-gpu`` serves on the
host engine; the alignment DPs run on the card otherwise).

Protocol: the client sends one FASTA/FASTQ payload (optionally
gzipped) and half-closes; the server replies with the mapping output
in the configured format and closes.  On failure the reply is a single
line starting with ``#mpserve-error:`` (PAF/GFF output never starts
with that prefix) so clients can distinguish errors from genuinely
empty results.  A failed request is reported, never re-run elsewhere.

Security posture: there is no authentication — bind to loopback
(the examples above) or a trusted network only.  Requests larger than
--max-request bytes (default 256M) are rejected without being
buffered.
"""

from __future__ import annotations

import io
import os
import socket
import socketserver
import sys
import tempfile

from .daemon import attach
from .index import Index
from .kernels import lib, resolve_device
from .options import MapOpt
from .pipeline import map_file

DEFAULT_MAX_REQUEST = 256 << 20

ERROR_PREFIX = b"#mpserve-error:"


class _Handler(socketserver.StreamRequestHandler):
    def _fail(self, msg: str) -> None:
        sys.stderr.write(f"[server] request failed: {msg}\n")
        self.wfile.write(ERROR_PREFIX + b" " + msg.encode() + b"\n")

    def handle(self):
        srv = self.server
        limit = srv.max_request
        chunks, total = [], 0
        while True:
            b = self.rfile.read1(1 << 20)
            if not b:
                break
            total += len(b)
            if total > limit:
                self._fail(f"request exceeds {limit} bytes")
                self.wfile.flush()
                # read the rest to its end, keeping none of it: closing
                # with unread bytes would reset the connection and could
                # drop the error line before the client reads it
                while self.rfile.read1(1 << 20):
                    pass
                return
            chunks.append(b)
        data = b"".join(chunks)
        if not data:
            return
        # spool to a temp file: reuses the gzip-sniffing batch reader
        fd, path = tempfile.mkstemp(prefix="mpserve", suffix=".faa")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            out = io.StringIO()
            try:
                map_file(srv.mi, path, srv.opt, n_threads=srv.n_threads,
                         out=out, device=srv.device)
            except Exception as e:  # report, keep serving
                self._fail(repr(e))
                return
            self.wfile.write(out.getvalue().encode())
        finally:
            os.unlink(path)


class MapServer(socketserver.TCPServer):
    """One request at a time, each mapped by map_file on ``device``
    ("cuda" by default, "cpu" for the kernels' plain versions, None for
    the host engine).  When a device daemon answers (daemon.attach),
    the requests' batches go to it and this process never touches the
    card."""

    allow_reuse_address = True

    def __init__(self, addr, mi: Index, opt: MapOpt, n_threads: int = 1,
                 device="cuda", max_request: int = DEFAULT_MAX_REQUEST):
        self.mi = mi
        self.opt = opt
        self.n_threads = n_threads
        self.device = device
        self.max_request = max_request
        if device is not None:
            client = attach(device)
            if client is not None:
                client.close()   # each request's engine attaches itself
            elif resolve_device(device).type == "cuda":
                lib()   # build and load the kernels before the first request
        super().__init__(addr, _Handler)


def query(host: str, port: int, payload: bytes,
          timeout: float = 600.0) -> bytes:
    """Send one request; returns the server's output bytes.
    Raises RuntimeError when the server reports a failure."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(payload)
        s.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            b = s.recv(1 << 16)
            if not b:
                break
            chunks.append(b)
    out = b"".join(chunks)
    if out.startswith(ERROR_PREFIX):
        raise RuntimeError(out[len(ERROR_PREFIX):].strip().decode())
    return out


def main(argv=None) -> int:
    from .sysutil import disable_numpy_thp
    disable_numpy_thp()
    from .cli import load_for_server
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--query":
        host, port = argv[1].rsplit(":", 1)
        with open(argv[2], "rb") as f:
            payload = f.read()
        sys.stdout.buffer.write(query(host, int(port), payload))
        return 0
    max_request = DEFAULT_MAX_REQUEST
    if argv and argv[0].startswith("--max-request="):
        max_request = int(argv[0].split("=", 1)[1])
        argv = argv[1:]
    if not argv or argv[0] != "--listen":
        sys.stderr.write(__doc__)
        return 1
    host, port = argv[1].rsplit(":", 1)
    # parse the remaining args exactly like the CLI, but stop after the
    # index + options are loaded instead of mapping
    parsed = load_for_server(argv[2:])
    if not isinstance(parsed, tuple):
        return int(parsed)
    mi, opt, n_threads, device = parsed
    if host not in ("127.0.0.1", "localhost", "::1"):
        sys.stderr.write("[server] WARNING: binding a non-loopback "
                         "address; the protocol is unauthenticated\n")
    with MapServer((host, int(port)), mi, opt, n_threads, device,
                   max_request=max_request) as srv:
        sys.stderr.write(f"[server] listening on {host}:{port} "
                         f"({mi.nt.l_seq} bp indexed, device {device})\n")
        srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
