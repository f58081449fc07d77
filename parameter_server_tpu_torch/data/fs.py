"""Pluggable file access: local paths, gzip, and an in-cluster file server.

The port's copy of ``parameter_server_tpu/data/fs.py`` (sockets and the
standard library only): a port client reads a JAX ``FileServer`` and the
other way round.

Reference analogue: ``src/util/file.h/.cc`` — the reference's readers open
local and ``hdfs://`` paths through one File API, which is how Criteo-1TB
shards reach worker machines [U].  Scheme dispatch:

- plain paths / ``file://`` — local files;
- ``*.gz`` — transparent gzip decompression (Criteo ships gzipped);
- ``psfs://host:port/relative/path`` — the :class:`FileServer` below, a
  read-only TCP file service any host can run next to its shard store
  (the HDFS role: workers stream ranges over the network, no shared
  filesystem required).

Every reader in :mod:`parameter_server_tpu_torch.data.reader` opens its
inputs through :func:`open_stream`, so remote shards feed SlotReader and
StreamReader (and therefore every learner) with no code changes at the
call sites.

Protocol (length-prefixed, binary, read-only):
    request  = op:u8 | path_len:u32 | path_utf8 | offset:u64 | length:u64
    response = status:u8 | body_len:u64 | body
ops: 1=STAT (body = "size:mtime_ns"), 2=READ (body = file bytes),
3=LIST (body = newline-joined relative paths).  status: 0=ok, 1=error
(body = message).  The server only serves paths under its root (resolved,
symlink-safe) — it is a cluster-internal data plane, not a public service.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import gzip
import io
import os
import socket
import socketserver
import struct
import threading
from typing import BinaryIO, List, Optional, Tuple
from urllib.parse import urlparse

_OP_STAT, _OP_READ, _OP_LIST = 1, 2, 3
_MAX_READ = 64 << 20  # per-request range cap; readers chunk anyway


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("psfs: peer closed mid-frame")
        buf += part
    return buf


def _request_on(sock: socket.socket, addr: Tuple[str, int], op: int,
                path: str, offset: int = 0, length: int = 0) -> bytes:
    p = path.encode()
    frame = struct.pack("!BI", op, len(p)) + p + struct.pack("!QQ", offset, length)
    sock.sendall(frame)
    status, body_len = struct.unpack("!BQ", _recv_exact(sock, 9))
    body = _recv_exact(sock, body_len) if body_len else b""
    if status != 0:
        raise OSError(f"psfs://{addr[0]}:{addr[1]}/{path}: {body.decode()}")
    return body


def _request(addr: Tuple[str, int], op: int, path: str, offset: int = 0,
             length: int = 0) -> bytes:
    """One-shot request (STAT/LIST); streams use a persistent connection."""
    with socket.create_connection(addr, timeout=30) as sock:
        return _request_on(sock, addr, op, path, offset, length)


@dataclasses.dataclass(frozen=True)
class StatResult:
    size: int
    mtime_ns: int


class _RemoteFile(io.RawIOBase):
    """Read-only file-like over ranged psfs READ requests.

    Holds ONE persistent connection for its lifetime (the server handler
    loops over framed requests), so streaming a shard pays the TCP
    handshake and slow-start once — not per buffered read.  A dropped
    connection reconnects transparently once per request.
    """

    def __init__(self, addr: Tuple[str, int], path: str, size: int) -> None:
        super().__init__()
        self._addr = addr
        self._path = path
        self._size = size
        self._pos = 0
        self._sock: Optional[socket.socket] = None

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self._addr, timeout=30)
        return self._sock

    def _req(self, offset: int, length: int) -> bytes:
        try:
            return _request_on(
                self._conn(), self._addr, _OP_READ, self._path, offset, length
            )
        except (ConnectionError, TimeoutError):
            # transport died (NOT a server error reply, which raises plain
            # OSError): one transparent retry on a fresh connection
            self.close_connection()
            return _request_on(
                self._conn(), self._addr, _OP_READ, self._path, offset, length
            )

    def close_connection(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        self.close_connection()
        super().close()

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        base = {os.SEEK_SET: 0, os.SEEK_CUR: self._pos, os.SEEK_END: self._size}
        self._pos = max(0, base[whence] + pos)
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = self._size - self._pos
        n = min(n, self._size - self._pos)
        if n <= 0:
            return b""
        out = []
        while n > 0:
            take = min(n, _MAX_READ)
            body = self._req(self._pos, take)
            if not body:
                break
            out.append(body)
            self._pos += len(body)
            n -= len(body)
        return b"".join(out)

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)


def _parse_psfs(url: str) -> Tuple[Tuple[str, int], str]:
    u = urlparse(url)
    if u.scheme != "psfs" or u.port is None:
        raise ValueError(f"not a psfs://host:port/path url: {url!r}")
    return (u.hostname or "127.0.0.1", u.port), u.path.lstrip("/")


def stat(url: str) -> StatResult:
    """Size + mtime for any supported url (the reference File::Size role)."""
    if url.startswith("psfs://"):
        addr, path = _parse_psfs(url)
        size_s, mtime_s = _request(addr, _OP_STAT, path).decode().split(":")
        return StatResult(int(size_s), int(mtime_s))
    path = url[len("file://") :] if url.startswith("file://") else url
    st = os.stat(path)
    return StatResult(st.st_size, st.st_mtime_ns)


def open_stream(url: str) -> BinaryIO:
    """Open any supported url for binary reading (gzip-transparent)."""
    if url.startswith("psfs://"):
        addr, path = _parse_psfs(url)
        size = stat(url).size
        raw: BinaryIO = io.BufferedReader(
            _RemoteFile(addr, path, size), buffer_size=4 << 20
        )
    else:
        path = url[len("file://") :] if url.startswith("file://") else url
        raw = open(path, "rb")
    if url.endswith(".gz"):
        return gzip.open(raw, "rb")  # type: ignore[return-value]
    return raw


def list_files(pattern: str) -> List[str]:
    """Expand a glob into urls: local globs, or psfs LIST + fnmatch."""
    if pattern.startswith("psfs://"):
        addr, pat = _parse_psfs(pattern)
        names = _request(addr, _OP_LIST, "").decode().splitlines()
        return [
            f"psfs://{addr[0]}:{addr[1]}/{n}"
            for n in sorted(names)
            # glob semantics: '*' must not cross directory separators
            if n.count("/") == pat.count("/") and fnmatch.fnmatch(n, pat)
        ]
    import glob as glob_lib

    path = pattern[len("file://") :] if pattern.startswith("file://") else pattern
    return sorted(glob_lib.glob(path))


class FileServer:
    """Read-only TCP file service for a shard directory (HDFS-role host).

    Run one next to wherever the training shards live::

        srv = FileServer("/data/criteo", port=0)
        srv.start()            # srv.url -> "psfs://host:port"

    Workers then read ``f"{srv.url}/day_0.gz"`` through the ordinary
    readers.  Serving is threaded (one connection per request) and strictly
    confined to the resolved root.
    """

    def __init__(self, root: str, *, host: str = "0.0.0.0", port: int = 0,
                 advertise_host: str = "127.0.0.1") -> None:
        self.root = os.path.realpath(root)
        if not os.path.isdir(self.root):
            raise NotADirectoryError(self.root)
        self.advertise_host = advertise_host
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                # persistent connection: loop framed requests until the
                # client closes (streaming readers reuse one socket per
                # shard instead of a handshake per 4 MB buffer fill)
                while True:
                    try:
                        first = self.request.recv(1)
                        if not first:
                            return  # clean EOF
                        rest = _recv_exact(self.request, 4)
                        op, path_len = struct.unpack("!BI", first + rest)
                        path = _recv_exact(self.request, path_len).decode()
                        offset, length = struct.unpack(
                            "!QQ", _recv_exact(self.request, 16)
                        )
                    except (ConnectionError, OSError):
                        return
                    try:
                        body = outer._serve(op, path, offset, length)
                        status = 0
                    except Exception as e:  # noqa: BLE001 — reply, don't die
                        body = f"{type(e).__name__}: {e}".encode()[:4096]
                        status = 1
                    try:
                        self.request.sendall(
                            struct.pack("!BQ", status, len(body)) + body
                        )
                    except OSError:
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None
        #: per-op request counters (observability + cache-behavior tests)
        self.op_counts: dict = {}
        self._count_lock = threading.Lock()

    # -- request handlers ----------------------------------------------------
    def _resolve(self, rel: str) -> str:
        full = os.path.realpath(os.path.join(self.root, rel))
        if full != self.root and not full.startswith(self.root + os.sep):
            raise PermissionError(f"path escapes root: {rel!r}")
        return full

    def _serve(self, op: int, path: str, offset: int, length: int) -> bytes:
        with self._count_lock:
            self.op_counts[op] = self.op_counts.get(op, 0) + 1
        if op == _OP_STAT:
            st = os.stat(self._resolve(path))
            return f"{st.st_size}:{st.st_mtime_ns}".encode()
        if op == _OP_READ:
            if length > _MAX_READ:
                raise ValueError(f"range too large: {length}")
            with open(self._resolve(path), "rb") as f:
                f.seek(offset)
                return f.read(length)
        if op == _OP_LIST:
            names = []
            for dirpath, _dirs, files in os.walk(self.root):
                for name in files:
                    full = os.path.join(dirpath, name)
                    names.append(os.path.relpath(full, self.root))
            return "\n".join(names).encode()
        raise ValueError(f"unknown op {op}")

    # -- lifecycle -----------------------------------------------------------
    @property
    def url(self) -> str:
        return f"psfs://{self.advertise_host}:{self.port}"

    def start(self) -> "FileServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="psfs-server", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
