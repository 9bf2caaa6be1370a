"""Reusable framed transports for the Leader/Helper deployment.

The reference keeps the Leader->Helper leg behind an injected callback
(`pir/dpf_pir_server.h:92-109`: transport-agnostic, no RPC stack
in-repo) and its tests play the network with in-process lambdas. The
demo script grew a real TCP framing on top of that seam; this module is
that framing extracted into library classes:

* `send_msg` / `recv_msg` — 4-byte big-endian length-prefixed messages,
  the demo's wire format unchanged (any proto message rides inside).
* `InProcessTransport` — the reference's "lambda as the network",
  conforming to the same `Transport` surface so protocol tests and the
  serving sessions are transport-blind.
* `TcpTransport` — a client connection with reuse across round trips,
  per-call timeouts, and one transparent reconnect when a pooled
  connection has gone stale (helper restarted between requests). The
  whole call — both legs AND the reconnect+resend — runs against one
  absolute deadline derived from `timeout`, so a caller's budget is
  never overshot by a retry.
* `TcpTransportPool` — (the port's addition) `size` `TcpTransport`s
  behind one `Transport`: a `TcpTransport` holds its one connection for
  the whole exchange, so concurrent Helper legs through it run one at a
  time; the pool lets up to `size` run at once, each on a connection of
  its own, so the Helper's batcher sees them together.
* `FramedTcpServer` — the serving side: a threading TCP server that
  feeds each framed request to a `handler(bytes) -> bytes` and writes
  the framed response back on the same connection.

Errors normalize to `TransportError` (connectivity) and its subclass
`TransportTimeout` (deadline on one leg) so retry policy in
`serving/service.py` can tell a slow Helper from a dead one.

Fault-injection sites (`robustness/failpoints.py`; inert unless armed):
`transport.tcp.connect`, `transport.tcp.send`, `transport.tcp.recv`,
`transport.inproc.roundtrip` raise transport faults; the frame-level
`transport.request` / `transport.response` mutate sites corrupt or
truncate payloads on BOTH transports — the chaos harness uses them to
prove a flipped byte surfaces as a protocol error, never a wrong
decoded share.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import struct
import threading
import time
from typing import Callable, Optional

from ..robustness import failpoints

logger = logging.getLogger(__name__)

# Hard cap on a framed message; matches the demo's sanity bound.
MAX_MESSAGE_BYTES = 1 << 30


class TransportError(ConnectionError):
    """The peer is unreachable or the connection broke mid-message."""


class TransportTimeout(TransportError):
    """One send/receive leg exceeded its deadline (peer may be alive)."""


# ---------------------------------------------------------------------------
# Framing: 4-byte big-endian length prefix per message.
# ---------------------------------------------------------------------------


def send_msg(sock: socket.socket, data: bytes) -> None:
    if len(data) > MAX_MESSAGE_BYTES:
        raise ValueError(f"message too large ({len(data)} bytes)")
    sock.sendall(struct.pack(">I", len(data)) + data)


def recv_msg(sock: socket.socket) -> bytes:
    header = _recv_exact(sock, 4)
    (length,) = struct.unpack(">I", header)
    if length > MAX_MESSAGE_BYTES:
        raise TransportError(f"unreasonable message length {length}")
    return _recv_exact(sock, length)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportError("peer closed the connection")
        buf += chunk
    return buf


def parse_hostport(s: str, default_host: str = "localhost") -> tuple:
    host, _, port = s.rpartition(":")
    return host or default_host, int(port)


# ---------------------------------------------------------------------------
# Client-side transports
# ---------------------------------------------------------------------------


class Transport:
    """One request/response exchange with a peer.

    `on_sent`, when given, fires after the request has been handed to the
    peer and before the response is awaited — the hook the Leader role
    uses to compute its own share while the Helper works
    (`dpf_pir_server.cc:108-110`). It may fire more than once if a send
    is transparently retried, so callbacks must be idempotent.
    """

    def roundtrip(
        self,
        payload: bytes,
        timeout: Optional[float] = None,
        on_sent: Optional[Callable[[], None]] = None,
    ) -> bytes:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - trivial default
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class InProcessTransport(Transport):
    """The reference's in-process lambda network as a `Transport`."""

    def __init__(self, handler: Callable[[bytes], bytes]):
        if handler is None:
            raise ValueError("handler must not be None")
        self._handler = handler

    def roundtrip(self, payload, timeout=None, on_sent=None):
        failpoints.fire("transport.inproc.roundtrip", error=TransportError)
        payload = failpoints.mutate("transport.request", payload)
        if on_sent is not None:
            on_sent()
        return failpoints.mutate("transport.response", self._handler(payload))


class TcpTransport(Transport):
    """Framed TCP client with connection reuse and reconnect.

    The socket persists across `roundtrip` calls (the demo paid a fresh
    TCP handshake per helper leg). A timeout on either leg surfaces as
    `TransportTimeout` and drops the connection — the response to a
    timed-out request must never be read as the answer to a later one.
    A stale pooled connection (peer restarted) gets one transparent
    reconnect+resend; a fresh connection failing is the peer's problem
    and raises immediately. The reconnect+resend runs inside the SAME
    per-call deadline as the original attempt (an absolute deadline is
    taken at entry and every leg — including the reconnect's TCP
    handshake — gets only the remaining budget), so a caller asking
    for `timeout` seconds never waits longer than that.

    `metrics`, when given (duck-typed: anything with `counter(name)`),
    counts transparent reconnects in `transport.reconnects` alongside
    the instance's `reconnects` attribute.
    """

    def __init__(
        self,
        host: str,
        port: int,
        connect_timeout: float = 5.0,
        metrics=None,
    ):
        self._host = host
        self._port = port
        self._connect_timeout = connect_timeout
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self.reconnects = 0
        self._c_reconnects = (
            metrics.counter("transport.reconnects")
            if metrics is not None
            else None
        )

    def _connect(self, budget: Optional[float] = None) -> socket.socket:
        timeout = self._connect_timeout
        if budget is not None:
            timeout = min(timeout, max(budget, 1e-3))
        failpoints.fire("transport.tcp.connect", error=TransportError)
        try:
            return socket.create_connection(
                (self._host, self._port), timeout=timeout
            )
        except OSError as e:
            raise TransportError(
                f"cannot connect to {self._host}:{self._port}: {e}"
            ) from e

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:  # pragma: no cover - close best-effort
                pass
            self._sock = None

    def _count_reconnect(self) -> None:
        self.reconnects += 1
        if self._c_reconnects is not None:
            self._c_reconnects.inc()

    def _exchange(self, sock, payload, timeout, on_sent) -> bytes:
        if timeout is not None and timeout <= 0:
            raise socket.timeout("per-call deadline exhausted")
        sock.settimeout(timeout)
        failpoints.fire("transport.tcp.send", error=TransportError)
        payload = failpoints.mutate("transport.request", payload)
        send_msg(sock, payload)
        if on_sent is not None:
            on_sent()
        failpoints.fire("transport.tcp.recv", error=TransportError)
        return failpoints.mutate("transport.response", recv_msg(sock))

    def roundtrip(self, payload, timeout=None, on_sent=None):
        deadline = None if timeout is None else time.monotonic() + timeout

        def remaining() -> Optional[float]:
            return (
                None if deadline is None else deadline - time.monotonic()
            )

        with self._lock:
            reused = self._sock is not None
            if not reused:
                self._sock = self._connect(remaining())
            try:
                return self._exchange(
                    self._sock, payload, remaining(), on_sent
                )
            except (socket.timeout, TimeoutError) as e:
                self._drop()
                raise TransportTimeout(
                    f"no response from {self._host}:{self._port} "
                    f"within {timeout}s"
                ) from e
            except (TransportError, OSError) as e:
                self._drop()
                if not reused:
                    raise TransportError(str(e)) from e
                # Pooled connection went stale (peer restarted between
                # round trips): reconnect once and resend — but only
                # within what is left of THIS call's deadline.
                budget = remaining()
                if budget is not None and budget <= 0:
                    raise TransportTimeout(
                        f"connection to {self._host}:{self._port} went "
                        f"stale and no budget remains of {timeout}s to "
                        f"reconnect"
                    ) from e
                self._count_reconnect()
                self._sock = self._connect(budget)
                try:
                    return self._exchange(
                        self._sock, payload, remaining(), on_sent
                    )
                except (socket.timeout, TimeoutError) as e2:
                    self._drop()
                    raise TransportTimeout(
                        f"no response from {self._host}:{self._port} "
                        f"within {timeout}s"
                    ) from e2
                except (TransportError, OSError) as e2:
                    self._drop()
                    raise TransportError(str(e2)) from e2

    def close(self):
        with self._lock:
            self._drop()


class TcpTransportPool(Transport):
    """Up to `size` concurrent round trips to one peer, each on its own
    `TcpTransport` (connections opened on first use, reused after); a
    call waits for a free one. Failures and timeouts are the
    `TcpTransport`'s."""

    def __init__(self, host: str, port: int, size: int,
                 connect_timeout: float = 5.0, metrics=None):
        if size < 1:
            raise ValueError("size must be >= 1")
        self._free = [
            TcpTransport(host, port, connect_timeout=connect_timeout,
                         metrics=metrics)
            for _ in range(size)
        ]
        self._all = list(self._free)
        self._cond = threading.Condition()

    def roundtrip(self, payload, timeout=None, on_sent=None):
        with self._cond:
            while not self._free:
                self._cond.wait()
            transport = self._free.pop()
        try:
            return transport.roundtrip(payload, timeout=timeout, on_sent=on_sent)
        finally:
            with self._cond:
                self._free.append(transport)
                self._cond.notify()

    @property
    def reconnects(self) -> int:
        return sum(t.reconnects for t in self._all)

    def close(self):
        for t in self._all:
            t.close()


# ---------------------------------------------------------------------------
# Server side
# ---------------------------------------------------------------------------


class FramedTcpServer:
    """Threaded length-prefixed request->response server.

    Each connection loops framed-request -> `handler` -> framed-response
    until the peer disconnects (connection reuse on the serving side).
    A handler exception closes that connection — the client observes a
    `TransportError` and applies its own retry policy — and is logged
    rather than silently swallowed.
    """

    def __init__(
        self,
        handler: Callable[[bytes], bytes],
        host: str = "",
        port: int = 0,
        name: str = "serving",
    ):
        self._handler = handler
        self._name = name
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        data = recv_msg(self.request)
                    except (TransportError, OSError, struct.error):
                        return
                    try:
                        reply = outer._handler(data)
                    except Exception:
                        logger.exception(
                            "[%s] handler failed; closing connection",
                            outer._name,
                        )
                        return
                    try:
                        send_msg(self.request, reply)
                    except OSError:
                        return

        class _Server(socketserver.ThreadingTCPServer):
            # Live connections are tracked so `stop()` can really stop:
            # ThreadingTCPServer.shutdown() only ends the accept loop,
            # leaving per-connection daemon threads serving old sockets.
            allow_reuse_address = True
            daemon_threads = True
            # The port's change: socketserver's default accept backlog of
            # 5 drops the SYNs of clients that connect together (64 at a
            # time), whose connects then wait out the kernel's
            # retransmits (1 s, 3 s, ... up to 127 s).
            request_queue_size = 128

            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self._conns = set()
                self._conns_lock = threading.Lock()

            def process_request(self, request, client_address):
                with self._conns_lock:
                    self._conns.add(request)
                super().process_request(request, client_address)

            def shutdown_request(self, request):
                with self._conns_lock:
                    self._conns.discard(request)
                super().shutdown_request(request)

            def close_connections(self):
                with self._conns_lock:
                    conns = list(self._conns)
                for c in conns:
                    try:
                        c.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

        self._server = _Server((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "FramedTcpServer":
        """Serve on a background thread (tests, embedded use)."""
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            daemon=True,
            name=f"{self._name}-tcp",
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve on the calling thread (the CLI roles)."""
        self._server.serve_forever()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.close_connections()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
