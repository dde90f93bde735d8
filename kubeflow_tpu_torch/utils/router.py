"""Minimal JSON-over-HTTP router (stdlib only): a copy of
kubeflow_tpu.webapps.router for the port's serving front end.

Route patterns with ``<name>`` path params, JSON bodies both ways, and
``NdjsonStream`` responses written as chunked newline-delimited JSON.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlparse

from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger("router")


class RestError(Exception):
    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.status = status
        # Extra response headers (e.g. Retry-After on a 503 so clients
        # back off instead of hammering a backendless balancer).
        self.headers = dict(headers or {})


class NdjsonStream:
    """Handler return type for streaming responses: an iterator of
    JSON-able payloads written as newline-delimited JSON with chunked
    transfer encoding (the serving front-end's token streaming)."""

    def __init__(self, chunks):
        self.chunks = chunks


@dataclasses.dataclass
class Request:
    method: str
    path: str
    params: Dict[str, str]          # path params from <name> segments
    query: Dict[str, str]
    body: Dict[str, Any]
    caller: str                     # trusted identity header value ("" = anon)
    headers: Dict[str, str]


Handler = Callable[[Request], Any]


def _compile(pattern: str) -> re.Pattern:
    regex = re.sub(r"<([a-zA-Z_][a-zA-Z0-9_]*)>", r"(?P<\1>[^/]+)", pattern)
    return re.compile(f"^{regex}$")


class Router:
    """Method+pattern table. Handlers return a JSON-able payload (status
    200) or a (status, payload) tuple; raise RestError for error codes."""

    def __init__(self) -> None:
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        self._routes.append((method.upper(), _compile(pattern), handler))

    def get(self, pattern: str, handler: Handler) -> None:
        self.add("GET", pattern, handler)

    def post(self, pattern: str, handler: Handler) -> None:
        self.add("POST", pattern, handler)

    def dispatch(self, req: Request) -> Tuple[int, Any]:
        matched_path = False
        for method, pattern, handler in self._routes:
            m = pattern.match(req.path)
            if m is None:
                continue
            matched_path = True
            if method != req.method:
                continue
            # Percent-decode AFTER segment matching: a %2F in a resource
            # name must not smuggle a path separator past the pattern.
            req.params = {k: unquote(v) for k, v in m.groupdict().items()}
            out = handler(req)
            if isinstance(out, tuple):
                return out
            return 200, out
        if matched_path:
            return 405, {"error": f"method {req.method} not allowed"}
        return 404, {"error": f"no route for {req.path}"}


class JsonHttpServer:
    """ThreadingHTTPServer around a Router; ``start()`` serves on a daemon
    thread, ``stop()`` shuts down and releases the socket."""

    def __init__(
        self,
        router: Router,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        user_id_header: str = "x-goog-authenticated-user-email",
    ):
        self.router = router
        rt = router
        hdr = user_id_header

        class _Handler(BaseHTTPRequestHandler):
            # HTTP/1.1: chunked Transfer-Encoding (NdjsonStream) is not
            # defined for the default HTTP/1.0; every non-stream response
            # sends Content-Length, so keep-alive semantics stay correct.
            protocol_version = "HTTP/1.1"
            # Bound idle keep-alive connections: without a timeout each
            # persistent connection pins a ThreadingHTTPServer thread
            # forever in readline() (HTTP/1.0 used to close per response).
            timeout = 65

            def log_message(self, *a):
                pass

            def _serve(self, method: str) -> None:
                if "chunked" in (
                    self.headers.get("Transfer-Encoding") or ""
                ).lower():
                    # Body parsing is Content-Length-only; silently reading
                    # an empty body would leave chunk framing on the wire
                    # and desync the keep-alive connection.
                    self._send(411, {
                        "error": "chunked request bodies unsupported; "
                                 "send Content-Length"
                    })
                    self.close_connection = True
                    return
                self._serve_inner(method)

            def _serve_inner(self, method: str) -> None:
                url = urlparse(self.path)
                n = int(self.headers.get("Content-Length", "0") or 0)
                raw = self.rfile.read(n) if n else b""
                try:
                    body = json.loads(raw) if raw else {}
                except json.JSONDecodeError as e:
                    self._send(400, {"error": f"bad JSON body: {e}"})
                    return
                req = Request(
                    method=method,
                    path=url.path,
                    params={},
                    query={k: v[0] for k, v in parse_qs(url.query).items()},
                    body=body if isinstance(body, dict) else {"_": body},
                    caller=self.headers.get(hdr, ""),
                    headers={k.lower(): v for k, v in self.headers.items()},
                )
                extra_headers: Dict[str, str] = {}
                try:
                    status, payload = rt.dispatch(req)
                except RestError as e:
                    status, payload = e.status, {"error": str(e)}
                    extra_headers = e.headers
                except KeyError as e:
                    status, payload = 400, {"error": f"missing field {e}"}
                except Exception as e:  # surface, don't kill the thread
                    log.error("handler error", kv={"path": url.path,
                                                   "err": repr(e)})
                    status, payload = 500, {"error": "internal error"}
                self._send(status, payload, extra_headers)

            def _send(self, status: int, payload: Any,
                      extra_headers: Optional[Dict[str, str]] = None) -> None:
                if isinstance(payload, NdjsonStream):
                    # HTTP/1.0 clients cannot parse chunked transfer
                    # coding: stream to them close-delimited (raw NDJSON,
                    # end of body == connection close).
                    chunked = self.request_version != "HTTP/1.0"
                    self.send_response(status)
                    self.send_header("Content-Type", "application/x-ndjson")
                    if chunked:
                        self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    try:
                        for chunk in payload.chunks:
                            data = (json.dumps(chunk) + "\n").encode()
                            if chunked:
                                data = (
                                    f"{len(data):x}\r\n".encode() + data
                                    + b"\r\n"
                                )
                            self.wfile.write(data)
                            self.wfile.flush()
                        if chunked:
                            self.wfile.write(b"0\r\n\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass             # client went away mid-stream
                    except Exception as e:  # generator bug: end the
                        log.error("stream error",   # stream, keep thread
                                  kv={"err": repr(e)})
                    # The chunk framing may be incomplete on any error
                    # path above — never reuse this connection.
                    self.close_connection = True
                    return
                ctype, data = "application/json", json.dumps(payload).encode()
                self.send_response(status)
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                if (300 <= status < 400 and isinstance(payload, dict)
                        and "location" in payload):
                    self.send_header("Location", payload["location"])
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._serve("GET")

            def do_POST(self):
                self._serve("POST")

        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "JsonHttpServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        # shutdown() handshakes with serve_forever — calling it on a
        # never-started server waits forever on the is_shut_down event.
        if self._thread is not None:
            self.httpd.shutdown()
        # Release the listening socket: without server_close() the port
        # keeps accepting connections into the backlog after stop(), so a
        # "dead" server looks alive to health checks and failover logic.
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
