"""JSON-over-HTTP serving layer (stdlib only, no new dependencies).

The reference's only deployment surface is ``streamlit run app.py``
(/root/reference/Procfile:1) — one interactive session, recomputing on every
widget rerun. mcport's production counterpart is a compile-once serve-many
daemon: ONE long-lived process owns the XLA jit and Pallas kernel caches, so
the first query at a given (paths, steps, assets) shape pays compilation and
every later query at that shape runs warm. That amortization is the entire
point of serving on an accelerator; a per-request CLI process would recompile
every time.

Protocol (deliberately the thinnest possible veneer over the tested CLI):

- ``GET  /health``        → ``{"status": "ok", "backend": ..., "commands": N}``
- ``GET  /v1/commands``   → the command names `POST /v1/<command>` accepts
- ``GET  /metrics``       → per-command request/error counts and wall times
- ``POST /v1/<command>``  → body ``{"args": [...], "options": {...}}``;
  positional ``args`` and ``options`` translate 1:1 to the CLI surface
  (``{"paths": 4096}`` → ``--paths 4096``; ``True`` → bare flag; a list →
  the flag repeated, for append-style options like bl-frontier's --view).
  The response body is exactly the JSON the CLI command emits.

Requests execute SEQUENTIALLY on purpose: there is one accelerator, JAX
tracing is not re-entrant, and queueing at the server beats queueing on the
device. Binds 127.0.0.1 by default — this layer adds no auth; put a real
proxy in front for anything public.
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["build_argv", "make_server", "run_command", "serve"]

_MAX_BODY = 8 << 20  # 8 MiB: inline price payloads stay well under this


def _commands() -> list[str]:
    from mcport.cli import build_parser

    for action in build_parser()._actions:
        if hasattr(action, "choices") and isinstance(action.choices, dict):
            return [c for c in action.choices if c != "serve"]
    return []


def build_argv(command: str, args: list | None, options: dict | None) -> list[str]:
    """Translate a JSON request into the CLI argv it is equivalent to.

    ``options`` keys may use underscores or dashes; values map as:
    ``True`` → bare flag, ``False``/``None`` → omitted, list → flag repeated
    per element (append-style options), anything else → ``--flag str(value)``.
    """
    argv = [command, *map(str, args or [])]
    for key, value in (options or {}).items():
        flag = "--" + str(key).replace("_", "-").lstrip("-")
        if value is None or value is False:
            continue
        if value is True:
            argv.append(flag)
        elif isinstance(value, (list, tuple)):
            for item in value:
                argv.extend((flag, str(item)))
        else:
            argv.extend((flag, str(value)))
    return argv


def run_command(argv: list[str]) -> tuple[int, bytes]:
    """Run one CLI command in-process, returning (http_status, json_body).

    stdout is captured (the command's ``_emit`` JSON becomes the response
    body); argparse rejections surface as 400 with the usage text instead of
    exiting the server process.
    """
    from mcport.cli import build_parser

    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            parsed = build_parser().parse_args(argv)
            parsed.fn(parsed)
    except SystemExit as exc:  # argparse --help/errors must not kill the server
        ok = not exc.code
        body = {"status": "ok"} if ok else {"error": "bad arguments"}
        # argparse writes usage to stderr, but `raise SystemExit("msg")` keeps
        # its message in exc.code (Python prints it only at interpreter exit).
        detail = (out.getvalue() + err.getvalue()).strip()
        if isinstance(exc.code, str):
            detail = f"{exc.code}\n{detail}".strip()
        body["detail"] = detail
        return (200 if ok else 400), json.dumps(body).encode()
    except (ValueError, FileNotFoundError, KeyError) as exc:
        return 400, json.dumps(
            {"error": f"{type(exc).__name__}: {exc}"}).encode()
    except Exception as exc:  # engine failure: report, keep serving
        return 500, json.dumps(
            {"error": f"{type(exc).__name__}: {exc}"}).encode()
    return 200, out.getvalue().encode()


class _Handler(BaseHTTPRequestHandler):
    server_version = "mcport"
    protocol_version = "HTTP/1.1"
    # Bound how long an idle keep-alive client may hold its connection open
    # between requests; engine work itself is unaffected (it runs to
    # completion once the request line has been read).
    timeout = 30.0

    def log_message(self, *_args) -> None:  # route through logging, not stderr
        pass

    def _reply(self, status: int, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self.path == "/health":
            def probe():
                import jax

                return jax.default_backend()

            # JAX touches stay on the single engine thread (consistent with
            # do_POST — backend init from an arbitrary handler thread is the
            # crash class the executor exists to prevent)
            backend = self.server.engine.submit(probe).result()
            body = {"status": "ok", "backend": backend,
                    "commands": len(self.server.commands)}
            self._reply(200, json.dumps(body).encode())
        elif self.path == "/v1/commands":
            self._reply(200, json.dumps(self.server.commands).encode())
        elif self.path == "/metrics":
            with self.server.metrics_lock:
                body = json.dumps(self.server.metrics).encode()
            self._reply(200, body)
        else:
            self._reply(404, b'{"error": "not found"}')

    def do_POST(self) -> None:  # noqa: N802
        if not self.path.startswith("/v1/"):
            self._reply(404, b'{"error": "not found"}')
            return
        command = self.path[len("/v1/"):]
        if command not in self.server.commands:
            self._reply(404, json.dumps(
                {"error": f"unknown command {command!r}",
                 "commands": self.server.commands}).encode())
            return
        length = int(self.headers.get("Content-Length") or 0)
        if length > _MAX_BODY:
            self._reply(413, b'{"error": "body too large"}')
            return
        raw = self.rfile.read(length) if length else b"{}"
        try:
            req = json.loads(raw or b"{}")
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
            argv = build_argv(command, req.get("args"), req.get("options"))
        except (ValueError, TypeError) as exc:
            self._reply(400, json.dumps({"error": str(exc)}).encode())
            return
        # One accelerator, one query at a time — and always the SAME thread:
        # connection handlers are per-thread (keep-alive), but JAX dispatch
        # and the compile caches live on a single dedicated worker so engine
        # state never hops threads.
        t0 = time.perf_counter()
        status, body = self.server.engine.submit(run_command, argv).result()
        self._record(command, status, time.perf_counter() - t0)
        self._reply(status, body)

    def _record(self, command: str, status: int, wall_s: float) -> None:
        """Per-command observability counters behind GET /metrics
        (SURVEY.md §5 metrics/logging — the serving layer's structured
        counterpart of utils.logging's JSONL)."""
        with self.server.metrics_lock:
            m = self.server.metrics["commands"].setdefault(
                command, {"count": 0, "errors": 0, "total_wall_s": 0.0,
                          "last_wall_s": 0.0})
            m["count"] += 1
            m["errors"] += status >= 400
            m["total_wall_s"] += wall_s
            m["last_wall_s"] = wall_s
            self.server.metrics["requests"] += 1


def make_server(host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """An HTTPServer ready for serve_forever(); port=0 picks a free port.

    Threading matters even though engine work is serialized: HTTP/1.1
    keep-alive (the default for pooled clients) leaves the handler blocked in
    ``readline()`` between requests, and a single-connection server would let
    one idle client starve everyone else. Each connection gets a daemon
    thread; all engine work funnels through ONE dedicated worker thread
    (single-tenant accelerator, and JAX state never hops threads).
    """
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.commands = _commands()
    server.engine = ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="mcport-engine")
    server.metrics = {"requests": 0, "commands": {}}
    server.metrics_lock = threading.Lock()
    return server


def serve(host: str = "127.0.0.1", port: int = 8799) -> None:
    """Blocking entry point used by ``mcport serve``."""
    server = make_server(host, port)
    print(json.dumps({"serving": f"http://{host}:{server.server_port}",
                      "commands": len(server.commands)}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.engine.shutdown(wait=False)
        server.server_close()
