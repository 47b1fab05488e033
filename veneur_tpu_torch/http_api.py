"""Operator HTTP API: health, version, the live query plane and the
gated operator routes.

Counterpart of `veneur_tpu.http_api` (`http.go:15-67`) for what this
package serves:

  GET  /healthcheck   "ok"
  GET  /version       the build's version (util/build.py)
  GET  /builddate     its build date
  GET  /query         windowed quantiles served between flushes
                      (?name=&window_s=|slots=&q=0.5,0.99&tags=
                      [&type=histogram|timer][&group_by=...&top=&by=]
                      [&since=&step=&until=]): the server's QueryEngine
                      parses, fuses and evaluates, and returns the status
                      with the JSON body (404 while query_window_slots
                      is 0)
  GET  /config/json   the config, secrets redacted
  GET  /config/yaml   (both with http_config_endpoint,
                      util/config/config.go:65-96)
  POST /quitquitquit  shutdown() on a thread (with http_quit)
  POST /flush         one flush now, answering {"flush_count": n} (with
                      http_flush_endpoint; an unauthenticated flush
                      trigger is a lever against production, hence the
                      gate)
  POST /checkpoint    one checkpoint cut now (checkpoint_now), answering
                      {"ok": bool, "writes": n}, 500 when it failed
                      (with http_flush_endpoint too)

Every other path answers 404: a gated route while its option is off,
and the JAX package's /debug/* (ROADMAP A16), which are not ported
yet.  The caller builds and starts `HttpApi`
(`cli/veneur.py` does on `http_address`; `Server` starts no HTTP
listener).
"""

from __future__ import annotations

import http.server
import json
import threading
import urllib.parse
from typing import Optional

import yaml

from veneur_tpu_torch import config as config_mod
from veneur_tpu_torch.util import netaddr
from veneur_tpu_torch.util.build import BUILD_DATE, VERSION

def reply(handler, code: int, body: bytes,
          ctype: str = "text/plain") -> None:
    handler.send_response(code)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def config_json_body(cfg_dict: dict) -> bytes:
    """util/config/config.go:65-77: indented JSON."""
    return json.dumps(cfg_dict, default=str, indent=2).encode()


def config_yaml_body(cfg_dict: dict) -> bytes:
    """util/config/config.go:78-96: YAML through a JSON round trip, so
    values that are not plain data dump as in the JSON body."""
    return yaml.safe_dump(
        json.loads(json.dumps(cfg_dict, default=str))).encode()


def make_handler(server) -> type:
    cfg = server.config

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_POST(self):
            if self.path == "/quitquitquit" and cfg.http_quit:
                reply(self, 200, b"terminating\n")
                threading.Thread(target=server.shutdown, daemon=True,
                                 name="quitquitquit").start()
            elif self.path == "/flush" and cfg.http_flush_endpoint:
                try:
                    server.flush()
                    # the answer follows the sinks' delivery, so that a
                    # harness reads what the interval sent
                    server.egress.settle(
                        timeout_s=max(10.0, cfg.interval))
                except Exception as e:
                    reply(self, 500, f"flush failed: {e}\n".encode())
                    return
                reply(self, 200, json.dumps(
                    {"flush_count": server.flush_count}).encode(),
                    "application/json")
            elif self.path == "/checkpoint" and cfg.http_flush_endpoint:
                try:
                    ok = server.checkpoint_now()
                except Exception as e:
                    reply(self, 500,
                          f"checkpoint failed: {e}\n".encode())
                    return
                reply(self, 200 if ok else 500, json.dumps(
                    {"ok": bool(ok),
                     "writes": server.checkpoint_stats["writes"]}
                ).encode(), "application/json")
            else:
                reply(self, 404, b"not found\n")

        def do_GET(self):
            if self.path == "/healthcheck":
                reply(self, 200, b"ok\n")
            elif self.path == "/version":
                reply(self, 200, VERSION.encode())
            elif self.path == "/builddate":
                reply(self, 200, BUILD_DATE.encode())
            elif self.path == "/config/json" and cfg.http_config_endpoint:
                reply(self, 200,
                      config_json_body(config_mod.redacted_dict(cfg)),
                      "application/json")
            elif self.path == "/config/yaml" and cfg.http_config_endpoint:
                reply(self, 200,
                      config_yaml_body(config_mod.redacted_dict(cfg)),
                      "application/x-yaml")
            elif self.path.startswith("/query"):
                q = urllib.parse.parse_qs(
                    urllib.parse.urlparse(self.path).query)
                code, body = server.query.serve(q)
                reply(self, code, json.dumps(body, indent=2).encode(),
                      "application/json")
            else:
                reply(self, 404, b"not found\n")

    return Handler


class HttpApi:
    """A threaded HTTP server for `server` on `address` ("host:port",
    port 0 for any free one; `address` after construction is the bound
    (host, port))."""

    def __init__(self, server, address: str):
        host, port = netaddr.split_hostport(address)

        class _Server(http.server.ThreadingHTTPServer):
            address_family = netaddr.family(host)

        self.httpd = _Server((host, port), make_handler(server))
        self.httpd.daemon_threads = True
        self.address = self.httpd.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="http-api")
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
