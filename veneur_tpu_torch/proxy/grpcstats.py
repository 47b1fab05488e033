"""Connection open/close counters for the proxy's gRPC surfaces.

The port's copy of `veneur_tpu.proxy.grpcstats`, which mirrors
`proxy/grpcstats/stats.go:1-49`: the reference registers a gRPC
`stats.Handler` emitting `grpc.conn_open`/`grpc.conn_closed` (server
side) and per-destination channel events (client side).  Python gRPC
does not expose raw TCP connection callbacks, so the closest 1:1
signals are used:

  * server side — a `ServerInterceptor` counting stream begin/end.  Every
    local veneur (and proxy hop) holds ONE long-lived `SendMetricsV2`
    stream per connection (`connect.go:76-133`), so stream lifecycle tracks
    connection lifecycle for the Forward service.
  * client side — channel connectivity-state transitions on each
    destination channel (`READY` = open, leaving `READY` = closed).

The counters are read with `snapshot()` (the proxy's `/debug/vars`).
The JAX package also mirrors them to a statsd client under the
reference's metric names; that hookup comes with self-telemetry
(ROADMAP A16), so `statsd` other than None raises.
"""

from __future__ import annotations

import threading
from typing import Optional

import grpc

CONN_OPEN = "grpc.conn_open"
CONN_CLOSED = "grpc.conn_closed"


class GrpcStats:
    def __init__(self, statsd=None, tags: Optional[list[str]] = None):
        if statsd is not None:
            raise NotImplementedError(
                "GrpcStats(statsd=...) is not ported yet (ROADMAP A16)")
        self.tags = tags or []
        self._lock = threading.Lock()
        self.opened = 0
        self.closed = 0
        self.client_opened = 0
        self.client_closed = 0

    def conn_open(self) -> None:
        with self._lock:
            self.opened += 1

    def conn_closed(self) -> None:
        with self._lock:
            self.closed += 1

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {"opened": self.opened, "closed": self.closed,
                    "client_opened": self.client_opened,
                    "client_closed": self.client_closed}

    # -- server side -------------------------------------------------------

    def interceptor(self) -> grpc.ServerInterceptor:
        stats = self

        class _Interceptor(grpc.ServerInterceptor):
            def intercept_service(self, continuation, handler_call_details):
                handler = continuation(handler_call_details)
                if handler is None:
                    return None
                return _wrap_handler(handler, stats)

        return _Interceptor()

    # -- client side -------------------------------------------------------

    def watch_channel(self, channel: grpc.Channel) -> None:
        """Count READY transitions as opens, departures from READY as
        closes (the channel-level analog of ConnBegin/ConnEnd)."""
        state = {"ready": False}
        stats = self

        def on_change(connectivity):
            ready = connectivity == grpc.ChannelConnectivity.READY
            if ready and not state["ready"]:
                with stats._lock:
                    stats.client_opened += 1
            elif not ready and state["ready"]:
                with stats._lock:
                    stats.client_closed += 1
            state["ready"] = ready

        channel.subscribe(on_change, try_to_connect=False)


def _wrap_handler(handler: grpc.RpcMethodHandler,
                  stats: GrpcStats) -> grpc.RpcMethodHandler:
    """Wrap whichever behavior the handler carries so stream begin/end is
    counted once per RPC."""

    def counted(behavior):
        def run(request_or_iterator, context):
            stats.conn_open()
            try:
                return behavior(request_or_iterator, context)
            finally:
                stats.conn_closed()
        return run

    if handler.unary_unary:
        return grpc.unary_unary_rpc_method_handler(
            counted(handler.unary_unary),
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer)
    if handler.unary_stream:
        return grpc.unary_stream_rpc_method_handler(
            counted(handler.unary_stream),
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer)
    if handler.stream_unary:
        return grpc.stream_unary_rpc_method_handler(
            counted(handler.stream_unary),
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer)
    return grpc.stream_stream_rpc_method_handler(
        counted(handler.stream_stream),
        request_deserializer=handler.request_deserializer,
        response_serializer=handler.response_serializer)
