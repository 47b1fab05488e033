"""Kafka sink: metric production with pluggable transport.

The metric half of `veneur_tpu.sinks.kafka` (`sinks/kafka/kafka.go:48,74`;
the span half comes with the span pipeline, ROADMAP A15): metrics are
encoded (protobuf or JSON, per config) and produced to a configurable
topic, keyed for partition affinity.  The reference uses the sarama async
producer; here `kafka_brokers` selects the native wire-protocol producer
(`util/kafka_wire.py`), and the producer is also an injection point: any
callable `produce(topic, key, value)` works (tests inject a recorder).
Without either the sink encodes and counts but drops, logging once — the
encoding layer (the testable contract) is identical either way.
"""

from __future__ import annotations

import json
import logging
from typing import Callable, Optional

from veneur_tpu_torch import sinks as sink_mod
from veneur_tpu_torch.protocol import metric_pb2

logger = logging.getLogger("veneur_tpu_torch.sinks.kafka")

Producer = Callable[[str, bytes, bytes], None]  # (topic, key, value)


def _wire_producer(cfg: dict):
    """Native wire-protocol producer when `kafka_brokers` is configured
    (util/kafka_wire.py — no client library needed)."""
    brokers = cfg.get("kafka_brokers")
    if not brokers:
        return None
    if isinstance(brokers, str):
        brokers = [b.strip() for b in brokers.split(",") if b.strip()]
    from veneur_tpu_torch.util.kafka_wire import KafkaProducer
    return KafkaProducer(brokers,
                         client_id=cfg.get("client_id", "veneur-tpu"))


def metric_to_json(m, interval_s: float) -> bytes:
    return json.dumps({
        "Name": m.name,
        "Timestamp": m.timestamp,
        "Value": m.value,
        "Tags": list(m.tags),
        "Type": m.type,
        "Message": m.message,
        "HostName": m.hostname,
    }).encode()


def metric_to_proto(m) -> bytes:
    pb = metric_pb2.Metric(name=m.name, tags=list(m.tags))
    if m.type == "counter":
        pb.type = metric_pb2.Type.Counter
        pb.counter.value = int(m.value)
    else:
        pb.type = metric_pb2.Type.Gauge
        pb.gauge.value = float(m.value)
    return pb.SerializeToString()


@sink_mod.register_metric_sink("kafka")
class KafkaMetricSink(sink_mod.BaseMetricSink):
    KIND = "kafka"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None, producer: Optional[Producer] = None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)
        cfg = self.config
        self.topic = cfg.get("metric_topic", "veneur-metrics")
        self.serializer = cfg.get("metric_serializer", "json")  # json|proto
        self.interval_s = float(
            getattr(server_config, "interval", 10.0) or 10.0)
        self.producer = producer
        self._wire = None   # native wire-protocol producer (kafka_brokers)
        self._warned = False

    def start(self, trace_client=None) -> None:
        if self.producer is None and self._wire is None:
            self._wire = _wire_producer(self.config)
        if self.producer is None and self._wire is None \
                and not self._warned:
            logger.warning(
                "kafka sink %s has no producer injected and no "
                "kafka_brokers configured; metrics will be encoded then "
                "dropped", self._name)
            self._warned = True

    def flush(self, metrics):
        if not metrics:
            return sink_mod.MetricFlushResult()
        messages = []
        for m in metrics:
            key = f"{m.name}{m.type}".encode()
            value = (metric_to_proto(m) if self.serializer == "protobuf"
                     else metric_to_json(m, self.interval_s))
            messages.append((key, value))
        if self._wire is not None:
            acked = self._wire.produce_batch(self.topic, messages)
            return sink_mod.MetricFlushResult(
                flushed=acked, dropped=len(messages) - acked)
        flushed = dropped = 0
        for key, value in messages:
            if self.producer is None:
                dropped += 1
                continue
            try:
                self.producer(self.topic, key, value)
                flushed += 1
            except Exception as e:
                logger.warning("kafka produce failed: %s", e)
                dropped += 1
        return sink_mod.MetricFlushResult(flushed=flushed, dropped=dropped)
