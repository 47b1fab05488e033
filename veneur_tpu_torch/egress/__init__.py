"""Egress data plane: async sink fan-out with per-sink breakers,
bounded retries, and spool-backed durable delivery.

Counterpart of `veneur_tpu.egress`.  See egress/plane.py for the
architecture; egress/breaker.py holds the per-sink circuit breaker.
"""

from veneur_tpu_torch.egress.breaker import CircuitBreaker
from veneur_tpu_torch.egress.plane import (EgressJob, EgressPlane, SinkLane,
                                           decode_metrics, encode_metrics)

__all__ = ["CircuitBreaker", "EgressJob", "EgressPlane", "SinkLane",
           "decode_metrics", "encode_metrics"]
