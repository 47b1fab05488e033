"""AWS CloudWatch sink: PutMetricData submission.

Capability twin of `sinks/cloudwatch/cloudwatch.go`
(`cloudwatch.go:37,131`): metrics become `MetricDatum` entries (tags as
dimensions, counters normalized to rate per the standard-unit mapping) in
a configured namespace, batched at the API limit.

The port's copy of `veneur_tpu.sinks.cloudwatch`.  The uploader is an
injection point: any callable `put_metric_data(namespace, metric_data)`
works (tests inject a recorder).  Without one, start() builds
SigV4-signed Query-API POSTs over the standard library
(`util/awsauth.py`) from the sink config's credentials or the AWS_*
environment, to `aws_endpoint` when it is set.  The JAX package first
tries boto3's credential chain when the config names neither credentials
nor an endpoint; the port uses no boto3.  The datum construction — the
testable contract — is independent of transport.
"""

from __future__ import annotations

import datetime as dt
import logging
import urllib.parse
from typing import Callable, Optional

from veneur_tpu_torch import sinks as sink_mod
from veneur_tpu_torch.util import awsauth

logger = logging.getLogger("veneur_tpu_torch.sinks.cloudwatch")

MAX_DATA_PER_CALL = 1000  # PutMetricData API limit
MAX_DIMENSIONS = 30


def flatten_query_params(namespace: str, metric_data: list[dict]) -> dict:
    """PutMetricData in the AWS Query protocol: nested structures flatten
    to `MetricData.member.N.<field>` form parameters."""
    params = {"Action": "PutMetricData", "Version": "2010-08-01",
              "Namespace": namespace}
    for i, d in enumerate(metric_data, 1):
        p = f"MetricData.member.{i}"
        params[f"{p}.MetricName"] = d["MetricName"]
        ts = d["Timestamp"]
        if isinstance(ts, (int, float)):
            ts = dt.datetime.fromtimestamp(
                ts, dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        params[f"{p}.Timestamp"] = ts
        params[f"{p}.Value"] = repr(float(d["Value"]))
        params[f"{p}.Unit"] = d.get("Unit", "None")
        for j, dim in enumerate(d.get("Dimensions", []), 1):
            params[f"{p}.Dimensions.member.{j}.Name"] = dim["Name"]
            params[f"{p}.Dimensions.member.{j}.Value"] = dim["Value"]
    return params


def _sigv4_uploader(cfg: dict):
    """Build `put_metric_data(namespace, metric_data)` doing SigV4-signed
    Query-API POSTs to CloudWatch (or an `aws_endpoint` override).
    Returns None without credentials."""
    creds = awsauth.Credentials.resolve(cfg)
    if creds is None:
        return None
    region = cfg.get("aws_region") or "us-east-1"
    endpoint = ((cfg.get("aws_endpoint") or "").rstrip("/")
                or f"https://monitoring.{region}.amazonaws.com")
    sessions = sink_mod.ParallelPoster(max_workers=1)

    def put(namespace, metric_data):
        body = urllib.parse.urlencode(
            flatten_query_params(namespace, metric_data)).encode()
        headers = awsauth.sign_request(
            "POST", endpoint + "/",
            {"content-type": "application/x-www-form-urlencoded"},
            body, creds, region, "monitoring")
        resp = sessions.session().post(endpoint + "/", data=body,
                                       headers=headers, timeout=30)
        resp.raise_for_status()

    return put


def metric_datum(m, interval_s: float, standard_unit_tag: str = "") -> dict:
    dims = []
    unit = "None"
    for t in m.tags:
        k, v = (t.split(":", 1) + [""])[:2]
        if standard_unit_tag and k == standard_unit_tag:
            unit = v or "None"
            continue
        if len(dims) < MAX_DIMENSIONS:
            dims.append({"Name": k, "Value": v or "none"})
    value = m.value
    if m.type == "counter" and interval_s > 0:
        value = m.value / interval_s
        if unit == "None":
            unit = "Count/Second"
    return {
        "MetricName": m.name,
        "Dimensions": dims,
        "Timestamp": int(m.timestamp),
        "Value": value,
        "Unit": unit,
    }


@sink_mod.register_metric_sink("cloudwatch")
class CloudWatchMetricSink(sink_mod.BaseMetricSink):
    KIND = "cloudwatch"

    def __init__(self, spec: Optional[sink_mod.SinkSpec] = None,
                 server_config=None,
                 put_metric_data: Optional[Callable] = None):
        spec = spec or sink_mod.SinkSpec(kind=self.KIND)
        super().__init__(spec.name, spec.config)
        cfg = self.config
        self.namespace = cfg.get("cloudwatch_namespace", "veneur")
        self.standard_unit_tag = cfg.get(
            "cloudwatch_standard_unit_tag_name", "")
        self.interval_s = float(
            getattr(server_config, "interval", 10.0) or 10.0)
        self.put_metric_data = put_metric_data
        self._warned = False

    def start(self, trace_client=None) -> None:
        if self.put_metric_data is not None:
            return
        # the real path: SigV4-signed Query-API POSTs (util/awsauth.py)
        self.put_metric_data = _sigv4_uploader(self.config)
        if self.put_metric_data is None and not self._warned:
            logger.warning(
                "cloudwatch sink %s: no uploader injected and no AWS "
                "credentials configured; metrics will be dropped",
                self._name)
            self._warned = True

    def flush(self, metrics):
        if not metrics:
            return sink_mod.MetricFlushResult()
        if self.put_metric_data is None:
            return sink_mod.MetricFlushResult(dropped=len(metrics))
        data = [metric_datum(m, self.interval_s, self.standard_unit_tag)
                for m in metrics]
        flushed = dropped = 0
        for i in range(0, len(data), MAX_DATA_PER_CALL):
            chunk = data[i:i + MAX_DATA_PER_CALL]
            try:
                self.put_metric_data(self.namespace, chunk)
                flushed += len(chunk)
            except Exception as e:
                logger.warning("cloudwatch PutMetricData failed: %s", e)
                dropped += len(chunk)
        return sink_mod.MetricFlushResult(flushed=flushed, dropped=dropped)

