"""Service discovery for the global tier's membership.

The port's copy of `veneur_tpu.discovery`, which mirrors `discovery/`:
the Discoverer contract (`discovery/discoverer.go:4-7`) with Consul healthy-instance queries
(`discovery/consul/consul.go:30-47`), Kubernetes pod-label queries
(`discovery/kubernetes/kubernetes.go:93-108`), plus a static list for
fixed fleets and tests.  Implementations use plain HTTP (urllib) and are
exercised against local fake endpoints in tests; real clusters are
reachable with the same code paths.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Protocol


class Discoverer(Protocol):
    def get_destinations_for_service(self, service: str) -> list[str]: ...


class StaticDiscoverer:
    """A fixed destination list (config-driven fleets, tests)."""

    def __init__(self, destinations: list[str]):
        self.destinations = list(destinations)

    def get_destinations_for_service(self, service: str) -> list[str]:
        return list(self.destinations)


class ConsulDiscoverer:
    """Healthy instances of a service from Consul's health API
    (consul.go:30-47: GET /v1/health/service/{service}?passing)."""

    def __init__(self, base_url: str = "http://127.0.0.1:8500",
                 timeout_s: float = 5.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def get_destinations_for_service(self, service: str) -> list[str]:
        url = f"{self.base_url}/v1/health/service/{service}?passing"
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            entries = json.loads(resp.read())
        out = []
        for entry in entries:
            svc = entry.get("Service", {})
            node = entry.get("Node", {})
            host = svc.get("Address") or node.get("Address")
            port = svc.get("Port")
            if host and port:
                out.append(f"{host}:{port}")
        return out


class KubernetesDiscoverer:
    """Pods labeled app={service} with a port named grpc (falling back to
    http), via the API server (kubernetes.go:93-108).  In-cluster auth
    uses the mounted service-account token."""

    TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"
    CA_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"

    def __init__(self, api_url: str = "", namespace: str = "default",
                 timeout_s: float = 5.0, insecure_skip_verify: bool = False):
        if not api_url:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "127.0.0.1")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            api_url = f"https://{host}:{port}"
        self.api_url = api_url.rstrip("/")
        self.namespace = namespace
        self.timeout_s = timeout_s
        self.insecure_skip_verify = insecure_skip_verify

    def _request(self, url: str):
        import ssl
        req = urllib.request.Request(url)
        if os.path.exists(self.TOKEN_PATH):
            with open(self.TOKEN_PATH) as f:
                req.add_header("Authorization", f"Bearer {f.read().strip()}")
        ctx = None
        if url.startswith("https"):
            if os.path.exists(self.CA_PATH):
                ctx = ssl.create_default_context(cafile=self.CA_PATH)
            elif self.insecure_skip_verify:
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            else:
                # never silently skip verification: a MITM could capture
                # the bearer token and forge the destination list
                ctx = ssl.create_default_context()
        return urllib.request.urlopen(req, timeout=self.timeout_s,
                                      context=ctx)

    def get_destinations_for_service(self, service: str) -> list[str]:
        url = (f"{self.api_url}/api/v1/namespaces/{self.namespace}/pods"
               f"?labelSelector=app%3D{service}")
        with self._request(url) as resp:
            pods = json.loads(resp.read())
        out = []
        for pod in pods.get("items", []):
            status = pod.get("status", {})
            if status.get("phase") != "Running":
                continue
            ip = status.get("podIP")
            if not ip:
                continue
            port = None
            fallback = None
            for c in pod.get("spec", {}).get("containers", []):
                for p in c.get("ports", []):
                    if p.get("name") == "grpc":
                        port = p.get("containerPort")
                    elif p.get("name") == "http":
                        fallback = p.get("containerPort")
            port = port or fallback
            if port:
                out.append(f"{ip}:{port}")
        return out
