"""Dependency-free AWS Signature Version 4 request signing.

The port's copy of `veneur_tpu.util.awsauth`.

The reference's s3/cloudwatch sinks authenticate through the AWS Go SDK
(`sinks/s3/s3.go:33`, `sinks/cloudwatch/cloudwatch.go:37`); the port uses
no boto3, so the real-backend path signs requests directly — SigV4 is pure
hmac/hashlib (the algorithm is published in the AWS General Reference,
"Signature Version 4 signing process").  Produces the same `Authorization`
header botocore would, verified by a recomputing fake server in
tests/test_torch_sinks.py.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse
from dataclasses import dataclass
from typing import Optional


@dataclass
class Credentials:
    access_key: str
    secret_key: str
    session_token: str = ""

    @classmethod
    def from_env(cls) -> Optional["Credentials"]:
        ak = os.environ.get("AWS_ACCESS_KEY_ID", "")
        sk = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        if not ak or not sk:
            return None
        return cls(ak, sk, os.environ.get("AWS_SESSION_TOKEN", ""))

    @classmethod
    def resolve(cls, cfg: dict) -> Optional["Credentials"]:
        """Sink-config credentials, falling back to the environment —
        the shared resolution for every AWS-speaking sink."""
        ak = cfg.get("aws_access_key_id")
        sk = cfg.get("aws_secret_access_key")
        if ak and sk:
            return cls(ak, sk, cfg.get("aws_session_token") or "")
        if ak or sk:
            import logging
            logging.getLogger("veneur_tpu_torch.awsauth").warning(
                "half-configured AWS credentials (only %s set in sink "
                "config); ignoring them and falling back to the "
                "environment",
                "aws_access_key_id" if ak else "aws_secret_access_key")
        return cls.from_env()

    @classmethod
    def config_has_explicit(cls, cfg: dict) -> bool:
        """True when the sink config itself names credentials or an
        endpoint override — the operator wants THIS identity/target, not
        whatever ambient chain an SDK would pick."""
        return bool((cfg.get("aws_access_key_id")
                     and cfg.get("aws_secret_access_key"))
                    or cfg.get("aws_endpoint"))


def _split_query(query: str) -> list[tuple[str, str]]:
    """Split a raw query string WITHOUT decoding '+' as space (parse_qsl
    would, mis-canonicalizing literal plus signs — AWS canonicalizes the
    bytes as sent)."""
    pairs = []
    if not query:
        return pairs
    for part in query.split("&"):
        k, _, v = part.partition("=")
        pairs.append((urllib.parse.unquote(k), urllib.parse.unquote(v)))
    return pairs


def _sorted_encoded(pairs):
    """SigV4 sorts canonical query parameters by their URI-ENCODED names
    (and values), not the decoded forms — the orders differ when encoded
    characters sort around literals."""
    return sorted(pairs, key=lambda kv: (_uri_encode(kv[0]),
                                         _uri_encode(kv[1])))


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-_.~" if encode_slash else "-_.~/"
    return urllib.parse.quote(s, safe=safe)


def _canonical_request(method: str, url: str, lower_headers: dict,
                       signed_names: list[str], payload_hash: str) -> str:
    """The shared canonicalization used by both signing and the test
    fake's verification — one algorithm, not two drifting copies."""
    parsed = urllib.parse.urlparse(url)
    canonical_uri = _uri_encode(parsed.path or "/", encode_slash=False)
    canonical_query = "&".join(
        f"{_uri_encode(k)}={_uri_encode(v)}"
        for k, v in _sorted_encoded(_split_query(parsed.query)))
    canonical_headers = "".join(
        f"{k}:{lower_headers.get(k, '')}\n" for k in signed_names)
    return "\n".join([
        method.upper(), canonical_uri, canonical_query,
        canonical_headers, ";".join(signed_names), payload_hash])


def _signature(canonical_request: str, amz_date: str, datestamp: str,
               region: str, service: str, secret_key: str
               ) -> tuple[str, str]:
    """(scope, hex signature) for a canonical request."""
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])
    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    return scope, hmac.new(k, string_to_sign.encode(),
                           hashlib.sha256).hexdigest()


def sign_request(method: str, url: str, headers: dict, body: bytes,
                 creds: Credentials, region: str, service: str,
                 now: Optional[datetime.datetime] = None,
                 sign_payload_header: bool = True) -> dict:
    """Return a new header dict carrying the SigV4 `Authorization`,
    `x-amz-date`, `x-amz-content-sha256` (and session token) headers for
    the given request.  `sign_payload_header=False` omits the
    content-sha256 header (query-protocol style; S3 requires it)."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    parsed = urllib.parse.urlparse(url)
    host = parsed.netloc
    payload_hash = hashlib.sha256(body or b"").hexdigest()

    out = dict(headers)
    out["host"] = host
    out["x-amz-date"] = amz_date
    if sign_payload_header:
        out["x-amz-content-sha256"] = payload_hash
    if creds.session_token:
        out["x-amz-security-token"] = creds.session_token

    signed_names = sorted(k.lower() for k in out)
    lower = {k.lower(): str(v).strip() for k, v in out.items()}
    canonical = _canonical_request(method, url, lower, signed_names,
                                   payload_hash)
    scope, signature = _signature(canonical, amz_date, datestamp, region,
                                  service, creds.secret_key)
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={creds.access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed_names)}, Signature={signature}")
    # `host` travels via the connection; requests sets it itself
    del out["host"]
    return out


def verify_signature(method: str, url: str, headers: dict, body: bytes,
                     secret_key: str) -> bool:
    """Recompute the signature from a received request (test fake's side).
    Parses the Authorization header for scope + signed headers and
    re-derives; returns True on match."""
    auth = headers.get("Authorization") or headers.get("authorization", "")
    if not auth.startswith("AWS4-HMAC-SHA256"):
        return False
    parts = dict(p.strip().split("=", 1)
                 for p in auth.split(" ", 1)[1].split(","))
    cred = parts["Credential"].split("/")
    _, datestamp, region, service, _ = cred
    signed_headers = parts["SignedHeaders"].split(";")
    amz_date = headers.get("x-amz-date") or headers.get("X-Amz-Date", "")
    payload_hash = hashlib.sha256(body or b"").hexdigest()

    lower = {k.lower(): str(v).strip() for k, v in headers.items()}
    canonical = _canonical_request(method, url, lower, signed_headers,
                                   payload_hash)
    _, want = _signature(canonical, amz_date, datestamp, region, service,
                         secret_key)
    return hmac.compare_digest(want, parts["Signature"])
