"""Minimal snappy block-format codec (compress + decompress).

The port's copy of `veneur_tpu.util.snappy`.

The cortex sink needs `Content-Encoding: snappy` for Prometheus
remote-write (reference: `sinks/cortex/cortex.go:194` uses
golang/snappy.Encode).  The port uses no python-snappy, so it implements
the block format directly.

The encoder emits a *valid but literal-only* stream (a legal snappy
encoding: any block may be encoded as literals; readers cannot tell the
difference).  Metric payloads are small and mostly-unique strings, so the
lost compression is an acceptable trade for zero dependencies.  The
decoder handles the full format (literals + all three copy element sizes)
so we can round-trip and accept compressed bodies from real writers in
tests.

Format reference (public): github.com/google/snappy format_description.txt.
"""

from __future__ import annotations


def _write_uvarint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def compress(data: bytes) -> bytes:
    """Encode `data` as a literal-only snappy block stream."""
    out = bytearray(_write_uvarint(len(data)))
    pos = 0
    n = len(data)
    while pos < n:
        # one literal element, max 2^24 bytes each (3-byte length form)
        chunk = data[pos:pos + (1 << 24)]
        ln = len(chunk) - 1
        if ln < 60:
            out.append(ln << 2)
        elif ln < (1 << 8):
            out.append(60 << 2)
            out.append(ln)
        elif ln < (1 << 16):
            out.append(61 << 2)
            out += ln.to_bytes(2, "little")
        else:
            out.append(62 << 2)
            out += ln.to_bytes(3, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Decode a snappy block stream (full format)."""
    expected, pos = _read_uvarint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:  # literal
            ln = tag >> 2
            if ln < 60:
                ln += 1
            else:
                extra = ln - 59  # 60->1, 61->2, 62->3, 63->4 bytes
                ln = int.from_bytes(data[pos:pos + extra], "little") + 1
                pos += extra
            out += data[pos:pos + ln]
            pos += ln
        elif kind == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x07) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
            _copy(out, offset, ln)
        elif kind == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
            _copy(out, offset, ln)
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
            _copy(out, offset, ln)
    if len(out) != expected:
        raise ValueError(
            f"snappy length mismatch: got {len(out)}, want {expected}")
    return bytes(out)


def _copy(out: bytearray, offset: int, length: int) -> None:
    if offset == 0 or offset > len(out):
        raise ValueError("invalid snappy copy offset")
    start = len(out) - offset
    for i in range(length):  # may self-overlap; byte-at-a-time is correct
        out.append(out[start + i])
