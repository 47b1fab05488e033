"""Build and load the native ingest engine, `ingest/csrc/ingest_engine.cpp`.

The engine compiles on first use with the host C++ compiler (`$CXX`,
else `g++`) into a shared library with a plain C interface, which
`ctypes` loads.  The flags are the JAX package's (`-O3 -std=c++17
-shared -fPIC -pthread -Wall -Wextra`) plus the result of one probe:
a three-line compile against `<linux/io_uring.h>` that finds whether
the header declares the provided-buffer ring ABI the io_uring receive
backend needs (`VN_UAPI_HAS_PBUF_RING`).  Some headers declare those
constants as enum members, which the preprocessor cannot test for, so
only a compile can tell; where the header lacks them, the engine
defines them itself.

The library lands in `build/veneur_tpu_torch/` at the root of the
checkout, named by a hash of the source and the flags, and is written
through a temporary file and `os.replace`, so several processes may
build it at once.  A failed build raises with the compiler's output;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "csrc" / "ingest_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "veneur_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall",
             "-Wextra")
PROBE = b"""#include <linux/io_uring.h>
struct io_uring_buf_ring r; struct io_uring_buf_reg g;
int x = IORING_REGISTER_PBUF_RING + IORING_UNREGISTER_PBUF_RING;
"""

_lock = threading.Lock()
_lib = None


def cxx() -> str:
    """The C++ compiler: $CXX, else g++ on PATH."""
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise RuntimeError("no C++ compiler ($CXX or g++ on PATH): the "
                           "native ingest engine cannot be built")
    return found


def probe_pbuf_ring() -> bool:
    """Whether `<linux/io_uring.h>` declares the provided-buffer ring
    structs and register opcodes (a compile of PROBE succeeds)."""
    proc = subprocess.run([cxx(), "-fsyntax-only", "-x", "c++", "-"],
                          input=PROBE, capture_output=True)
    return proc.returncode == 0


def flags() -> tuple:
    """The full flag list: CXX_FLAGS and the probe's define."""
    return CXX_FLAGS + (f"-DVN_UAPI_HAS_PBUF_RING={int(probe_pbuf_ring())}",)


def _target(all_flags: tuple) -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(all_flags).encode())
    return BUILD_DIR / f"libvningest-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the engine if its library is missing.  Returns {"path",
    "seconds" (0 for a library already built), "probe" (the
    VN_UAPI_HAS_PBUF_RING value), "log"}; raises with the compiler's
    output if the compile fails."""
    t0 = time.perf_counter()
    all_flags = flags()
    probe = all_flags[len(CXX_FLAGS)].endswith("=1")
    probe_s = time.perf_counter() - t0
    lib = _target(all_flags)
    out = {"path": lib, "seconds": 0.0, "probe": probe,
           "probe_seconds": probe_s, "log": ""}
    if lib.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}."
                        f"{threading.get_ident()}")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx(), *all_flags, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    out.update(seconds=time.perf_counter() - t0,
               log=proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed:\n{out['log']}")
    os.replace(tmp, lib)
    return out


def load() -> ctypes.CDLL:
    """The loaded engine library (built if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()["path"]))
        return _lib
