"""Build metadata (`util/build/build.go:9-17`).

The reference injects VERSION and BUILD_DATE with -ldflags at link
time; here they are module constants that a packaged build may set
through the environment.
"""

from __future__ import annotations

import os

VERSION = os.environ.get("VENEUR_TPU_VERSION", "0.1.0-dev")
BUILD_DATE = os.environ.get("VENEUR_TPU_BUILD_DATE", "unknown")
