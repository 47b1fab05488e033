"""The port file: the resolved addresses of a process whose listeners
may have bound port 0, for its supervisor (systemd, k8s, a test
harness).

Written to a temporary file and moved into place with os.replace, so a
reader never sees a torn JSON.  Its appearance is the boot-complete
marker, so a writer installs its signal handlers before writing it.
"""

from __future__ import annotations

import json
import os


def write_port_file(path: str, ports: dict) -> None:
    ports = dict(ports)
    ports["pid"] = os.getpid()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(ports))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
