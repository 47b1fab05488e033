"""Crash plumbing: a thread that dies ends the process.

Counterpart of the reference's `ConsumePanic` (`sentry.go:22-64`), which
reports a goroutine's panic and panics again so that the supervisor
restarts the process.  `install()` sets `threading.excepthook` and
`sys.excepthook`: an uncaught exception in any thread (a listener, the
flush ticker, the HTTP API) is logged with its traceback and, with
`terminate=True`, ends the process with exit code 2 instead of leaving
it running without that thread.  Reports to Sentry (`sentry_dsn`) are
not ported (ROADMAP A16).

`panics_detected` and `last_panic` record what was caught.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import traceback
from typing import Callable, Optional

logger = logging.getLogger("veneur_tpu_torch.crash")

panics_detected = 0
last_panic: Optional[dict] = None

_installed = False
_prev_threading_hook = None
_prev_sys_hook = None


def _report(exc_type, exc_value, exc_tb, thread_name: str,
            terminate: bool, on_panic: Optional[Callable]) -> None:
    global panics_detected, last_panic
    panics_detected += 1
    tb_str = "".join(traceback.format_exception(exc_type, exc_value, exc_tb))
    last_panic = {"thread": thread_name, "type": exc_type.__name__,
                  "value": str(exc_value), "traceback": tb_str}
    logger.critical("panic in thread %s: %s\n%s",
                    thread_name, exc_value, tb_str)
    if on_panic is not None:
        try:
            on_panic(last_panic)
        except Exception:
            logger.exception("on_panic callback failed")
    if terminate:
        # the reference panics again after reporting (sentry.go:59-63)
        os._exit(2)


def install(terminate: bool = True,
            on_panic: Optional[Callable[[dict], None]] = None) -> None:
    """Install the process-wide hooks.  Idempotent."""
    global _installed, _prev_threading_hook, _prev_sys_hook
    if _installed:
        return
    _installed = True
    _prev_threading_hook = threading.excepthook
    _prev_sys_hook = sys.excepthook

    def thread_hook(args) -> None:
        if args.exc_type is SystemExit:
            return
        name = args.thread.name if args.thread is not None else "?"
        _report(args.exc_type, args.exc_value, args.exc_traceback,
                name, terminate, on_panic)

    def main_hook(exc_type, exc_value, exc_tb) -> None:
        if exc_type is KeyboardInterrupt:
            _prev_sys_hook(exc_type, exc_value, exc_tb)
            return
        _report(exc_type, exc_value, exc_tb, "MainThread",
                terminate, on_panic)

    threading.excepthook = thread_hook
    sys.excepthook = main_hook


def uninstall() -> None:
    """Restore the hooks install() replaced."""
    global _installed
    if not _installed:
        return
    _installed = False
    threading.excepthook = _prev_threading_hook
    sys.excepthook = _prev_sys_hook
