"""The server's entry point (`cmd/veneur/main.go:44-215`).

    python -m veneur_tpu_torch.cli.veneur -f config.yaml [-device cpu]

loads the YAML config (template expansion and `VENEUR_*` environment
overrides, `util/config/config.go:16-63`), boots the server and the HTTP
API on `http_address`, writes `port_file` once its signal handlers are
in place, and flushes once an interval until SIGTERM or SIGINT (a
shutdown, with the final flush when `flush_on_shutdown` is set) or
SIGUSR2 (the zero-drop handoff to a replacement bound to the same UDP
ports).  `-validate-config[-strict]` checks the config, prints it and
exits; `-print-secrets` turns off the redaction of that dump.

The flush runs on `-device`: CUDA by default, which raises at boot when
there is no CUDA device; `-device cpu` runs the plain PyTorch versions.
Exit codes: 0 after a clean shutdown, 1 for a bad config or a failed
boot, 2 when a thread dies (`crash.py`).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

from veneur_tpu_torch import config as config_mod
from veneur_tpu_torch.util.build import BUILD_DATE, VERSION


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="veneur-tpu-torch")
    p.add_argument("-f", dest="config", metavar="FILE",
                   help="The config file to read for settings.")
    p.add_argument("-validate-config", action="store_true",
                   dest="validate_config",
                   help="Validate the config file and exit.")
    p.add_argument("-validate-config-strict", action="store_true",
                   dest="validate_strict",
                   help="Validate the config file, rejecting unknown "
                        "fields, and exit.")
    p.add_argument("-print-secrets", action="store_true",
                   dest="print_secrets",
                   help="Disable redaction when dumping config.")
    p.add_argument("-version", action="store_true", dest="version")
    p.add_argument("-device", default="cuda",
                   help="The device the flush runs on: cuda (the "
                        "default; the boot fails without one) or cpu.")
    return p


def _write_port_file(path: str, server, api) -> None:
    from veneur_tpu_torch.cli.portfile import write_port_file
    ports = server.resolved_ports()
    ports["http"] = list(api.address) if api is not None else None
    write_port_file(path, ports)


def _boot(cfg, device: str):
    """Server and HTTP API, started; raises what failed."""
    import torch

    from veneur_tpu_torch import resolve_device
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.http_api import HttpApi

    dev = resolve_device(device)
    if dev.type == "cuda":
        # the card's context now, so that a broken card fails the boot
        # and not the first flush
        torch.empty(1, device=dev)
    server = Server(cfg, device=dev)
    api = None
    try:
        server.start()
        if cfg.http_address:
            api = HttpApi(server, cfg.http_address)
            api.start()
    except Exception:
        server.shutdown()
        raise
    return server, api


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"veneur-tpu-torch {VERSION} (built {BUILD_DATE})")
        return 0
    if not args.config:
        print("You must specify a config file", file=sys.stderr)
        return 1

    try:
        cfg = config_mod.read_config(args.config,
                                     strict=args.validate_strict)
    except Exception as e:
        print(f"error reading config file: {e}", file=sys.stderr)
        return 1
    if args.validate_config or args.validate_strict:
        import yaml
        dump = config_mod.redacted_dict(cfg, redact=not args.print_secrets)
        print(yaml.safe_dump(dump, default_flow_style=False), end="")
        print("config valid")
        return 0

    logging.basicConfig(
        level=logging.DEBUG if cfg.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")

    # a dying thread ends the process, so that the supervisor restarts
    # it (cmd/veneur/main.go:63-79)
    from veneur_tpu_torch import crash
    crash.install(terminate=True)

    # a failed boot is a plain non-zero exit with its cause on stderr,
    # which a supervisor keys its restart decisions off
    try:
        server, api = _boot(cfg, args.device)
    except Exception as e:
        logging.getLogger("veneur_tpu_torch").exception("server boot failed")
        print(f"server boot failed: {e}", file=sys.stderr)
        return 1

    def on_signal(signum, frame):
        # only unblock serve(): the teardown, which may flush and take
        # locks the interrupted frame holds, runs below
        server.stop_serving()

    # the handlers go in before the port file: its appearance is the
    # boot-complete marker, and a supervisor may signal at once.
    # SIGUSR2 is the zero-drop handoff (server.go:1365-1413): the
    # supervisor has started the replacement, which joined the
    # SO_REUSEPORT groups, and this process drains and exits
    previous = {
        signal.SIGTERM: signal.signal(signal.SIGTERM, on_signal),
        signal.SIGINT: signal.signal(signal.SIGINT, on_signal),
        signal.SIGUSR2: signal.signal(
            signal.SIGUSR2, lambda s, f: server.request_graceful_restart()),
    }
    try:
        if cfg.port_file:
            _write_port_file(cfg.port_file, server, api)
        server.serve()
    finally:
        if api is not None:
            api.stop()
        if server._graceful_restart:
            server.graceful_restart_drain()
        else:
            server.shutdown()
        for signum, handler in previous.items():
            signal.signal(signum, handler)
    return 0


if __name__ == "__main__":
    sys.exit(main())
