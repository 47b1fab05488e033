"""The proxy's entry point (`cmd/veneur-proxy/main.go:29-136`).

    python -m veneur_tpu_torch.cli.veneur_proxy -f proxy.yaml [-device cpu]

loads the YAML config (`proxy.proxy_config_from_dict`, Go durations
included), boots the consistent-hash fan-in tier with its static
destinations or a discoverer (`discoverer: consul | kubernetes`, polled
every `discovery_interval`), writes `port_file` once its signal handlers
are in place, and serves until SIGTERM or SIGINT.  `-validate-config`
runs the loader, so an option the port does not serve refuses there,
and exits (the JAX CLI prints "config valid" without parsing).

The `/query` merge runs on `-device`: CUDA by default, which fails the
boot when there is no CUDA device.  A non-empty `sentry_dsn` refuses
(Sentry reports are ROADMAP A16).  Exit codes: 0 after a clean
shutdown, 1 for a bad config or a failed boot, 2 when a thread dies
(`crash.py`).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

import yaml


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="veneur-tpu-torch-proxy")
    p.add_argument("-f", dest="config", metavar="FILE", required=False,
                   help="The config file to read for settings.")
    p.add_argument("-validate-config", action="store_true",
                   dest="validate_config",
                   help="Validate the config file and exit.")
    p.add_argument("-device", default="cuda",
                   help="The device the /query merge runs on: cuda (the "
                        "default; the boot fails without one) or cpu.")
    return p


def load(path: str):
    """(ProxyConfig, the raw YAML dict) of a config file; raises what
    the loader refuses."""
    from veneur_tpu_torch.proxy.proxy import proxy_config_from_dict

    data = {}
    if path:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
    if data.get("sentry_dsn"):
        raise NotImplementedError(
            "sentry_dsn is not supported here (Sentry reports, ROADMAP "
            "A16)")
    return proxy_config_from_dict(data), data


def discoverer_from(data: dict):
    """The discoverer a config names, or None for its static list."""
    from veneur_tpu_torch import discovery

    kind = data.get("discoverer", "")
    if kind == "kubernetes":
        return discovery.KubernetesDiscoverer()
    if kind == "consul":
        return discovery.ConsulDiscoverer(
            data.get("consul_url", "http://127.0.0.1:8500"))
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        cfg, data = load(args.config)
    except Exception as e:
        print(f"error reading config file: {e}", file=sys.stderr)
        return 1
    if args.validate_config:
        print("config valid")
        return 0

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    # a dying thread ends the process, so that the supervisor restarts it
    from veneur_tpu_torch import crash
    crash.install(terminate=True)

    from veneur_tpu_torch.proxy.proxy import Proxy
    try:
        proxy = Proxy(cfg, discoverer=discoverer_from(data),
                      device=args.device)
        proxy.start()
    except Exception as e:
        logging.getLogger("veneur_tpu_torch").exception("proxy boot failed")
        print(f"proxy boot failed: {e}", file=sys.stderr)
        return 1
    logging.info("proxy serving grpc=:%d http=:%d", proxy.grpc_port,
                 proxy.http_port)
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    # the handlers go in before the port file: its appearance is the
    # boot-complete marker (cli/portfile.py)
    previous = {signum: signal.signal(signum, on_signal)
                for signum in (signal.SIGTERM, signal.SIGINT)}
    try:
        if cfg.port_file:
            from veneur_tpu_torch.cli.portfile import write_port_file
            write_port_file(cfg.port_file, {"grpc": proxy.grpc_port,
                                            "http": proxy.http_port})
        while not stop.wait(0.2):
            pass
    finally:
        proxy.stop()
        for signum, handler in previous.items():
            signal.signal(signum, handler)
    return 0


if __name__ == "__main__":
    sys.exit(main())
