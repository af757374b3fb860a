"""paddle.distributed.utils (counterpart of paddle_tpu/distributed/utils.py):
the launch helpers. `Pod` and `get_cluster`, which the JAX module
re-exports from `launch.py`, wait for the launcher (ROADMAP §1 item 8h).
"""
from __future__ import annotations

import logging
import socket
from contextlib import closing

__all__ = ["get_logger", "get_host_name_ip", "find_free_ports",
           "terminate_local_procs", "add_arguments"]


def get_logger(log_level=20, name="root"):
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s-%(levelname)s: %(message)s"))
        logger.addHandler(h)
    return logger


def get_host_name_ip():
    """(host name, its address), or None when it does not resolve."""
    try:
        host = socket.gethostname()
        return host, socket.gethostbyname(socket.getfqdn(host))
    except OSError:
        return None


def find_free_ports(num):
    """A set of `num` TCP ports of this host that are free now, or None."""
    ports = set()
    for _ in range(num * 10):
        if len(ports) >= num:
            break
        with closing(socket.socket(socket.AF_INET,
                                   socket.SOCK_STREAM)) as s:
            s.bind(("", 0))
            ports.add(s.getsockname()[1])
    return ports if len(ports) >= num else None


def terminate_local_procs(procs):
    """Terminate launched children (each a Popen or has `.proc`), then
    wait up to 10 s for each and kill what is left."""
    for p in procs:
        proc = getattr(p, "proc", p)
        if proc is not None and proc.poll() is None:
            proc.terminate()
    for p in procs:
        proc = getattr(p, "proc", p)
        if proc is None:
            continue
        try:
            proc.wait(timeout=10)
        except Exception:       # TimeoutExpired: it would not stop
            proc.kill()


def add_arguments(argname, type, default, help, argparser, **kwargs):  # noqa: A002
    argparser.add_argument("--" + argname, default=default, type=type,
                           help=help + " Default: %(default)s.", **kwargs)
