"""Result-dir naming utilities (port of limbo_tpu/utils/sysinfo.py; limbo
tools/sys.hpp:63-92)."""

from __future__ import annotations

import datetime
import os
import socket


def date() -> str:
    return datetime.datetime.now().strftime("%Y-%m-%d_%H_%M_%S")


def hostname() -> str:
    return socket.gethostname()


def getpid() -> str:
    return str(os.getpid())


def make_res_dir(base: str = ".") -> str:
    """Create the `hostname_date_pid` result dir under `base` (limbo
    BoBase::_make_res_dir, bayes_opt/bo_base.hpp:276-283)."""
    name = f"{hostname()}_{date()}_{getpid()}"
    path = os.path.join(base, name)
    os.makedirs(path, exist_ok=True)
    return path
