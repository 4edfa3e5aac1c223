"""Subcommand registry for the port's CLI (seaweedfs_tpu_torch.cli).

Commands self-register via @command; modules under this package are imported
for their registration side effects, as in seaweedfs_tpu.commands.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Callable

REGISTRY: dict[str, "Command"] = {}


@dataclass
class Command:
    name: str
    help: str
    configure: Callable[[argparse.ArgumentParser], None] = field(
        default=lambda p: None
    )
    run: Callable[[argparse.Namespace], int | None] = field(
        default=lambda a: None
    )


def command(name: str, help: str):
    """Register a subcommand: decorate a run(args) function; attach
    .configure via a `configure` attribute if flags are needed (resolved
    lazily so it may be assigned after decoration)."""

    def wrap(fn):
        cmd = Command(
            name=name,
            help=help,
            configure=lambda p: getattr(fn, "configure", lambda _: None)(p),
            run=fn,
        )
        REGISTRY[name] = cmd
        return fn

    return wrap


def _import_all() -> None:
    # command modules register on import; they defer torch and storage
    # imports into run() so `-h` stays fast
    from seaweedfs_tpu_torch.commands import (  # noqa: F401
        admin_cmd,
        backup_cmd,
        benchmark_cmd,
        client_cmd,
        config_cmd,
        ec_local,
        gateway_cmd,
        mount_cmd,
        mq_cmd,
        servers,
        shell_cmd,
        sync_cmd,
        tier_cmd,
        tls_cmd,
        version,
    )


_import_all()
