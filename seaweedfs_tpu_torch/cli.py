"""The port's dispatching binary: ``python -m seaweedfs_tpu_torch.cli <cmd>``.

The counterpart of seaweedfs_tpu/cli.py for the commands ported so far
(``ec.encode.local``, ``ec.rebuild.local``, ``ec.decode.local``, for the RS
and LRC storage classes; ``master``, ``volume``, ``filer``, ``s3``,
``server``, ``iam``, ``shell`` and ``benchmark``; ``admin``, ``worker`` and
``telemetry``; the file gateways ``webdav``, ``sftp`` and ``mount``; the
message queue's ``mq.broker``, ``mq.benchmark``, ``mq.topic.configure`` and
``mq.topic.list``; ``upload``, ``download`` and ``filer.copy``;
``volume.tier.local``, ``backup`` and ``fix``; ``tls.gen``; ``scaffold``;
``version``); ``<cmd> -h`` shows each command's flags.

``-config FILE`` and the ``WEEDTPU_<COMMAND>_<FLAG>`` environment set the
commands' flag defaults, as in the JAX package (util/config.py: TOML file <
environment < CLI flag; without ``-config`` ``./weed-tpu.toml`` and
``~/.seaweedfs_tpu/weed-tpu.toml`` are read when present); ``-v LEVEL``
sets the log verbosity.  The port-only ``-device`` takes the same layers:
a value from a file or the environment is still an explicit ask.  A
missing CUDA device is not caught here: it raises.
"""

from __future__ import annotations

import argparse
import sys


def _build_parser(config: dict | None = None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="seaweedfs_tpu_torch.cli",
        description="SeaweedFS-capability blob store, PyTorch/CUDA port",
    )
    parser.add_argument(
        "-config",
        default="",
        help="TOML config file (defaults: ./weed-tpu.toml, "
        "~/.seaweedfs_tpu/weed-tpu.toml); see the scaffold command",
    )
    parser.add_argument(
        "-v", type=int, default=None, metavar="LEVEL",
        help="log verbosity (also WEEDTPU_V)",
    )
    sub = parser.add_subparsers(dest="command")
    from seaweedfs_tpu_torch.commands import REGISTRY
    from seaweedfs_tpu_torch.util import config as config_mod

    for name, cmd in sorted(REGISTRY.items()):
        p = sub.add_parser(name, help=cmd.help)
        cmd.configure(p)
        if config is not None:
            try:
                config_mod.apply_to_parser(p, name, config)
            except ValueError as e:
                # a bad value for this command must not break every other
                # one (the scaffold you would fix it with included): it is
                # reported only when this command runs
                p.set_defaults(_config_error=str(e))
        p.set_defaults(_run=cmd.run)
    return parser


def _config_path(argv: list[str] | None) -> str | None:
    args = argv if argv is not None else sys.argv[1:]
    for i, a in enumerate(args):
        if a in ("-config", "--config") and i + 1 < len(args):
            return args[i + 1]
        if a.startswith(("-config=", "--config=")):
            return a.split("=", 1)[1]
    return None


def main(argv: list[str] | None = None) -> int:
    from seaweedfs_tpu_torch.util import config as config_mod

    config = config_mod.load_config_file(_config_path(argv))
    parser = _build_parser(config)
    args = parser.parse_args(argv)
    if not getattr(args, "_run", None):
        parser.print_help()
        return 1
    if getattr(args, "_config_error", None):
        print(f"error: {args._config_error}", file=sys.stderr)
        return 1
    if getattr(args, "v", None) is not None:
        from seaweedfs_tpu_torch.util import wlog

        wlog.set_verbosity(args.v)
    try:
        return args._run(args) or 0
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
