"""The port's dispatching binary: ``python -m seaweedfs_tpu_torch.cli <cmd>``.

The counterpart of seaweedfs_tpu/cli.py for the commands ported so far
(``ec.encode.local``, ``ec.rebuild.local``, ``ec.decode.local``, for the RS
and LRC storage classes); ``<cmd> -h`` shows each command's flags.  A
missing CUDA device is not caught here: it raises.
"""

from __future__ import annotations

import argparse
import sys


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="seaweedfs_tpu_torch.cli",
        description="SeaweedFS-capability blob store, PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command")
    from seaweedfs_tpu_torch.commands import REGISTRY

    for name, cmd in sorted(REGISTRY.items()):
        p = sub.add_parser(name, help=cmd.help)
        cmd.configure(p)
        p.set_defaults(_run=cmd.run)
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "_run", None):
        parser.print_help()
        return 1
    try:
        return args._run(args) or 0
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
