"""Layered configuration: TOML file < environment < CLI flags.

The port's copy of seaweedfs_tpu/util/config.py, so one ``weed-tpu.toml``
drives either package's CLI the same way.  Counterpart of the reference's
config stack (util/fla9 flags-from-file, Viper TOML via `weed scaffold`
templates, WEED_* env overrides — weed/command/scaffold.go:16-35): every
subcommand's flag defaults can
come from a ``[command]`` section of a TOML file and from
``WEEDTPU_<COMMAND>_<FLAG>`` environment variables; explicit CLI flags
always win because config only replaces *defaults*.

Resolution order (low → high): built-in default, TOML section value,
environment variable, CLI flag.
"""

from __future__ import annotations

import os

import tomllib

DEFAULT_CONFIG_PATHS = (
    "./weed-tpu.toml",
    os.path.expanduser("~/.seaweedfs_tpu/weed-tpu.toml"),
)

ENV_PREFIX = "WEEDTPU"


def load_config_file(path: str | None = None) -> dict:
    """Parse the TOML config.  An explicitly named file must exist — a
    typo'd -config silently starting with built-in defaults is how wrong
    ports and missing keys reach production; only the default search
    paths tolerate absence."""
    explicit = path is not None
    paths = [path] if explicit else list(DEFAULT_CONFIG_PATHS)
    for p in paths:
        try:
            with open(p, "rb") as fh:
                return tomllib.load(fh)
        except FileNotFoundError:
            if explicit:
                raise
            continue
        except tomllib.TOMLDecodeError as e:
            raise ValueError(f"config {p}: {e}") from e
    return {}


def _env_key(command: str, flag: str) -> str:
    norm = lambda s: s.replace(".", "_").replace("-", "_").upper()  # noqa: E731
    return f"{ENV_PREFIX}_{norm(command)}_{norm(flag)}"


def section_defaults(config: dict, command: str) -> dict:
    """The TOML ``[command]`` table (dots in command names become nested
    tables, so [mq.broker] works naturally)."""
    node = config
    for part in command.split("."):
        node = node.get(part)
        if not isinstance(node, dict):
            return {}
    # leaf tables may still contain nested tables (sub-commands); only
    # scalar values are flag defaults
    return {k: v for k, v in node.items() if not isinstance(v, dict)}


def apply_to_parser(parser, command: str, config: dict) -> None:
    """Override the parser's *defaults* from config + env.  Uses the
    parser's own option table so types come from the declared flags."""
    file_section = section_defaults(config, command)
    overrides: dict = {}
    for action in parser._actions:  # noqa: SLF001 — argparse's public-enough shape
        if not action.option_strings or action.dest in ("help",):
            continue
        flag = action.option_strings[0].lstrip("-")
        raw = None
        if flag in file_section:
            raw = file_section[flag]
        env_val = os.environ.get(_env_key(command, flag))
        if env_val is not None:
            raw = env_val
        if raw is None:
            continue
        if action.const is not None and not isinstance(raw, bool):
            # store_true flags: accept true/1/yes from env/TOML strings
            raw = str(raw).lower() in ("1", "true", "yes", "on")
        elif action.type is not None and not isinstance(raw, bool):
            try:
                raw = action.type(raw)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"config value for -{flag} ({raw!r}): {e}"
                ) from e
        overrides[action.dest] = raw
    if overrides:
        parser.set_defaults(**overrides)


SCAFFOLD = """\
# weed-tpu.toml — layered configuration for every subcommand.
# Flags here become *defaults*; explicit CLI flags always win, and
# WEEDTPU_<COMMAND>_<FLAG> environment variables beat this file.
# Generate fresh with: weed-tpu scaffold

[master]
# port = 9333
# volumeSizeLimitMB = 30720
# defaultReplication = "000"
# mdir = "/var/lib/weed-tpu/master"
# jwtKey = ""

[volume]
# dir = "/var/lib/weed-tpu/vol1,/var/lib/weed-tpu/vol2"
# mserver = "127.0.0.1:19333"
# max = 8
# index = "leveldb"     # memory | compact | leveldb
# backend = "disk"      # disk | mmap | memory

[filer]
# master = "127.0.0.1:19333"
# db = "/var/lib/weed-tpu/filer-ldb"   # dir = LSM store, *.db = sqlite
# metaLogDir = "/var/lib/weed-tpu/filer-metalog"
# maxMB = 4

[s3]
# master = "127.0.0.1:19333"
# port = 8333
# accessKey = ""
# secretKey = ""
# kmsKeyFile = "/var/lib/weed-tpu/kms.json"

[webdav]
# filer = "127.0.0.1:28888"
# port = 7333

[mq.broker]
# dir = "/var/lib/weed-tpu/mq"
# master = "127.0.0.1:9333"
# port = 17777
"""
