"""``cli scaffold``: print a commented config template (the reference's
``weed scaffold``, weed/command/scaffold.go); the port's copy of
seaweedfs_tpu/commands/config_cmd.py, printing the same text."""

from __future__ import annotations

from seaweedfs_tpu_torch.commands import command


@command("scaffold", "print a weed-tpu.toml configuration template")
def run_scaffold(args) -> int:
    from seaweedfs_tpu_torch.util.config import SCAFFOLD

    print(SCAFFOLD, end="")
    return 0
