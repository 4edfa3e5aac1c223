"""The lock / unlock / help shell commands.

The port's copy of those three commands of
seaweedfs_tpu/shell/command_volume.py (reference
shell/command_lock_unlock.go).  volume.list, volume.vacuum and the
collection commands are not ported."""

from __future__ import annotations

from seaweedfs_tpu_torch.shell import SHELL_REGISTRY, shell_command


@shell_command("lock", "acquire the cluster-exclusive admin lock")
def cmd_lock(env, args, out):
    env.acquire_lock()
    print("lock acquired", file=out)


@shell_command("unlock", "release the cluster-exclusive admin lock")
def cmd_unlock(env, args, out):
    env.release_lock()
    print("lock released", file=out)


@shell_command("help", "list shell commands")
def cmd_help(env, args, out):
    for name in sorted(SHELL_REGISTRY):
        print(f"  {name:24s} {SHELL_REGISTRY[name].help}", file=out)
