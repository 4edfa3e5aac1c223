"""Trace inspection shell commands: the port's copy of
seaweedfs_tpu/shell/command_trace.py.

``trace.dump`` prints recent request traces — either this process's own
span ring (in-process servers: tests, ``cli server``) or a remote
server's ``/debug/tracez`` endpoint (any data or -metricsPort listener)
when ``-server host:port`` is given."""

from __future__ import annotations

from seaweedfs_tpu_torch.shell import shell_command


@shell_command(
    "trace.dump",
    "dump recent request traces (local ring or a server's /debug/tracez)",
)
def cmd_trace_dump(env, args, out):
    if args.server:
        from seaweedfs_tpu_torch.shell.command_resilience import _fetch

        path = "/debug/tracez"
        q = []
        if args.traceId:
            q.append(f"trace_id={args.traceId}")
        if args.limit:
            q.append(f"limit={args.limit}")
        if q:
            path += "?" + "&".join(q)
        print(_fetch(args.server, path), file=out, end="")
        return
    from seaweedfs_tpu_torch.stats import trace

    print(
        trace.default_buffer.render_text(
            args.traceId or None, args.limit or 50
        ),
        file=out,
        end="",
    )


def _trace_dump_flags(p):
    p.add_argument(
        "-server", default="",
        help="fetch /debug/tracez from this host:port instead of the "
        "local process ring",
    )
    p.add_argument("-traceId", default="", help="only this trace id")
    p.add_argument(
        "-limit", type=int, default=50, help="max traces to show (newest first)"
    )


cmd_trace_dump.configure = _trace_dump_flags
