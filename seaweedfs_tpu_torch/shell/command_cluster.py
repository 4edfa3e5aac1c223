"""Cluster-health and raft-administration shell commands: the port's copy
of seaweedfs_tpu/shell/command_cluster.py.

Counterparts of the reference's shell/command_cluster_check.go,
command_cluster_ps.go, and command_cluster_raft_{ps,add,remove}.go —
the raft commands drive the master's Raft* RPCs (served when the master
runs ``-ha raft``)."""

from __future__ import annotations

from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.shell import shell_command
from seaweedfs_tpu_torch.util import wlog


@shell_command("cluster.ps", "show cluster process status (masters, nodes)")
def cmd_cluster_ps(env, args, out):
    resp = env.collect_topology()
    topo = resp.topology_info
    n_nodes = sum(
        len(rack.data_node_infos)
        for dc in topo.data_center_infos
        for rack in dc.rack_infos
    )
    print(f"master: {env.master_address}", file=out)
    try:
        raft = env.master().RaftListClusterServers(
            m_pb.RaftListClusterServersRequest()
        )
        for s in raft.servers:
            role = "leader" if s.is_leader else "follower"
            print(f"  raft {s.id} {role}", file=out)
    except Exception as e:
        # lease-mode master: no raft servers to list
        if wlog.V(2):
            wlog.info("cluster.status: raft listing unavailable: %s", e)
    print(f"volume servers: {n_nodes}", file=out)
    for dc in topo.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                print(f"  {dc.id}/{rack.id}/{dn.id}", file=out)


@shell_command("cluster.check", "check cluster connectivity and capacity")
def cmd_cluster_check(env, args, out):
    resp = env.collect_topology()
    topo = resp.topology_info
    problems = 0
    nodes = [
        dn
        for dc in topo.data_center_infos
        for rack in dc.rack_infos
        for dn in rack.data_node_infos
    ]
    if not nodes:
        print("no volume servers registered", file=out)
        problems += 1
    free = active = 0
    for dn in nodes:
        for disk in dn.disk_infos.values():
            free += disk.free_volume_count
            active += disk.active_volume_count
    print(
        f"topology: {len(nodes)} volume servers, "
        f"{active} active volumes, {free} free slots",
        file=out,
    )
    if nodes and free == 0:
        print("WARNING: no free volume slots — writes will fail to grow", file=out)
        problems += 1
    # every volume server must answer its gRPC port (NOT_FOUND for a
    # probe volume id still proves connectivity; only transport errors
    # count as problems)
    import grpc as grpc_mod

    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
    from seaweedfs_tpu_torch.shell.ec_common import grpc_addr

    for dn in nodes:
        try:
            env.volume(grpc_addr(dn.url, dn.grpc_port)).VolumeStatus(
                vs_pb.VolumeStatusRequest(volume_id=0)
            )
        except grpc_mod.RpcError as e:
            if e.code() == grpc_mod.StatusCode.UNAVAILABLE:
                print(f"UNREACHABLE: {dn.id} gRPC — {e.details()}", file=out)
                problems += 1
        except Exception as e:  # noqa: BLE001
            print(f"UNREACHABLE: {dn.id} gRPC — {e}", file=out)
            problems += 1
    print("cluster is healthy" if problems == 0 else f"{problems} problem(s)",
          file=out)


@shell_command("cluster.raft.ps", "show raft cluster status")
def cmd_raft_ps(env, args, out):
    st = env.master().RaftListClusterServers(
        m_pb.RaftListClusterServersRequest()
    )
    print(
        f"term:{st.term} commit:{st.commit_index} last:{st.last_index}",
        file=out,
    )
    for s in st.servers:
        role = "leader" if s.is_leader else "follower"
        match = f" match:{s.match_index}" if s.match_index else ""
        print(f"  {s.id} {role}{match}", file=out)


@shell_command("cluster.raft.add", "add a master to the raft cluster")
def cmd_raft_add(env, args, out):
    resp = env.master().RaftAddServer(m_pb.RaftAddServerRequest(id=args.id))
    if not resp.ok:
        raise RuntimeError(f"raft add {args.id} failed")
    print(f"added {args.id}; members: {list(resp.members)}", file=out)


cmd_raft_add.configure = lambda p: p.add_argument(
    "-id", required=True, help="master http address (ip:port) to add"
)


@shell_command("cluster.raft.remove", "remove a master from the raft cluster")
def cmd_raft_remove(env, args, out):
    resp = env.master().RaftRemoveServer(
        m_pb.RaftRemoveServerRequest(id=args.id)
    )
    if not resp.ok:
        raise RuntimeError(f"raft remove {args.id} failed")
    print(f"removed {args.id}; members: {list(resp.members)}", file=out)


cmd_raft_remove.configure = lambda p: p.add_argument(
    "-id", required=True, help="master http address (ip:port) to remove"
)
