#!/usr/bin/env python3
"""What the RPC and observability layers and the native data plane cost one
request, on one GPU's host.

    python3 chip_layer_costs.py [--rounds 20] [--per-round 25] [--device cuda]
                                [--out layer_costs.json]

Five configurations of one small cluster: TLS off or on (``WEEDTPU_TLS_*``
from a ``cli tls.gen`` CA on every gRPC hop, and HTTPS on the S3
gateways) by tracing off or on (``SEAWEEDFS_TPU_TRACE``), each with the
native data plane on (the default: the volume server's C++ front door and
the gateways' splice), and a fifth with TLS and tracing off and the plane
off (``SEAWEEDFS_TPU_NATIVE_DP=0 SEAWEEDFS_TPU_NATIVE_PX=0``).  Each runs
in a worker process of its own, started once: an in-process master,
volume server (on ``--device``), filer and two S3 gateways over
``RemoteFiler`` (as ``cli s3 -filer`` runs them), one SigV4 and one open
(the splice streams only an open gateway's PUT bodies, as in the JAX
package), with the client in the same process, so the client's spans and
TLS follow the configuration too.  The workers are started together and
then driven in short rounds, one configuration at a time, the order
rotated each round, so that a drift of the host falls on every
configuration alike.  In a round a worker times, one request at a time on
the host's clock, ``--per-round`` signed 16 KiB S3 PUTs, GETs of the same
objects (byte-checked), 1 KiB needle writes (the master's assign, then the
volume server's POST) and GETs of them, and unsigned 1 MiB PUTs and GETs
(above the splice's MIN_SPLICE_BYTES) through the open gateway.  Each
round also reports the volume server's native counters and the process's
splice counters, so that the plane is seen to serve.

Printed per configuration and kind: n, the median, p99 and mean in host
ms, and the spread of the rounds' medians; then the median differences
(tracing on - off at each TLS setting, TLS on - off at each tracing
setting, native plane on - off with TLS and tracing off) with a 95%
bootstrap interval (seed 0).  The line before the
last is a JSON record of all of it (also written to ``--out``); the last
is {"ok": true}.  Any failed request or worker exits non-zero.
``--device cuda`` needs a GPU and prints its name and power limit;
``--device cpu`` runs the same on a machine without one.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import chip_smoke as cs

CONFIGS = [(tls, trace, True) for tls in (False, True) for trace in (False, True)] + [
    (False, False, False)]
KINDS = ("s3_put_16KiB", "s3_get_16KiB", "needle_write_1KiB", "needle_assign", "needle_post_1KiB",
         "needle_get_1KiB", "s3_put_1MiB", "s3_get_1MiB")
WARM = 8  # requests of each kind before the first round: connections and the FidPool
READY_S = 300.0  # a worker's cluster up
ROUND_S = 120.0  # one round of one worker
TAG = "@@ "  # the protocol's lines on a worker's stdout


def label(tls: bool, trace: bool, native: bool = True) -> str:
    return (f"tls_{'on' if tls else 'off'}_trace_{'on' if trace else 'off'}"
            + ("" if native else "_native_off"))


# -- the worker: one configuration's cluster and client ------------------------


def worker(args) -> int:
    tls_on, trace_on, native_on = next(c for c in CONFIGS if label(*c) == args.worker)
    if not native_on:
        os.environ.update(SEAWEEDFS_TPU_NATIVE_DP="0", SEAWEEDFS_TPU_NATIVE_PX="0")
    certs = {k: os.path.join(args.certs, f) for k, f in (("ca", "ca.crt"), ("cert", "node.crt"),
                                                        ("key", "node.key"))}
    if tls_on:
        os.environ.update(WEEDTPU_TLS_CA=certs["ca"], WEEDTPU_TLS_CERT=certs["cert"],
                          WEEDTPU_TLS_KEY=certs["key"])
    os.environ["SEAWEEDFS_TPU_TRACE"] = "1" if trace_on else "0"
    import ssl

    import hashlib

    from seaweedfs_tpu_torch.filer.remote import RemoteFiler
    from seaweedfs_tpu_torch.native import dataplane
    from seaweedfs_tpu_torch.s3 import S3ApiServer
    from seaweedfs_tpu_torch.s3.auth import Identity
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.master_server import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool
    from seaweedfs_tpu_torch.wdclient import MasterClient

    d = args.dir
    ms = MasterServer(port=0, grpc_port=0, volume_size_limit_mb=cs.FILER_VOLUME_MB)
    ms.start()
    vs = VolumeServer([os.path.join(d, "v")], ms.grpc_address, port=0, grpc_port=0,
                      heartbeat_interval=0.2, device=args.device, scrub_interval_s=0)
    vs.start()
    fs = FilerServer(ms.grpc_address, port=0, grpc_port=0, store_path=os.path.join(d, "db"))
    fs.start()
    gw = S3ApiServer(ms.grpc_address, port=0,
                     filer=RemoteFiler(fs.grpc_address, MasterClient(ms.grpc_address)),
                     identities={cs.S3_AK: Identity(cs.S3_AK, cs.S3_SK, "admin")},
                     chunk_cache_mb=0, lifecycle_sweep_interval=0,
                     tls_cert=certs["cert"] if tls_on else "",
                     tls_key=certs["key"] if tls_on else "")
    gw.start()
    ogw = S3ApiServer(ms.grpc_address, port=0,
                      filer=RemoteFiler(fs.grpc_address, MasterClient(ms.grpc_address)),
                      chunk_cache_mb=0, lifecycle_sweep_interval=0,
                      tls_cert=certs["cert"] if tls_on else "",
                      tls_key=certs["key"] if tls_on else "")
    ogw.start()
    if tls_on:
        for g in (gw, ogw):
            cs._TLS_CONTEXTS[g.url] = ssl.create_default_context(cafile=certs["ca"])
    pool = HttpConnectionPool(timeout=60.0)
    client = oclient = mc = None
    try:
        cs._poll(lambda: len(ms.topology.nodes) == 1, "the node's heartbeat", 60)
        client = cs._S3Client(gw.url)
        oclient = cs._S3Client(ogw.url)
        mc = MasterClient(ms.grpc_address)
        status, _d, _h, _dt = client.request("PUT", "/layers")
        cs.check(status == 200, f"CreateBucket: {status}")
        status, _d, _h, _dt = oclient.request("PUT", "/open", mode="anon")
        cs.check(status == 200, f"CreateBucket on the open gateway: {status}")

        def run(first: int, n: int) -> dict:
            out = {k: [] for k in KINDS}
            bodies = [cs._s3_body(0, 60_000 + i, 16 * 1024) for i in range(first, first + n)]
            for i, body in enumerate(bodies, first):
                status, _d, _h, dt = client.request("PUT", f"/layers/o{i:05d}", body=body)
                cs.check(status == 200, f"PUT {i}: {status}")
                out["s3_put_16KiB"].append(dt)
            for i, body in enumerate(bodies, first):
                status, data, _h, dt = client.request("GET", f"/layers/o{i:05d}")
                cs.check(status == 200 and data == body, f"GET {i}: {status}")
                out["s3_get_16KiB"].append(dt)
            for i, body in enumerate(bodies, first):
                t0 = time.perf_counter()
                fid, url, _auth = mc.assign_batch(1)[0]
                t1 = time.perf_counter()
                status, _b = pool.request(url, "POST", f"/{fid}", body=body[:1024])
                t2 = time.perf_counter()
                cs.check(status == 201, f"needle write {i}: {status}")
                status, data = pool.request(url, "GET", f"/{fid}")
                t3 = time.perf_counter()
                cs.check(status == 200 and data == body[:1024], f"needle read {i}: {status}")
                out["needle_assign"].append(t1 - t0)
                out["needle_post_1KiB"].append(t2 - t1)
                out["needle_write_1KiB"].append(t2 - t0)
                out["needle_get_1KiB"].append(t3 - t2)
            for i in range(first, first + n):
                body = cs._s3_body(0, 80_000 + i, cs.MIB)
                status, _d, h, dt = oclient.request("PUT", f"/open/m{i:05d}", body=body,
                                                    mode="anon")
                cs.check(status == 200 and h.get("etag") == f'"{hashlib.md5(body).hexdigest()}"',
                         f"1 MiB PUT {i}: {status}")
                out["s3_put_1MiB"].append(dt)
                status, data, _h, dt = oclient.request("GET", f"/open/m{i:05d}", mode="anon")
                cs.check(status == 200 and data == body, f"1 MiB GET {i}: {status}")
                out["s3_get_1MiB"].append(dt)
            # the plane's own counters: the requests above went through it
            out["_dp"] = vs._dp.stats() if vs._dp is not None else {}
            px = dataplane.px_stats()
            out["_px"] = {k: px[k] for k in ("get_spliced", "fanout_ok", "loop_get_jobs",
                                             "loop_put_jobs")}
            out["_px"]["loop_mode"] = dataplane.px_loop_mode() if px["loop_get_jobs"] else 0
            return out

        run(1_000_000, WARM)
        print(TAG + "ready", flush=True)
        for line in sys.stdin:
            cmd = line.split()
            if cmd[0] == "quit":
                break
            print(TAG + json.dumps(run(int(cmd[1]), int(cmd[2]))), flush=True)
    finally:
        for c in (client, oclient):
            if c is not None:
                c.close()
        pool.close()
        ogw.stop()
        gw.stop()
        fs.stop()
        vs.stop()
        ms.stop()
    print(TAG + "stopped", flush=True)
    return 0


# -- the parent: start the workers, drive the rounds, summarise ------------------


class Worker:
    """One configuration's worker process; its tagged stdout lines are
    read by a thread, and every read waits at most a given time."""

    def __init__(self, cfg: tuple, root: str, certs: str, device: str):
        self.label = label(*cfg)
        here = os.path.dirname(os.path.abspath(__file__))
        d = os.path.join(root, self.label)
        os.makedirs(d)
        self.log_path = os.path.join(root, f"{self.label}.log")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", self.label, "--certs", certs,
             "--dir", d, "--device", device], cwd=here, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self._log, text=True,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                filter(None, [here, os.environ.get("PYTHONPATH")]))))
        self._lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.startswith(TAG):
                self._lines.put(line[len(TAG):].strip())
        self._lines.put(None)

    def line(self, timeout: float) -> str:
        try:
            got = self._lines.get(timeout=timeout)
        except queue.Empty:
            got = None
        if got is None:
            raise cs.SmokeFailure(f"{self.label}: no answer within {timeout:.0f}s (rc "
                                  f"{self.proc.poll()}): {self.log_tail()}")
        return got

    def send(self, text: str) -> None:
        self.proc.stdin.write(text + "\n")
        self.proc.stdin.flush()

    def log_tail(self) -> str:
        self._log.flush()
        with open(self.log_path) as f:
            return f.read()[-3000:]

    def stop(self) -> int:
        if self.proc.poll() is None:
            try:
                self.send("quit")
                self.proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        return self.proc.returncode


def summarise(samples: dict, per_round: int, rng) -> dict:
    import numpy as np

    out: dict = {}
    for lab, kinds in samples.items():
        out[lab] = {}
        for kind, xs in kinds.items():
            arr = np.array(xs) * 1e3
            rounds = arr.reshape(-1, per_round)
            meds = np.median(rounds, axis=1)
            out[lab][kind] = dict(n=int(arr.size), median=float(np.median(arr)),
                                  p99=float(np.percentile(arr, 99)), mean=float(arr.mean()),
                                  round_medians=[float(meds.min()), float(meds.max())])
    diffs: dict = {}
    pairs = [("tracing", label(t, True), label(t, False)) for t in (False, True)] + \
        [("tls", label(True, t), label(False, t)) for t in (False, True)] + \
        [("native", label(False, False), label(False, False, False))]
    for what, on, off in pairs:
        for kind in KINDS:
            a, b = (np.array(samples[x][kind]) * 1e3 for x in (on, off))
            boot = np.array([np.median(rng.choice(a, a.size)) - np.median(rng.choice(b, b.size))
                             for _ in range(1000)])
            diffs[f"{what}: {on} - {off}: {kind}"] = dict(
                median_diff=float(np.median(a) - np.median(b)),
                ci95=[float(np.percentile(boot, 2.5)), float(np.percentile(boot, 97.5))])
    return dict(configs=out, diffs=diffs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--per-round", type=int, default=25)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--certs", default="", help=argparse.SUPPRESS)
    ap.add_argument("--dir", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)

    import numpy as np

    ident = "the host's CPU"
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("chip_layer_costs: no CUDA device", file=sys.stderr)
            return 1
        ident = cs.gpu_identity()
        print(f"device: {torch.cuda.get_device_name(0)} ({ident})")
    root = tempfile.mkdtemp(prefix="chip_layer_costs-")
    here = os.path.dirname(os.path.abspath(__file__))
    certs = os.path.join(root, "certs")
    gen = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.cli", "tls.gen", "-dir",
                          certs, "-host", "127.0.0.1,localhost"], cwd=here, capture_output=True,
                         text=True, timeout=120)
    if gen.returncode != 0:
        print(f"FAIL: tls.gen exited {gen.returncode}: {gen.stderr[-2000:]}")
        return 1
    workers: list = []
    t0 = time.perf_counter()
    try:
        workers = [Worker(cfg, root, certs, args.device) for cfg in CONFIGS]
        for w in workers:
            cs.check(w.line(READY_S) == "ready", f"{w.label} did not start")
        up_s = time.perf_counter() - t0
        samples = {w.label: {k: [] for k in KINDS} for w in workers}
        plane = {}
        for r in range(args.rounds):
            order = workers[r % len(workers):] + workers[:r % len(workers)]
            for w in order:
                w.send(f"round {r * args.per_round} {args.per_round}")
                for k, xs in json.loads(w.line(ROUND_S)).items():
                    if k.startswith("_"):  # counters, the last round's kept
                        plane.setdefault(w.label, {})[k[1:]] = xs
                    else:
                        samples[w.label][k].extend(xs)
        rcs = {w.label: w.stop() for w in workers}
        cs.check(all(rc == 0 for rc in rcs.values()), f"workers exited {rcs}")
    except cs.SmokeFailure as e:
        print(f"FAIL: {e}")
        return 1
    finally:
        for w in workers:
            w.stop()
        shutil.rmtree(root, ignore_errors=True)
    for lab, counters in plane.items():
        on = not lab.endswith("_native_off")
        cs.check(bool(counters["dp"].get("native_writes")) == on
                 and bool(counters["px"]["get_spliced"]) == (on and lab.startswith("tls_off")),
                 f"{lab}: the native plane's counters {counters}")
    record = dict(device=ident, rounds=args.rounds, per_round=args.per_round, up_s=up_s,
                  wall_s=time.perf_counter() - t0, plane=plane,
                  **summarise(samples, args.per_round, np.random.default_rng(0)))
    for lab, kinds in record["configs"].items():
        print(f"layers: {lab} on {ident} (host ms a request; n, median, p99, mean, the rounds' "
              f"medians): " + "; ".join(
                  f"{k} {v['n']} {v['median']:.3f} {v['p99']:.3f} {v['mean']:.3f} "
                  f"[{v['round_medians'][0]:.3f}, {v['round_medians'][1]:.3f}]"
                  for k, v in kinds.items()))
    for lab, counters in plane.items():
        print(f"plane: {lab}: volume server {counters['dp']}; splice {counters['px']} "
              f"(loop mode 2 io_uring, 1 epoll, 0 not started)")
    for name, v in record["diffs"].items():
        print(f"diff: {name}: {v['median_diff']:+.3f} ms [{v['ci95'][0]:+.3f}, "
              f"{v['ci95'][1]:+.3f}]")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
    print(json.dumps(record, sort_keys=True))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
