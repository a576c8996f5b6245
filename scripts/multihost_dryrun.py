#!/usr/bin/env python
"""Real multi-process multihost dryrun.

A monkeypatched `jax.distributed.initialize` proves little; this script
actually runs it: a launcher spawns N worker processes on this machine,
each initializes `jax.distributed` against a localhost coordinator (the
same grpc coordination service a multi-host GPU cluster uses), builds a
mesh SPANNING the processes, and runs the sharded batch scorer plus the
best-hit reducer over it:

    python scripts/multihost_dryrun.py            # launcher, N=2
    python scripts/multihost_dryrun.py --worker I --port P --nproc N

Each worker holds 4 virtual CPU devices, so the 2-process default
exercises an 8-device mesh where intra-process and cross-process
collectives both occur. Workers verify
their addressable shard of the scores against the oracle and the
replicated global best hit against the global oracle, then print
MULTIHOST_OK. The reference has no distributed analog whatsoever
(SURVEY.md §2.6: no MPI/NCCL/UCX anywhere in the tree).
"""

import argparse
import os
import socket
import subprocess
import sys

LOCAL_DEVICES = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(process_id: int, port: int, nproc: int) -> None:
    # CPU-only: virtual devices stand in for the cards of each host
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()
    sys.path.insert(0, REPO)

    import numpy as np

    from swtpu.dist.mesh import data_mesh, initialize_multihost

    initialize_multihost(coordinator_address=f"localhost:{port}",
                         num_processes=nproc, process_id=process_id)

    import jax

    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == nproc * LOCAL_DEVICES
    assert jax.local_device_count() == LOCAL_DEVICES

    from swtpu.core import oracle
    from swtpu.core.encode import random_batch
    from swtpu.dist.batch import (make_best_hit_reducer,
                                  make_sharded_batch_scorer)

    mesh = data_mesh()                      # spans BOTH processes
    D = nproc * LOCAL_DEVICES
    B, m, n = 2 * D, 48, 72                 # 2 pairs per device
    aa, bb = random_batch(B, m, n, seed=42)  # same seed -> same global data

    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("data", None))
    a_g = jax.make_array_from_callback((B, m), sh, lambda idx: aa[idx])
    b_g = jax.make_array_from_callback((B, n), sh, lambda idx: bb[idx])

    hits = make_sharded_batch_scorer(mesh)(a_g, b_g)
    # verify the shards THIS process owns against the oracle
    checked = 0
    for shard in hits.scores.addressable_shards:
        lo = shard.index[0].start or 0
        for k, s in enumerate(np.asarray(shard.data)):
            ref = oracle.fill(aa[lo + k], bb[lo + k])
            assert int(s) == ref.max_score, (lo + k, int(s), ref.max_score)
            checked += 1
    assert checked == B // nproc, checked

    best = make_best_hit_reducer(mesh)(a_g, b_g)
    refs = [oracle.fill(aa[g], bb[g]) for g in range(B)]
    gbest = max(r.max_score for r in refs)
    gpair = next(g for g, r in enumerate(refs) if r.max_score == gbest)
    assert int(best.score) == gbest
    assert int(best.pair) == gpair
    assert (int(best.max_i), int(best.max_j)) == refs[gpair].max_ij

    # sequence-parallel PIPELINE across the process boundary: the
    # column-stripe halo exchange (ppermute) between devices 3 and 4
    # crosses processes — the host-to-host hop of a real cluster
    from swtpu.core.encode import random_pair
    from swtpu.dist.checkpoint import ResumablePipeline
    from swtpu.dist.mesh import pipeline_mesh

    pm = pipeline_mesh(axis="seq")
    mseq, nseq, R = 8 * D, 24, 8
    pa, pb = random_pair(mseq, nseq, seed=7)
    rp = ResumablePipeline(pm, mseq, nseq, block_rows=R,
                           stages_per_segment=2)
    psh = NamedSharding(pm, P("seq"))
    a_sh = jax.make_array_from_callback(
        (D, mseq // D), psh, lambda idx: pa.reshape(D, mseq // D)[idx])
    carry = rp.init()
    for seg in range(rp.num_segments):
        carry = rp.segment(a_sh, np.asarray(pb), carry, seg)
    # finish() fetches host-side; gather the process-sharded carry first
    from jax.experimental import multihost_utils
    carry_np = {k: multihost_utils.process_allgather(v, tiled=True)
                for k, v in carry.items()}
    res = rp.finish(carry_np)
    pref = oracle.fill(pa, pb)
    assert int(res.max_score) == pref.max_score, (
        int(res.max_score), pref.max_score)
    assert (int(res.max_i), int(res.max_j)) == pref.max_ij

    print(f"MULTIHOST_OK process={process_id}/{nproc} devices={D} "
          f"checked={checked} best={gbest}@pair{gpair} "
          f"pipeline={int(res.max_score)}", flush=True)


def launcher(nproc: int, timeout: float) -> int:
    with socket.socket() as s:              # free localhost port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(i), "--port", str(port), "--nproc", str(nproc)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for i in range(nproc)
    ]
    rc = 0
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n[launcher] TIMEOUT"
        print(f"--- worker {i} (rc={p.returncode}) ---\n{out}")
        if p.returncode != 0 or "MULTIHOST_OK" not in out:
            rc = 1
    print("multihost dryrun:", "OK" if rc == 0 else "FAILED")
    return rc


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args()
    if args.worker is None:
        return launcher(args.nproc, args.timeout)
    worker(args.worker, args.port, args.nproc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
