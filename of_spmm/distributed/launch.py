"""Per-rank process launcher — python -m of_spmm.distributed.launch.

The reference launcher (python/oneflow/distributed/launch.py:103-237)
spawns one process per local rank with MASTER_ADDR/MASTER_PORT/WORLD_SIZE/
RANK/LOCAL_RANK set, forwards signals, and kills the whole group when any
child fails (no elastic recovery — checkpoint/restart is the recovery
story, SURVEY.md §5). Same contract here; distributed.initialize() in the
child picks the env up and runs jax.distributed.initialize.

Usage:
    python -m of_spmm.distributed.launch --nproc_per_node 4 train.py args...
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="of_spmm multi-process launcher")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--master_addr", default="127.0.0.1")
    p.add_argument("--master_port", type=int, default=29500)
    p.add_argument("-m", dest="module", action="store_true",
                   help="run the script as a module (python -m)")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch(args) -> int:
    world_size = args.nnodes * args.nproc_per_node
    procs: List[subprocess.Popen] = []
    base_env = dict(os.environ)
    base_env["MASTER_ADDR"] = args.master_addr
    base_env["MASTER_PORT"] = str(args.master_port)
    base_env["WORLD_SIZE"] = str(world_size)

    for local_rank in range(args.nproc_per_node):
        rank = args.node_rank * args.nproc_per_node + local_rank
        env = dict(base_env)
        env["RANK"] = str(rank)
        env["LOCAL_RANK"] = str(local_rank)
        cmd = [sys.executable, "-u"]
        if args.module:
            cmd.append("-m")
        cmd.append(args.training_script)
        cmd.extend(args.training_script_args)
        procs.append(subprocess.Popen(cmd, env=env))

    def kill_all(signum=None, frame=None):
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 10
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()

    signal.signal(signal.SIGINT, kill_all)
    signal.signal(signal.SIGTERM, kill_all)

    # reference behavior: first failure kills the group (launch.py:173-201)
    ret = 0
    alive = list(procs)
    while alive:
        for p in list(alive):
            rc = p.poll()
            if rc is None:
                continue
            alive.remove(p)
            if rc != 0:
                ret = rc
                kill_all()
                alive = []
                break
        time.sleep(0.2)
    return ret


def main(argv=None) -> int:
    return launch(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
