"""Fail-fast multi-process launcher with heartbeat monitoring (a copy of
:mod:`rtgs_tpu.parallel.launcher`, whose package imports JAX).

It starts one worker process per rank, gives each a HEARTBEAT file to touch
periodically, and tears every worker down as soon as one dies or stops
beating: a wedged collective otherwise hangs the other ranks until the
transport's timeout. Restarts resume from the solver's checkpoints.

Stdlib only and transport-agnostic: workers are plain commands. Each gets
torch's rendezvous variables, ``MASTER_ADDR`` and ``MASTER_PORT`` (from
``--coordinator host:port``), ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``
(every rank runs on this host), which
:func:`rtgs_tpu_torch.parallel.mesh.initialize_distributed` reads.

CLI:  python -m rtgs_tpu_torch.parallel.launcher --num-processes 2 \
          --coordinator localhost:29500 -- python worker.py ...
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import time

logger = logging.getLogger(__name__)

HEARTBEAT_ENV = "RTGS_HEARTBEAT_FILE"


def touch_heartbeat() -> None:
    """Called by WORKERS: touch the launcher-provided heartbeat file.

    Cheap enough to call every training step; a no-op when the process
    was not started by the launcher."""
    path = os.environ.get(HEARTBEAT_ENV)
    if path:
        try:
            pathlib.Path(path).touch()
        except OSError:  # pragma: no cover - heartbeat must never crash
            pass


def launch(cmd, num_processes: int, coordinator: str,
           heartbeat_timeout: float = 300.0, poll_s: float = 1.0,
           env=None) -> int:
    """Run ``cmd`` once per rank; fail fast on any death or stale heartbeat.

    Returns the exit code: 0 iff every rank exited 0. On the first
    failure (non-zero exit, or a rank whose heartbeat file goes stale
    beyond ``heartbeat_timeout`` seconds after its first beat), all other
    ranks receive SIGTERM.
    """
    host, _, port = coordinator.rpartition(":")
    tmp = tempfile.mkdtemp(prefix="rtgs_hb_")
    procs = []
    hb_files = []
    base_env = dict(os.environ if env is None else env)
    for rank in range(num_processes):
        hb = os.path.join(tmp, f"rank{rank}.hb")
        hb_files.append(hb)
        worker_env = dict(
            base_env,
            MASTER_ADDR=host,
            MASTER_PORT=port,
            WORLD_SIZE=str(num_processes),
            RANK=str(rank),
            LOCAL_RANK=str(rank),
            **{HEARTBEAT_ENV: hb},
        )
        procs.append(subprocess.Popen(cmd, env=worker_env))
        logger.info("launched rank %d (pid %d)", rank, procs[-1].pid)

    failed = None
    try:
        while True:
            now = time.time()
            done = 0
            for rank, p in enumerate(procs):
                rc = p.poll()
                if rc is not None:
                    if rc != 0:
                        failed = (rank, f"exit code {rc}")
                        break
                    done += 1
                    continue
                hb = pathlib.Path(hb_files[rank])
                if hb.exists():
                    age = now - hb.stat().st_mtime
                    if age > heartbeat_timeout:
                        failed = (rank, f"heartbeat stale {age:.0f}s")
                        break
            if failed or done == num_processes:
                break
            time.sleep(poll_s)
    finally:
        if failed:
            rank, why = failed
            logger.error("rank %d failed (%s); tearing down all ranks",
                         rank, why)
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            deadline = time.time() + 10.0
            for p in procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    p.kill()
    return 0 if not failed else 1


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(
        "rtgs-launch",
        description="Fail-fast multi-process launcher with heartbeats.")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", type=str, default="localhost:29500",
                    help="host:port of rank 0's rendezvous store.")
    ap.add_argument("--heartbeat-timeout", type=float, default=300.0,
                    help="Seconds without a heartbeat before fail-fast "
                         "teardown (workers call launcher.touch_heartbeat "
                         "each step).")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="Worker command (prefix with --).")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no worker command given")
    return launch(cmd, args.num_processes, args.coordinator,
                  heartbeat_timeout=args.heartbeat_timeout)


if __name__ == "__main__":
    sys.exit(main())
