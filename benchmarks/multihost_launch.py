"""Local 2-process scaling-efficiency harness — the executed version of
the multi-host story (SURVEY.md §2.2 item 3; BASELINE "≥80% at 2 hosts").

This launcher runs the multi-host code path one level down: two OS
processes, each owning 4 CPU devices, joined into one 8-device
jax.distributed cluster (gloo collectives over localhost — the same code
path a multi-host fleet runs, minus the wire).  It times the
data-sharded batched filter step at

  * 1 process × 4 devices  (batch = seqs_per_device · 4)
  * 2 processes × 4 devices (batch = seqs_per_device · 8)

and reports weak-scaling efficiency = agg_2proc / (2 · agg_1proc), a
CPU number, not a GPU one.  Writes results/multihost_scaling.json.

Every worker is pinned to the CPU (EKF_VIO_PLATFORM=cpu).  Never point
it at a GPU: each JAX process reserves most of a card's memory when it
starts, so several workers on one card fail or spoil each other.

Usage:  python benchmarks/multihost_launch.py [--steps N]
The pytest wrapper (tests/test_multiproc.py) runs this with few steps.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_env(num_procs: int, pid: int, port: int, devices: int) -> dict:
    env = dict(os.environ)
    env.update(
        EKF_VIO_COORDINATOR=f"localhost:{port}",
        EKF_VIO_NUM_PROCESSES=str(num_procs),
        EKF_VIO_PROCESS_ID=str(pid),
        EKF_VIO_PLATFORM="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
    )
    return env


def run_cluster(num_procs: int, devices_per_proc: int, steps: int,
                seqs_per_device: int) -> dict:
    """Launch `num_procs` multihost_scaling.py workers; return proc-0's
    report (parsed from its stdout).

    Each worker is pinned to its own CPU-core share so every simulated
    "host" has identical fixed resources — without pinning, the 1-process
    baseline consumes the whole machine and the 2-process run measures
    core oversubscription instead of scaling."""
    port = _free_port()
    script = os.path.join(HERE, "multihost_scaling.py")
    cores = sorted(os.sched_getaffinity(0))
    # per-host share is fixed by the LARGEST cluster compared (2), so the
    # 1-process baseline gets the same resources as each host in the
    # 2-process run
    per = max(1, len(cores) // 2)
    procs = []
    for pid in range(num_procs):
        share = set(cores[pid * per:(pid + 1) * per]) or {cores[-1]}

        def _pin(s=share):
            os.sched_setaffinity(0, s)

        procs.append(subprocess.Popen(
            [sys.executable, script, "--steps", str(steps),
             "--seqs-per-device", str(seqs_per_device), "--no-json"],
            env=_worker_env(num_procs, pid, port, devices_per_proc),
            stdout=subprocess.PIPE if pid == 0 else subprocess.DEVNULL,
            stderr=subprocess.DEVNULL, cwd=REPO, text=True,
            preexec_fn=_pin,
        ))
    out0, _ = procs[0].communicate(timeout=900)
    for p in procs[1:]:
        p.wait(timeout=900)
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise RuntimeError(f"cluster {num_procs}x{devices_per_proc} failed, "
                           f"rcs={rcs}, out={out0[-2000:]}")
    for line in out0.splitlines():
        if line.startswith("EKFVIO_REPORT "):
            return json.loads(line[len("EKFVIO_REPORT "):])
    raise RuntimeError(f"no report line in output: {out0[-2000:]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seqs-per-device", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(
        REPO, "results", "multihost_scaling.json"))
    args = ap.parse_args()

    one = run_cluster(1, 4, args.steps, args.seqs_per_device)
    two = run_cluster(2, 4, args.steps, args.seqs_per_device)

    eff = two["aggregate_steps_per_s"] / (2.0 * one["aggregate_steps_per_s"])
    report = {
        "mode": "2-process localhost CPU cluster (gloo), 4 devices/process",
        "one_process": one,
        "two_process": two,
        "weak_scaling_efficiency": round(eff, 4),
        "target": ">= 0.8 at 2 hosts (BASELINE.json)",
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
