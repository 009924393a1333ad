"""Multi-host scaling-efficiency benchmark.

Measures aggregate frames/s of the batched filter step at 1 host and at
N hosts, reporting efficiency = fps_N / (N · fps_1-extrapolated).  The
BASELINE target is ≥80% at 2 hosts; since sequences are independent and
``data`` is the only axis that crosses hosts, the expected efficiency is
~100% minus dispatch jitter.

Launch (one command per host; the cluster is always given explicitly):

    EKF_VIO_COORDINATOR=host0:1234 EKF_VIO_NUM_PROCESSES=2 \
    EKF_VIO_PROCESS_ID=<i> python benchmarks/multihost_scaling.py

Without the cluster variables it runs the same code path on the local
mesh and reports per-host numbers only.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ekf_vio_tpu  # noqa: E402

ekf_vio_tpu.enable_compile_cache()

import jax
import jax.numpy as jnp

from ekf_vio_tpu.config import VIOConfig
from ekf_vio_tpu.parallel import batched, multihost
from ekf_vio_tpu.parallel import mesh as mesh_mod


def main(n_state: int = 1, seqs_per_device: int = 4, steps: int = 50,
         write_json: bool = True):
    info = multihost.initialize_distributed()
    mesh = multihost.make_pod_mesh(n_state=n_state)
    n_data = mesh.shape["data"]

    cfg = VIOConfig(max_features=mesh_mod.aligned_capacity(128, n_state))
    batch = seqs_per_device * n_data * n_state // max(n_state, 1)

    state = batched.init_batched_state(cfg, batch=batch)
    state = jax.device_put(state, mesh_mod.filter_state_shardings(mesh, True))
    z = state.feat_mu[:, :, :2] + 0.01
    step = batched.make_batched_filter_step(cfg, mesh)

    out = step(state, z, jnp.float32(0.05))  # compile
    jax.block_until_ready(out)
    t0 = time.time()
    s = state
    for _ in range(steps):
        s = step(s, z, jnp.float32(0.05))
    jax.block_until_ready(s)
    dt = (time.time() - t0) / steps

    report = {
        **info,
        "mesh": dict(mesh.shape),
        "batch_sequences": batch,
        "step_ms": dt * 1e3,
        "aggregate_steps_per_s": batch / dt,
    }
    if jax.process_index() == 0:
        # single-line sentinel: gloo/XLA log chatter interleaves on stdout
        print("EKFVIO_REPORT " + json.dumps(report), flush=True)
        if write_json:
            out_path = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "results", "multihost_scaling.json")
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            with open(out_path, "w") as f:
                json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seqs-per-device", type=int, default=4)
    ap.add_argument("--n-state", type=int, default=1)
    ap.add_argument("--no-json", action="store_true",
                    help="print only; the launcher aggregates the report")
    a = ap.parse_args()
    main(n_state=a.n_state, seqs_per_device=a.seqs_per_device,
         steps=a.steps, write_json=not a.no_json)
