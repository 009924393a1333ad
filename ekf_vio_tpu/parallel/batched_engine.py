"""Batched multi-sequence VIO: many sequences data-parallel across chips.

BASELINE.json config 4 ("all EuRoC MH/V sequences data-parallel across
chips").  The whole per-sequence rollout (image front-end + filter) is a
pure scan, so a batch of sequences is literally ``vmap`` over it, and
distribution is a sharding annotation on the batch axis — the mesh's
``data`` axis.  No reference analog exists (one ROS node = one sequence).
"""
from __future__ import annotations

from functools import partial

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ekf_vio_tpu import engine
from ekf_vio_tpu.config import VIOConfig


# Lanes per device program.  Larger batches run as sequential
# micro-batches of this size (standard serving practice).  16 was the
# per-lane optimum on the machine the engine was first built for; on the
# GPU it is not measured yet (benchmarks/batch_scaling.py draws the
# curve; ROADMAP queue 2, item 3).
MICROBATCH = 16


@partial(jax.jit, static_argnames=("cfg", "cam"))
def _run_microbatch(images, times, cfg: VIOConfig, cam):
    return jax.vmap(lambda im, t: engine.run_sequence(im, t, cfg, cam))(
        images, times)


def run_sequences_batched(images, times, cfg: VIOConfig, cam,
                          microbatch: int = MICROBATCH):
    """images: [B, T, H, W]; times: [B, T].  Returns per-sequence final
    EngineStates and stacked StepOutputs, batch-leading.

    Batches larger than ``microbatch`` are split into sequential chunks
    (each fully device-parallel); the results are concatenated on the
    batch axis.  Chunks are dispatched back-to-back without host syncs in
    between, so the pipeline stays full."""
    b = images.shape[0]
    if b <= microbatch or b % microbatch:
        return _run_microbatch(images, times, cfg, cam)
    outs = [
        _run_microbatch(images[i:i + microbatch], times[i:i + microbatch],
                        cfg, cam)
        for i in range(0, b, microbatch)
    ]
    return jax.tree.map(lambda *xs: jax.numpy.concatenate(xs, 0), *outs)


def run_sequences_sharded(images, times, cfg: VIOConfig, cam, mesh: Mesh):
    """Same, with the batch axis split over the mesh's ``data`` axis:
    each device runs its own sequences (``shard_map``, so a kernel in the
    step runs per device on its shard); zero collectives.  The batch must
    divide by the axis size."""
    spec = NamedSharding(mesh, P("data"))
    return _run_sharded(jax.device_put(images, spec),
                        jax.device_put(times, spec), cfg, cam, mesh)


@partial(jax.jit, static_argnames=("cfg", "cam", "mesh"))
def _run_sharded(images, times, cfg: VIOConfig, cam, mesh: Mesh):
    return jax.shard_map(
        lambda im, t: run_sequences_batched(im, t, cfg, cam),
        mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P("data"),
        check_vma=False)(images, times)
