"""FilterState: the whole EKF state as a single static-shape pytree.

The reference stores a dynamic ``std::list<Feature>`` plus a sparse Σ that
is ``conservativeResize``d as features come and go
(reference: TightlyCoupledEKF.h:29-34, TightlyCoupledEKF.cpp:58-94).
Under jit, dynamic shapes force recompiles, so the design here is a fixed
capacity of ``N_max`` feature *slots* with an ``active`` mask; Σ is a dense
f32 ``[D, D]`` matrix, ``D = 22 + 3·N_max``.  Slot allocation/free replaces
list insert/erase (and, unlike the reference, dead features actually free
their slot — the reference sets ``delete_flag`` but never erases,
TightlyCoupledEKF.cpp:525-529 / SURVEY.md §2.1).

Everything is a registered dataclass pytree: it jits, vmaps, shards, and
serializes (orbax/npz) for free.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ekf_vio_tpu.config import BASE_STATE_SIZE, VIOConfig


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["base_mu", "feat_mu", "active", "klt_ref", "Sigma", "t",
                 "age"],
    meta_fields=[],
)
@dataclasses.dataclass
class FilterState:
    base_mu: jnp.ndarray  # [22]
    feat_mu: jnp.ndarray  # [N_max, 3]  (u, v, 1/depth)
    active: jnp.ndarray   # [N_max] bool
    klt_ref: jnp.ndarray  # [N_max, 2]  last tracker result (metric), Feature.h:43
    Sigma: jnp.ndarray    # [D, D] dense covariance
    t: jnp.ndarray        # scalar f64-as-f32 time (seconds)
    age: jnp.ndarray      # [N_max] int32 — frames since slot allocation

    @property
    def n_max(self) -> int:
        return self.feat_mu.shape[-2]

    @property
    def state_dim(self) -> int:
        return BASE_STATE_SIZE + 3 * self.n_max

    def num_active(self) -> jnp.ndarray:
        return jnp.sum(self.active.astype(jnp.int32), axis=-1)

    def mu_flat(self) -> jnp.ndarray:
        """Flatten [base | features] into the single state vector the
        update operates on (analog of TightlyCoupledEKF.cpp:492-541)."""
        return jnp.concatenate([self.base_mu, self.feat_mu.reshape(-1)], axis=-1)

    def replace(self, **kw) -> "FilterState":
        return dataclasses.replace(self, **kw)


def init_state(cfg: VIOConfig, t0: float = 0.0, dtype=jnp.float32) -> FilterState:
    """Initial state (reference: TightlyCoupledEKF.cpp:23-56).

    base_mu = 0 except unit quaternion; pose block variance 0 (anchored),
    kinematic block variance 30, bias variance 0.5.  Feature slots start
    inactive at the default-depth prior (ρ = 1/default_depth keeps the
    transport math finite for padded slots).
    """
    n = cfg.max_features
    d = BASE_STATE_SIZE + 3 * n

    base_mu = jnp.zeros((BASE_STATE_SIZE,), dtype)
    base_mu = base_mu.at[3].set(1.0)  # qw = 1, no rotation

    sig_diag = jnp.concatenate(
        [
            jnp.full((7,), cfg.init_pose_variance, dtype),
            jnp.full((9,), cfg.init_kinematic_variance, dtype),
            jnp.full((6,), cfg.init_bias_variance, dtype),
            jnp.zeros((3 * n,), dtype),
        ]
    )

    rho0 = 1.0 / cfg.default_point_depth
    feat_mu = jnp.tile(jnp.array([0.0, 0.0, rho0], dtype), (n, 1))

    return FilterState(
        base_mu=base_mu,
        feat_mu=feat_mu,
        active=jnp.zeros((n,), bool),
        klt_ref=jnp.zeros((n, 2), dtype),
        Sigma=jnp.diag(sig_diag),
        t=jnp.asarray(t0, dtype),
        age=jnp.zeros((n,), jnp.int32),
    )


def plan_insertion(active: jnp.ndarray, valid: jnp.ndarray):
    """Slot assignment for feature insertion (shared by the covariance- and
    factor-form add_features): candidate j goes to the j-th free slot.

    Returns (take [N] bool — slots that get filled, src [N] int32 — which
    candidate index each slot receives).  Computed with cumsums so shapes
    stay static.
    """
    k = valid.shape[0]
    free = ~active  # [N]
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1   # rank among free
    cand_rank = jnp.cumsum(valid.astype(jnp.int32)) - 1  # rank among valid
    n_free = jnp.sum(free.astype(jnp.int32))
    n_cand = jnp.sum(valid.astype(jnp.int32))
    n_insert = jnp.minimum(n_free, n_cand)

    take = free & (free_rank < n_insert)                 # slots that fill
    cand_idx_of_rank = jnp.zeros((k,), jnp.int32).at[
        jnp.where(valid, cand_rank, k)].set(
        jnp.arange(k, dtype=jnp.int32), mode="drop")
    src = cand_idx_of_rank[jnp.clip(free_rank, 0, k - 1)]  # [N]
    return take, src


def feature_rowcol_indices(n_max: int):
    """Static index vectors into the flat state for feature sub-blocks."""
    base = BASE_STATE_SIZE + 3 * jnp.arange(n_max)
    uv = jnp.stack([base, base + 1], axis=-1).reshape(-1)  # [2N]
    uvr = jnp.stack([base, base + 1, base + 2], axis=-1).reshape(-1)  # [3N]
    return uv, uvr


# --------------------------------------------------------------------------
# Gather/scatter-free index algebra.  The feature sub-blocks are STRIDED
# (rows 22+3i, +1, +2), so every hot access is expressible as reshape +
# contiguous slice, and diagonals as eye-masked elementwise ops, with no
# gather or scatter.  Chosen on a machine where gathers were slow; on the
# GPU it is not yet A/B'd against plain indexing (ROADMAP queue 3, item 2).
# --------------------------------------------------------------------------


def uv_rows(M: jnp.ndarray, n: int) -> jnp.ndarray:
    """[2N, ...] = M[uv_idx] without a gather: rows 22+3i, 22+3i+1."""
    tail = M[BASE_STATE_SIZE:]
    return tail.reshape((n, 3) + tail.shape[1:])[:, :2].reshape(
        (2 * n,) + tail.shape[1:])


def uv_cols(M: jnp.ndarray, n: int) -> jnp.ndarray:
    """[..., 2N] = M[:, uv_idx] without a gather."""
    tail = M[:, BASE_STATE_SIZE:]
    return tail.reshape(tail.shape[0], n, 3)[:, :, :2].reshape(
        tail.shape[0], 2 * n)


def diag_of(M: jnp.ndarray) -> jnp.ndarray:
    """diag(M) without the gather fusion (eye-masked row reduction)."""
    d = M.shape[0]
    return jnp.sum(M * jnp.eye(d, dtype=M.dtype), axis=1)


def diag_embed(v: jnp.ndarray) -> jnp.ndarray:
    """jnp.diag(vector) without the scatter fusion."""
    d = v.shape[0]
    return jnp.eye(d, dtype=v.dtype) * v[None, :]


def block_diag_dense(B: jnp.ndarray) -> jnp.ndarray:
    """[N, k, k] blocks -> [kN, kN] block diagonal, built directly in 2D.

    The eye-broadcast 4D form ([N,k,N,k] -> reshape) needs a relayout
    copy; this k²-term masked broadcast stays in the final 2D layout and
    fuses into the consumer.
    """
    n, k, _ = B.shape
    d = n * k
    rr = jnp.arange(d)[:, None]
    cc = jnp.arange(d)[None, :]
    same_blk = (rr // k) == (cc // k)
    out = jnp.zeros((d, d), B.dtype)
    for i in range(k):
        for j in range(k):
            vec = jnp.repeat(B[:, i, j], k)        # value at row 2f+i -> r//k
            m = same_blk & ((rr % k) == i) & ((cc % k) == j)
            out = out + jnp.where(m, vec[:, None], 0.0)
    return out


def add_features(
    state: FilterState, cfg: VIOConfig, new_uv: jnp.ndarray, valid: jnp.ndarray,
    depths: jnp.ndarray | None = None,
    depth_vars: jnp.ndarray | None = None,
) -> FilterState:
    """Insert up to K new features into free slots.

    Analog of ``addNewFeatures`` (TightlyCoupledEKF.cpp:58-94): each new
    feature enters at the default depth with diagonal prior
    [σ_uv, σ_uv, σ_depth] and *no* initial cross-correlation ("introduced
    naturally through the process", TightlyCoupledEKF.cpp:66-67) — so the
    inserted slot's Σ rows/cols are wiped before the diagonal is set
    (slot-reuse semantics replacing conservativeResize).

    Args:
      new_uv: [K, 2] candidate normalized-metric positions.
      valid:  [K] bool — which candidates are real (static-shape padding).
      depths: optional [K] per-candidate initial depths (triangulated —
        see core/depth_init.py); defaults to the constant prior.
      depth_vars: optional [K] per-candidate ρ-prior variances matched to
        the triangulation geometry (σ_ρ ≈ ρ·σ_angle/parallax) — a
        constant prior on a near-degenerate two-view depth invites
        confidently-wrong features; defaults to the constant prior.
    """
    n = state.n_max
    take, src = plan_insertion(state.active, valid)

    if depths is None:
        rho = jnp.full((n, 1), 1.0 / cfg.default_point_depth,
                       state.feat_mu.dtype)
    else:
        rho = (1.0 / jnp.clip(depths[src], 1e-3, 1e3))[:, None]
    new_mu = jnp.concatenate([new_uv[src], rho], axis=-1)  # [N,3]

    feat_mu = jnp.where(take[:, None], new_mu, state.feat_mu)
    klt_ref = jnp.where(take[:, None], new_uv[src], state.klt_ref)
    active = state.active | take

    # Σ bookkeeping: zero the rows/cols of (re)allocated slots, then set the
    # diagonal prior.
    take3 = jnp.repeat(take, 3)  # [3N]
    # multiplicative wipe: one fused [D,D] pass (a bool-broadcast where()
    # costs two materialized [D,D] operands).  uvr covers exactly indices
    # >= BASE_STATE_SIZE, so the keep vector is a concat, not a scatter.
    keep = jnp.concatenate([
        jnp.ones((BASE_STATE_SIZE,), state.Sigma.dtype),
        1.0 - take3.astype(state.Sigma.dtype)])
    Sigma = state.Sigma * (keep[:, None] * keep[None, :])
    if depth_vars is None:
        dvar = jnp.full((n,), cfg.default_point_depth_variance, Sigma.dtype)
    else:
        dvar = jnp.clip(depth_vars[src], 1e-8,
                        cfg.default_point_depth_variance)
    prior = jnp.where(
        take[:, None],
        jnp.stack(
            [
                jnp.full((n,), cfg.default_point_homogenous_variance,
                         Sigma.dtype),
                jnp.full((n,), cfg.default_point_homogenous_variance,
                         Sigma.dtype),
                dvar,
            ],
            axis=-1,
        ),
        0.0,
    ).reshape(-1)
    # diagonal prior for the taken slots as an eye-masked add — the
    # scatter form (Sigma.at[uvr, uvr].set) lowered to a 34 us/frame
    # scalar-unit fusion, and the taken rows were just wiped to zero so
    # an ADD of the prior is exact
    add_diag = jnp.concatenate([
        jnp.zeros((BASE_STATE_SIZE,), Sigma.dtype),
        jnp.where(take3, prior, 0.0)])
    Sigma = Sigma + diag_embed(add_diag)

    age = jnp.where(take, 0, state.age)
    return state.replace(feat_mu=feat_mu, active=active, klt_ref=klt_ref,
                         Sigma=Sigma, age=age)


def drop_features(state: FilterState, drop: jnp.ndarray) -> FilterState:
    """Free slots (the cleanup the reference never performs).

    Σ rows/cols of dropped slots are zeroed so they cannot re-correlate;
    their mean returns to the default prior on next allocation.
    """
    n = state.n_max
    drop = drop & state.active
    drop3 = jnp.repeat(drop, 3)
    keep = jnp.concatenate([
        jnp.ones((BASE_STATE_SIZE,), state.Sigma.dtype),
        1.0 - drop3.astype(state.Sigma.dtype)])
    Sigma = state.Sigma * (keep[:, None] * keep[None, :])
    return state.replace(active=state.active & ~drop, Sigma=Sigma)


def check_sigma(state: FilterState, sym_eps: float = 1e-3):
    """Invariant audit (analog of checkSigma, TightlyCoupledEKF.cpp:699-714).

    Returns (min_diag, max_asymmetry) for assertion in tests: diagonal must
    be >= 0 and Σ symmetric within sym_eps.
    """
    diag = jnp.diag(state.Sigma)
    asym = jnp.max(jnp.abs(state.Sigma - state.Sigma.T))
    return jnp.min(diag), asym
