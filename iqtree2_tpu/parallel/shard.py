"""Site-sharded likelihood over a device mesh.

Design (SURVEY §2c / §5): alignment *site patterns* are the data-parallel
axis. Each device holds a pattern shard of the tip partials and pattern
weights; the pruning recursion runs independently per shard (site
likelihoods are independent given the tree — no halo exchange), and the only
cross-device communication is a psum of logL and branch-derivative scalars
across devices. This goes beyond the reference, whose MPI ranks each hold the
whole alignment (main/main.cpp:2506 — MPI only parallelizes search).

The mesh axis is named "sites". Model pack and topology schedule are
replicated; branch lengths are replicated (updated identically everywhere
from psum'd derivatives, like the reference's synchronized controllers).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from iqtree2_tpu.ops import pruning

AXIS = "sites"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def pad_patterns_for_mesh(n_patterns: int, n_shards: int,
                          lane: int = 128) -> int:
    """Pattern count padded so each shard is a multiple of `lane`."""
    per = -(-n_patterns // n_shards)
    per = -(-per // lane) * lane
    return per * n_shards


_PER_PATTERN_PACK_KEYS = ("log_ptn_invar", "asc_mask")


def _pack_specs(pack) -> dict:
    """PartitionSpec pytree mirroring the model pack's keys: every array
    replicated except the per-pattern ones (spec derives from the actual
    pack so new keys — Q, asc_mask, ... — never desync)."""
    return {k: (P(AXIS) if k in _PER_PATTERN_PACK_KEYS else P())
            for k in pack}


def sharded_loglik_fn(mesh: Mesh, pack):
    """Returns a jitted fn(blens, tipP, sched, pack, pattern_weights) with
    tipP/pattern_weights sharded on the pattern axis."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(None, None, AXIS), P(), _pack_specs(pack), P(AXIS)),
        out_specs=(P(), P(AXIS)),
        check_vma=False)
    def fn(blens, tipP, sched, pack, pw):
        logL, lp = pruning.tree_loglik(blens, tipP, sched, pack, pw,
                                       axis_name=AXIS)
        return logL, lp

    return jax.jit(fn)


def sharded_optimize_step_fn(mesh: Mesh, pack, n_newton: int = 4):
    """One full sharded branch-optimization round: down+up passes on each
    shard, per-edge Newton with psum'd derivatives, returns (blens, logL).

    This is the multi-chip "training step": all heavy tensors live sharded;
    only O(n_edges) scalars cross chips per Newton iteration.
    """

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(None, None, AXIS), P(), _pack_specs(pack), P(AXIS),
                  P(), P()),
        out_specs=(P(), P()),
        check_vma=False)
    def step(blens, tipP, sched, pack, pw, t_min, t_max):
        dtype = tipP.dtype
        Pm = pruning.transition_tensors(blens.astype(dtype), pack)
        dp = pruning.down_pass(Pm, tipP, sched)
        up = pruning.up_pass(Pm, dp, tipP, sched, pack["root_freqs"])
        th = pruning.edge_thetas(up, dp, sched["edge_src"], pack)
        newton = jax.vmap(
            lambda t_e, th_e, sc_e: pruning.newton_branch_step(
                th_e, sc_e, t_e, pack, pack["log_ptn_invar"], pw,
                t_min, t_max, n_iter=n_newton, axis_name=AXIS))
        new_blens = jnp.clip(
            newton(blens.astype(dtype), th.theta, th.scale), t_min, t_max)
        logL, _ = pruning.tree_loglik(new_blens, tipP, sched, pack, pw,
                                      axis_name=AXIS)
        return new_blens, logL

    return jax.jit(step)


def sharded_rell_fn(mesh: Mesh):
    """UFBoot RELL rescoring [R, P] @ [P] with the pattern axis sharded
    over the mesh (reference analog: per-rank replicate slices,
    tree/iqtree.cpp:352-362 — here each device holds a SITE slice of all
    replicates and one psum yields every replicate's score)."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, AXIS), P(AXIS)), out_specs=P(),
        check_vma=False)
    def rell(samples, lp):
        # HIGHEST for the reason given in UFBoot.enable_device_rell
        return jax.lax.psum(jnp.matmul(samples, lp,
                                       precision=jax.lax.Precision.HIGHEST),
                            AXIS)

    return jax.jit(rell)


def sharded_nni_fn(mesh: Mesh, pack, n_newton: int = 4):
    """Batched NNI candidate scoring with every per-pattern buffer (down
    partials, outside partials, weights) sharded on the sites axis; Newton
    derivative sums psum across devices (the batch workloads ride the
    mesh, not just plain logL)."""
    from iqtree2_tpu.ops.nni import evaluate_nnis

    dp_spec = pruning.DownPass(P(None, None, None, AXIS), P(None, AXIS))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=((P(), P(), P(), P()), P(), dp_spec,
                  P(None, None, None, AXIS), P(None, AXIS), P(),
                  _pack_specs(pack), P(AXIS), P(), P()),
        out_specs=(P(), P()),
        check_vma=False)
    def fn(cand, blens, dp, up_in, up_scale, sched, pack_, pw,
           t_min, t_max):
        return evaluate_nnis(cand, blens, pruning.DownPass(*dp), up_in,
                             up_scale, sched, pack_, pw, t_min, t_max,
                             n_newton=n_newton, axis_name=AXIS)

    return jax.jit(fn)


def shard_engine_arrays(mesh: Mesh, tipP, pattern_weights, log_ptn_invar):
    """Place the per-pattern arrays on the mesh with pattern sharding."""
    s3 = NamedSharding(mesh, P(None, None, AXIS))
    s1 = NamedSharding(mesh, P(AXIS))
    return (jax.device_put(tipP, s3), jax.device_put(pattern_weights, s1),
            jax.device_put(log_ptn_invar, s1))
