"""Site-specific ML rates (RateMeyerHaeseler analog).

Reference: RateMeyerHaeseler / RateMeyerDiscrete (model/ratemeyer*.cpp,
SURVEY #12): instead of a parametric +G law, each site gets its own ML
rate on the fixed tree. Here: evaluate per-pattern log-likelihoods
on a log-spaced rate grid in ONE batched lax.map (every grid point scales
ALL branch lengths), take the per-pattern argmax, then refine with one
parabolic step — no per-site host loops.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from iqtree2_tpu.ops import pruning
from iqtree2_tpu.tree.schedule import build_schedule


def site_rates_ml(eng, tree, n_grid: int = 33, r_min: float = 1e-3,
                  r_max: float = 20.0):
    """(ml_rate [num_patterns], lp_at_best [num_patterns]).

    eng should carry a single-category rate model (the reference replaces
    +G by the per-site rates); with multiple categories the result is the
    ML *multiplier* on top of the rate mixture."""
    sched = build_schedule(tree)
    sa = eng.schedule_arrays(sched)
    blens = jnp.asarray(sched.blens, eng.dtype)
    grid = jnp.asarray(
        np.geomspace(r_min, r_max, n_grid), eng.dtype)

    @jax.jit
    def all_lps(b):
        def one(r):
            _, lp = pruning.tree_loglik(b * r, eng._dev_tipP, sa,
                                        eng._dev_pack, eng._dev_pw)
            return lp
        return jax.lax.map(one, grid)              # [n_grid, Pp]

    lps = np.asarray(all_lps(blens))
    P = eng.aln.num_patterns
    lps = lps[:, :P]
    best = lps.argmax(axis=0)
    g = np.asarray(grid)
    rates = g[best]
    # one parabolic refinement in log-rate for interior maxima
    logg = np.log(g)
    for p in range(P):
        b = best[p]
        if 0 < b < n_grid - 1:
            y0, y1, y2 = lps[b - 1, p], lps[b, p], lps[b + 1, p]
            denom = (y0 - 2 * y1 + y2)
            if denom < -1e-12:
                dx = 0.5 * (y0 - y2) / denom
                dx = float(np.clip(dx, -1.0, 1.0))
                step = logg[b + 1] - logg[b]
                rates[p] = float(np.exp(logg[b] + dx * step))
    lp_best = lps[best, np.arange(P)]
    return rates, lp_best


def write_mlrate(path: str, aln, rates: np.ndarray) -> None:
    """.mlrate output (reference: -wsr with RateMeyerHaeseler)."""
    with open(path, "w") as f:
        f.write("# Site-specific ML rates (RateMeyerHaeseler analog)\n"
                "Site\tRate\n")
        for s in range(aln.nsites):
            f.write(f"{s + 1}\t{rates[aln.site_to_pattern[s]]:.5f}\n")
