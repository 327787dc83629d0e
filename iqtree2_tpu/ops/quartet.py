"""Likelihood mapping: batched quartet likelihoods on-chip.

Reference analog: doLikelihoodMapping (tree/quartet.cpp:1365): sample
quartets (a,b,c,d), compute the ML logL of the three quartet topologies
(ab|cd), (ac|bd), (ad|bc), convert to posterior weights, and map each
quartet onto the barycentric simplex — corner/edge/center region counts
diagnose tree-likeness of the data.

Design: the CPU reference evaluates quartets one at a time in an OpenMP
loop (tree/quartet.cpp:676); here all quartets are a leading batch axis of
one jitted function — topology logLs with a 5-branch Newton (full 5x5
Hessian via autodiff) vmapped over the batch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST


def _quartet_loglik(t5, tips, pack, pw):
    """logL of one quartet topology given 5 branch lengths.

    tips: [4, C?, S, P] leaf partials already gathered in topology order
    (a, b | c, d with the central edge between); t5 = (ta, tb, tc, td, tm).
    """
    from iqtree2_tpu.ops import pruning
    P5 = pruning.transition_tensors(t5, pack)   # [5, C, S, S]
    La, Lb, Lc, Ld = tips[0], tips[1], tips[2], tips[3]

    def msg(k, L):
        return jnp.einsum("cxy,cyp->cxp", P5[k], L, precision=HIGHEST)

    pu = msg(0, La) * msg(1, Lb)               # [C, S, P]
    pv = msg(2, Lc) * msg(3, Ld)
    mv = jnp.einsum("cxy,cyp->cxp", P5[4], pv, precision=HIGHEST)
    site = jnp.einsum("c,cx,cxp->p", pack["cat_weight"],
                      pack["root_freqs"], pu * mv, precision=HIGHEST)
    tiny = jnp.finfo(site.dtype).tiny
    lp = jnp.log(jnp.maximum(site, tiny))
    lp = jnp.logaddexp(lp, pack["log_ptn_invar"])
    return jnp.sum(pw * lp)


@functools.partial(jax.jit, static_argnames=("n_iter",))
def quartet_topology_logls(tip_idx, tipP, pack, pw, t_init,
                           n_iter: int = 5):
    """[Q, 4] taxon indices -> [Q, 3] optimized topology logLs.

    Branch lengths optimized per (quartet, topology) by full-Newton on the
    5-vector (jax.hessian; 5x5 solve), vmapped over the batch.
    """
    dtype = tipP.dtype
    tips_all = tipP[tip_idx]      # [Q, 4, S, P]
    if tips_all.ndim == 4:        # no category axis on leaf partials
        tips_all = tips_all[:, :, None, :, :]   # [Q, 4, 1, S, P]
    C = pack["cat_rate"].shape[0]
    tips_all = jnp.broadcast_to(
        tips_all, tips_all.shape[:2] + (C,) + tips_all.shape[3:])

    orders = jnp.asarray([[0, 1, 2, 3], [0, 2, 1, 3], [0, 3, 1, 2]])

    def one_quartet(tips):
        def one_topo(order):
            tt = tips[order]

            def nll(t5):
                return -_quartet_loglik(jnp.exp(t5), tt, pack, pw)

            # optimize in log-space (unconstrained Newton with clipping)
            x = jnp.log(t_init * jnp.ones(5, dtype))

            def step(i, x):
                g = jax.grad(nll)(x)
                H = jax.hessian(nll)(x)
                H = H + 1e-3 * jnp.eye(5, dtype=dtype)
                dx = jnp.linalg.solve(H, g)
                ok = jnp.all(jnp.isfinite(dx))
                x_new = jnp.where(ok, x - jnp.clip(dx, -2.0, 2.0),
                                  x - 0.1 * g)
                return jnp.clip(x_new, jnp.log(1e-6), jnp.log(9.0))

            x = jax.lax.fori_loop(0, n_iter, step, x)
            return -nll(x)

        return jax.vmap(one_topo)(orders)

    return jax.vmap(one_quartet)(tips_all)


def likelihood_mapping(eng, n_quartets: int = 1000,
                       rng: np.random.Generator | None = None,
                       chunk: int = 128):
    """Sample quartets, compute topology weights, bin into the 7 simplex
    regions. Returns dict with regions, weights, quartet indices."""
    if rng is None:
        rng = np.random.default_rng(1)
    L = eng.aln.ntaxa
    if L < 4:
        raise ValueError("likelihood mapping needs >= 4 taxa")
    qs = np.stack([rng.choice(L, size=4, replace=False)
                   for _ in range(n_quartets)]).astype(np.int32)
    logls = np.zeros((n_quartets, 3))
    t_init = jnp.asarray(0.1, eng.dtype)
    for i in range(0, n_quartets, chunk):
        idx = jnp.asarray(qs[i:i + chunk])
        out = quartet_topology_logls(idx, eng._dev_tipP, eng._dev_pack,
                                     eng._dev_pw, t_init)
        logls[i:i + chunk] = np.asarray(out, np.float64)

    m = logls.max(axis=1, keepdims=True)
    wts = np.exp(logls - m)
    wts /= wts.sum(axis=1, keepdims=True)

    # 7 regions (Strimmer & von Haeseler 1997): 3 corners (resolved),
    # 3 edges (partly resolved), center (star-like)
    regions = np.zeros(7, dtype=np.int64)
    for w in wts:
        order = np.argsort(-w)
        if w[order[0]] > 2.0 / 3.0 or (w[order[0]] > 0.5 and
                                       w[order[1]] < 1.0 / 6.0):
            regions[order[0]] += 1                    # corner 1..3
        elif w[order[2]] < 1.0 / 6.0:
            pair = tuple(sorted(order[:2]))
            edge_id = {(0, 1): 3, (0, 2): 4, (1, 2): 5}[pair]
            regions[edge_id] += 1                     # edge regions
        else:
            regions[6] += 1                           # center
    return {"regions": regions, "weights": wts, "quartets": qs,
            "logls": logls}


def write_lmap_svg(path, wts: np.ndarray) -> None:
    """Simplex scatter plot of quartet weights (.lmap.svg analog)."""
    W, H = 500, 460
    # triangle corners
    ax, ay = W / 2, 30
    bx, by = 40, H - 30
    cx, cy = W - 40, H - 30
    pts = []
    for w in wts:
        x = w[0] * ax + w[1] * bx + w[2] * cx
        y = w[0] * ay + w[1] * by + w[2] * cy
        pts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="1.5" '
                   'fill="#1f6feb" fill-opacity="0.5"/>')
    svg = (f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" '
           f'height="{H}">'
           f'<polygon points="{ax},{ay} {bx},{by} {cx},{cy}" fill="none" '
           'stroke="black"/>' + "".join(pts) +
           '<text x="10" y="20" font-size="12">likelihood mapping: '
           'corners = resolved quartets</text></svg>')
    with open(path, "w") as f:
        f.write(svg)
