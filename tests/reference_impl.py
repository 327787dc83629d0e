"""Independent brute-force likelihood implementation (pure numpy, float64).

Used as an in-repo oracle for the jitted kernels: a direct recursive
Felsenstein pruning with no scaling tricks, no pattern padding, no schedule
arrays. Deliberately written differently from ops/pruning.py so that shared
bugs are unlikely.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu.data.alignment import Alignment
from iqtree2_tpu.model.pack import build_model_pack
from iqtree2_tpu.tree.topology import Tree


def brute_force_loglik(aln: Alignment, tree: Tree, model, rates) -> float:
    return float((aln.pattern_weights
                  * brute_force_site_lp(aln, tree, model, rates)).sum())


def brute_force_site_lp(aln: Alignment, tree: Tree, model,
                        rates) -> np.ndarray:
    """Per-pattern log-likelihoods [num_patterns]. Each node's partial is
    divided by its per-pattern maximum and the log of that factor carried
    along, so trees of thousands of taxa do not underflow float64."""
    pk = build_model_pack(aln, model, rates)
    C = pk.num_categories
    S = pk.num_states
    tbl = pk.tip_table  # [codes, S]
    codes = aln.tip_codes()  # [L, P]
    P = aln.num_patterns

    def pmat(t, c):
        m = pk.cat_mix[c]
        lam = pk.eigvals[m] * pk.cat_rate[c]
        return np.maximum(
            (pk.U[m] * np.exp(lam * t)[None, :]) @ pk.V[m], 0.0)

    root = tree._default_root()

    def partial(v, parent):  # ([C, P, S], log scale [P])
        if tree.is_leaf(v):
            return np.repeat(tbl[codes[v]][None], C, axis=0), np.zeros(P)
        out = np.ones((C, P, S))
        logscale = np.zeros(P)
        for u in tree.adj[v]:
            if u == parent:
                continue
            child, child_scale = partial(u, v)
            t = tree.get_blen(u, v)
            for c in range(C):
                out[c] *= child[c] @ pmat(t, c).T
            logscale += child_scale
        mx = np.maximum(out.max(axis=(0, 2)), 1e-300)
        return out / mx[None, :, None], logscale + np.log(mx)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        part, logscale = partial(root, -1)
    finally:
        sys.setrecursionlimit(old)
    site = np.zeros(P)
    for c in range(C):
        site += pk.cat_weight[c] * (part[c] @ pk.root_freqs[c])
    lp = np.log(site) + logscale
    if pk.p_invar > 0:
        lp = np.logaddexp(lp, pk.log_ptn_invar)
    return lp
