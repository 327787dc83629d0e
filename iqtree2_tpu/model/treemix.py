"""Tree-mixture models (+T): the site likelihood is a weighted sum over T
topologies sharing one alignment and one substitution model.

Reference analog: IQTreeMix (tree/iqtreemix.h:21, computeLikelihood
tree/iqtreemix.cpp:586): L(p) = sum_t w_t L_t(p); weights by EM; branch
lengths per tree by EM-weighted per-tree optimization.

Device mapping: the T schedules have identical array shapes (same ntaxa), so
per-tree site likelihoods batch on a leading tree axis; the EM M-step for
tree t's branch lengths reuses the standard all-branch Newton with the
posterior-weighted pattern weights (the exact EM surrogate).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from iqtree2_tpu.engine import LikelihoodEngine, _optimize_blens_jit
from iqtree2_tpu.ops import pruning
from iqtree2_tpu.tree.schedule import build_schedule, write_blens_to_tree


class TreeMixture:
    """EM fitter over a fixed set of topologies (+T)."""

    def __init__(self, eng: LikelihoodEngine, trees: list,
                 weights=None):
        if len(trees) < 2:
            raise ValueError("+T needs at least two trees")
        self.eng = eng
        self.trees = [t.copy() for t in trees]
        T = len(trees)
        self.weights = (np.full(T, 1.0 / T) if weights is None
                        else np.asarray(weights, float))
        self.weights = self.weights / self.weights.sum()
        self.fix_weights = weights is not None

    # ------------------------------------------------------------ E-step
    def _site_lps(self) -> np.ndarray:
        """[T, P] per-tree per-pattern log-likelihoods."""
        out = []
        for t in self.trees:
            _, lp = self.eng.site_lp(t)
            out.append(lp)
        return np.stack(out)

    def loglik(self) -> float:
        lps = self._site_lps()                      # [T, P]
        m = lps.max(axis=0)
        lw = np.log(self.weights)[:, None]
        site = m + np.log(np.exp(lps - m[None, :] + lw).sum(0))
        # weights of log(w) already folded above
        w = self.eng.aln.pattern_weights
        return float((w * site).sum())

    def _posteriors(self) -> np.ndarray:
        """[T, P] posterior tree responsibilities per pattern."""
        lps = self._site_lps()
        lw = np.log(np.maximum(self.weights, 1e-300))[:, None]
        a = lps + lw
        a -= a.max(axis=0, keepdims=True)
        e = np.exp(a)
        return e / np.maximum(e.sum(axis=0, keepdims=True), 1e-300)

    # ------------------------------------------------------------- M-step
    def _optimize_tree_blens(self, t_idx: int, post_row: np.ndarray,
                             n_rounds: int = 4) -> None:
        """Branch lengths of tree t under posterior-weighted patterns."""
        eng = self.eng
        tree = self.trees[t_idx]
        sched = build_schedule(tree)
        pw = jnp.asarray(
            eng.pattern_weights[: eng.Pp] *
            np.pad(post_row, (0, eng.Pp - post_row.shape[0])), eng.dtype)
        blens = jnp.asarray(np.maximum(sched.blens, 1e-6), eng.dtype)
        new_blens, _ = _optimize_blens_jit(
            blens, eng._dev_tipP, eng.schedule_arrays(sched),
            eng._dev_pack, pw, jnp.asarray(1e-6, eng.dtype),
            jnp.asarray(10.0, eng.dtype), n_rounds, 4)
        write_blens_to_tree(tree, sched, np.asarray(new_blens, np.float64))

    def fit(self, n_iter: int = 10, tol: float = 1e-3,
            log=lambda s: None) -> float:
        """EM: alternate tree responsibilities, per-tree branch lengths,
        and weights until the mixture logL converges."""
        prev = -np.inf
        for it in range(n_iter):
            post = self._posteriors()               # [T, P]
            w_site = self.eng.aln.pattern_weights
            for t_idx in range(len(self.trees)):
                self._optimize_tree_blens(t_idx, post[t_idx])
            if not self.fix_weights:
                resp = (post * w_site[None, :]).sum(1)
                resp = np.maximum(resp, 1e-9)
                self.weights = resp / resp.sum()
            cur = self.loglik()
            log(f"  [+T] EM iter {it + 1}: logL {cur:.4f}  weights "
                f"{np.round(self.weights, 4).tolist()}")
            if cur - prev < tol and it > 0:
                return cur
            prev = cur
        return prev
