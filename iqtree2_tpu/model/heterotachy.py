"""Heterotachy (+H / mixlen) models: H classes sharing one substitution
model but each with its OWN branch lengths; class weights optimized by EM.

Reference analogs: RateHeterotachy (model/rateheterotachy.cpp) +
PhyloTreeMixlen (tree/phylotreemixlen.cpp — per-category lengths via EM +
per-category Newton, computeLikelihoodDervMixlen).

Device mapping: branch lengths become a [n_edges, H] tensor; the transition
builder broadcasts per-category lengths (ops/pruning.transition_tensors
accepts 2-D blens), so the SAME pruning kernels serve +H with zero extra
kernel code. Branch optimization uses the mixlen coordinate-Newton on the
shared theta buffers.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from iqtree2_tpu.engine import LikelihoodEngine, DEFAULT_MIN_BLEN, \
    DEFAULT_MAX_BLEN
from iqtree2_tpu.model.rates import RateModel
from iqtree2_tpu.ops import pruning
from iqtree2_tpu.tree.schedule import build_schedule, write_blens_to_tree


class RateHeterotachy(RateModel):
    """+H{k}: k classes, all rates 1, free weights (optimized by EM —
    reference: RateHeterotachy::optimizeWithEM)."""

    def __init__(self, ncat: int, weights=None):
        self._ncat = ncat
        self.weights = (np.full(ncat, 1.0 / ncat) if weights is None
                        else np.asarray(weights, float))
        self.name = f"+H{ncat}"

    @property
    def ncat(self) -> int:
        return self._ncat

    def category_rates(self) -> np.ndarray:
        return np.ones(self.ncat)

    def category_weights(self) -> np.ndarray:
        return self.weights / self.weights.sum()

    # weights are EM-optimized by the engine, not by generic L-BFGS
    def get_params(self) -> np.ndarray:
        return np.zeros(0)

    def set_params(self, x) -> None:
        pass

    def param_bounds(self):
        return np.zeros(0), np.zeros(0)

    def num_free_params(self) -> int:
        return self.ncat - 1


@functools.partial(jax.jit, static_argnames=("n_rounds", "n_newton"))
def _optimize_mixlen_jit(blens2, tipP, sched, pack, pattern_weights,
                         t_min, t_max, n_rounds: int, n_newton: int):
    """All-branch mixlen Newton rounds with joint backtracking
    (the [E, H] analog of engine._optimize_blens_jit)."""
    dtype = tipP.dtype

    def lg(b2):
        return pruning.tree_loglik(b2, tipP, sched, pack,
                                   pattern_weights)[0]

    def one_round(b2, logL_prev):
        P = pruning.transition_tensors(b2.astype(dtype), pack)
        dp, up = pruning.both_passes(P, tipP, sched, pack)
        th = pruning.edge_thetas(up, dp, sched["edge_src"], pack)
        newton = jax.vmap(
            lambda tv, th_e, sc_e: pruning.newton_branch_step_mixlen(
                th_e, sc_e, tv, pack, pack["log_ptn_invar"],
                pattern_weights, t_min, t_max, n_iter=n_newton))
        prop = jnp.clip(newton(b2.astype(dtype), th.theta, th.scale),
                        t_min, t_max)
        from iqtree2_tpu.engine import _backtrack
        return _backtrack(lg, b2, prop, logL_prev)

    from iqtree2_tpu.engine import _sweep_until
    return _sweep_until(lg, one_round, blens2, n_rounds, 1e-3)


@jax.jit
def _class_posterior_jit(blens2, tipP, sched, pack, pattern_weights):
    """(logL, class posterior [C]) — weighted mean over patterns of
    post(c|p), the EM E-step for the class weights."""
    dtype = tipP.dtype
    P = pruning.transition_tensors(blens2.astype(dtype), pack)
    dp = pruning.down_pass(P, tipP, sched)
    n_int = sched["child_src"].shape[0]
    Broot, SCroot = pruning.root_partial(dp, P, tipP, n_int)
    lh_cat = jnp.einsum("cx,cxp->cp", pack["root_freqs"], Broot,
                        precision=jax.lax.Precision.HIGHEST)
    wl = pack["cat_weight"][:, None] * lh_cat
    tot = jnp.maximum(wl.sum(0, keepdims=True), jnp.finfo(dtype).tiny)
    post = wl / tot                                    # [C, P]
    wsum = jnp.maximum(pattern_weights.sum(), 1.0)
    w_new = (post * pattern_weights[None, :]).sum(1) / wsum
    logL, _ = pruning.root_loglik(
        Broot, SCroot, pack["root_freqs"], pack["cat_weight"],
        pack["log_ptn_invar"], pattern_weights)
    return logL, w_new


class MixlenEngine(LikelihoodEngine):
    """Engine over +H models: per-category branch lengths [E, H].

    Fixed-topology evaluation/optimization (the reference's -te +H flow);
    the last optimized mixlen vector set is kept on the engine."""

    _fused_nni = False   # scalar fused NNI round would drop class lengths

    def __init__(self, aln, model, rates: RateHeterotachy, **kw):
        super().__init__(aln, model, rates, **kw)
        self.mixlen = rates.ncat
        self.blens2: np.ndarray | None = None

    def init_blens2(self, sched) -> np.ndarray:
        """Spread initial per-class lengths around the tree's lengths
        (reference initializes classes at 0.5x..1.5x to break symmetry)."""
        H = self.mixlen
        spread = np.linspace(0.5, 1.5, H)
        return np.maximum(sched.blens[:, None] * spread[None, :],
                          DEFAULT_MIN_BLEN)

    def optimize_mixlen(self, tree, n_outer: int = 5, n_rounds: int = 4,
                        n_newton: int = 4) -> float:
        """Alternate (branch-length Newton rounds) with (EM weight
        updates) until done; writes the weight-averaged lengths back to
        the host tree and keeps self.blens2."""
        sched = build_schedule(tree)
        sa = self.schedule_arrays(sched)
        b2 = jnp.asarray(self.blens2 if self.blens2 is not None and
                         self.blens2.shape[0] == sched.n_edges
                         else self.init_blens2(sched), self.dtype)
        t_min = jnp.asarray(DEFAULT_MIN_BLEN, self.dtype)
        t_max = jnp.asarray(DEFAULT_MAX_BLEN, self.dtype)
        logL = -np.inf
        for _ in range(n_outer):
            b2, logL = _optimize_mixlen_jit(
                b2, self._dev_tipP, sa, self._dev_pack, self._dev_pw,
                t_min, t_max, n_rounds, n_newton)
            _, w_new = _class_posterior_jit(
                b2, self._dev_tipP, sa, self._dev_pack, self._dev_pw)
            w_new = np.maximum(np.asarray(w_new, np.float64), 1e-6)
            self.rates.weights = w_new / w_new.sum()
            self.refresh_model()
        logL = float(logL)
        self.blens2 = np.asarray(b2, np.float64)
        mean_b = (self.blens2 *
                  self.rates.category_weights()[None, :]).sum(1)
        write_blens_to_tree(tree, sched, mean_b)
        return float(_class_posterior_jit(
            jnp.asarray(self.blens2, self.dtype), self._dev_tipP, sa,
            self._dev_pack, self._dev_pw)[0])

    # -------------------------------------------------- search integration
    # The reference searches +H models WITH per-class branch lengths
    # (PhyloTreeMixlen overrides optimizeOneBranch / optimizeAllBranches,
    # tree/phylotreemixlen.cpp:338, :736).  These overrides give the
    # TreeSearch machinery the same semantics: optimize_branches runs the
    # per-class Newton sweeps, and NNI candidates are scored with
    # per-class central-branch (NNI1) or five-branch (NNI5) Newton.
    def _blens2_for(self, tree, sched) -> np.ndarray:
        """[E, H] start lengths from the tree's stored per-class vectors
        (tree.blen_h), falling back to scalar x spread for edges without
        one (fresh edges after an NNI swap)."""
        H = self.mixlen
        spread = np.linspace(0.5, 1.5, H)
        out = np.empty((sched.n_edges, H))
        from iqtree2_tpu.tree.topology import Tree as _T
        for e, pair in enumerate(sched.edge_nodes):
            if pair is None:
                out[e] = max(sched.blens[e], DEFAULT_MIN_BLEN) * spread
                continue
            v = tree.blen_h.get(_T._key(*pair))
            if v is None or len(v) != H:
                out[e] = max(sched.blens[e], DEFAULT_MIN_BLEN) * spread
            else:
                out[e] = np.maximum(v, DEFAULT_MIN_BLEN)
        return out

    def _write_blens2(self, tree, sched, b2: np.ndarray) -> None:
        from iqtree2_tpu.tree.topology import Tree as _T
        w = self.rates.category_weights()
        mean_b = (b2 * w[None, :]).sum(1)
        write_blens_to_tree(tree, sched, mean_b)
        for e, pair in enumerate(sched.edge_nodes):
            if pair is not None:
                tree.blen_h[_T._key(*pair)] = b2[e].copy()

    def optimize_branches(self, tree, n_rounds: int = 10,
                          n_newton: int = 4,
                          t_min: float = DEFAULT_MIN_BLEN,
                          t_max: float = DEFAULT_MAX_BLEN) -> float:
        """Per-class all-branch Newton sweeps (no EM weight update — the
        weights are model parameters, refit by optimize_mixlen)."""
        sched = build_schedule(tree)
        sa = self.schedule_arrays(sched)
        b2 = jnp.asarray(self._blens2_for(tree, sched), self.dtype)
        b2, logL = _optimize_mixlen_jit(
            b2, self._dev_tipP, sa, self._dev_pack, self._dev_pw,
            self._dev_scalar(t_min), self._dev_scalar(t_max),
            n_rounds, n_newton)
        b2 = np.asarray(b2, np.float64)
        self._write_blens2(tree, sched, b2)
        self.blens2 = b2
        return float(logL)

    def evaluate_nni_batch(self, sched, cand_arrays,
                           t_min: float = DEFAULT_MIN_BLEN,
                           t_max: float = DEFAULT_MAX_BLEN,
                           return_site_lp: bool = False,
                           nni5: bool = False):
        """NNI scoring with PER-CLASS branch Newton.  Returns
        (logl [n,3], t_opt mean [n,3]) and with nni5 also t5 mean
        [n,3,5]; the full per-class optimized tensors are kept on
        self.last_t5_h for callers that re-apply class vectors."""
        from iqtree2_tpu.ops.nni import evaluate_nnis, evaluate_nnis5
        import jax as _jax
        tree_for_b2 = getattr(self, "_nni_tree", None)
        b2 = (self._blens2_for(tree_for_b2, sched)
              if tree_for_b2 is not None else None)
        if b2 is None:
            spread = np.linspace(0.5, 1.5, self.mixlen)
            b2 = np.maximum(sched.blens[:, None], DEFAULT_MIN_BLEN)                 * spread[None, :]
        blens2 = jnp.asarray(b2, self.dtype)
        sa = self.schedule_arrays(sched)
        P = pruning.transition_tensors(blens2, self._dev_pack)
        dp, up = pruning.both_passes(P, self._dev_tipP, sa,
                                     self._dev_pack)
        cand = jnp.asarray(cand_arrays)
        w = jnp.asarray(self.rates.category_weights(), self.dtype)
        if nni5:
            logl, t5e, t5 = evaluate_nnis5(
                cand, blens2, dp, up, sa, self._dev_pack, self._dev_pw,
                self._dev_scalar(t_min), self._dev_scalar(t_max),
                mixlen=True)
            logl = np.asarray(logl)
            t5 = np.asarray(t5)                    # [n, 3, 5, H]
            self.last_t5_h = t5
            t5m = (t5 * np.asarray(w)[None, None, None, :]).sum(-1)
            return logl, t5m[:, :, 4], t5m
        logl, t_opt, _ = evaluate_nnis(
            cand, blens2, dp, up.up_in, up.up_scale, sa, self._dev_pack,
            self._dev_pw, self._dev_scalar(t_min),
            self._dev_scalar(t_max), mixlen=True)
        t_opt = np.asarray(t_opt)                  # [n, 3, H]
        tm = (t_opt * np.asarray(w)[None, None, :]).sum(-1)
        return np.asarray(logl), tm

    def loglik_mixlen(self, tree) -> float:
        sched = build_schedule(tree)
        if self.blens2 is None or self.blens2.shape[0] != sched.n_edges:
            self.blens2 = self.init_blens2(sched)
        logL, _ = _class_posterior_jit(
            jnp.asarray(self.blens2, self.dtype), self._dev_tipP,
            self.schedule_arrays(sched), self._dev_pack, self._dev_pw)
        return float(logL)
