"""Stochastic tree search controller (host).

Reference analog: IQTree::doTreeSearch (tree/iqtree.cpp:2196):
  1. initCandidateTreeSet (:697): parsimony + BIONJ start trees, quick
     branch optimization, NNI-polish the best ones into the candidate set.
  2. iterate: pick a top candidate, perturb (random NNIs / IQP), NNI
     hill-climb, update candidate set; stop by StopRule / UFBoot
     correlation.
Defaults follow SURVEY A12 (numInitTrees=100, numNNITrees=20, popSize=5,
unsuccess_iteration=100).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from iqtree2_tpu.data.alignment import Alignment
from iqtree2_tpu.engine import LikelihoodEngine
from iqtree2_tpu.ops.distances import hamming_jc_distances, ml_distances
from iqtree2_tpu.ops.pars import fitch_score, random_stepwise_addition, \
    state_bitmasks
from iqtree2_tpu.search.bionj import bionj_tree
from iqtree2_tpu.search.candidate import CandidateSet
from iqtree2_tpu.search.nni import nni_optimize
from iqtree2_tpu.search.perturb import iqp_perturb, random_nnis
from iqtree2_tpu.search.stoprule import StopRule
from iqtree2_tpu.tree.topology import Tree


@dataclasses.dataclass
class SearchParams:
    n_init_trees: int = 100         # numInitTrees
    n_nni_trees: int = 20           # numNNITrees
    pop_size: int = 5               # popSize
    pertub_strength: float = 0.5    # initPS
    loglh_epsilon: float = 0.001
    use_iqp: bool = False
    seed: int = 1
    min_iterations: int = 100
    max_iterations: int = 1000
    unsuccess_iteration: int = 100
    fixed_iterations: int | None = None


@dataclasses.dataclass
class SearchResult:
    best_tree: Tree
    best_logL: float
    n_iterations: int
    candidates: CandidateSet


class TreeSearch:
    def __init__(self, eng: LikelihoodEngine, aln: Alignment,
                 params: SearchParams | None = None,
                 ufboot=None, log=None, ckp=None, constraint=None):
        self.eng = eng
        self.aln = aln
        self.params = params or SearchParams()
        self.rng = np.random.default_rng(self.params.seed)
        self.cands = CandidateSet(max_size=self.params.n_nni_trees,
                                  max_top=self.params.pop_size)
        self.ufboot = ufboot  # optional UFBoot collector
        self.log = log or (lambda s: None)
        self.ckp = ckp        # optional Checkpoint (mid-search resume)
        self.constraint = constraint   # optional TopologyConstraint (-g)
        self._resume_iter = 0
        # lockstep candidate batching (plain LikelihoodEngine only:
        # mixlen subclasses carry per-class length state and partition
        # engines their own batching — both fall back to serial), as
        # many trees as the device memory holds
        import os
        k = (int(os.environ.get("IQTREE2_TPU_SEARCH_BATCH", "8"))
             if type(eng) is LikelihoodEngine else 1)
        self.batch_iterations = eng.batch_limit(k) if k > 1 else 1
        if self.batch_iterations < k:
            self.log(f"Lockstep search batch cut from {k} to "
                     f"{self.batch_iterations} trees to fit device memory")

    # ----------------------------------------------------------- checkpoint
    def _save_ckp(self, it: int, stop: "StopRule") -> None:
        """Persist the full search state so a killed run resumes exactly
        (reference: doTreeSearch checkpoint guards, tree/iqtree.cpp:2221,
        2394). RNG bit-generator state makes the resumed run byte-identical
        to an uninterrupted one."""
        if self.ckp is None:
            return
        c = self.ckp
        c.put("search.iteration", it)
        c.put("search.last_improved", stop.last_improved)
        c.put("search.rng", self.rng.bit_generator.state)
        c.put("search.candidates",
              [[it_.tree.to_newick(digits=17), it_.logL]
               for it_ in self.cands.items])
        if self.ufboot is not None:
            c.put("search.ufboot", self.ufboot.state_dict())
        c.dump()

    def _load_ckp(self, stop: "StopRule") -> bool:
        c = self.ckp
        if c is None or c.get("search.iteration") is None:
            return False
        from iqtree2_tpu.tree.topology import Tree as _Tree
        self._resume_iter = int(c.get("search.iteration"))
        stop.last_improved = int(c.get("search.last_improved", 0))
        self.rng.bit_generator.state = c.get("search.rng")
        self.cands = CandidateSet(max_size=self.params.n_nni_trees,
                                  max_top=self.params.pop_size)
        for nwk, logL in c.get("search.candidates", []):
            self.cands.update(_Tree.from_newick(nwk, self.aln.names),
                              float(logL))
        if self.ufboot is not None and c.get("search.ufboot") is not None:
            self.ufboot.load_state_dict(c.get("search.ufboot"))
        self.log(f"Resumed search from checkpoint at iteration "
                 f"{self._resume_iter} (best logL "
                 f"{self.cands.best_score():.4f})")
        return True

    # ------------------------------------------------------------ init set
    def init_candidates(self) -> None:
        p = self.params
        self.log(f"Generating {p.n_init_trees} parsimony start trees...")
        masks = state_bitmasks(self.aln)
        w = self.aln.pattern_weights
        scored: list[tuple[float, Tree]] = []
        seen: set[str] = set()
        for i in range(p.n_init_trees):
            t = random_stepwise_addition(self.aln, self.rng,
                                         constraint=self.constraint)
            tid = t.topology_id()
            if tid in seen:
                continue
            seen.add(tid)
            scored.append((fitch_score(t, masks, w), t))
        # BIONJ tree from ML (or JC) distances
        try:
            D = ml_distances(self.aln, self.eng.model, dtype=self.eng.dtype)
        except Exception:
            D = hamming_jc_distances(self.aln)
        tb = bionj_tree(D, self.aln.names)
        tb.clamp_blens(1e-6, 10.0)
        if self.constraint is None or self.constraint.compatible(tb):
            scored.append((fitch_score(tb, masks, w), tb))
        scored.sort(key=lambda x: x[0])

        # quick branch optimization on the best parsimony trees
        top = scored[: max(p.n_nni_trees, 1)]
        self.log(f"Optimizing {len(top)} best start trees...")
        if self.batch_iterations > 1 and len(top) > 1:
            ts = [t for _, t in top]
            logLs = self.eng.optimize_branches_batch(ts, n_rounds=4)
            for t, logL in zip(ts, logLs):
                self._save_tree(t, logL)
                self.cands.update(t, logL)
        else:
            for _, t in top:
                logL = self.eng.optimize_branches(t, n_rounds=4)
                self._save_tree(t, logL)
                self.cands.update(t, logL)
        # NNI-polish the best few into proper local optima
        polish = [it.tree.copy()
                  for it in list(self.cands.items[: p.pop_size])]
        K = self.batch_iterations
        for group in (polish[i:i + K] for i in range(0, len(polish), K)):
            if len(group) > 1:
                from iqtree2_tpu.search.nni import nni_optimize_batch
                outs = nni_optimize_batch(
                    self.eng, group,
                    loglh_epsilon=self.params.loglh_epsilon,
                    constraint=self.constraint,
                    want_lp=self.ufboot is not None)
            else:
                outs = [self._nni_opt(group[0])]
            for t, (res, lp) in zip(group, outs):
                self._save_tree(t, res.logL, lp)
                self.cands.update(t, res.logL)
        self.log(f"Initial best logL: {self.cands.best_score():.4f}")

    # ---------------------------------------------------------- main loop
    def run(self) -> SearchResult:
        p = self.params
        stop = StopRule(
            min_iterations=p.min_iterations,
            max_iterations=p.max_iterations,
            unsuccess_iteration=p.unsuccess_iteration,
            fixed_iterations=p.fixed_iterations,
            use_correlation=self.ufboot is not None)
        resumed = self._load_ckp(stop)
        if not resumed and len(self.cands) == 0:
            self.init_candidates()
            self._save_ckp(0, stop)
        it = self._resume_iter
        # batched iterations: K perturbed candidates hill-climb in
        # lockstep, one fused dispatch per NNI round for ALL of them
        # (engine._opt_nni_flat_batch_jit), so K iterations cost one
        # dispatch and one fetch per round. Reference analog: the MPI-rank-parallel candidate iterations
        # of doTreeSearch (tree/iqtree.cpp:2196).
        K = self.batch_iterations
        stopping = False
        while not stopping:
            # never let a potential stop land mid-batch: the RNG draw
            # sequence must match the serial schedule for checkpoint
            # resume to be bit-identical
            ufstep = (self.ufboot.step_iterations
                      if self.ufboot is not None else None)
            # align blocks to the absolute K-grid and never cross the
            # earliest potential stop: checkpoints land exactly on block
            # boundaries, making the K-block the atomic resume unit
            kk = max(1, min(K - (it % K), stop.earliest_stop(ufstep) - it))
            trees = []
            for _ in range(kk):
                cand = self.cands.random_top(self.rng)
                t = cand.tree.copy()
                if p.use_iqp and self.constraint is None:
                    iqp_perturb(t, self.aln, self.rng)
                else:
                    random_nnis(t, self.rng, p.pertub_strength,
                                constraint=self.constraint)
                trees.append(t)
            if kk == 1:
                res0, lp0 = self._nni_opt(trees[0])
                outs = [(res0, lp0)]
            else:
                from iqtree2_tpu.search.nni import nni_optimize_batch
                outs = nni_optimize_batch(
                    self.eng, trees,
                    loglh_epsilon=p.loglh_epsilon,
                    constraint=self.constraint,
                    want_lp=self.ufboot is not None)
            for t, (res, lp) in zip(trees, outs):
                it += 1
                self._save_tree(t, res.logL, lp)
                improved = (res.logL
                            > self.cands.best_score() + p.loglh_epsilon)
                self.cands.update(t, res.logL)
                if improved:
                    stop.note_improvement(it)
                    self.log(f"BETTER TREE FOUND at iteration {it}: "
                             f"{res.logL:.4f}")
                corr_done = None
                if self.ufboot is not None and \
                        it % self.ufboot.step_iterations == 0:
                    corr_done = self.ufboot.check_convergence()
                if stop.should_stop(it, corr_done):
                    stopping = True
                    break
            self._save_ckp(it, stop)
        best = self.cands.best()
        return SearchResult(best_tree=best.tree.copy(),
                            best_logL=best.logL, n_iterations=it,
                            candidates=self.cands)

    # ------------------------------------------------------------- helpers
    def _nni_opt(self, t: Tree):
        """NNI hill-climb; with UFBoot active the final tree's site
        log-likelihoods ride the same fused dispatch (want_lp)."""
        want_lp = self.ufboot is not None
        out = nni_optimize(self.eng, t, loglh_epsilon=self.params.loglh_epsilon,
                           constraint=self.constraint, want_lp=want_lp)
        if want_lp:
            return out
        return out, None

    def _save_tree(self, tree: Tree, logL: float, lp=None) -> None:
        """Hook every optimized tree into UFBoot RELL scoring
        (reference analog: saveCurrentTree, tree/iqtree.cpp:3553)."""
        if self.ufboot is not None:
            if logL < self.ufboot.logl_cutoff:
                self.ufboot.n_pruned += 1
                return
            if lp is None:
                _, lp = self.eng.site_lp(tree)
            self.ufboot.add_tree(tree, lp, tree_logL=logL)
