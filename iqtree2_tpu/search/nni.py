"""NNI hill-climbing on the host, scored by batched device evaluation.

Reference analog: IQTree::optimizeNNI (tree/iqtree.cpp:2998) /
evaluateNNIs (:3426): evaluate all candidate NNIs, apply the best
non-conflicting improving subset, re-optimize, repeat until no improvement.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from iqtree2_tpu.engine import LikelihoodEngine
from iqtree2_tpu.ops.nni import build_nni_candidates
from iqtree2_tpu.tree.schedule import build_schedule
from iqtree2_tpu.tree.topology import Tree


@dataclasses.dataclass
class NNIResult:
    logL: float
    n_rounds: int
    n_applied_total: int


def _supports_nni5(eng) -> bool:
    """Engines whose evaluate_nni_batch accepts nni5: LikelihoodEngine
    (reversible + nonreversible packs), MixlenEngine (+H models with
    per-class five-branch Newton — round-4 VERDICT Next #5) and
    PartitionEngine for LINKED partitions (joint five-branch Newton
    across parts — round-4 VERDICT Next #6)."""
    from iqtree2_tpu.engine import LikelihoodEngine
    from iqtree2_tpu.model.heterotachy import MixlenEngine
    from iqtree2_tpu.partition.engine import PartitionEngine
    if type(eng) in (LikelihoodEngine, MixlenEngine):
        return True
    return (type(eng) is PartitionEngine
            and eng.partition_type != "unlinked")


def _slot_node(tree: Tree, sched, i_node: int, slot: int) -> int:
    src = int(sched.child_src[i_node, slot])
    if src < sched.ntaxa:
        return src
    return sched.postorder_nodes[src - sched.ntaxa]


def _apply_best_swaps(tree: Tree, sched, cand, logl, t_opt, t5,
                      loglh_epsilon: float, constraint):
    """Apply the best non-conflicting improving NNI swaps to ``tree``
    (greedy by gain, one move per node — reference applyNNIs,
    tree/iqtree.cpp:3426). Returns (applied, undo) where undo =
    (swap_log, pre-swap blen snapshot, blen_h snapshot)."""
    base = logl[:, 2]
    gains = logl[:, :2] - base[:, None]
    best_var = gains.argmax(axis=1)
    best_gain = gains[np.arange(len(base)), best_var]
    order = np.argsort(-best_gain)
    used_nodes: set[int] = set()
    applied = 0
    swap_log: list[tuple[int, int, int, int]] = []
    undo = (swap_log, dict(tree.blen), dict(tree.blen_h))
    L = sched.ntaxa
    for ci in order:
        if best_gain[ci] <= loglh_epsilon:
            break
        u = cand.nodes_u[ci]
        v = cand.nodes_v[ci]
        if u in used_nodes or v in used_nodes:
            continue
        var = int(best_var[ci])
        # variant 0 swaps child at slot 1 (b) with sibling c;
        # variant 1 swaps child at slot 0 (a) with sibling c
        iu, iv = int(cand.iu[ci]), int(cand.iv[ci])
        a_node = _slot_node(tree, sched, iu, 0)
        b_node = _slot_node(tree, sched, iu, 1)
        moved_slot = 1 if var == 0 else 0
        x = _slot_node(tree, sched, iu, moved_slot)
        c = _slot_node(tree, sched, iv, int(cand.slot_c[ci]))
        tree.swap_subtrees(u, x, v, c)
        if constraint is not None and not constraint.compatible(tree):
            tree.swap_subtrees(u, c, v, x)   # undo: violates -g
            continue
        swap_log.append((u, x, v, c))
        tree.set_blen(u, v, float(t_opt[ci, var]))
        if t5 is None:
            used_nodes.update([u, v])
            applied += 1
            continue
        # apply the 4 outer optimized lengths (post-swap adjacency):
        # the moved child x now hangs off v, c now hangs off u
        tv5 = t5[ci, var]     # (a, b, c, d, e)
        kept = a_node if var == 0 else b_node
        kept_t = float(tv5[0] if var == 0 else tv5[1])
        moved_t = float(tv5[moved_slot])
        tree.set_blen(kept, u, kept_t)
        tree.set_blen(c, u, float(tv5[2]))
        tree.set_blen(x, v, moved_t)
        if iv != sched.n_int - 1:
            vp = sched.edge_nodes[L + iv][1]
            if vp not in used_nodes:
                tree.set_blen(v, vp, float(tv5[3]))
        used_nodes.update([u, v])
        applied += 1
    return applied, undo


def _revert_swaps(tree: Tree, undo) -> None:
    swaps, blen_snap, blen_h_snap = undo
    for (u_, x_, v_, c_) in reversed(swaps):
        tree.swap_subtrees(u_, c_, v_, x_)
    tree.blen = dict(blen_snap)
    tree.blen_h = dict(blen_h_snap)


def nni_optimize_batch(eng: LikelihoodEngine, trees: list,
                       loglh_epsilon: float = 0.001,
                       max_rounds: int = 100,
                       blen_rounds: int = 2,
                       nni5: bool = True,
                       constraint=None,
                       want_lp: bool = False):
    """Lockstep NNI hill-climb of K same-size trees: each round is ONE
    batched fused dispatch (engine.optimize_and_evaluate_nnis_batch), so
    K whole perturb+NNI iterations cost one dispatch and one fetch per
    round instead of K (reference analog: the MPI-rank-parallel
    candidate iterations, tree/iqtree.cpp:2196).

    The batch stays at fixed K every round (stable shapes, no
    recompiles); finished trees keep riding but their results are
    ignored. Mutates trees in place; returns [(NNIResult, lp or None)]
    aligned with ``trees``."""
    K = len(trees)
    st = [dict(logL=None, done=False, undo=None, lp=None, rounds=0,
               applied_total=0, dirty=False) for _ in range(K)]
    for rnd in range(1, max_rounds + 1):
        if all(s["done"] for s in st):
            break
        scheds, cands, cand_arrays = [], [], []
        for k in range(K):
            sched = build_schedule(trees[k])
            cand = build_nni_candidates(trees[k], sched)
            if len(cand.nodes_u) == 0:
                st[k]["done"] = True
            scheds.append(sched)
            cands.append(cand)
            cand_arrays.append(np.stack(
                [cand.iu, cand.iv, cand.slot_c, cand.edge_id]))
        if all(s["done"] for s in st):
            break
        results = eng.optimize_and_evaluate_nnis_batch(
            trees, scheds, cand_arrays, n_rounds=blen_rounds,
            nni5=nni5, want_lp=want_lp)
        for k in range(K):
            s = st[k]
            if s["done"]:
                continue
            s["rounds"] = rnd
            out = results[k]
            if nni5:
                opt_logL, logl, t_opt, t5 = out[:4]
            else:
                opt_logL, logl, t_opt = out[:3]
                t5 = None
            if want_lp:
                s["lp"] = out[-1]
            s["dirty"] = False
            if s["logL"] is not None and opt_logL < s["logL"] - 1e-6 \
                    and s["undo"] is not None:
                _revert_swaps(trees[k], s["undo"])
                s["lp"] = None
                s["done"] = True
                continue
            if s["logL"] is not None and \
                    opt_logL - s["logL"] < loglh_epsilon:
                s["logL"] = max(opt_logL, s["logL"])
                s["done"] = True
                continue
            s["logL"] = opt_logL
            applied, undo = _apply_best_swaps(
                trees[k], scheds[k], cands[k], logl, t_opt, t5,
                loglh_epsilon, constraint)
            s["undo"] = undo
            if applied == 0:
                s["done"] = True
            else:
                s["applied_total"] += applied
                s["dirty"] = True
    # finalize: converge branch lengths properly once at exit (the
    # in-loop rounds use cheap 2-sweep economics) — batched too
    logLs = eng.optimize_branches_batch(trees,
                                        n_rounds=max(blen_rounds, 8))
    for k, lL in enumerate(logLs):
        if st[k]["dirty"] or st[k]["logL"] is None or \
                lL > st[k]["logL"] + 1e-9:
            st[k]["lp"] = None
        st[k]["logL"] = max(lL, st[k]["logL"] or -np.inf)
    out = []
    for k in range(K):
        s = st[k]
        lp = s["lp"]
        if want_lp and lp is None:
            _, lp = eng.site_lp(trees[k])
        out.append((NNIResult(logL=s["logL"], n_rounds=s["rounds"],
                              n_applied_total=s["applied_total"]),
                    lp if want_lp else None))
    return out


def nni_optimize(eng: LikelihoodEngine, tree: Tree,
                 loglh_epsilon: float = 0.001,
                 max_rounds: int = 100,
                 blen_rounds: int = 2,
                 nni5: bool = True,
                 constraint=None,
                 verbose: bool = False,
                 want_lp: bool = False):
    """Hill-climb with NNI moves until no improving move remains.

    nni5=True (the reference default, params.nni5) scores each candidate
    with all five surrounding branches re-optimized and applies those
    lengths on acceptance. Mutates ``tree`` in place; returns the final
    logL.

    On a LikelihoodEngine each round is ONE fused device dispatch
    (branch optimization + NNI scoring + optional site lp — see
    engine._opt_nni_flat_jit). want_lp=True additionally returns the final tree's
    per-pattern log-likelihoods (for UFBoot RELL collection) computed
    in the same dispatch: returns (NNIResult, lp) instead of NNIResult.
    """
    total_applied = 0
    # NNI5 is universal for LikelihoodEngine (reversible via theta,
    # nonreversible via expm derivatives — reference applies it to all
    # models, tree/phylotree.cpp:4058); engines without 5-branch support
    # (partition/mixlen) announce the NNI1 downgrade instead of hiding it
    use5 = nni5 and hasattr(eng, "evaluate_nni_batch")
    # the fused one-dispatch round optimizes SCALAR lengths; engines with
    # their own length semantics (mixlen) opt out via _fused_nni = False
    fused = (hasattr(eng, "optimize_and_evaluate_nnis")
             and getattr(eng, "_fused_nni", True))
    eng._nni_tree = tree    # per-class engines read tree.blen_h
    if use5 and not _supports_nni5(eng):
        use5 = False
        if nni5 and not getattr(eng, "_warned_nni1", False):
            eng._warned_nni1 = True
            print(f"NOTE: {type(eng).__name__} scores NNIs on the central "
                  "branch only (NNI1); five-branch re-optimization is not "
                  "implemented for this engine")
    logL = None if fused else eng.optimize_branches(tree,
                                                    n_rounds=blen_rounds)
    lp = None
    rnd = 0
    applied = 0
    dirty = False        # True iff swaps applied after the last optimize
    undo: list | None = None   # (swaps, blen, blen_h) to revert a
    #                            regressing round (tree and reported logL
    #                            must stay consistent)

    def _revert():
        swaps, blen_snap, blen_h_snap = undo
        for (u_, x_, v_, c_) in reversed(swaps):
            tree.swap_subtrees(u_, c_, v_, x_)
        tree.blen = dict(blen_snap)
        tree.blen_h = dict(blen_h_snap)

    for rnd in range(1, max_rounds + 1):
        sched = build_schedule(tree)
        cand = build_nni_candidates(tree, sched)
        if len(cand.nodes_u) == 0:
            break
        cand_arrays = jnp.asarray(np.stack(
            [cand.iu, cand.iv, cand.slot_c, cand.edge_id]))
        t5 = None
        if fused:
            out = eng.optimize_and_evaluate_nnis(
                tree, sched, cand_arrays, n_rounds=blen_rounds,
                nni5=use5, want_lp=want_lp)
            if use5:
                opt_logL, logl, t_opt, t5 = out[:4]
            else:
                opt_logL, logl, t_opt = out[:3]
            if want_lp:
                lp = out[-1]
            dirty = False
            # convergence: this round's optimized logL is what the
            # unfused flow computed as new_logL at the END of the
            # previous round.  If the previous round's swaps REGRESSED,
            # revert them so the returned tree matches the returned logL.
            if logL is not None and opt_logL < logL - 1e-6 \
                    and undo is not None:
                _revert()
                lp = None
                break
            if logL is not None and opt_logL - logL < loglh_epsilon:
                logL = max(opt_logL, logL)
                break
            logL = opt_logL
        else:
            if use5:
                try:
                    logl, t_opt, t5 = eng.evaluate_nni_batch(
                        sched, cand_arrays, nni5=True)
                except TypeError:       # engines without nni5 support
                    use5 = False
            if t5 is None:
                logl, t_opt = eng.evaluate_nni_batch(sched, cand_arrays)

        applied, undo = _apply_best_swaps(
            tree, sched, cand, logl, t_opt, t5, loglh_epsilon, constraint)
        if applied == 0:
            break
        total_applied += applied
        dirty = True
        if fused:
            if verbose:
                print(f"  [nni] round {rnd}: applied {applied}, "
                      f"logL {logL:.4f}")
            continue      # next round's fused program re-optimizes
        new_logL = eng.optimize_branches(tree, n_rounds=blen_rounds)
        if verbose:
            print(f"  [nni] round {rnd}: applied {applied}, "
                  f"logL {new_logL:.4f}")
        if new_logL < logL - 1e-6:
            # regression: revert this round's swaps and re-optimize so
            # the returned (tree, logL) pair is consistent
            _revert()
            logL = eng.optimize_branches(tree, n_rounds=blen_rounds)
            dirty = False
            break
        if new_logL - logL < loglh_epsilon:
            logL = max(new_logL, logL)
            break
        logL = new_logL
    else:
        rnd = max_rounds
    # final polish: the in-loop rounds use the reference's cheap
    # optimizeAllBranches economics (1-2 sweeps); converge properly once
    # at exit (reference: optimizeAllBranches() after doNNISearch,
    # tree/iqtree.cpp:2640)
    if logL is None:      # fused path with no NNI candidates at all
        logL = eng.optimize_branches(tree, n_rounds=max(blen_rounds, 8))
    else:
        new_logL = eng.optimize_branches(tree,
                                         n_rounds=max(blen_rounds, 8))
        if dirty or new_logL > logL + 1e-9:
            lp = None
        logL = max(new_logL, logL)
    res = NNIResult(logL=logL, n_rounds=rnd,
                    n_applied_total=total_applied)
    if want_lp:
        if lp is None and hasattr(eng, "site_lp"):
            _, lp = eng.site_lp(tree)
        return res, lp
    return res
