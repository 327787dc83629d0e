"""Batched NNI candidate evaluation on-chip.

For every internal edge e=(u child, v parent) the two NNI rearrangements are
scored *simultaneously for all edges* from the down-pass partials and
up-pass outside partials — no per-candidate tree traversal:

  around e the four subtrees are (a, b | c, d):  a,b = children of u,
  c = the other child of v, d = rest (everything above v — the up-pass
  outside partial, which already folds in the root frequencies and the
  leaf-0 message when v is the root).
  variant 0 swaps b<->c:  down' = m_a * m_c ; out' = rest * m_b
  variant 1 swaps a<->c:  down' = m_b * m_c ; out' = rest * m_a
  theta' = (out' U) (V down') ; central branch re-optimized by Newton.

Child messages m_* are recomputed from the unified partial buffer
(one gather + small contraction each — they are no longer stored).

This is the NNI1 evaluation mode (re-optimize the central branch only);
reference analog: getBestNNIForBran (tree/phylotree.cpp:4058). The CPU
reference evaluates candidates one at a time; here they are one batch
axis (SURVEY §7 step 3).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from iqtree2_tpu.ops import pruning
from iqtree2_tpu.tree.schedule import TreeSchedule
from iqtree2_tpu.tree.topology import Tree


class NNICandidates(NamedTuple):
    """Host-built index arrays, one row per internal edge."""
    iu: np.ndarray        # [n] postorder idx of child node u
    iv: np.ndarray        # [n] postorder idx of parent node v
    slot_c: np.ndarray    # [n] slot of the sibling c at v (u is 1-slot_c)
    edge_id: np.ndarray   # [n] central edge id
    # host bookkeeping for applying moves
    nodes_u: list
    nodes_v: list


def build_nni_candidates(tree: Tree, sched: TreeSchedule) -> NNICandidates:
    L = sched.ntaxa
    order_idx = {v: i for i, v in enumerate(sched.postorder_nodes)}
    rows = []
    nodes_u, nodes_v = [], []
    for e, pair in enumerate(sched.edge_nodes):
        if pair is None:
            continue
        u, v = pair
        if tree.is_leaf(u) or tree.is_leaf(v):
            continue
        iu = e - L  # internal node u owns edge L + postorder(u)
        iv = order_idx[v]
        k_u = 0 if int(sched.child_edge[iv, 0]) == e else 1
        rows.append((iu, iv, 1 - k_u, e))
        nodes_u.append(u)
        nodes_v.append(v)
    if not rows:
        z = np.zeros(0, np.int32)
        return NNICandidates(z, z, z, z, [], [])
    arr = np.asarray(rows, dtype=np.int32)
    return NNICandidates(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3],
                         nodes_u, nodes_v)


@functools.partial(jax.jit, static_argnames=("n_newton", "return_site_lp",
                                             "nonrev", "axis_name",
                                             "mixlen"))
def evaluate_nnis(cand_arrays, blens, dp: pruning.DownPass, up_in, up_scale,
                  sched, pack, pattern_weights, t_min, t_max,
                  n_newton: int = 4, return_site_lp: bool = False,
                  nonrev: bool = False, axis_name: str | None = None,
                  mixlen: bool = False):
    """Score both NNI variants (and the no-swap baseline) for all candidate
    edges at once. Returns (logl [n,3], t_opt [n,3]) where column 2 is the
    re-optimized current topology (baseline). With return_site_lp, also
    returns per-pattern log-likelihoods [n, 3, Ppat] (for SH-aLRT RELL)."""
    iu, iv, slot_c, eid = _cand_rows(cand_arrays)
    log_ptn_invar = pack["log_ptn_invar"]
    child_src = sched["child_src"]
    child_edge = sched["child_edge"]
    P = pruning.transition_tensors(blens.astype(dp.all.dtype), pack)

    def one(iu_, iv_, sc__, eid_):
        m_a, s_a = pruning.gather_messages(dp, P, child_src[iu_, 0],
                                           child_edge[iu_, 0])
        m_b, s_b = pruning.gather_messages(dp, P, child_src[iu_, 1],
                                           child_edge[iu_, 1])
        m_c, s_c = pruning.gather_messages(dp, P, child_src[iv_, sc__],
                                           child_edge[iv_, sc__])
        rest = up_in[iv_]
        s_rest = up_scale[iv_]
        t0 = blens[eid_]

        Uc = pack["U"][pack["cat_mix"]]
        Vc = pack["V"][pack["cat_mix"]]

        def score_nonrev(down, s_down, out, s_out):
            scale = s_down + s_out
            t_opt = pruning.newton_branch_step_nonrev(
                down, out, scale, t0, pack, log_ptn_invar, pattern_weights,
                t_min, t_max, n_iter=n_newton)
            logl, _, _ = pruning.branch_lh_derivs_nonrev(
                down, out, scale, t_opt, pack, log_ptn_invar,
                pattern_weights, order=0)
            lp = jnp.zeros((0,), down.dtype)
            return logl, t_opt, lp

        def score(down, s_down, out, s_out):
            if nonrev:
                return score_nonrev(down, s_down, out, s_out)
            theta = pruning.apply_PT(Uc, out) * pruning.apply_P(Vc, down)
            scale = s_down + s_out
            if mixlen:
                # per-class central-branch Newton (+H search: reference
                # overrides optimizeOneBranch with the mixlen Newton,
                # tree/phylotreemixlen.cpp:338)
                t_opt = pruning.newton_branch_step_mixlen(
                    theta, scale, t0, pack, log_ptn_invar,
                    pattern_weights, t_min, t_max, n_iter=n_newton)
                logl, _, _ = pruning.branch_lh_derivs_mixlen(
                    theta, scale, t_opt, pack, log_ptn_invar,
                    pattern_weights)
                lp = jnp.zeros((0,), theta.dtype)
                return logl, t_opt, lp
            t_opt = pruning.newton_branch_step(
                theta, scale, t0, pack, log_ptn_invar, pattern_weights,
                t_min, t_max, n_iter=n_newton, axis_name=axis_name)
            logl, _, _ = pruning.branch_lh_derivs(
                theta, scale, t_opt, pack, log_ptn_invar, pattern_weights,
                order=0, axis_name=axis_name)
            if return_site_lp:
                lp = pruning.branch_site_lp(theta, scale, t_opt, pack,
                                            log_ptn_invar)
            else:
                lp = jnp.zeros((0,), theta.dtype)
            return logl, t_opt, lp

        l0, tt0, p0 = score(m_a * m_c, s_a + s_c, rest * m_b, s_rest + s_b)
        l1, tt1, p1 = score(m_b * m_c, s_b + s_c, rest * m_a, s_rest + s_a)
        l2, tt2, p2 = score(m_a * m_b, s_a + s_b, rest * m_c, s_rest + s_c)
        out = (jnp.stack([l0, l1, l2]), jnp.stack([tt0, tt1, tt2]))
        if return_site_lp:
            return out + (jnp.stack([p0, p1, p2]),)
        return out

    return jax.vmap(one)(iu, iv, slot_c, eid)


def _cand_rows(cand_arrays):
    """Accept either the 4-tuple (iu, iv, slot_c, eid) or ONE stacked
    [4, n] int32 array (a single host->device upload)."""
    if isinstance(cand_arrays, (tuple, list)):
        return cand_arrays
    return (cand_arrays[0], cand_arrays[1], cand_arrays[2],
            cand_arrays[3])


def _transition_one(t, pack):
    """P(t) [C, S, S] for one scalar branch length."""
    return pruning.transition_tensors(t[None], pack)[0]


def _theta(out, down, Uc, Vc):
    return pruning.apply_PT(Uc, out) * pruning.apply_P(Vc, down)


@functools.partial(jax.jit, static_argnames=("n_rounds", "n_newton",
                                             "return_site_lp", "nonrev",
                                             "mixlen", "cand_chunk"))
def evaluate_nnis5(cand_arrays, blens, dp: pruning.DownPass, up,
                   sched, pack, pattern_weights, t_min, t_max,
                   n_rounds: int = 2, n_newton: int = 2,
                   return_site_lp: bool = False, nonrev: bool = False,
                   mixlen: bool = False, cand_chunk: int | None = None):
    """NNI5 evaluation: for every candidate edge, score both NNI variants
    and the baseline with ALL FIVE surrounding branch lengths re-optimized
    by coordinate Newton rounds (reference: getBestNNIForBran NNI5 mode,
    tree/phylotree.cpp:4058; params.nni5 default true).

    Returns (logl [n, 3], t_e [n, 3], t5 [n, 3, 5]) where t5 columns are
    the optimized lengths of (a, b, c, d, e): a,b = u's child edges,
    c = v's other child edge, d = v's parent edge (kept fixed when v is
    the schedule root), e = central. With return_site_lp also per-pattern
    logLs [n, 3, Ppat].

    nonrev=True applies the same five-branch coordinate Newton with the
    direct (down, out) bilinear derivatives through dP/dt = Q P instead of
    the eigenbasis theta trick (round-3 VERDICT Weak #8: the reference
    applies NNI5 universally, tree/phylotree.cpp:4058).

    cand_chunk bounds device memory: candidates are scored cand_chunk at
    a time in a sequential loop instead of all at once, so the working
    set is cand_chunk (not n) times 3 variants of [C, S, Ppat] partials.
    """
    iu, iv, slot_c, eid = _cand_rows(cand_arrays)
    log_ptn_invar = pack["log_ptn_invar"]
    child_src = sched["child_src"]
    child_edge = sched["child_edge"]
    n_int = child_src.shape[0]
    if not nonrev:
        Uc = pack["U"][pack["cat_mix"]]
        Vc = pack["V"][pack["cat_mix"]]
    dtype = dp.all.dtype
    thresh, rescale, _ = pruning.scaling_consts(dtype)

    def resc(x, sc):
        mx = x.max(axis=(0, 1))
        need = mx < thresh
        x = x * jnp.where(need, rescale, 1.0).astype(dtype)
        return x, sc + need.astype(jnp.int32)

    def one(iu_, iv_, sc__, eid_):
        ea = child_edge[iu_, 0]
        eb = child_edge[iu_, 1]
        ec = child_edge[iv_, sc__]
        L = dp.all.shape[0] - n_int
        p_a, s_a = dp.all[child_src[iu_, 0]], dp.scale[child_src[iu_, 0]]
        p_b, s_b = dp.all[child_src[iu_, 1]], dp.scale[child_src[iu_, 1]]
        p_c, s_c = dp.all[child_src[iv_, sc__]], dp.scale[child_src[iv_, sc__]]
        is_root = iv_ == n_int - 1
        ed = jnp.where(is_root, 0, L + iv_)     # v's parent edge id
        E_d = up.edge_E[ed]
        s_Ed = up.edge_E_scale[ed]
        # for the root, the fixed outside at v (up_in) replaces P_d^T E_d
        out_root = up.up_in[iv_]
        s_out_root = up.up_scale[iv_]

        t0 = jnp.stack([blens[ea], blens[eb], blens[ec], blens[ed],
                        blens[eid_]])

        def newton(out, down, sc, t):
            if nonrev:
                return pruning.newton_branch_step_nonrev(
                    down, out, sc, t, pack, log_ptn_invar,
                    pattern_weights, t_min, t_max, n_iter=n_newton)
            if mixlen:
                return pruning.newton_branch_step_mixlen(
                    _theta(out, down, Uc, Vc), sc, t, pack,
                    log_ptn_invar, pattern_weights, t_min, t_max,
                    n_iter=n_newton)
            return pruning.newton_branch_step(
                _theta(out, down, Uc, Vc), sc, t, pack, log_ptn_invar,
                pattern_weights, t_min, t_max, n_iter=n_newton)

        def score_variant(px1, sx1, px2, sx2, px3, sx3, idx1, idx2, idx3):
            """u' children = (x1, x2); v' children = (u', x3).

            idx* map the variant's branch roles back into t5 slots."""
            def round_body(_, ts):
                ta, tb, tc, td, te = (ts[0], ts[1], ts[2], ts[3], ts[4])
                t1, t2, t3 = ts[idx1], ts[idx2], ts[idx3]
                m1 = pruning.apply_P(_transition_one(t1, pack), px1)
                m2 = pruning.apply_P(_transition_one(t2, pack), px2)
                m3 = pruning.apply_P(_transition_one(t3, pack), px3)
                Pd = _transition_one(td, pack)
                out_v = jnp.where(
                    is_root, out_root,
                    pruning.apply_PT(Pd, E_d))
                s_out = jnp.where(is_root, s_out_root, s_Ed)
                down_u, s_du = resc(m1 * m2, sx1 + sx2)
                out_e, s_oe = resc(out_v * m3, s_out + sx3)
                # central branch
                te = newton(out_e, down_u, s_du + s_oe, te)
                Pe = _transition_one(te, pack)
                m_u = pruning.apply_P(Pe, down_u)
                # x3 branch (v's other child)
                out_3, s_o3 = resc(out_v * m_u, s_out + s_du)
                t3 = newton(out_3, px3, s_o3 + sx3, t3)
                # u-side outside
                out_u = pruning.apply_PT(Pe, out_e)
                o1, s_o1 = resc(out_u * m2, s_oe + sx2)
                t1 = newton(o1, px1, s_o1 + sx1, t1)
                m1 = pruning.apply_P(_transition_one(t1, pack), px1)
                o2, s_o2 = resc(out_u * m1, s_oe + sx1)
                t2 = newton(o2, px2, s_o2 + sx2, t2)
                # d branch (skip at root)
                m2 = pruning.apply_P(_transition_one(t2, pack), px2)
                down_v, s_dv = resc(m_u * m3, s_du + sx3)
                td_new = newton(E_d, down_v, s_dv + s_Ed, td)
                td = jnp.where(is_root, td, td_new)
                ts = ts.at[idx1].set(t1).at[idx2].set(t2).at[idx3].set(t3)
                ts = ts.at[3].set(td).at[4].set(te)
                return ts

            ts = jax.lax.fori_loop(0, n_rounds, round_body, t0)
            # final score at optimized lengths
            t1, t2, t3 = ts[idx1], ts[idx2], ts[idx3]
            m1 = pruning.apply_P(_transition_one(t1, pack), px1)
            m2 = pruning.apply_P(_transition_one(t2, pack), px2)
            m3 = pruning.apply_P(_transition_one(t3, pack), px3)
            Pd = _transition_one(ts[3], pack)
            out_v = jnp.where(
                is_root, out_root,
                pruning.apply_PT(Pd, E_d))
            s_out = jnp.where(is_root, s_out_root, s_Ed)
            down_u, s_du = resc(m1 * m2, sx1 + sx2)
            out_e, s_oe = resc(out_v * m3, s_out + sx3)
            sc = s_du + s_oe
            if nonrev:
                logl, _, _ = pruning.branch_lh_derivs_nonrev(
                    down_u, out_e, sc, ts[4], pack, log_ptn_invar,
                    pattern_weights, order=0)
                if return_site_lp:
                    lp = pruning.branch_site_lp_nonrev(
                        down_u, out_e, sc, ts[4], pack, log_ptn_invar)
                else:
                    lp = jnp.zeros((0,), dtype)
                return logl, ts[4], ts, lp
            theta = _theta(out_e, down_u, Uc, Vc)
            if mixlen:
                logl, _, _ = pruning.branch_lh_derivs_mixlen(
                    theta, sc, ts[4], pack, log_ptn_invar,
                    pattern_weights)
                lp = jnp.zeros((0,), dtype)
                return logl, ts[4], ts, lp
            logl, _, _ = pruning.branch_lh_derivs(
                theta, sc, ts[4], pack, log_ptn_invar, pattern_weights,
                order=0)
            if return_site_lp:
                lp = pruning.branch_site_lp(theta, sc, ts[4], pack,
                                            log_ptn_invar)
            else:
                lp = jnp.zeros((0,), dtype)
            return logl, ts[4], ts, lp

        # The three configurations (variant 0 swaps b<->c, variant 1
        # swaps a<->c, baseline keeps {a,b}) run as ONE vmapped batch
        # axis: unrolling them tripled the sequential op chain of the
        # coordinate-Newton sweep, which is op-latency- (not FLOP-)
        # bound at example.phy scale.
        PX1 = jnp.stack([p_a, p_b, p_a])
        SX1 = jnp.stack([s_a, s_b, s_a])
        PX2 = jnp.stack([p_c, p_c, p_b])
        SX2 = jnp.stack([s_c, s_c, s_b])
        PX3 = jnp.stack([p_b, p_a, p_c])
        SX3 = jnp.stack([s_b, s_a, s_c])
        IDX1 = jnp.asarray([0, 1, 0])
        IDX2 = jnp.asarray([2, 2, 1])
        IDX3 = jnp.asarray([1, 0, 2])
        l, te, ts, lp = jax.vmap(score_variant)(
            PX1, SX1, PX2, SX2, PX3, SX3, IDX1, IDX2, IDX3)
        if return_site_lp:
            return l, te, ts, lp
        return l, te, ts

    n = iu.shape[0]
    if cand_chunk is None or cand_chunk >= n:
        return jax.vmap(one)(iu, iv, slot_c, eid)
    # pad to whole chunks (repeating row 0) so one loop body serves all
    # of them, then drop the padding rows
    pad = -n % cand_chunk
    rows = tuple(jnp.concatenate([r, jnp.broadcast_to(r[:1], (pad,))])
                 for r in (iu, iv, slot_c, eid))
    outs = jax.lax.map(lambda r: one(*r), rows, batch_size=cand_chunk)
    return tuple(o[:n] for o in outs)
