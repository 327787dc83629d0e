"""Site-specific-frequency likelihood kernels (PMSF pass 2 / ModelSet).

Every pattern p owns its own reversible eigensystem (lam[p], U[p], V[p])
built from shared exchangeabilities and per-site stationary frequencies.
The pruning contraction is therefore TWO pattern-batched small matmuls per
edge (into and out of the per-pattern eigenbasis) instead of one shared
one; rate categories stay a broadcast axis.

Reference analog: the site-specific-model kernel family
(tree/phylokernelsitemodel.h — "one eigensystem per site"), used by PMSF
(main/phyloanalysis.cpp:3744 computeSiteFrequencyModel) and ModelSet.

All math float32-safe through the same per-pattern rescale discipline as
ops/pruning.py; functions are jit-pure with static shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from iqtree2_tpu.ops import pruning

HI = jax.lax.Precision.HIGHEST


def build_ssf_eigensystems(exch: np.ndarray, site_freqs: np.ndarray,
                           min_freq: float = 1e-4):
    """Per-pattern eigensystems from shared exchangeabilities.

    exch: [S, S] symmetric exchangeability matrix (zero diagonal);
    site_freqs: [P, S]. Returns (lam [P, S], U [P, S, S], V [P, S, S]),
    float64, each Q normalized to mean rate 1 under its own frequencies
    (reference: ModelMarkov::decomposeRateMatrix per site class).
    """
    f = np.maximum(site_freqs, min_freq)
    f = f / f.sum(axis=1, keepdims=True)            # [P, S]
    S = exch.shape[0]
    Q = exch[None, :, :] * f[:, None, :]            # [P, S, S] off-diag
    Q[:, np.arange(S), np.arange(S)] = 0.0
    rowsum = Q.sum(axis=2)
    Q[:, np.arange(S), np.arange(S)] = -rowsum
    mu = np.einsum("ps,ps->p", f, rowsum)           # mean rate
    Q = Q / np.maximum(mu, 1e-12)[:, None, None]
    # symmetrize: B = D^{1/2} Q D^{-1/2} (D = diag(f)); eigh
    sq = np.sqrt(f)
    B = Q * (sq[:, :, None] / sq[:, None, :])
    B = 0.5 * (B + np.swapaxes(B, 1, 2))
    lam, W = np.linalg.eigh(B)                      # [P, S], [P, S, S]
    U = W / sq[:, :, None]                          # rows x, cols k
    V = np.swapaxes(W, 1, 2) * sq[:, None, :]       # V = W^T D^{1/2}
    return lam, U, V, f


class SSFPack(NamedTuple):
    lam: jax.Array          # [Pp, S]
    U: jax.Array            # [Pp, S, S]
    V: jax.Array            # [Pp, S, S]
    freqs: jax.Array        # [Pp, S]
    cat_rate: jax.Array     # [C]
    cat_weight: jax.Array   # [C]
    log_ptn_invar: jax.Array  # [Pp]


def _msg(Pk: SSFPack, child, t):
    """Per-pattern eigenbasis message: U diag(e^{lam r_c t}) V child.

    child: [..., C, S, Pp]; t: [...] matching leading axes.
    """
    b = jnp.einsum("pks,...csp->...ckp", Pk.V, child, precision=HI)
    expo = jnp.exp(Pk.lam.T[None, :, :] * Pk.cat_rate[:, None, None]
                   * t[..., None, None, None])      # [..., C, K, Pp]
    b = b * expo
    return jnp.einsum("pxk,...ckp->...cxp", Pk.U, b, precision=HI)


def _msg_T(Pk: SSFPack, out, t):
    """Transpose-direction message: V^T diag(e) U^T out (for the up pass)."""
    b = jnp.einsum("pxk,...cxp->...ckp", Pk.U, out, precision=HI)
    expo = jnp.exp(Pk.lam.T[None, :, :] * Pk.cat_rate[:, None, None]
                   * t[..., None, None, None])
    b = b * expo
    return jnp.einsum("pks,...ckp->...csp", Pk.V, b, precision=HI)


def ssf_down_pass(blens, tipP, sched, Pk: SSFPack):
    """Level-batched post-order sweep (mirror of pruning.down_pass)."""
    dtype = tipP.dtype
    thresh, rescale, _ = pruning.scaling_consts(dtype)
    child_src = sched["child_src"]
    child_edge = sched["child_edge"]
    step_node = sched["step_node"]
    n_int = child_src.shape[0]
    C = Pk.cat_rate.shape[0]
    L, S, Pp = tipP.shape

    ALL0 = jnp.zeros((L + n_int, C, S, Pp), dtype)
    ALL0 = ALL0.at[:L].set(jnp.broadcast_to(tipP[:, None], (L, C, S, Pp)))
    SC0 = jnp.zeros((L + n_int, Pp), jnp.int32)

    def body(carry, nid):
        ALL, SC = carry
        nid_c = jnp.minimum(nid, n_int - 1)
        src_idx = child_src[nid_c]
        eids = child_edge[nid_c]
        src = ALL[src_idx]                          # [G, 2, C, S, Pp]
        t = blens[eids]                             # [G, 2]
        msg = _msg(Pk, src, t)
        prod = msg[:, 0] * msg[:, 1]
        sc = SC[src_idx[:, 0]] + SC[src_idx[:, 1]]
        mx = prod.max(axis=(1, 2))
        need = mx < thresh
        prod = prod * jnp.where(need, rescale,
                                1.0).astype(dtype)[:, None, None]
        sc = sc + need.astype(jnp.int32)
        out_idx = jnp.where(nid < n_int, L + nid, L + n_int)
        ALL = ALL.at[out_idx].set(prod, mode="drop")
        SC = SC.at[out_idx].set(sc, mode="drop")
        return (ALL, SC), None

    (ALL, SC), _ = jax.lax.scan(body, (ALL0, SC0), step_node)
    return pruning.DownPass(ALL, SC)


def ssf_up_pass(blens, dp, tipP, sched, Pk: SSFPack):
    """Pre-order outside partials (mirror of pruning.up_pass)."""
    dtype = dp.all.dtype
    thresh, rescale, _ = pruning.scaling_consts(dtype)
    child_src = sched["child_src"]
    child_edge = sched["child_edge"]
    step_node = sched["step_node"]
    n_int = child_src.shape[0]
    C = Pk.cat_rate.shape[0]
    L, S, Pp = tipP.shape
    n_edges = blens.shape[0]
    rootf = jnp.broadcast_to(Pk.freqs.T[None], (C, S, Pp))

    UP0 = jnp.zeros((n_int, C, S, Pp), dtype)
    UPS0 = jnp.zeros((n_int, Pp), jnp.int32)
    m0 = _msg(Pk, tipP[0][None, None], blens[0][None])[0]   # [C, S, Pp]
    UP0 = UP0.at[n_int - 1].set(rootf * m0)
    E0 = jnp.zeros((n_edges, C, S, Pp), dtype)
    ES0 = jnp.zeros((n_edges, Pp), jnp.int32)
    E0 = E0.at[0].set(rootf * dp.all[L + n_int - 1])
    ES0 = ES0.at[0].set(dp.scale[L + n_int - 1])

    def body(carry, nid):
        UP, UPS, E, ES = carry
        nid_c = jnp.minimum(nid, n_int - 1)
        src_idx = child_src[nid_c]
        eids = child_edge[nid_c]
        src = dp.all[src_idx]
        t = blens[eids]
        msg = _msg(Pk, src, t)
        msc = dp.scale[src_idx]
        up = UP[nid_c]
        ups = UPS[nid_c]
        Es = up[:, None] * msg[:, ::-1]
        Esc = ups[:, None] + msc[:, ::-1]
        mx = Es.max(axis=(2, 3))
        need = mx < thresh
        Es = Es * jnp.where(need, rescale,
                            1.0).astype(dtype)[:, :, None, None]
        Esc = Esc + need.astype(jnp.int32)
        ok = nid < n_int
        e_idx = jnp.where(ok[:, None], eids, n_edges)
        E = E.at[e_idx].set(Es, mode="drop")
        ES = ES.at[e_idx].set(Esc, mode="drop")
        up_child = _msg_T(Pk, Es, t)
        mx2 = up_child.max(axis=(2, 3))
        need2 = mx2 < thresh
        up_child = up_child * jnp.where(need2, rescale,
                                        1.0).astype(dtype)[:, :, None, None]
        sc2 = Esc + need2.astype(jnp.int32)
        is_int = ok[:, None] & (src_idx >= L)
        c_idx = jnp.where(is_int, src_idx - L, n_int)
        UP = UP.at[c_idx].set(up_child, mode="drop")
        UPS = UPS.at[c_idx].set(sc2, mode="drop")
        return (UP, UPS, E, ES), None

    (UP, UPS, E, ES), _ = jax.lax.scan(body, (UP0, UPS0, E0, ES0),
                                       step_node[::-1])
    return pruning.UpPass(E, ES, UP, UPS)


def ssf_root_loglik(dp, blens, tipP, Pk: SSFPack, pattern_weights,
                    n_int: int, axis_name=None):
    dtype = dp.all.dtype
    _, _, log_rescale = pruning.scaling_consts(dtype)
    L = tipP.shape[0]
    m0 = _msg(Pk, tipP[0][None, None], blens[0][None])[0]   # [C, S, Pp]
    Broot = dp.all[L + n_int - 1] * m0
    SCroot = dp.scale[L + n_int - 1]
    w = Pk.cat_weight
    site = jnp.einsum("c,px,cxp->p", w, Pk.freqs, Broot, precision=HI)
    tiny = jnp.finfo(dtype).tiny
    lp = jnp.log(jnp.maximum(site, tiny)) \
        - SCroot.astype(dtype) * jnp.asarray(log_rescale, dtype)
    lp = jnp.logaddexp(lp, Pk.log_ptn_invar)
    return pruning.finalize_loglik(lp, pattern_weights,
                                   axis_name=axis_name)


def ssf_tree_loglik(blens, tipP, sched, Pk: SSFPack, pattern_weights,
                    axis_name=None):
    dp = ssf_down_pass(blens, tipP, sched, Pk)
    n_int = sched["child_src"].shape[0]
    return ssf_root_loglik(dp, blens, tipP, Pk, pattern_weights, n_int,
                           axis_name=axis_name)


def ssf_edge_thetas(up, dp, edge_src, Pk: SSFPack):
    """theta_e(c,k,p) = (E_e U_p)_k (V_p D_e)_k per pattern eigenbasis."""
    down = dp.all[edge_src]
    a = jnp.einsum("pxk,ecxp->eckp", Pk.U, up.edge_E, precision=HI)
    b = jnp.einsum("pks,ecsp->eckp", Pk.V, down, precision=HI)
    return pruning.Thetas(a * b, up.edge_E_scale + dp.scale[edge_src])


def ssf_branch_lh_derivs(theta, scale, t, Pk: SSFPack, pattern_weights,
                         order: int = 2):
    """Branch logL/d1/d2 from a per-pattern-eigenbasis theta buffer."""
    dtype = theta.dtype
    _, _, log_rescale = pruning.scaling_consts(dtype)
    lr = Pk.lam.T[None] * Pk.cat_rate[:, None, None]   # [C, K, Pp]
    w = Pk.cat_weight[:, None, None]
    et = jnp.exp(lr * t) * w
    site0 = jnp.maximum(jnp.sum(theta * et, axis=(0, 1)), 0.0)
    sc = scale.astype(dtype) * jnp.asarray(log_rescale, dtype)
    tiny = jnp.finfo(dtype).tiny
    lp = jnp.log(jnp.maximum(site0, tiny)) - sc
    lp = jnp.logaddexp(lp, Pk.log_ptn_invar)
    logL = jnp.sum(pattern_weights * lp)
    if order == 0:
        return logL, None, None
    site1 = jnp.sum(theta * et * lr, axis=(0, 1))
    site2 = jnp.sum(theta * et * lr * lr, axis=(0, 1))
    inv_scaled = jnp.exp(Pk.log_ptn_invar + sc)
    denom = site0 + inv_scaled
    d1p = site1 / denom
    d2p = site2 / denom - d1p * d1p
    return (logL, jnp.sum(pattern_weights * d1p),
            jnp.sum(pattern_weights * d2p))


def ssf_evaluate_nnis(cand_arrays, blens, dp, up, sched, Pk: SSFPack,
                      pattern_weights, t_min, t_max, n_newton: int = 4):
    """Batched NNI1 evaluation under the site-specific model (mirror of
    ops/nni.evaluate_nnis; central branch re-optimized)."""
    iu, iv, slot_c, eid = cand_arrays
    child_src = sched["child_src"]
    child_edge = sched["child_edge"]

    def one(iu_, iv_, sc__, eid_):
        def gmsg(src_i, e_i):
            return (_msg(Pk, dp.all[src_i][None], blens[e_i][None])[0],
                    dp.scale[src_i])

        m_a, s_a = gmsg(child_src[iu_, 0], child_edge[iu_, 0])
        m_b, s_b = gmsg(child_src[iu_, 1], child_edge[iu_, 1])
        m_c, s_c = gmsg(child_src[iv_, sc__], child_edge[iv_, sc__])
        rest = up.up_in[iv_]
        s_rest = up.up_scale[iv_]
        t0 = blens[eid_]

        def score(down, s_down, out, s_out):
            a = jnp.einsum("pxk,cxp->ckp", Pk.U, out, precision=HI)
            b = jnp.einsum("pks,csp->ckp", Pk.V, down, precision=HI)
            theta = a * b
            scale = s_down + s_out
            t_opt = ssf_newton_branch_step(theta, scale, t0, Pk,
                                           pattern_weights, t_min, t_max,
                                           n_iter=n_newton)
            logl, _, _ = ssf_branch_lh_derivs(theta, scale, t_opt, Pk,
                                              pattern_weights, order=0)
            return logl, t_opt

        l0, tt0 = score(m_a * m_c, s_a + s_c, rest * m_b, s_rest + s_b)
        l1, tt1 = score(m_b * m_c, s_b + s_c, rest * m_a, s_rest + s_a)
        l2, tt2 = score(m_a * m_b, s_a + s_b, rest * m_c, s_rest + s_c)
        return jnp.stack([l0, l1, l2]), jnp.stack([tt0, tt1, tt2])

    return jax.vmap(one)(iu, iv, slot_c, eid)


def ssf_newton_branch_step(theta, scale, t0, Pk: SSFPack, pattern_weights,
                           t_min, t_max, n_iter: int = 4):
    def one(i, t):
        _, d1, d2 = ssf_branch_lh_derivs(theta, scale, t, Pk,
                                         pattern_weights)
        newton_t = t - d1 / d2
        bad = (d2 >= 0) | ~jnp.isfinite(newton_t)
        fallback = jnp.where(d1 > 0, jnp.minimum(t * 4.0, t_max),
                             jnp.maximum(t * 0.25, t_min))
        return jnp.where(bad, fallback, jnp.clip(newton_t, t_min, t_max))
    return jax.lax.fori_loop(0, n_iter, one, t0)
