"""Felsenstein pruning as batched tensor contractions (the hot path).

Math (reference: tree/phylokernelnew.h computePartialLikelihoodSIMD :1290,
computeLikelihoodBranchSIMD :2643, theta buffer :2050/:3196):

  partial[v](c,x,p) = prod_{children u} sum_y P_e(c,x,y) partial[u](c,y,p)
  P_e(c) = U_m exp(Lambda_m r_c t_e) V_m          (m = mixture class of c)
  site_lh(p) = sum_c w_c sum_x pi_c(x) partial[root](c,x,p)  (+ invariant)
  logL = sum_p freq_p log site_lh(p)

Layout is category/state-major, **pattern-last** ([C, S, Ppat]) so the
pattern axis is the contiguous, vectorized one; the (S x S) contraction per edge
is a small matmul batched over (level-width x 2 children x categories) —
one pruning *step* processes a whole level of independent nodes (see
tree/schedule.py) so XLA sees one large batched contraction per step
instead of one tiny matmul per node. Site patterns are the data-parallel
shard axis.

Partials for leaves and internal nodes live in ONE unified buffer
([L + n_int, C, S, Ppat], tips broadcast over categories) so each step's
inputs are a single gather; the up (pre-order) pass recomputes child
messages from that buffer instead of storing them — O(partials) memory
instead of 4x (reference contrast: one slab carved into per-branch views,
tree/phylotree.cpp:795).

Numerical scaling: partials are kept in [2^-B, 1] by per-pattern rescaling
with 2^B (B=30 for float32, 256 for float64 — reference analog
SCALING_THRESHOLD, tree/phylotree.h:74); integer scale counts enter the
final log. Invariant-site likelihood is added outside the scaled product
in log space (reference contract: tree/phylokernelnew.h:3295).

All functions are pure and jit-safe with static shapes; topology lives in
index arrays (schedule), so NNI moves never recompile.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST


def scaling_consts(dtype) -> tuple[float, float, float]:
    """(threshold, rescale_factor, log_rescale) for a partials dtype."""
    if jnp.dtype(dtype) == jnp.float64:
        b = 256
    else:
        b = 30
    return 2.0 ** (-b), 2.0 ** b, b * float(np.log(2.0))


# --------------------------------------------------------------- transition
def transition_tensors(blens, pack):
    """P[e,c] = exp(Q_m r_c t_e)  -> [E, C, S, S].

    blens may be [E] (one length per edge) or [E, C] (heterotachy /
    mixlen models: one length per edge per category — reference analog
    PhyloTreeMixlen, tree/phylotreemixlen.cpp).

    Reversible models use the cancellation-free orthonormal form
      P = D^{-1/2} (I + W diag(expm1(lambda r t)) W^T) D^{1/2}
    which keeps tiny off-diagonal entries accurate in float32 (the naive
    U e^{Lt} V form loses them to catastrophic cancellation). Nonreversible
    models (pack["Q"] present) use a scaling-and-squaring matrix
    exponential — all matmuls (reference analog: the nonrev
    kernel path, tree/phylokernelnonrev.h). Reference:
    ModelMarkov::computeTransMatrix (model/modelmarkov.cpp:504) folded
    per-category as in computePartialInfo (tree/phylokernelnew.h:896).
    """
    cat_mix = pack["cat_mix"]
    t_ec = blens[:, None] if blens.ndim == 1 else blens      # [E, C]
    if pack.get("Q") is not None:
        Qc = pack["Q"][cat_mix]             # [C, S, S]
        A = Qc[None] * (pack["cat_rate"][None, :, None, None]
                        * t_ec[:, :, None, None])   # [E, C, S, S]
        return jnp.maximum(expm_ss(A), 0.0)
    lam = pack["eigvals"][cat_mix]          # [C, S]
    expo = lam[None, :, :] * pack["cat_rate"][None, :, None] \
        * t_ec[:, :, None]                  # [E, C, S]
    if pack.get("W") is not None:
        Wc = pack["W"][cat_mix]             # [C, S, S]
        sq = pack["sqrt_freqs"][cat_mix]    # [C, S]
        em1 = jnp.expm1(expo)
        core = jnp.einsum("cxk,eck,cyk->ecxy", Wc, em1, Wc, precision=HIGHEST)
        S = lam.shape[-1]
        eye = jnp.eye(S, dtype=core.dtype)
        P = (eye[None, None] + core) * (sq[None, :, None, :]
                                        / sq[None, :, :, None])
    else:
        Uc = pack["U"][cat_mix]
        Vc = pack["V"][cat_mix]
        P = jnp.einsum("cxk,eck,cky->ecxy", Uc, jnp.exp(expo), Vc,
                       precision=HIGHEST)
    return jnp.maximum(P, 0.0)


def expm_ss(A, order: int = 8, squarings: int = 8):
    """Batched matrix exponential by scaling-and-squaring with a truncated
    Taylor series: exp(A) = (exp(A/2^k))^(2^k). For rate matrices Q*t with
    t <= 10 and mean rate 1 the scaled norm is tiny, so a fixed (order,
    squarings) is accurate to float32 precision and — unlike the Padé path
    of jax.scipy.linalg.expm — contains no data-dependent control flow, so
    it fuses cleanly under jit. All work is [.., S, S] matmuls."""
    A = A / (2.0 ** squarings)
    S = A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(S, dtype=A.dtype), A.shape)
    P = eye
    term = eye
    for k in range(1, order + 1):
        term = jnp.matmul(term, A, precision=HIGHEST) / k
        P = P + term
    for _ in range(squarings):
        P = jnp.matmul(P, P, precision=HIGHEST)
    return P


def tip_partials(tip_codes, tip_table):
    """[L, Ppat] codes + [ncodes, S] table -> [L, S, Ppat] leaf partials."""
    return jnp.swapaxes(tip_table[tip_codes], 1, 2)


class DownPass(NamedTuple):
    all: jax.Array           # [L + n_int, C, S, Ppat] unified partials
    scale: jax.Array         # [L + n_int, Ppat] int32 scale counts


def down_pass(P, tipP, sched) -> DownPass:
    """Post-order sweep computing internal-node partials.

    P: [E, C, S, S] transition tensors; tipP: [L, S, Ppat] leaf partials.
    sched: dict with child_src [n_int,2], child_edge [n_int,2],
    step_node [n_steps, G] (padded with n_int). One level-batched scan
    step per tree level.
    """
    dtype = tipP.dtype
    thresh, rescale, _ = scaling_consts(dtype)
    child_src = sched["child_src"]
    child_edge = sched["child_edge"]
    step_node = sched["step_node"]
    n_int = child_src.shape[0]
    C, S = P.shape[1], P.shape[2]
    L, _, Pp = tipP.shape

    ALL0 = jnp.zeros((L + n_int, C, S, Pp), dtype)
    ALL0 = ALL0.at[:L].set(jnp.broadcast_to(tipP[:, None], (L, C, S, Pp)))
    SC0 = jnp.zeros((L + n_int, Pp), jnp.int32)

    def body(carry, nid):  # nid: [G] postorder indices (pad = n_int)
        ALL, SC = carry
        nid_c = jnp.minimum(nid, n_int - 1)
        src_idx = child_src[nid_c]                      # [G, 2]
        eids = child_edge[nid_c]                        # [G, 2]
        src = ALL[src_idx]                              # [G, 2, C, S, Pp]
        Pe = P[eids]                                    # [G, 2, C, S, S]
        msg = apply_P(Pe, src)
        prod = msg[:, 0] * msg[:, 1]                    # [G, C, S, Pp]
        sc = SC[src_idx[:, 0]] + SC[src_idx[:, 1]]      # [G, Pp] int32
        mx = prod.max(axis=(1, 2))
        need = mx < thresh
        prod = prod * jnp.where(need, rescale,
                                1.0).astype(dtype)[:, None, None]
        sc = sc + need.astype(jnp.int32)
        out_idx = jnp.where(nid < n_int, L + nid, L + n_int)  # pad -> OOB
        ALL = ALL.at[out_idx].set(prod, mode="drop")
        SC = SC.at[out_idx].set(sc, mode="drop")
        return (ALL, SC), None

    (ALL, SC), _ = jax.lax.scan(body, (ALL0, SC0), step_node)
    return DownPass(ALL, SC)


# ----------------------------------------------- tiny-state contractions
# Broadcast-multiply-reduce forms of the per-edge [S, S] contractions:
# XLA fuses each into a single reduce without materializing the
# [..., S, S, P] intermediate, and the sums stay in the partials dtype
# (no reduced-precision matmul unit is involved). All small-state
# NNI/Newton hot paths route through these helpers.

def apply_P(P, x):
    """msg[..., x, p] = sum_y P[..., x, y] * x[..., y, p]."""
    return (P[..., :, :, None] * x[..., None, :, :]).sum(-2)


def apply_PT(P, x):
    """out[..., y, p] = sum_x P[..., x, y] * x[..., x, p]."""
    return (P[..., :, :, None] * x[..., :, None, :]).sum(-3)


def weight_sum(theta, w):
    """site[..., p] = sum_{c,k} theta[..., c, k, p] * w[..., c, k]."""
    return (theta * w[..., None]).sum((-3, -2))


def weight_sum3(theta, coef):
    """s[..., j, p] = sum_{c,k} theta[..., c, k, p] * coef[..., c, k, j]."""
    return (theta[..., :, :, None, :] * coef[..., :, :, :, None]).sum(
        (-4, -3))


def gather_messages(dp: DownPass, P, src_idx, eids):
    """Recompute child messages msg = P_e @ partial[src] for arbitrary index
    arrays (used by NNI evaluation — messages are no longer stored).

    src_idx/eids: [...]; returns (msg [..., C, S, Ppat], scale [..., Ppat]).
    """
    src = dp.all[src_idx]
    msg = apply_P(P[eids], src)
    return msg, dp.scale[src_idx]


def root_partial(dp: DownPass, P, tipP, n_int: int):
    """Combined root partial B_root * (P_0 @ tip_0): folds the message from
    leaf 0 (which the schedule excludes from the traversal) into the root.
    Returns ([C, S, Ppat], scale [Ppat])."""
    L = tipP.shape[0]
    m0 = jnp.einsum("cxy,yp->cxp", P[0], tipP[0], precision=HIGHEST)
    return dp.all[L + n_int - 1] * m0, dp.scale[L + n_int - 1]


def root_loglik(Broot, SCroot, root_freqs, cat_weight, log_ptn_invar,
                pattern_weights, axis_name: str | None = None,
                asc_mask=None, asc_nsites=None):
    """Site log-likelihoods + total logL from the root partials.

    Returns (logL, site_lp[Ppat]). When the pattern axis is sharded over a
    mesh axis, pass its name: the pattern-sum becomes a cross-device psum
    (site sharding is embarrassingly parallel — SURVEY §5).

    asc_mask/asc_nsites: Lewis ascertainment-bias correction (+ASC) —
    pseudo-patterns (one all-same-state column per state, weight 0) are
    flagged by asc_mask; logL -= N * log(1 - sum_x L_x) (reference:
    tree/phylokernelnew.h:3275-3330 ASC_LEWIS).
    """
    dtype = Broot.dtype
    _, _, log_rescale = scaling_consts(dtype)
    lh_cat = jnp.einsum("cx,cxp->cp", root_freqs, Broot, precision=HIGHEST)
    site = jnp.einsum("c,cp->p", cat_weight, lh_cat, precision=HIGHEST)
    tiny = jnp.finfo(dtype).tiny
    lp = jnp.log(jnp.maximum(site, tiny)) \
        - SCroot.astype(dtype) * jnp.asarray(log_rescale, dtype)
    lp = jnp.logaddexp(lp, log_ptn_invar)
    return finalize_loglik(lp, pattern_weights, axis_name=axis_name,
                           asc_mask=asc_mask, asc_nsites=asc_nsites)


def finalize_loglik(lp, pattern_weights, axis_name: str | None = None,
                    asc_mask=None, asc_nsites=None):
    """(logL, lp) from per-pattern log-likelihoods: weighted sum, optional
    mesh psum, optional Lewis +ASC correction."""
    logL = jnp.sum(pattern_weights * lp)
    if axis_name is not None:
        logL = jax.lax.psum(logL, axis_name)
    if asc_mask is not None:
        prob_unobs = jnp.sum(asc_mask * jnp.exp(lp))
        if axis_name is not None:
            prob_unobs = jax.lax.psum(prob_unobs, axis_name)
        logL = logL - asc_nsites * jnp.log1p(
            -jnp.minimum(prob_unobs, 1.0 - 1e-10))
    return logL, lp


def tree_loglik(blens, tipP, sched, pack, pattern_weights,
                axis_name: str | None = None):
    """Full tree log-likelihood in one call.

    sched: dict of device schedule arrays; pack: dict of model arrays
    (eigvals,U,V,cat_rate,cat_mix,cat_weight,root_freqs,log_ptn_invar).
    """
    P = transition_tensors(blens.astype(tipP.dtype), pack)
    dp = down_pass(P, tipP, sched)
    n_int = sched["child_src"].shape[0]
    Broot, SCroot = root_partial(dp, P, tipP, n_int)
    return root_loglik(Broot, SCroot, pack["root_freqs"],
                       pack["cat_weight"], pack["log_ptn_invar"],
                       pattern_weights, axis_name=axis_name,
                       asc_mask=pack.get("asc_mask"),
                       asc_nsites=pack.get("asc_nsites"))


def both_passes(P, tipP, sched, pack):
    """(DownPass, UpPass) for one topology (vmap-safe: the batched
    multi-candidate NNI programs map over it)."""
    dp = down_pass(P, tipP, sched)
    return dp, up_pass(P, dp, tipP, sched, pack["root_freqs"])


# ------------------------------------------------------------------ up pass
class UpPass(NamedTuple):
    edge_E: jax.Array        # [E, C, S, Ppat] outside partial per edge
    edge_E_scale: jax.Array  # [E, Ppat]
    up_in: jax.Array         # [n_int, C, S, Ppat] outside partial per node
    up_scale: jax.Array      # [n_int, Ppat]


def up_pass(P, dp: DownPass, tipP, sched, root_freqs) -> UpPass:
    """Pre-order sweep: for every edge e=(child v, parent u), compute
    E_e(c,x,p) = likelihood of everything outside v's subtree as a function
    of u's state x (stationary frequencies folded in at the root).

    Level-batched like down_pass (same steps, reversed order — a node's
    parent is always in a later down-step, hence an earlier up-step).
    Child messages are recomputed from the unified partial buffer rather
    than read from storage: one extra contraction per edge in exchange for
    never materializing [n_int, 3, C, S, Ppat].

    With E and the down partials, any branch's likelihood and its
    t-derivatives are O(C*S*Ppat) — the theta-buffer trick
    (tree/phylokernelnew.h:2050).
    """
    dtype = dp.all.dtype
    thresh, rescale, _ = scaling_consts(dtype)
    child_src = sched["child_src"]
    child_edge = sched["child_edge"]
    step_node = sched["step_node"]
    n_int = child_src.shape[0]
    C, S = P.shape[1], P.shape[2]
    L, _, Pp = tipP.shape
    n_edges = P.shape[0]

    # UP[i] = outside-likelihood at internal node i (function of its state).
    # Root: everything outside the root's two scheduled subtrees = the
    # stationary frequencies times the message from leaf 0.
    UP0 = jnp.zeros((n_int, C, S, Pp), dtype)
    UPS0 = jnp.zeros((n_int, Pp), jnp.int32)
    m0 = jnp.einsum("cxy,yp->cxp", P[0], tipP[0], precision=HIGHEST)
    UP0 = UP0.at[n_int - 1].set(root_freqs[:, :, None] * m0)
    E0 = jnp.zeros((n_edges, C, S, Pp), dtype)
    ES0 = jnp.zeros((n_edges, Pp), jnp.int32)
    # E for leaf 0's edge: the root's own down partial times the frequencies
    E0 = E0.at[0].set(root_freqs[:, :, None] * dp.all[L + n_int - 1])
    ES0 = ES0.at[0].set(dp.scale[L + n_int - 1])

    def body(carry, nid):  # nid: [G] postorder indices (pad = n_int)
        UP, UPS, E, ES = carry
        nid_c = jnp.minimum(nid, n_int - 1)
        src_idx = child_src[nid_c]                      # [G, 2]
        eids = child_edge[nid_c]                        # [G, 2]
        src = dp.all[src_idx]                           # [G, 2, C, S, Pp]
        Pe = P[eids]                                    # [G, 2, C, S, S]
        msg = apply_P(Pe, src)
        msc = dp.scale[src_idx]                         # [G, 2, Pp]
        up = UP[nid_c]                                  # [G, C, S, Pp]
        ups = UPS[nid_c]                                # [G, Pp]
        # E for slot k = up * msg[other slot]
        Es = up[:, None] * msg[:, ::-1]                 # [G, 2, C, S, Pp]
        Esc = ups[:, None] + msc[:, ::-1]               # [G, 2, Pp]
        mx = Es.max(axis=(2, 3))
        need = mx < thresh
        Es = Es * jnp.where(need, rescale,
                            1.0).astype(dtype)[:, :, None, None]
        Esc = Esc + need.astype(jnp.int32)
        ok = nid < n_int
        e_idx = jnp.where(ok[:, None], eids, n_edges)   # pad -> OOB drop
        E = E.at[e_idx].set(Es, mode="drop")
        ES = ES.at[e_idx].set(Esc, mode="drop")
        # propagate to internal children: up[child] = P_e^T E_e
        up_child = jnp.einsum("gkcxy,gkcxp->gkcyp", Pe, Es,
                              precision=HIGHEST)
        mx2 = up_child.max(axis=(2, 3))
        need2 = mx2 < thresh
        up_child = up_child * jnp.where(need2, rescale,
                                        1.0).astype(dtype)[:, :, None, None]
        sc2 = Esc + need2.astype(jnp.int32)
        is_int = ok[:, None] & (src_idx >= L)
        c_idx = jnp.where(is_int, src_idx - L, n_int)   # pad -> OOB drop
        UP = UP.at[c_idx].set(up_child, mode="drop")
        UPS = UPS.at[c_idx].set(sc2, mode="drop")
        return (UP, UPS, E, ES), None

    (UP, UPS, E, ES), _ = jax.lax.scan(body, (UP0, UPS0, E0, ES0),
                                       step_node[::-1])
    return UpPass(E, ES, UP, UPS)


# ------------------------------------------------------------ theta buffers
class Thetas(NamedTuple):
    theta: jax.Array        # [E, C, S, Ppat] eigenbasis products
    scale: jax.Array        # [E, Ppat] total scale counts


def edge_down_partials(dp: DownPass, edge_src):
    """Per-edge child-side partials (leaf or internal) + scale counts: a
    single gather from the unified buffer by each edge's source index."""
    return dp.all[edge_src], dp.scale[edge_src]


def edge_thetas(up: UpPass, dp: DownPass, edge_src, pack) -> Thetas:
    """theta_e(c,k,p) = (sum_x E_e(c,x,p) U(c,x,k)) (sum_y V(c,k,y) D_e(c,y,p))

    where D_e is the down partial of the child endpoint of e. Branch
    likelihood: f(t) = sum_k theta_k exp(lambda_k r_c t) per category.
    """
    Uc = pack["U"][pack["cat_mix"]]   # [C, S, S]
    Vc = pack["V"][pack["cat_mix"]]
    down, down_sc = edge_down_partials(dp, edge_src)
    a = apply_PT(Uc, up.edge_E)
    b = apply_P(Vc, down)
    theta = a * b
    return Thetas(theta, up.edge_E_scale + down_sc)


# ------------------------------------------- nonreversible branch derivatives
def branch_lh_derivs_nonrev(down, out, scale, t, pack, log_ptn_invar,
                            pattern_weights, order: int = 2,
                            axis_name: str | None = None):
    """Branch logL + d/dt + d2/dt2 for nonreversible models (no eigenbasis):
    site0 = out . P(t) . down, dP/dt = (sum_c w_c r_c Q) P, etc.

    down/out: [C, S, Ppat]; scale: [Ppat]. Reference analog: the nonrev
    derivative kernels (tree/phylokernelnonrev.h)."""
    dtype = down.dtype
    _, _, log_rescale = scaling_consts(dtype)
    Qc = pack["Q"][pack["cat_mix"]]                    # [C, S, S]
    r = pack["cat_rate"]
    w = pack["cat_weight"]
    A = Qc * (r[:, None, None] * t)                    # [C, S, S]
    P = expm_ss(A)
    outP = jnp.einsum("cxp,cxy->cyp", out, P, precision=HIGHEST)
    site0 = jnp.einsum("c,cyp,cyp->p", w, outP, down, precision=HIGHEST)
    site0 = jnp.maximum(site0, 0.0)
    sc = scale.astype(dtype) * jnp.asarray(log_rescale, dtype)
    tiny = jnp.finfo(dtype).tiny
    lp = jnp.log(jnp.maximum(site0, tiny)) - sc
    lp = jnp.logaddexp(lp, log_ptn_invar)
    logL = jnp.sum(pattern_weights * lp)
    if axis_name is not None:
        logL = jax.lax.psum(logL, axis_name)
    if order == 0:
        return logL, None, None
    rQ = Qc * r[:, None, None]
    outQP = jnp.einsum("cxp,cxy->cyp",
                       jnp.einsum("cxp,cxz->czp", out, rQ,
                                  precision=HIGHEST),
                       P, precision=HIGHEST)
    outQQP = jnp.einsum("cxp,cxy->cyp",
                        jnp.einsum("cxp,cxz->czp",
                                   jnp.einsum("cxp,cxw->cwp", out, rQ,
                                              precision=HIGHEST),
                                   rQ, precision=HIGHEST),
                        P, precision=HIGHEST)
    site1 = jnp.einsum("c,cyp,cyp->p", w, outQP, down, precision=HIGHEST)
    site2 = jnp.einsum("c,cyp,cyp->p", w, outQQP, down, precision=HIGHEST)
    inv_scaled = jnp.exp(log_ptn_invar + sc)
    denom = site0 + inv_scaled
    d1p = site1 / denom
    d2p = site2 / denom - d1p * d1p
    d1 = jnp.sum(pattern_weights * d1p)
    d2 = jnp.sum(pattern_weights * d2p)
    if axis_name is not None:
        d1 = jax.lax.psum(d1, axis_name)
        d2 = jax.lax.psum(d2, axis_name)
    return logL, d1, d2


def newton_branch_step_nonrev(down, out, scale, t0, pack, log_ptn_invar,
                              pattern_weights, t_min, t_max,
                              n_iter: int = 4):
    def one(i, t):
        _, d1, d2 = branch_lh_derivs_nonrev(down, out, scale, t, pack,
                                            log_ptn_invar, pattern_weights)
        newton_t = t - d1 / d2
        bad = (d2 >= 0) | ~jnp.isfinite(newton_t)
        fallback = jnp.where(d1 > 0, jnp.minimum(t * 4.0, t_max),
                             jnp.maximum(t * 0.25, t_min))
        return jnp.where(bad, fallback, jnp.clip(newton_t, t_min, t_max))
    return jax.lax.fori_loop(0, n_iter, one, t0)


def branch_lh_derivs(theta, scale, t, pack, log_ptn_invar, pattern_weights,
                     order: int = 2, axis_name: str | None = None):
    """logL(t) of one branch from its theta buffer, with d/dt and d2/dt2.

    theta: [C, K, Ppat]; scale: [Ppat]; t scalar. Returns (logL, d1, d2).
    Reference analog: computeLikelihoodDervSIMD / FromBufferSIMD
    (tree/phylokernelnew.h:2235, :3196).
    """
    dtype = theta.dtype
    _, _, log_rescale = scaling_consts(dtype)
    lam = pack["eigvals"][pack["cat_mix"]]           # [C, K]
    lr = lam * pack["cat_rate"][:, None]             # [C, K]
    w = pack["cat_weight"]
    et = jnp.exp(lr * t)                             # [C, K]
    wet = w[:, None] * et
    sc = scale.astype(dtype) * jnp.asarray(log_rescale, dtype)
    tiny = jnp.finfo(dtype).tiny
    asc_mask = pack.get("asc_mask")
    if order == 0:
        site0 = jnp.maximum(weight_sum(theta, wet), 0.0)
        lp = jnp.log(jnp.maximum(site0, tiny)) - sc
        lp = jnp.logaddexp(lp, log_ptn_invar)
        logL = jnp.sum(pattern_weights * lp)
        if axis_name is not None:
            logL = jax.lax.psum(logL, axis_name)
        if asc_mask is not None:
            prob_unobs = jnp.sum(asc_mask * jnp.exp(lp))
            if axis_name is not None:
                prob_unobs = jax.lax.psum(prob_unobs, axis_name)
            logL = logL - pack["asc_nsites"] * jnp.log1p(
                -jnp.minimum(prob_unobs, 1.0 - 1e-10))
        return logL, None, None
    # one fused pass over the theta buffer for all three t-derivative
    # sums: theta is the big HBM array (132 MB at 64 taxa x 16k patterns);
    # three separate einsums re-read it three times per Newton iteration
    coef = jnp.stack([wet, wet * lr, wet * lr * lr], axis=-1)  # [C, K, 3]
    s012 = weight_sum3(theta, coef)
    site0 = jnp.maximum(s012[0], 0.0)
    lp = jnp.log(jnp.maximum(site0, tiny)) - sc
    lp = jnp.logaddexp(lp, log_ptn_invar)
    logL = jnp.sum(pattern_weights * lp)
    if axis_name is not None:
        logL = jax.lax.psum(logL, axis_name)
    site1 = s012[1]
    site2 = s012[2]
    # denom = site0 + inv * 2^{B*sc}; overflow -> inf -> ratios 0 (correct:
    # when scaled-out variable part is negligible vs invariant part)
    inv_scaled = jnp.exp(log_ptn_invar + sc)
    denom = site0 + inv_scaled
    d1p = site1 / denom
    d2p = site2 / denom - d1p * d1p
    d1 = jnp.sum(pattern_weights * d1p)
    d2 = jnp.sum(pattern_weights * d2p)
    if axis_name is not None:
        d1 = jax.lax.psum(d1, axis_name)
        d2 = jax.lax.psum(d2, axis_name)
    if asc_mask is not None:
        # d/dt of -N log(1 - s),  s = sum_x e^{lp_x}:
        #   s'  = sum_x e^{lp_x} (lp_x)'
        #   s'' = sum_x e^{lp_x} ((lp_x)'' + (lp_x)'^2)
        sx = asc_mask * jnp.exp(lp)
        s = jnp.sum(sx)
        s1 = jnp.sum(sx * d1p)
        s2 = jnp.sum(sx * (d2p + d1p * d1p))
        if axis_name is not None:
            s = jax.lax.psum(s, axis_name)
            s1 = jax.lax.psum(s1, axis_name)
            s2 = jax.lax.psum(s2, axis_name)
        N = pack["asc_nsites"]
        om = jnp.maximum(1.0 - s, 1e-10)
        logL = logL - N * jnp.log(om)
        d1 = d1 + N * s1 / om
        d2 = d2 + N * (s2 / om + (s1 / om) ** 2)
    return logL, d1, d2


def branch_site_lp(theta, scale, t, pack, log_ptn_invar):
    """Per-pattern log-likelihood of one branch configuration from its
    theta buffer (for SH-aLRT / RELL resampling of NNI alternatives)."""
    dtype = theta.dtype
    _, _, log_rescale = scaling_consts(dtype)
    lam = pack["eigvals"][pack["cat_mix"]]
    lr = lam * pack["cat_rate"][:, None]
    wet = pack["cat_weight"][:, None] * jnp.exp(lr * t)
    site0 = jnp.maximum(weight_sum(theta, wet), 0.0)
    sc = scale.astype(dtype) * jnp.asarray(log_rescale, dtype)
    tiny = jnp.finfo(dtype).tiny
    lp = jnp.log(jnp.maximum(site0, tiny)) - sc
    return jnp.logaddexp(lp, log_ptn_invar)


def branch_site_lp_nonrev(down, out, scale, t, pack, log_ptn_invar):
    """Per-pattern log-likelihood of one branch configuration for
    nonreversible models (no eigenbasis): site0 = out . P(t) . down."""
    dtype = down.dtype
    _, _, log_rescale = scaling_consts(dtype)
    Qc = pack["Q"][pack["cat_mix"]]
    A = Qc * (pack["cat_rate"][:, None, None] * t)
    P = expm_ss(A)
    outP = jnp.einsum("cxp,cxy->cyp", out, P, precision=HIGHEST)
    site0 = jnp.maximum(
        jnp.einsum("c,cyp,cyp->p", pack["cat_weight"], outP, down,
                   precision=HIGHEST), 0.0)
    sc = scale.astype(dtype) * jnp.asarray(log_rescale, dtype)
    tiny = jnp.finfo(dtype).tiny
    lp = jnp.log(jnp.maximum(site0, tiny)) - sc
    return jnp.logaddexp(lp, log_ptn_invar)


def branch_lh_derivs_mixlen(theta, scale, tvec, pack, log_ptn_invar,
                            pattern_weights):
    """Per-category branch derivatives for heterotachy (+H) models: tvec
    is [C] (one length per category); returns (logL, d1 [C], d2 [C]) where
    d1/d2 are the per-category partial derivatives (cross-terms through
    the site-likelihood denominator are kept — exact coordinate Newton).
    Reference analog: computeLikelihoodDervMixlen
    (tree/phylotreemixlen.cpp)."""
    dtype = theta.dtype
    _, _, log_rescale = scaling_consts(dtype)
    lam = pack["eigvals"][pack["cat_mix"]]           # [C, K]
    lr = lam * pack["cat_rate"][:, None]             # [C, K]
    w = pack["cat_weight"]
    et = jnp.exp(lr * tvec[:, None])                 # [C, K]
    wet = w[:, None] * et
    s0c = (theta * wet[..., None]).sum(-2)
    site0 = jnp.maximum(s0c.sum(0), 0.0)
    sc = scale.astype(dtype) * jnp.asarray(log_rescale, dtype)
    tiny = jnp.finfo(dtype).tiny
    lp = jnp.log(jnp.maximum(site0, tiny)) - sc
    lp = jnp.logaddexp(lp, log_ptn_invar)
    logL = jnp.sum(pattern_weights * lp)
    s1c = (theta * (wet * lr)[..., None]).sum(-2)
    s2c = (theta * (wet * lr * lr)[..., None]).sum(-2)
    inv_scaled = jnp.exp(log_ptn_invar + sc)
    denom = site0 + inv_scaled
    d1p = s1c / denom                                # [C, P]
    d2p = s2c / denom - d1p * d1p
    d1 = jnp.einsum("p,cp->c", pattern_weights, d1p, precision=HIGHEST)
    d2 = jnp.einsum("p,cp->c", pattern_weights, d2p, precision=HIGHEST)
    return logL, d1, d2


def newton_branch_step_mixlen(theta, scale, t0vec, pack, log_ptn_invar,
                              pattern_weights, t_min, t_max,
                              n_iter: int = 4):
    """Bounded coordinate Newton on all C per-category lengths of one
    branch jointly (each category's length updated from its own d1/d2)."""
    def one(i, t):
        _, d1, d2 = branch_lh_derivs_mixlen(theta, scale, t, pack,
                                            log_ptn_invar, pattern_weights)
        newton_t = t - d1 / d2
        bad = (d2 >= 0) | ~jnp.isfinite(newton_t)
        fallback = jnp.where(d1 > 0, jnp.minimum(t * 4.0, t_max),
                             jnp.maximum(t * 0.25, t_min))
        return jnp.where(bad, fallback, jnp.clip(newton_t, t_min, t_max))
    return jax.lax.fori_loop(0, n_iter, one, t0vec)


def newton_branch_step(theta, scale, t0, pack, log_ptn_invar,
                       pattern_weights, t_min, t_max, n_iter: int = 4,
                       axis_name: str | None = None):
    """A few bounded Newton iterations on one branch length (vmapped over
    edges by the caller). Mirrors minimizeNewton (utils/optimization.cpp:422):
    fall back to stepping toward a bound when curvature is wrong.
    """
    def one(i, t):
        _, d1, d2 = branch_lh_derivs(theta, scale, t, pack, log_ptn_invar,
                                     pattern_weights, axis_name=axis_name)
        newton_t = t - d1 / d2
        bad = (d2 >= 0) | ~jnp.isfinite(newton_t)
        # wrong curvature: move in gradient direction geometrically
        fallback = jnp.where(d1 > 0, jnp.minimum(t * 4.0, t_max),
                             jnp.maximum(t * 0.25, t_min))
        t_new = jnp.where(bad, fallback, jnp.clip(newton_t, t_min, t_max))
        return t_new
    return jax.lax.fori_loop(0, n_iter, one, t0)
