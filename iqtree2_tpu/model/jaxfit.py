"""Device-side joint (model + rate + branch-length) fitting with exact
autodiff gradients, one optimizer dispatch per fit.

Reference analog: ModelFactory::optimizeParameters
(model/modelfactory.cpp:1329) alternating optimizeParametersOnly (:1054)
with tree->optimizeAllBranches, using numeric-derivative BFGS/Brent on a
double-precision CPU likelihood (utils/optimization.cpp:422).

Redesign: instead of a chatty host loop (hundreds of host-device
round-trips, finite-difference gradients that stall in float32), the
whole objective is re-expressed in JAX:

  x (unconstrained params) ──> exchangeabilities / freqs / Gamma rates /
  p_invar / FreeRate weights ──> Q ──> P(t) by scaling-and-squaring expm
  ──> pruning down-pass ──> logL

and optimized jointly with log branch lengths by an in-jit L-BFGS
(optax.lbfgs + zoom linesearch) under ``lax.while_loop`` — ONE device
dispatch for the entire model optimization. Gradients are exact
(reverse-mode), so float32 no longer stalls; the fit itself defaults to
float64 whenever x64 is enabled, which closes the default-precision gap.

Design notes:
- P(t) uses the expm path (ops/pruning.expm_ss), not eigh: autodiff of
  eigh is undefined at the degenerate eigenvalues that symmetric DNA
  models (JC/K80/...) always have; expm is matmuls only (smooth
  everywhere).
- The down pass is a Python-unrolled level loop (static step count,
  dynamic index arrays): unlike ``lax.scan`` whose reverse-mode saves the
  full partials carry per step (O(n_steps * nodes) memory), the unrolled
  graph's residuals are just the actual per-level messages (O(nodes)).
- Restricted DNA models (HKY, TN, ...) share one compiled structure with
  GTR via a constraint matrix input; frozen parameters are masked so
  their gradient is exactly zero and L-BFGS never moves them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp

from iqtree2_tpu.model.rates import (RateFree, RateFreeInvar, RateGamma,
                                     RateGammaInvar, RateInvar, RateModel)
from iqtree2_tpu.model.subst import GTRModel
from iqtree2_tpu.ops.pruning import HIGHEST, expm_ss, scaling_consts

# residual-memory guard for reverse-mode through the down pass:
# n_int * C * S * Pp elements (messages ~2x that)
MAX_REVERSE_ELEMENTS = 2.0e8


# --------------------------------------------------------------- special fns
@jax.custom_jvp
def gammaincinv(a, q):
    """Inverse regularized lower incomplete gamma: P(a, x) = q -> x.

    Forward: Wilson-Hilferty initial guess + damped Newton in log space.
    JVP: implicit function theorem (dP/dx = gamma pdf; dP/da =
    lax.igamma_grad_a). scipy.special.gammaincinv analog, traceable.
    """
    a = jnp.asarray(a)
    q = jnp.asarray(q)
    dt = jnp.result_type(a, q, jnp.float32)
    a = a.astype(dt)
    q = q.astype(dt)
    # Wilson-Hilferty: x ~ a * (1 - 1/(9a) + z * sqrt(1/(9a)))^3
    z = jnp.sqrt(jnp.asarray(2.0, dt)) * jax.scipy.special.erfinv(2 * q - 1)
    c = 1.0 - 1.0 / (9.0 * a) + z * jnp.sqrt(1.0 / (9.0 * a))
    x0 = a * jnp.maximum(c, 1e-8) ** 3
    x0 = jnp.clip(x0, jnp.finfo(dt).tiny * 100, 1e8)
    u0 = jnp.log(x0)

    def body(_, u):
        x = jnp.exp(u)
        P = jax.scipy.special.gammainc(a, x)
        # log-pdf of Gamma(a, 1); Newton step in u = log x:
        # du = -(P - q) / (pdf * x)
        logpdf = (a - 1.0) * u - x - jax.scipy.special.gammaln(a)
        step = (P - q) * jnp.exp(-(logpdf + u))
        return u - jnp.clip(step, -4.0, 4.0)

    u = jax.lax.fori_loop(0, 40, body, u0)
    return jnp.exp(u)


@gammaincinv.defjvp
def _gammaincinv_jvp(primals, tangents):
    a, q = primals
    da, dq = tangents
    x = gammaincinv(a, q)
    a = jnp.asarray(a, x.dtype)
    q = jnp.asarray(q, x.dtype)
    logpdf = ((a - 1.0) * jnp.log(x) - x - jax.scipy.special.gammaln(a))
    inv_pdf = jnp.exp(-logpdf)
    dPda = jax.lax.igamma_grad_a(a, x)
    dx = (jnp.asarray(dq, x.dtype)
          - dPda * jnp.asarray(da, x.dtype)) * inv_pdf
    return x, dx


def gamma_cat_rates(alpha, ncat: int, median: bool = False):
    """Discrete Gamma category rates, mean 1 (traceable + differentiable).

    Same math as model/rates.py discrete_gamma_rates (reference:
    model/rategamma.cpp:98-131), expressed with the traceable
    gammaincinv above.
    """
    dt = jnp.result_type(alpha, jnp.float32)
    if ncat == 1:
        return jnp.ones((1,), dt)
    if median:
        probs = ((2.0 * jnp.arange(ncat) + 1.0) / (2.0 * ncat)).astype(dt)
        r = gammaincinv(alpha, probs) / alpha
        return r * ncat / jnp.sum(r)
    qs = (jnp.arange(1, ncat) / ncat).astype(dt)
    xq = gammaincinv(alpha, qs)                 # a * edges in mean-1 scale
    cum = jax.scipy.special.gammainc(alpha + 1.0, xq)
    cum = jnp.concatenate([jnp.zeros((1,), cum.dtype), cum,
                           jnp.ones((1,), cum.dtype)])
    return jnp.diff(cum) * ncat


# ------------------------------------------------------------------- spec
@dataclasses.dataclass
class FitSpec:
    """Static structure + dynamic inputs of one fittable (model, rates).

    Static (affects compilation): S, C, rate kind, has_pinv, median, nr.
    Dynamic (same compile across models): Cmat, ref_mask, x0, mask.
    """
    S: int
    C: int
    nr: int                     # number of exchangeability slots S(S-1)/2
    rate_kind: str              # "none" | "gamma" | "free"
    has_pinv: bool
    median: bool
    # dynamic arrays
    Cmat: np.ndarray            # [nr, nr] expands free-class values
    ref_mask: np.ndarray        # [nr] positions fixed at rate 1
    x0: np.ndarray              # [k] unconstrained init
    mask: np.ndarray            # [k] 1 = free, 0 = frozen at x0
    # host objects for writeback
    model: GTRModel = None
    rates: RateModel = None
    # segment slicing (static)
    seg: dict = None

    @property
    def k(self) -> int:
        return len(self.x0)

    def struct_key(self):
        # has_pinv is intentionally NOT part of the compile key: it rides
        # as a dynamic 0/1 flag so ModelFinder's whole {,+I,+G,+I+G} grid
        # shares at most one compile per category count
        return (self.S, self.C, self.nr, self.rate_kind,
                self.median, self.k)


def _logit(p):
    return float(np.log(p / (1.0 - p)))


def build_spec(model, rates, fix_model: bool = False,
               fix_rates: bool = False) -> FitSpec | None:
    """Map host (model, rates) onto a FitSpec, or None if unsupported.

    Supported: plain GTRModel (covers every named DNA model via rate
    constraints, GTR on any state space, empirical protein matrices with
    or without +F) x {none, +I, +G, +I+G, +R, +I+R} rate models.
    Mixtures/nonreversible/PoMo/+E keep the host optimization path.
    """
    if type(model) is not GTRModel:
        return None
    if hasattr(model, "transform_tip_table"):
        return None
    t = type(rates)
    if t not in (RateModel, RateInvar, RateGamma, RateGammaInvar,
                 RateFree, RateFreeInvar):
        return None

    S = model.num_states
    nr = S * (S - 1) // 2

    # --- exchangeability structure --------------------------------------
    Cmat = np.zeros((nr, nr))
    ref_mask = np.zeros(nr)
    xr0 = np.zeros(nr)
    free_classes = ([] if (model.fixed_rates or fix_model)
                    else model.free_rate_classes())
    for j, c in enumerate(free_classes):
        pos = model._class_of == c
        Cmat[pos, j] = 1.0
        v = float(model.exch_rates[np.nonzero(pos)[0][0]])
        xr0[j] = np.log(np.clip(v, 1e-6, 1e6))
    if model.fixed_rates or fix_model:
        # whole exchangeability vector frozen at its current values
        ref_mask = np.asarray(model.exch_rates, float).copy()
    else:
        ref_mask[model._class_of == model._ref_class] = 1.0
        # frozen non-free classes (shouldn't exist, but be safe)
    mask_r = np.zeros(nr)
    mask_r[: len(free_classes)] = 1.0

    # --- frequencies ----------------------------------------------------
    f = np.clip(np.asarray(model.freqs, float), 1e-10, None)
    xf0 = np.log(f[:-1] / f[-1])
    freqs_free = (model.freq_type == "estimate") and not fix_model
    mask_f = np.full(S - 1, 1.0 if freqs_free else 0.0)

    # --- rate heterogeneity ---------------------------------------------
    median = bool(getattr(rates, "median", False))
    if t in (RateFree, RateFreeInvar):
        rate_kind = "free"
        C = rates.ncat
    else:
        # "gamma" covers plain/+I too (C=1 Gamma is the identity), so the
        # whole TEST rate grid shares compiles
        rate_kind = "gamma"
        C = rates.ncat

    p_inv = float(rates.p_invar)
    free_pinv = ((t is RateInvar and not getattr(rates, "fix_pinv", False))
                 or (t in (RateGammaInvar, RateFreeInvar)
                     and not getattr(rates, "fix_pinv", False)))
    free_pinv = free_pinv and not fix_rates
    has_pinv = bool(p_inv > 0 or free_pinv)

    # alpha/pinv slots always exist (masked when absent) so restricted
    # rate models reuse the same compiled structure
    alpha0 = float(np.clip(getattr(rates, "alpha", 1.0), 0.02, 100.0))
    xa0 = np.array([np.log(alpha0)])
    afree = (rate_kind == "gamma" and C > 1
             and not getattr(rates, "fix_alpha", True) and not fix_rates)
    mask_a = np.array([1.0 if afree else 0.0])
    xc0 = np.zeros(0)
    xw0 = np.zeros(0)
    mask_c = np.zeros(0)
    mask_w = np.zeros(0)
    if rate_kind == "free":
        r = np.clip(np.asarray(rates.rates, float), 1e-4, 100.0)
        w = np.clip(np.asarray(rates.weights, float), 1e-8, None)
        xc0 = np.log(r)
        xw0 = np.log(w[:-1] / w[-1])
        fr = 0.0 if (rates.fix_rates or fix_rates) else 1.0
        mask_c = np.full(C, fr)
        mask_w = np.full(C - 1, fr)
    xp0 = np.array([_logit(np.clip(p_inv if p_inv > 0 else 0.1,
                                   1e-4, 0.99))])
    mask_p = np.array([1.0 if free_pinv else 0.0])

    segs = {}
    off = 0
    for name, arr in (("r", xr0), ("f", xf0), ("a", xa0), ("c", xc0),
                      ("w", xw0), ("p", xp0)):
        segs[name] = (off, off + len(arr))
        off += len(arr)
    x0 = np.concatenate([xr0, xf0, xa0, xc0, xw0, xp0])
    mask = np.concatenate([mask_r, mask_f, mask_a, mask_c, mask_w, mask_p])

    return FitSpec(S=S, C=C, nr=nr, rate_kind=rate_kind, has_pinv=has_pinv,
                   median=median, Cmat=Cmat, ref_mask=ref_mask,
                   x0=x0, mask=mask, model=model, rates=rates, seg=segs)


def _unpack(x, spec: FitSpec, Cmat, ref_mask, pinv_flag):
    """x (already mask-frozen) -> (exch [nr], freqs [S], cat_rate [C],
    cat_weight [C], p_inv scalar). pinv_flag: dynamic 0/1 (+I present)."""
    def seg(name):
        a, b = spec.seg[name]
        return x[a:b]

    exch = jnp.matmul(Cmat, jnp.exp(jnp.clip(seg("r"), -18.0, 18.0)),
                      precision=HIGHEST) + ref_mask
    uf = jnp.concatenate([seg("f"), jnp.zeros((1,), x.dtype)])
    freqs = jax.nn.softmax(jnp.clip(uf, -30.0, 30.0))

    p_inv = jax.nn.sigmoid(seg("p")[0]) * 0.9999 * pinv_flag

    if spec.rate_kind == "gamma":
        alpha = jnp.exp(jnp.clip(seg("a")[0], float(np.log(0.02)),
                                 float(np.log(1e3))))
        r = gamma_cat_rates(alpha, spec.C, spec.median)
        w = jnp.full((spec.C,), 1.0 / spec.C, x.dtype)
    elif spec.rate_kind == "free":
        uw = jnp.concatenate([seg("w"), jnp.zeros((1,), x.dtype)])
        w = jax.nn.softmax(jnp.clip(uw, -30.0, 30.0))
        raw = jnp.exp(jnp.clip(seg("c"), float(np.log(1e-4)),
                               float(np.log(100.0))))
        r = raw / jnp.sum(w * raw)
    else:
        r = jnp.ones((1,), x.dtype)
        w = jnp.ones((1,), x.dtype)
    r = r / (1.0 - p_inv)
    w = w * (1.0 - p_inv)
    return exch, freqs, r, w, p_inv


def _gtr_q(exch, freqs, iu):
    """Normalized reversible Q from exchangeabilities + freqs (traceable).
    Same math as model/subst.py build_gtr_rate_matrix."""
    S = freqs.shape[0]
    R = jnp.zeros((S, S), exch.dtype).at[iu].set(exch)
    R = R + R.T
    Q = R * freqs[None, :]
    Q = Q - jnp.diag(jnp.sum(Q, axis=1))
    mu = -jnp.sum(freqs * jnp.diagonal(Q))
    return Q / jnp.maximum(mu, 1e-12)


def _down_pass_unrolled(P, tipP, sched, n_steps: int, dtype):
    """Pruning down pass, Python-unrolled over levels (AD-friendly).

    sched: device dict (child_src [n_int,2], child_edge, step_node
    [n_steps,G], ...). Scale counts are float (differentiable graph skips
    them; they only shift logs by constants).
    """
    thresh, rescale, _ = scaling_consts(dtype)
    L, S, Pp = tipP.shape
    C = P.shape[1]
    child_src = sched["child_src"]
    child_edge = sched["child_edge"]
    step_node = sched["step_node"]
    n_int = child_src.shape[0]

    ALL = jnp.concatenate(
        [jnp.broadcast_to(tipP[:, None], (L, C, S, Pp)).astype(dtype),
         jnp.zeros((n_int, C, S, Pp), dtype)], axis=0)
    SC = jnp.zeros((L + n_int, Pp), dtype)
    for i in range(n_steps):
        nid = step_node[i]
        nid_c = jnp.minimum(nid, n_int - 1)
        src_idx = child_src[nid_c]
        eids = child_edge[nid_c]
        src = ALL[src_idx]                          # [G, 2, C, S, Pp]
        Pe = P[eids]
        # merged batch dims: the 4-batch-dim form ("gkcxy,gkcyp->gkcxp")
        # trips an XLA hlo-verifier bug when this graph is vmapped
        # (batched ModelFinder screening)
        Gs = src.shape[0]
        msg = jnp.einsum(
            "bxy,byp->bxp", Pe.reshape(-1, S, S),
            src.reshape(-1, S, Pp),
            precision=HIGHEST).reshape(Gs, 2, C, S, Pp)
        prod = msg[:, 0] * msg[:, 1]
        sc = SC[src_idx[:, 0]] + SC[src_idx[:, 1]]
        mx = prod.max(axis=(1, 2))
        need = mx < thresh
        prod = prod * jnp.where(need, rescale, 1.0).astype(dtype)[:, None,
                                                                  None]
        sc = sc + need.astype(dtype)
        out_idx = jnp.where(nid < n_int, L + nid, L + n_int)
        ALL = ALL.at[out_idx].set(prod, mode="drop")
        SC = SC.at[out_idx].set(sc, mode="drop")
    return ALL, SC


def _loglik(x, log_t, spec: FitSpec, consts):
    """Joint objective: logL(model params x, log branch lengths)."""
    dtype = log_t.dtype
    Cmat = consts["Cmat"]
    ref_mask = consts["ref_mask"]
    exch, freqs, cat_r, cat_w, p_inv = _unpack(x, spec, Cmat, ref_mask,
                                               consts["pinv_flag"])
    Q = _gtr_q(exch, freqs, consts["iu"])

    t = jnp.exp(jnp.clip(log_t, float(np.log(1e-7)),
                         float(np.log(10.0))))
    A = Q[None, None] * (cat_r[None, :, None, None]
                         * t[:, None, None, None])     # [E, C, S, S]
    if dtype == jnp.float64:
        P = expm_ss(A, order=12, squarings=14)
    else:
        P = expm_ss(A, order=8, squarings=8)
    P = jnp.maximum(P, 0.0)

    tipP = consts["tipP"]
    sched = consts["sched"]
    ALL, SC = _down_pass_unrolled(P, tipP, sched, consts["n_steps"], dtype)
    L = tipP.shape[0]
    n_int = sched["child_src"].shape[0]
    m0 = jnp.einsum("cxy,yp->cxp", P[0], tipP[0], precision=HIGHEST)
    Broot = ALL[L + n_int - 1] * m0
    SCroot = SC[L + n_int - 1]

    _, _, log_rescale = scaling_consts(dtype)
    lh_cat = jnp.einsum("x,cxp->cp", freqs, Broot, precision=HIGHEST)
    site = jnp.einsum("c,cp->p", cat_w, lh_cat, precision=HIGHEST)
    tiny = jnp.finfo(dtype).tiny
    lp = jnp.log(jnp.maximum(site, tiny)) \
        - SCroot * jnp.asarray(log_rescale, dtype)
    cmf = jnp.matmul(consts["cmf_raw"], freqs, precision=HIGHEST)  # [Pp]
    use = consts["is_const"] & (consts["pinv_flag"] > 0)
    safe = jnp.where(use, jnp.maximum(cmf, tiny), 1.0)
    lpi = jnp.where(use,
                    jnp.log(jnp.maximum(p_inv, tiny)) + jnp.log(safe),
                    -jnp.inf)
    lp = jnp.logaddexp(lp, lpi)
    return jnp.sum(consts["pw"] * lp)


def _fit_core(x0, logt0, mask, consts, spec, max_iters, gtol, k: int,
              dtype):
    """In-graph joint L-BFGS fit. Returns (x, log_t, logL, n_iter)."""
    import optax
    import optax.tree_utils as otu

    x0 = x0.astype(dtype)
    mask = mask.astype(dtype)          # [k + E]: params then log-blens
    z0 = jnp.concatenate([x0, logt0.astype(dtype)])

    def obj(z):
        # frozen entries pinned to z0: gradient exactly 0 there
        zz = z0 * (1 - mask) + z * mask
        return -_loglik(zz[:k], zz[k:], spec, consts)
    solver = optax.lbfgs()
    vg = optax.value_and_grad_from_state(obj)

    def step(carry):
        z, state = carry
        value, grad = vg(z, state=state)
        updates, state = solver.update(grad, state, z, value=value,
                                       grad=grad, value_fn=obj)
        z = optax.apply_updates(z, updates)
        return z, state

    def cont(carry):
        _, state = carry
        count = otu.tree_get(state, "count")
        grad = otu.tree_get(state, "grad")
        value = otu.tree_get(state, "value")
        gmax = jnp.max(jnp.abs(grad))
        return ((count == 0) |
                ((count < max_iters) & (gmax > gtol)
                 & jnp.isfinite(value)))

    z, state = jax.lax.while_loop(cont, step, (z0, solver.init(z0)))
    zz = z0 * (1 - mask) + z * mask
    logL = _loglik(zz[:k], zz[k:], spec, consts)
    return zz[:k], zz[k:], logL, otu.tree_get(state, "count")


@functools.partial(jax.jit,
                   static_argnames=("spec_key", "n_steps", "k", "E"))
def _fit_jit(x0, logt0, mask, Cmat, ref_mask, iu0, iu1, tipP, sched, pw,
             cmf_raw, is_const, pinv_flag, max_iters, gtol,
             spec_key=None, n_steps=None, k=None, E=None):
    spec = _SPECS[spec_key]
    consts = dict(Cmat=Cmat, ref_mask=ref_mask, iu=(iu0, iu1), tipP=tipP,
                  sched=sched, pw=pw, cmf_raw=cmf_raw, is_const=is_const,
                  pinv_flag=pinv_flag, n_steps=n_steps)
    return _fit_core(x0, logt0, mask, consts, spec, max_iters, gtol, k,
                     tipP.dtype)


@functools.partial(jax.jit,
                   static_argnames=("spec_key", "n_steps", "k", "E"))
def _fit_batch_jit(x0B, logt0, maskB, CmatB, refB, iu0, iu1, tipP, sched,
                   pw, cmf_raw, is_const, flagB, max_iters, gtol,
                   spec_key=None, n_steps=None, k=None, E=None):
    """Vmapped joint fit of B same-structure candidates in ONE dispatch
    (ModelFinder's whole restricted-model grid per category count; the
    batched while_loop runs to the slowest candidate's convergence)."""
    spec = _SPECS[spec_key]
    dtype = tipP.dtype

    def one(x0, mask, Cmat, ref_mask, flag):
        consts = dict(Cmat=Cmat, ref_mask=ref_mask, iu=(iu0, iu1),
                      tipP=tipP, sched=sched, pw=pw, cmf_raw=cmf_raw,
                      is_const=is_const, pinv_flag=flag, n_steps=n_steps)
        return _fit_core(x0, logt0, mask, consts, spec, max_iters, gtol,
                         k, dtype)

    return jax.vmap(one)(x0B, maskB, CmatB, refB, flagB)


# static spec registry keyed by structure (jit static arg can't be a
# dataclass with arrays; the arrays travel as dynamic args)
_SPECS: dict = {}


def _writeback(spec: FitSpec, x: np.ndarray) -> None:
    """Set host model/rate objects from the optimized vector."""
    model, rates = spec.model, spec.rates

    def seg(name):
        a, b = spec.seg[name]
        return x[a:b]

    if not model.fixed_rates and np.any(spec.mask[slice(*spec.seg["r"])]):
        exch = spec.Cmat @ np.exp(seg("r")) + spec.ref_mask
        model.exch_rates = np.asarray(exch, np.float64)
    if model.freq_type == "estimate" and \
            np.any(spec.mask[slice(*spec.seg["f"])]):
        uf = np.concatenate([seg("f"), [0.0]])
        e = np.exp(uf - uf.max())
        model.freqs = e / e.sum()
    p_inv = 0.0
    if spec.has_pinv:
        p_inv = float(1.0 / (1.0 + np.exp(-seg("p")[0])) * 0.9999)
    if spec.rate_kind == "gamma":
        if spec.mask[spec.seg["a"][0]]:
            rates.alpha = float(np.exp(seg("a")[0]))
        if spec.mask[spec.seg["p"][0]]:
            rates._p_invar = p_inv
    elif spec.rate_kind == "free":
        if not rates.fix_rates and np.any(spec.mask[slice(*spec.seg["c"])]):
            uw = np.concatenate([seg("w"), [0.0]])
            e = np.exp(uw - uw.max())
            w = e / e.sum()
            raw = np.exp(seg("c"))
            rates.weights = w
            rates.rates = raw / (w * raw).sum()
            rates.normalize()
        if spec.mask[spec.seg["p"][0]]:
            rates._p_invar = p_inv


def try_fit_batch(eng, tree, pairs, epsilon: float = 0.1,
                  dtype=None) -> list[float] | None:
    """Fit B same-structure (model, rates) candidates jointly in ONE
    vmapped L-BFGS dispatch on a fixed topology (ModelFinder screening).

    eng: any LikelihoodEngine on the target alignment (supplies tip
    codes/weights; all candidates share its tip table). Mutates every
    pair's host objects in place; returns per-candidate logLs, or None
    when the pairs don't share one compiled structure.
    """
    from iqtree2_tpu.engine import LikelihoodEngine
    if type(eng) is not LikelihoodEngine or eng.asc or not pairs:
        return None
    specs = [build_spec(m, r) for m, r in pairs]
    if any(sp is None for sp in specs):
        return None
    key0 = specs[0].struct_key()
    if any(sp.struct_key() != key0 for sp in specs[1:]):
        return None

    from iqtree2_tpu.tree.schedule import build_schedule
    sched = build_schedule(tree)
    n_int = sched.child_src.shape[0]
    Pp = eng.Pp
    spec = specs[0]
    B = len(specs)
    if B * n_int * spec.C * spec.S * Pp > 4 * MAX_REVERSE_ELEMENTS:
        return None
    if dtype is None:
        dtype = jnp.float32 if epsilon >= 0.05 or             not jax.config.jax_enable_x64 else jnp.float64
    dtype = jnp.dtype(dtype)

    import contextlib
    with contextlib.ExitStack() as stack:
        # mirror try_fit: an explicit float64 request with global x64 off
        # would otherwise silently downcast every jnp.asarray to f32
        # while keeping the f64-tuned gtol (round-4 ADVICE.md item 2)
        if dtype == jnp.float64 and not jax.config.jax_enable_x64:
            stack.enter_context(jax.enable_x64(True))
        pk = eng.pack_np
        tip_table = jnp.asarray(pk.tip_table, dtype)
        tipP = jnp.swapaxes(tip_table[jnp.asarray(eng.tip_codes)], 1, 2)
        pw = jnp.asarray(eng.pattern_weights, dtype)
        P_real = eng.aln.num_patterns
        cm = np.zeros((Pp, spec.S))
        cm[:P_real] = eng.aln.const_state_mask()
        is_const = jnp.asarray(cm.sum(1) > 0)
        cmf_raw = jnp.asarray(cm, dtype)
        iu = np.triu_indices(spec.S, 1)
        dev_sched = {kk: jnp.asarray(v)
                     for kk, v in sched.to_device_arrays().items()
                     if kk in ("child_src", "child_edge", "step_node",
                               "edge_src")}
        n_steps = int(sched.step_node.shape[0])
        blens = np.clip(sched.blens, 1e-6, 10.0)
        logt0 = jnp.asarray(np.log(blens), dtype)

        key = key0 + ("batch",)
        _SPECS[key] = spec
        max_iters = 400 if epsilon < 0.05 else 30
        gtol = 0.05 if epsilon >= 0.05 else 1e-4
        if dtype == jnp.float32:
            gtol = max(gtol, 1e-2)
        x0B = jnp.asarray(np.stack([sp.x0 for sp in specs]))
        maskB = jnp.asarray(np.stack([
            np.concatenate([sp.mask, np.ones(len(blens))])
            for sp in specs]))
        CmatB = jnp.asarray(np.stack([sp.Cmat for sp in specs]), dtype)
        refB = jnp.asarray(np.stack([sp.ref_mask for sp in specs]), dtype)
        flagB = jnp.asarray(
            np.array([1.0 if sp.has_pinv else 0.0 for sp in specs]),
            dtype)
        xB, logtB, logLB, _ = _fit_batch_jit(
            x0B, logt0, maskB, CmatB, refB,
            jnp.asarray(iu[0]), jnp.asarray(iu[1]),
            tipP, dev_sched, pw, cmf_raw, is_const, flagB,
            jnp.asarray(max_iters), jnp.asarray(gtol, dtype),
            spec_key=key, n_steps=n_steps, k=spec.k, E=len(blens))
    out = []
    xB = np.asarray(xB, np.float64)
    logLB = np.asarray(logLB, np.float64)
    for i, sp in enumerate(specs):
        if np.isfinite(logLB[i]):
            _writeback(sp, xB[i])
            out.append(float(logLB[i]))
        else:
            out.append(float("nan"))
    return out


def try_fit(eng, tree, fix_model: bool = False, fix_rates: bool = False,
            fix_blens: bool = False, epsilon: float = 0.01,
            dtype=None, max_iters: int | None = None) -> float | None:
    """Joint device fit of (model params, branch lengths) on one topology.

    Returns the final logL (computed at the fit precision) and mutates the
    host model/rates/tree in place — or None when this (engine, model,
    rates) combination isn't supported by the JAX objective (caller then
    falls back to the host alternation loop).
    """
    from iqtree2_tpu.engine import LikelihoodEngine
    if type(eng) is not LikelihoodEngine or eng.asc:
        return None
    spec = build_spec(eng.model, eng.rates, fix_model=fix_model,
                      fix_rates=fix_rates)
    if spec is None:
        return None

    from iqtree2_tpu.tree.schedule import build_schedule, \
        write_blens_to_tree
    sched = build_schedule(tree)
    n_int = sched.child_src.shape[0]
    Pp = eng.Pp
    if n_int * spec.C * spec.S * Pp > MAX_REVERSE_ELEMENTS:
        return None

    if dtype is None:
        # thorough fits (final refit, fixed-topology runs) get float64;
        # screening fits (ModelFinder / search init, epsilon >= 0.05) are
        # faster in float32 and exact gradients keep them within
        # ~0.05 logL — far below any BIC selection gap
        dtype = jnp.float64 if epsilon < 0.05 else jnp.float32
    dtype = jnp.dtype(dtype)

    # The fit runs on the default device. x64 is SCOPED to the fit
    # (jax.enable_x64) so float64 fits work while the process-wide
    # precision policy (cli.py) keeps the likelihood in float32.
    import contextlib
    with contextlib.ExitStack() as stack:
        if dtype == jnp.float64 and not jax.config.jax_enable_x64:
            stack.enter_context(jax.enable_x64(True))
        return _run_fit(eng, tree, sched, spec, dtype, fix_model,
                        fix_rates, fix_blens, epsilon,
                        max_iters=max_iters)


def _run_fit(eng, tree, sched, spec, dtype, fix_model, fix_rates,
             fix_blens, epsilon, max_iters: int | None = None):
    from iqtree2_tpu.tree.schedule import write_blens_to_tree
    Pp = eng.Pp

    # fit-precision constants (independent of the engine's device arrays)
    pk = eng.pack_np
    tip_table = jnp.asarray(pk.tip_table, dtype)
    tipP = jnp.swapaxes(tip_table[jnp.asarray(eng.tip_codes)], 1, 2)
    pw = jnp.asarray(eng.pattern_weights, dtype)
    P_real = eng.aln.num_patterns
    cm = np.zeros((Pp, spec.S))
    cm[:P_real] = eng.aln.const_state_mask()
    is_const = jnp.asarray(cm.sum(1) > 0)
    cmf_raw = jnp.asarray(cm, dtype)
    iu = np.triu_indices(spec.S, 1)

    dev_sched = {kk: jnp.asarray(v)
                 for kk, v in sched.to_device_arrays().items()
                 if kk in ("child_src", "child_edge", "step_node",
                           "edge_src")}
    n_steps = int(sched.step_node.shape[0])

    blens = np.clip(sched.blens, 1e-6, 10.0)
    logt0 = jnp.asarray(np.log(blens), dtype)
    mask_full = np.concatenate(
        [spec.mask, np.full(len(blens), 0.0 if fix_blens else 1.0)])
    if not np.any(mask_full):
        return None                      # nothing to optimize

    key = spec.struct_key() + (bool(fix_model), bool(fix_rates))
    _SPECS[key] = spec
    # quick mode (model screening): L-BFGS converges the logL to well
    # under the selection granularity long before the gradient flattens
    if max_iters is None:
        max_iters = 400 if epsilon < 0.05 else 25
    gtol = 1e-4 if epsilon < 0.05 else 0.05
    if dtype == jnp.float32:
        gtol = max(gtol, 1e-2)

    x, logt, logL, n_iter = _fit_jit(
        jnp.asarray(spec.x0), logt0, jnp.asarray(mask_full),
        jnp.asarray(spec.Cmat, dtype), jnp.asarray(spec.ref_mask, dtype),
        jnp.asarray(iu[0]), jnp.asarray(iu[1]),
        tipP, dev_sched, pw, cmf_raw, is_const,
        jnp.asarray(1.0 if spec.has_pinv else 0.0, dtype),
        jnp.asarray(max_iters), jnp.asarray(gtol, dtype),
        spec_key=key, n_steps=n_steps, k=spec.k, E=len(blens))
    logL = float(logL)
    if not np.isfinite(logL):
        return None

    _writeback(spec, np.asarray(x, np.float64))
    new_blens = np.exp(np.asarray(logt, np.float64))
    write_blens_to_tree(tree, sched, np.clip(new_blens, 1e-6, 10.0))
    eng.refresh_model()
    return logL
