"""LikelihoodEngine: binds an Alignment + model + rate model to jitted
device computations over arbitrary topologies.

Host objects (Tree, SubstModel, RateModel) stay on the host; the engine
converts them to static-shaped arrays (schedule, ModelPack) and calls the
jitted kernels in ops/pruning.py. One engine instance serves many topologies
without recompilation (shapes depend only on ntaxa / pattern count).

Reference analog: PhyloTree (tree/phylotree.h:343) minus the search logic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from iqtree2_tpu.data.alignment import Alignment
from iqtree2_tpu.model.pack import ModelPack, build_model_pack
from iqtree2_tpu.ops import pruning
from iqtree2_tpu.tree.schedule import (TreeSchedule, build_schedule,
                                       write_blens_to_tree)
from iqtree2_tpu.tree.topology import Tree

DEFAULT_MIN_BLEN = 1e-6   # reference: min_branch_length (utils/tools.cpp)
DEFAULT_MAX_BLEN = 10.0   # reference: max_branch_length

# Device memory the fused search programs keep live per tree, counted in
# slabs of one node's partials ([C, S, Ppat]) per tree node, and per NNI
# candidate variant in evaluate_nnis5. From compiled.memory_analysis() on
# an H100 (tools/xla_probe.py; PERF.md): the batched NNI round 19.6 per
# node and tree, the serial one about 3 per node plus 11.3 per candidate
# variant, serial 10-round optimization 4.4 per node. The batched programs
# evaluate every backtracking step at once (vectorized=True), so they
# hold several whole passes per tree.
_BATCH_SLABS_PER_NODE = 24
_SERIAL_SLABS_PER_NODE = 5
_SLABS_PER_CANDIDATE = 12
_MEM_HEADROOM = 0.8       # share of the free device memory planned for


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ----------------------------------------------------------- jitted kernels
@functools.partial(jax.jit, static_argnames=())
def _loglik_jit(blens, tipP, sched, pack, pattern_weights):
    return pruning.tree_loglik(blens, tipP, sched, pack, pattern_weights)


@functools.partial(jax.jit, static_argnames=("n_rounds", "n_newton",
                                             "vectorized"))
def _optimize_blens_jit(blens, tipP, sched, pack, pattern_weights,
                        t_min, t_max, n_rounds: int, n_newton: int,
                        eps=1e-3, vectorized: bool = False):
    """Iterative all-branch Newton via theta buffers with global backtracking.

    Each round: down pass (cache msgs) + up pass -> thetas for every edge ->
    per-edge bounded Newton (parallel coordinate update) -> monotonicity
    backtracking on the joint update. Rounds stop early once a sweep gains
    less than ``eps`` logL. Reference analog: optimizeAllBranches sweeps
    (tree/phylotree.cpp:2689, tolerance exit) — here all branches update in
    parallel. vectorized=True selects the backtracking form for the
    vmapped multi-candidate programs (see _backtrack).
    """
    dtype = tipP.dtype

    def lg(b):
        return pruning.tree_loglik(b, tipP, sched, pack, pattern_weights)[0]

    def one_round(blens, logL_prev):
        P = pruning.transition_tensors(blens.astype(dtype), pack)
        dp, up = pruning.both_passes(P, tipP, sched, pack)
        th = pruning.edge_thetas(up, dp, sched["edge_src"], pack)
        newton = jax.vmap(
            lambda t_e, th_e, sc_e: pruning.newton_branch_step(
                th_e, sc_e, t_e, pack, pack["log_ptn_invar"],
                pattern_weights, t_min, t_max, n_iter=n_newton))
        prop = newton(blens.astype(dtype), th.theta, th.scale)
        prop = jnp.clip(prop, t_min, t_max)

        return _backtrack(lg, blens, prop, logL_prev,
                          vectorized=vectorized)

    return _sweep_until(lg, one_round, blens, n_rounds, eps)


def _backtrack(lg, blens_old, prop, logL_prev, n_halve: int = 4,
               vectorized: bool = False):
    """Monotonic acceptance of a joint Newton proposal: halve toward the
    old lengths (each halving behind lax.cond, so the converged/common
    case pays nothing) and keep the old state if all halvings fail
    (reference contract: optimizeAllBranches never worsens).

    vectorized=True evaluates ALL halving candidates in one batched
    logL call and picks the first acceptable — the form used inside the
    vmapped multi-candidate programs, where lax.cond lowers to select
    (both branches execute) and the sequential chain would cost
    n_halve+1 full evaluations of serialized latency."""
    if vectorized:
        cands = [prop]
        cur = prop
        for _ in range(n_halve):
            cur = 0.5 * (cur + blens_old)
            cands.append(cur)
        C = jnp.stack(cands)                # [H+1, E]
        ls = jax.vmap(lg)(C)                # [H+1]
        ok = ls >= logL_prev - 1e-9         # NaN-safe: NaN -> False
        idx = jnp.argmax(ok)                # first acceptable
        any_ok = jnp.any(ok)
        b = jnp.where(any_ok, C[idx], blens_old)
        l_new = jnp.where(any_ok, ls[idx], logL_prev)
        return b, l_new

    def halve(state):
        cur, _ = state
        cur = 0.5 * (cur + blens_old)
        return cur, lg(cur)

    state = (prop, lg(prop))
    for _ in range(n_halve):
        # NaN-safe: a NaN logL must keep backtracking
        state = jax.lax.cond(
            jnp.logical_not(state[1] >= logL_prev - 1e-9),
            halve, lambda s: s, state)
    prop, l_new = state
    worse = jnp.logical_not(l_new >= logL_prev - 1e-9)
    prop = jnp.where(worse, blens_old, prop)
    l_new = jnp.where(worse, logL_prev, l_new)
    return prop, l_new


def _sweep_until(lg, one_round, blens, n_rounds: int, eps):
    """Run optimizeAllBranches-style sweeps until the per-sweep logL gain
    drops below eps (reference tolerance exit, tree/phylotree.cpp:2689) or
    n_rounds is reached. Rounds are unrolled, each behind lax.cond, so the
    program has a static structure and a skipped round costs only its
    predicate."""
    l0 = lg(blens)
    state = (blens, l0, jnp.asarray(True))

    def go(s):
        b, l, _ = s
        nb, nl = one_round(b, l)
        return nb, nl, (nl - l) > eps

    for _ in range(n_rounds):
        state = jax.lax.cond(state[2], go, lambda s: s, state)
    return state[0], state[1]


@functools.partial(jax.jit, static_argnames=("n_rounds", "n_newton"))
def _optimize_blens_nonrev_jit(blens, tipP, sched, pack, pattern_weights,
                               t_min, t_max, n_rounds: int, n_newton: int,
                               eps=1e-3):
    """Branch Newton for nonreversible models: no eigenbasis theta trick;
    per-edge (down, out) partials feed direct bilinear derivatives through
    dP/dt = Q P (ops/pruning.py branch_lh_derivs_nonrev)."""
    dtype = tipP.dtype

    def lg(b):
        return pruning.tree_loglik(b, tipP, sched, pack, pattern_weights)[0]

    def one_round(blens, logL_prev):
        P = pruning.transition_tensors(blens.astype(dtype), pack)
        dp, up = pruning.both_passes(P, tipP, sched, pack)
        down, down_sc = pruning.edge_down_partials(dp, sched["edge_src"])
        scale = up.edge_E_scale + down_sc
        newton = jax.vmap(
            lambda t_e, d_e, o_e, sc_e: pruning.newton_branch_step_nonrev(
                d_e, o_e, sc_e, t_e, pack, pack["log_ptn_invar"],
                pattern_weights, t_min, t_max, n_iter=n_newton))
        prop = jnp.clip(newton(blens.astype(dtype), down, up.edge_E, scale),
                        t_min, t_max)
        return _backtrack(lg, blens, prop, logL_prev)

    return _sweep_until(lg, one_round, blens, n_rounds, eps)


@jax.jit
def _site_lp_jit(blens, tipP, sched, pack, pattern_weights):
    logL, lp = pruning.tree_loglik(blens, tipP, sched, pack, pattern_weights)
    return logL, lp


@jax.jit
def _passes_jit(blens, tipP, sched, pack, pattern_weights):
    """Down+up passes (for NNI eval / thetas)."""
    dtype = tipP.dtype
    P = pruning.transition_tensors(blens.astype(dtype), pack)
    dp, up = pruning.both_passes(P, tipP, sched, pack)
    n_int = sched["child_src"].shape[0]
    Broot, SCroot = pruning.root_partial(dp, P, tipP, n_int)
    logL, _ = pruning.root_loglik(Broot, SCroot,
                                  pack["root_freqs"], pack["cat_weight"],
                                  pack["log_ptn_invar"], pattern_weights,
                                  asc_mask=pack.get("asc_mask"),
                                  asc_nsites=pack.get("asc_nsites"))
    return dp, up, logL


HIGHEST_P = jax.lax.Precision.HIGHEST


@jax.jit
def _pack_flat(arrs):
    dt = jnp.result_type(*[a.dtype for a in arrs])
    return jnp.concatenate([a.reshape(-1).astype(dt) for a in arrs])


@functools.partial(jax.jit, static_argnames=("shapes",))
def _unpack_ints(flat, shapes=None):
    """Split ONE uploaded int32 buffer into the schedule arrays: a
    topology's schedule rides one host-to-device transfer and one
    execution instead of one transfer per array."""
    out = []
    off = 0
    for shp in shapes:
        n = int(np.prod(shp)) if len(shp) else 1
        out.append(flat[off:off + n].reshape(shp))
        off += n
    return tuple(out)


def _pull(out):
    """ONE blocking device->host fetch for a tuple of device arrays:
    concatenated in-graph, so every engine call synchronizes once."""
    if not isinstance(out, (tuple, list)):
        return np.asarray(out)
    flat = np.asarray(_pack_flat(tuple(out)))
    res = []
    off = 0
    for a in out:
        n = int(np.prod(a.shape)) if a.ndim else 1
        res.append(flat[off:off + n].reshape(a.shape))
        off += n
    return tuple(res)


@jax.jit
def _asr_jit(blens, tipP, sched, pack, pattern_weights):
    """Marginal ancestral-state posteriors at every internal node, plus the
    per-pattern rate-category posterior at the root.

    Reference analog: computeMarginalAncestralState (tree/phylotree.h:1069):
    posterior(node, state) ∝ Σ_c w_c · down(node,c,s,p) · up(node,c,s,p).
    """
    dtype = tipP.dtype
    P = pruning.transition_tensors(blens.astype(dtype), pack)
    dp, up = pruning.both_passes(P, tipP, sched, pack)
    L = tipP.shape[0]
    n_int = sched["child_src"].shape[0]
    w = pack["cat_weight"]
    joint = dp.all[L:] * up.up_in                      # [n_int, C, S, Pp]
    post = jnp.einsum("c,ncsp->nsp", w, joint, precision=HIGHEST_P)
    post = post / jnp.maximum(post.sum(axis=1, keepdims=True),
                              jnp.finfo(dtype).tiny)
    # rate-category posterior at the root (for .rate site rates)
    Broot, _ = pruning.root_partial(dp, P, tipP, n_int)
    lh_cat = jnp.einsum("cx,cxp->cp", pack["root_freqs"], Broot,
                        precision=HIGHEST_P)
    cat_post = w[:, None] * lh_cat
    cat_post = cat_post / jnp.maximum(cat_post.sum(axis=0, keepdims=True),
                                      jnp.finfo(dtype).tiny)
    return post, cat_post


@functools.partial(jax.jit, static_argnames=("return_site_lp", "nonrev",
                                             "nni5"))
def _nni_batch_flat_jit(cand, blens, tipP, sched, pack, pw, t_min, t_max,
                        return_site_lp: bool = False, nonrev: bool = False,
                        nni5: bool = False):
    """Down+up passes + NNI candidate scoring in ONE program, returning
    ONE flat array (single upload chain, single blocking fetch; see
    _pull)."""
    from iqtree2_tpu.ops.nni import evaluate_nnis, evaluate_nnis5
    dtype = tipP.dtype
    P = pruning.transition_tensors(blens.astype(dtype), pack)
    dp, up = pruning.both_passes(P, tipP, sched, pack)
    if nni5:
        out = evaluate_nnis5(cand, blens, dp, up, sched, pack, pw,
                             t_min, t_max, return_site_lp=return_site_lp,
                             nonrev=nonrev)
    else:
        out = evaluate_nnis(cand, blens, dp, up.up_in, up.up_scale, sched,
                            pack, pw, t_min, t_max,
                            return_site_lp=return_site_lp, nonrev=nonrev)
    return jnp.concatenate([o.reshape(-1).astype(dtype) for o in out])


_OPT_KINDS = {"std": _optimize_blens_jit,
              "nonrev": _optimize_blens_nonrev_jit}


@functools.partial(jax.jit, static_argnames=("kind", "n_rounds", "n_newton",
                                             "nni5", "nonrev", "want_lp",
                                             "vectorized", "cand_chunk"))
def _opt_nni_flat_jit(cand, blens, tipP, sched, pack, pw, t_min, t_max,
                      kind: str = "std", n_rounds: int = 4,
                      n_newton: int = 4, nni5: bool = False,
                      nonrev: bool = False, want_lp: bool = False,
                      vectorized: bool = False,
                      cand_chunk: int | None = None):
    """One fused NNI-round program: all-branch optimization, down+up
    passes on the OPTIMIZED lengths, NNI candidate scoring, and
    (optionally) the optimized tree's per-pattern log-likelihoods —
    one dispatch, one flat output, ONE blocking fetch (reference
    analog: optimizeAllBranches + evaluateNNIs inside one doNNISearch
    round, tree/iqtree.cpp:2998)."""
    from iqtree2_tpu.ops.nni import evaluate_nnis, evaluate_nnis5
    dtype = tipP.dtype
    if kind == "std":
        nb, logL = _optimize_blens_jit(blens, tipP, sched, pack, pw,
                                       t_min, t_max, n_rounds, n_newton,
                                       vectorized=vectorized)
    else:
        nb, logL = _OPT_KINDS[kind](blens, tipP, sched, pack, pw,
                                    t_min, t_max, n_rounds, n_newton)
    P = pruning.transition_tensors(nb.astype(dtype), pack)
    dp, up = pruning.both_passes(P, tipP, sched, pack)
    if nni5:
        out = evaluate_nnis5(cand, nb.astype(dtype), dp, up, sched, pack,
                             pw, t_min, t_max, nonrev=nonrev,
                             cand_chunk=cand_chunk)
    else:
        out = evaluate_nnis(cand, nb.astype(dtype), dp, up.up_in,
                            up.up_scale, sched, pack, pw, t_min, t_max,
                            nonrev=nonrev)
    parts = [nb.reshape(-1), logL.reshape(1)]
    parts += [o.reshape(-1).astype(dtype) for o in out]
    if want_lp:
        n_int = sched["child_src"].shape[0]
        Broot, SCroot = pruning.root_partial(dp, P, tipP, n_int)
        _, lp = pruning.root_loglik(
            Broot, SCroot, pack["root_freqs"], pack["cat_weight"],
            pack["log_ptn_invar"], pw, asc_mask=pack.get("asc_mask"),
            asc_nsites=pack.get("asc_nsites"))
        parts.append(lp.reshape(-1).astype(dtype))
    return jnp.concatenate(parts)


@functools.partial(jax.jit, static_argnames=("kind", "n_rounds",
                                             "n_newton"))
def _opt_flat_jit(blens, tipP, sched, pack, pw, t_min, t_max,
                  kind: str = "std", n_rounds: int = 10,
                  n_newton: int = 4):
    """Branch optimization returning concat([new_blens, logL]) — one
    program, one pull."""
    fn = _OPT_KINDS[kind]
    nb, logL = fn(blens, tipP, sched, pack, pw, t_min, t_max,
                  n_rounds, n_newton)
    return jnp.concatenate([nb.reshape(-1), logL.reshape(1)])


@functools.partial(jax.jit, static_argnames=("n_rounds", "n_newton",
                                             "nni5", "nonrev", "want_lp"))
def _opt_nni_flat_batch_jit(cand, blens, tipP, sched, pack, pw, t_min,
                            t_max, n_rounds: int = 4, n_newton: int = 4,
                            nni5: bool = False, nonrev: bool = False,
                            want_lp: bool = False):
    """K lockstep fused NNI rounds in ONE program: vmap over
    (candidates, branch lengths, schedule arrays) of K same-size
    topologies; model/tip arrays broadcast. One dispatch + one fetch
    scores K whole perturb+NNI iterations (reference analog: the
    MPI-parallel candidate iterations of tree/iqtree.cpp:2196)."""
    def one(c, b, sd):
        return _opt_nni_flat_jit(c, b, tipP, sd, pack, pw, t_min, t_max,
                                 kind="std", n_rounds=n_rounds,
                                 n_newton=n_newton, nni5=nni5,
                                 nonrev=nonrev, want_lp=want_lp,
                                 vectorized=True)
    return jax.vmap(one)(cand, blens, sched)


@functools.partial(jax.jit, static_argnames=("n_rounds", "n_newton"))
def _opt_flat_batch_jit(blens, tipP, sched, pack, pw, t_min, t_max,
                        n_rounds: int = 4, n_newton: int = 4):
    """K branch optimizations in one program (start-tree screening)."""
    def one(b, sd):
        nb, logL = _optimize_blens_jit(b, tipP, sd, pack, pw, t_min,
                                       t_max, n_rounds, n_newton,
                                       vectorized=True)
        return jnp.concatenate([nb.reshape(-1), logL.reshape(1)])
    return jax.vmap(one)(blens, sched)


class LikelihoodEngine:
    def __init__(self, aln: Alignment, model, rates, dtype=jnp.float32,
                 pattern_pad: int = 128, asc: bool = False):
        self.aln = aln
        self.model = model
        self.rates = rates
        self.dtype = jnp.dtype(dtype)
        self.asc = asc

        P = aln.num_patterns
        S = aln.num_states
        # +ASC appends S weight-0 pseudo-patterns (one constant column per
        # state) whose likelihoods feed the Lewis correction
        needed = P + (S if asc else 0)
        self.Pp = _round_up(max(needed, 1), pattern_pad)
        pad = self.Pp - P

        codes = aln.tip_codes()  # [L, P]
        unk = aln.seqtype.unknown_code
        self.tip_codes = np.pad(codes, ((0, 0), (0, pad)),
                                constant_values=unk)
        if asc:
            definite = np.nonzero(
                aln.seqtype.tip_table.sum(1) == 1.0)[0]
            state_code = np.full(S, unk, dtype=np.int64)
            for c in definite:
                state_code[aln.seqtype.tip_table[c].argmax()] = c
            for x in range(S):
                self.tip_codes[:, P + x] = state_code[x]
        self.pattern_weights = np.pad(
            aln.pattern_weights.astype(np.float64), (0, pad))
        self._dev_pw = jnp.asarray(self.pattern_weights, dtype=self.dtype)

        self.pack_np: ModelPack | None = None
        self._dev_pack = None
        self._dev_tipP = None
        self.refresh_model()

    # ----------------------------------------------------------- model mgmt
    def refresh_model(self) -> None:
        """Rebuild the ModelPack after model/rate parameter changes."""
        if not hasattr(self, "_sched_arrays_cache"):
            self._sched_arrays_cache = {}
        pk = build_model_pack(self.aln, self.model, self.rates)
        pad = self.Pp - self.aln.num_patterns
        log_inv = np.pad(pk.log_ptn_invar, (0, pad),
                         constant_values=-np.inf)
        self.pack_np = pk
        d = self.dtype
        self._dev_pack = dict(
            eigvals=jnp.asarray(pk.eigvals, d),
            U=jnp.asarray(pk.U, d),
            V=jnp.asarray(pk.V, d),
            W=None if pk.W is None else jnp.asarray(pk.W, d),
            sqrt_freqs=None if pk.sqrt_freqs is None
            else jnp.asarray(pk.sqrt_freqs, d),
            cat_rate=jnp.asarray(pk.cat_rate, d),
            cat_weight=jnp.asarray(pk.cat_weight, d),
            cat_mix=jnp.asarray(pk.cat_mix, jnp.int32),
            Q=None if pk.Q is None else jnp.asarray(pk.Q, d),
            root_freqs=jnp.asarray(pk.root_freqs, d),
            log_ptn_invar=jnp.asarray(log_inv, d),
        )
        if self.asc:
            P = self.aln.num_patterns
            S = self.aln.num_states
            mask = np.zeros(self.Pp)
            mask[P: P + S] = 1.0
            self._dev_pack["asc_mask"] = jnp.asarray(mask, d)
            self._dev_pack["asc_nsites"] = jnp.asarray(
                self.aln.pattern_weights.sum(), d)
        tip_table = jnp.asarray(pk.tip_table, d)
        tipP = pruning.tip_partials(jnp.asarray(self.tip_codes), tip_table)
        self._dev_tipP = tipP

    def with_pattern_weights(self, weights: np.ndarray
                             ) -> "LikelihoodEngine":
        """Shallow view of this engine with different pattern weights
        (bootstrap-replicate refinement; shares device model arrays)."""
        import copy
        view = copy.copy(self)
        w = np.zeros(self.Pp)
        w[: len(weights)] = weights
        view.pattern_weights = w
        view._dev_pw = jnp.asarray(w, self.dtype)
        return view

    # ------------------------------------------------------------- schedule
    def schedule_arrays(self, sched: TreeSchedule) -> dict:
        # Schedule arrays depend only on the topology, so repeated
        # evaluations of the same tree — every fixed-topology model refit,
        # each optimizer call — reuse the device copies.
        key = getattr(sched, "_arrays_key", None)
        if key is None:
            import hashlib
            h = hashlib.blake2b(digest_size=16)
            h.update(sched.child_src.tobytes())
            h.update(sched.child_edge.tobytes())
            h.update(sched.step_node.tobytes())
            h.update(sched.edge_src.tobytes())
            key = h.digest()
            sched._arrays_key = key
        cache = self._sched_arrays_cache
        hit = cache.get(key)
        if hit is not None:
            return hit
        # collect every int array on the host first, ship them as ONE
        # upload, and split on device (_unpack_ints)
        np_items = list(sched.to_device_arrays().items())
        flat = np.concatenate(
            [np.asarray(a, np.int32).ravel() for _, a in np_items])
        shapes = tuple(tuple(np.asarray(a).shape) for _, a in np_items)
        devs = _unpack_ints(jnp.asarray(flat), shapes=shapes)
        d = dict(zip([k for k, _ in np_items], devs))
        if len(cache) >= 32:     # bound memory: drop the oldest entry
            cache.pop(next(iter(cache)))
        cache[key] = d
        return d

    def _dev_scalar(self, v):
        """Cached device scalar (t_min/t_max constants would otherwise
        cost one host-to-device transfer per engine call)."""
        if not hasattr(self, "_scalar_cache"):
            self._scalar_cache = {}
        key = float(v)
        hit = self._scalar_cache.get(key)
        if hit is None:
            hit = jnp.asarray(v, self.dtype)
            self._scalar_cache[key] = hit
        return hit

    # ------------------------------------------------------------ main API
    def loglik_tree(self, tree: Tree) -> float:
        sched = build_schedule(tree)
        return self.loglik_sched(sched)

    def loglik_sched(self, sched: TreeSchedule) -> float:
        logL, _ = _loglik_jit(jnp.asarray(sched.blens, self.dtype),
                              self._dev_tipP,
                              self.schedule_arrays(sched),
                              self._dev_pack, self._dev_pw)
        return float(logL)

    def site_lp(self, tree: Tree) -> tuple[float, np.ndarray]:
        """(logL, per-pattern log-likelihood [num_patterns])."""
        sched = build_schedule(tree)
        logL, lp = _pull(_site_lp_jit(
            jnp.asarray(sched.blens, self.dtype), self._dev_tipP,
            self.schedule_arrays(sched), self._dev_pack, self._dev_pw))
        return float(logL), lp[: self.aln.num_patterns]

    def compute_passes(self, sched: TreeSchedule):
        """(DownPass, UpPass, logL) device buffers for one topology.

        logL stays ON DEVICE: a host conversion would force a blocking
        device-to-host transfer that NNI evaluation — the main caller —
        never needs."""
        dp, up, logL = _passes_jit(jnp.asarray(sched.blens, self.dtype),
                                   self._dev_tipP,
                                   self.schedule_arrays(sched),
                                   self._dev_pack, self._dev_pw)
        return dp, up, logL

    def ancestral_posteriors(self, tree: Tree):
        """(posteriors [n_int, S, P], postorder internal node ids, sched).

        Marginal ASR (reference: -asr, SURVEY A10)."""
        sched = build_schedule(tree)
        post, _ = _asr_jit(jnp.asarray(sched.blens, self.dtype),
                           self._dev_tipP, self.schedule_arrays(sched),
                           self._dev_pack, self._dev_pw)
        P = self.aln.num_patterns
        return (np.asarray(post)[:, :, :P], list(sched.postorder_nodes),
                sched)

    def site_rate_posterior(self, tree: Tree):
        """(mean posterior rate per pattern [P], category posterior [C, P]).

        Reference analog: the .rate output (empirical Bayes site rates)."""
        sched = build_schedule(tree)
        _, cat_post = _asr_jit(jnp.asarray(sched.blens, self.dtype),
                               self._dev_tipP, self.schedule_arrays(sched),
                               self._dev_pack, self._dev_pw)
        P = self.aln.num_patterns
        cat_post = np.asarray(cat_post)[:, :P]
        rates = np.asarray(self.pack_np.cat_rate)
        mean_rate = rates @ cat_post
        return mean_rate, cat_post

    def _free_device_slabs(self) -> float | None:
        """Free device memory in [C, S, Ppat] partial slabs, with
        headroom; None where the device reports no memory limit (the
        CPU backend)."""
        dev = next(iter(self._dev_tipP.devices()))
        stats = dev.memory_stats() or {}
        if "bytes_limit" not in stats:
            return None
        slab = (self.pack_np.cat_rate.shape[0] * self.aln.num_states
                * self.Pp * self.dtype.itemsize)
        free = stats["bytes_limit"] - stats.get("bytes_in_use", 0)
        return _MEM_HEADROOM * free / slab

    def batch_limit(self, k: int) -> int:
        """How many of k same-size trees one batched (vmapped) search
        program may hold in device memory; 1 means run them one by one."""
        free = self._free_device_slabs()
        if free is None:
            return k
        n_nodes = 2 * self.tip_codes.shape[0] - 2
        return max(1, min(k, int(free // (_BATCH_SLABS_PER_NODE
                                          * n_nodes))))

    def nni_cand_chunk(self) -> int | None:
        """NNI candidates that one tree's fused NNI round (serial
        program) scores at once: all (None) when they fit the device
        memory, else a power of two that does."""
        free = self._free_device_slabs()
        if free is None:
            return None
        L = self.tip_codes.shape[0]
        spare = free - _SERIAL_SLABS_PER_NODE * (2 * L - 2)
        per_cand = 3 * _SLABS_PER_CANDIDATE
        if spare >= (L - 3) * per_cand:
            return None
        return 1 << max(0, int(max(spare, 1) // per_cand).bit_length() - 1)

    def evaluate_nni_batch(self, sched, cand_arrays,
                           t_min: float = DEFAULT_MIN_BLEN,
                           t_max: float = DEFAULT_MAX_BLEN,
                           return_site_lp: bool = False,
                           nni5: bool = False):
        """Score all NNI candidates (both variants + baseline) in one jitted
        batch. Returns (logl [n,3], t_opt [n,3]) numpy arrays; with
        return_site_lp also the per-pattern logLs [n, 3, num_patterns].

        nni5=True re-optimizes all five branches around each candidate
        (reference: getBestNNIForBran NNI5 mode, tree/phylotree.cpp:4058)
        and additionally returns t5 [n, 3, 5] optimized lengths for the
        (a, b, c, d, e) branches — for reversible (eigenbasis theta) AND
        nonreversible (direct expm derivative) models."""
        n = int(cand_arrays.shape[1]) if not isinstance(
            cand_arrays, (tuple, list)) else len(cand_arrays[0])
        flat = np.asarray(_nni_batch_flat_jit(
            cand_arrays, jnp.asarray(sched.blens, self.dtype),
            self._dev_tipP, self.schedule_arrays(sched), self._dev_pack,
            self._dev_pw, self._dev_scalar(t_min), self._dev_scalar(t_max),
            return_site_lp=return_site_lp,
            nonrev=self._dev_pack.get("Q") is not None, nni5=nni5))
        shapes = [(n, 3), (n, 3)]
        if nni5:
            shapes.append((n, 3, 5))
        if return_site_lp:
            shapes.append((n, 3, self.Pp))
        parts = []
        off = 0
        for shp in shapes:
            cnt = int(np.prod(shp))
            parts.append(flat[off:off + cnt].reshape(shp))
            off += cnt
        if return_site_lp:
            parts[-1] = parts[-1][:, :, : self.aln.num_patterns]
        return tuple(parts)

    def _opt_kind(self) -> str:
        return "nonrev" if self._dev_pack.get("Q") is not None else "std"

    def optimize_and_evaluate_nnis(self, tree, sched, cand_arrays,
                                   n_rounds: int = 4,
                                   t_min: float = DEFAULT_MIN_BLEN,
                                   t_max: float = DEFAULT_MAX_BLEN,
                                   nni5: bool = False,
                                   want_lp: bool = False):
        """Fused NNI round: optimize all branches (written back into
        ``tree``), then score every NNI candidate at the optimized
        lengths — one dispatch, one pull (see _opt_nni_flat_jit).

        Returns (opt_logL, logl [n,3], t_opt [n,3][, t5 [n,3,5]]
        [, site_lp [num_patterns]])."""
        from iqtree2_tpu.tree.schedule import write_blens_to_tree
        n = int(cand_arrays.shape[1])
        blens = jnp.asarray(np.maximum(sched.blens, t_min), self.dtype)
        sa = self.schedule_arrays(sched)
        nonrev = self._dev_pack.get("Q") is not None
        flat = np.asarray(_opt_nni_flat_jit(
            cand_arrays, blens, self._dev_tipP, sa, self._dev_pack,
            self._dev_pw, self._dev_scalar(t_min), self._dev_scalar(t_max),
            kind=self._opt_kind(), n_rounds=n_rounds, nni5=nni5,
            nonrev=nonrev, want_lp=want_lp,
            cand_chunk=self.nni_cand_chunk() if nni5 else None), np.float64)
        nb = flat[: len(sched.blens)]
        write_blens_to_tree(tree, sched, nb)
        sched.blens[:] = nb
        off = len(sched.blens)
        opt_logL = float(flat[off]); off += 1
        shapes = [(n, 3), (n, 3)] + ([(n, 3, 5)] if nni5 else [])
        outs = []
        for shp in shapes:
            cnt = int(np.prod(shp))
            outs.append(flat[off:off + cnt].reshape(shp))
            off += cnt
        if want_lp:
            outs.append(flat[off:off + self.Pp][: self.aln.num_patterns])
        return (opt_logL, *outs)

    def _stack_scheds(self, scheds) -> dict:
        """Stack K same-size topologies' schedule arrays for the batched
        (vmapped) programs. step_node's level count varies by topology (bucketed to multiples of 4): pad every
        tree to the batch max with n_int rows (the scatter-drop padding
        value), so one compiled batch program serves all topologies."""
        sas = [self.schedule_arrays(s) for s in scheds]
        n_int = scheds[0].n_int
        max_steps = max(sa["step_node"].shape[0] for sa in sas)
        max_steps = -(-max_steps // 8) * 8    # one bucket per 8 levels
        out = {}
        for k in sas[0]:
            arrs = [sa[k] for sa in sas]
            if k == "step_node":
                arrs = [jnp.pad(a, ((0, max_steps - a.shape[0]), (0, 0)),
                                constant_values=n_int) for a in arrs]
            out[k] = jnp.stack(arrs)
        return out

    def optimize_and_evaluate_nnis_batch(self, trees, scheds, cand_list,
                                         n_rounds: int = 4,
                                         t_min: float = DEFAULT_MIN_BLEN,
                                         t_max: float = DEFAULT_MAX_BLEN,
                                         nni5: bool = False,
                                         want_lp: bool = False):
        """Fused NNI round for K trees in ONE dispatch + ONE pull.

        Same contract as optimize_and_evaluate_nnis, per tree: writes
        optimized lengths back into trees[k]/scheds[k] and returns a
        list of (opt_logL, logl [n,3], t_opt [n,3][, t5][, lp])."""
        from iqtree2_tpu.tree.schedule import write_blens_to_tree
        K = len(trees)
        # candidate counts can differ per topology: pad to the widest
        # (duplicating row 0) and truncate each tree's outputs back to
        # its true count below
        ns = [int(c.shape[1]) for c in cand_list]
        n = max(max(ns), 1)
        nonrev = self._dev_pack.get("Q") is not None

        def _pad(c):
            if c.shape[1] == n:
                return np.asarray(c)
            if c.shape[1] == 0:
                return np.zeros((c.shape[0], n), c.dtype)
            return np.concatenate(
                [c, np.repeat(c[:, :1], n - c.shape[1], axis=1)], axis=1)
        cand = jnp.asarray(np.stack([_pad(np.asarray(c))
                                     for c in cand_list]))
        blens = jnp.stack([
            jnp.asarray(np.maximum(s.blens, t_min), self.dtype)
            for s in scheds])
        sd = self._stack_scheds(scheds)
        out = np.asarray(_opt_nni_flat_batch_jit(
            cand, blens, self._dev_tipP, sd, self._dev_pack, self._dev_pw,
            self._dev_scalar(t_min), self._dev_scalar(t_max),
            n_rounds=n_rounds, nni5=nni5, nonrev=nonrev,
            want_lp=want_lp), np.float64)
        results = []
        nE = len(scheds[0].blens)
        for k in range(K):
            flat = out[k]
            nb = flat[:nE]
            write_blens_to_tree(trees[k], scheds[k], nb)
            scheds[k].blens[:] = nb
            off = nE
            opt_logL = float(flat[off]); off += 1
            shapes = [(n, 3), (n, 3)] + ([(n, 3, 5)] if nni5 else [])
            outs = []
            for shp in shapes:
                cnt = int(np.prod(shp))
                outs.append(flat[off:off + cnt].reshape(shp)[:ns[k]])
                off += cnt
            if want_lp:
                outs.append(flat[off:off + self.Pp]
                            [: self.aln.num_patterns])
            results.append((opt_logL, *outs))
        return results

    def optimize_branches_batch(self, trees, n_rounds: int = 4,
                                n_newton: int = 4,
                                t_min: float = DEFAULT_MIN_BLEN,
                                t_max: float = DEFAULT_MAX_BLEN):
        """Branch-optimize K same-size trees in ONE dispatch; returns
        their logLs (lengths written back in place). Where K trees do
        not fit the device memory, in groups that do, or one by one."""
        from iqtree2_tpu.tree.schedule import write_blens_to_tree
        g = self.batch_limit(len(trees))
        if g < len(trees):
            if g == 1:
                return [self.optimize_branches(t, n_rounds, n_newton,
                                               t_min, t_max) for t in trees]
            return [lL for i in range(0, len(trees), g)
                    for lL in self.optimize_branches_batch(
                        trees[i:i + g], n_rounds, n_newton, t_min, t_max)]
        scheds = [build_schedule(t) for t in trees]
        blens = jnp.stack([
            jnp.asarray(np.maximum(s.blens, t_min), self.dtype)
            for s in scheds])
        sd = self._stack_scheds(scheds)
        out = np.asarray(_opt_flat_batch_jit(
            blens, self._dev_tipP, sd, self._dev_pack, self._dev_pw,
            self._dev_scalar(t_min), self._dev_scalar(t_max),
            n_rounds=n_rounds, n_newton=n_newton), np.float64)
        logLs = []
        for k, (t, s) in enumerate(zip(trees, scheds)):
            write_blens_to_tree(t, s, out[k, :-1])
            logLs.append(float(out[k, -1]))
        return logLs

    def optimize_branches(self, tree: Tree, n_rounds: int = 10,
                          n_newton: int = 4,
                          t_min: float = DEFAULT_MIN_BLEN,
                          t_max: float = DEFAULT_MAX_BLEN) -> float:
        """Optimize all branch lengths in place on the host tree."""
        sched = build_schedule(tree)
        blens = jnp.asarray(np.maximum(sched.blens, t_min), self.dtype)
        sa = self.schedule_arrays(sched)
        flat = np.asarray(_opt_flat_jit(
            blens, self._dev_tipP, sa, self._dev_pack, self._dev_pw,
            self._dev_scalar(t_min), self._dev_scalar(t_max),
            kind=self._opt_kind(), n_rounds=n_rounds, n_newton=n_newton), np.float64)
        write_blens_to_tree(tree, sched, flat[:-1])
        return float(flat[-1])
