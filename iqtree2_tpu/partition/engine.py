"""PartitionEngine: partitioned-supermatrix likelihood on one shared tree.

Reference analogs: PhyloSuperTree (tree/phylosupertree.h:57, partition-
parallel likelihood :701-777), PhyloSuperTreePlen (edge-linked proportional
partitions, tree/phylosupertreeplen.h:38), PhyloSuperTreeUnlinked, and
PartitionModel/PartitionModelPlen (model/partitionmodel.cpp).

Design: all partitions share one tree schedule (the supermatrix
union taxon set — see data/superalignment.py), so one jitted program handles
every partition; the partition loop is unrolled *inside* jit (static K) and
XLA overlaps the per-partition einsum pipelines. Branch-length Newton is
joint: per-edge derivatives are summed across partitions through the chain
rule of the per-partition rate multiplier (edge-proportional mode) —
d/dt logL = sum_k r_k * dlogL_k/dt_k evaluated at t_k = r_k t.

Three linkage modes (CLI -q / -p(-spp) / -Q):
  edge-equal:        one branch-length vector, r_k == 1
  edge-proportional: one branch-length vector, free per-partition scalar r_k
  unlinked:          per-partition branch-length vectors on the shared
                     topology (optimized independently, summed logL)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from iqtree2_tpu.data.superalignment import SuperAlignment
from iqtree2_tpu.engine import (DEFAULT_MAX_BLEN, DEFAULT_MIN_BLEN,
                                LikelihoodEngine)
from iqtree2_tpu.ops import pruning
from iqtree2_tpu.tree.schedule import (build_schedule, write_blens_to_tree)
from iqtree2_tpu.tree.topology import Tree

HIGHEST = jax.lax.Precision.HIGHEST


# ------------------------------------------------------- jitted multi-kernels
@jax.jit
def _multi_loglik(blens_k, parts, scheds_shared, pws):
    """blens_k: [K?] list of per-partition effective blens [E]; parts: tuple
    of (tipP, pack); returns (total logL, tuple of per-pattern lp)."""
    total = 0.0
    lps = []
    for bl, (tipP, pack), pw in zip(blens_k, parts, pws):
        logL, lp = pruning.tree_loglik(bl, tipP, scheds_shared, pack, pw)
        total = total + logL
        lps.append(lp)
    return total, tuple(lps)


def _joint_newton(thetas, scales, t0, packs, pws, rks, t_min, t_max,
                  n_iter: int):
    """Bounded Newton on one shared branch length with derivatives summed
    over partitions (chain rule through the per-partition rate scalar)."""
    def one(i, t):
        d1 = 0.0
        d2 = 0.0
        for th, sc, pack, pw, rk in zip(thetas, scales, packs, pws, rks):
            _, d1k, d2k = pruning.branch_lh_derivs(
                th, sc, t * rk, pack, pack["log_ptn_invar"], pw)
            d1 = d1 + rk * d1k
            d2 = d2 + rk * rk * d2k
        newton_t = t - d1 / d2
        bad = (d2 >= 0) | ~jnp.isfinite(newton_t)
        fallback = jnp.where(d1 > 0, jnp.minimum(t * 4.0, t_max),
                             jnp.maximum(t * 0.25, t_min))
        return jnp.where(bad, fallback, jnp.clip(newton_t, t_min, t_max))
    return jax.lax.fori_loop(0, n_iter, one, t0)


@functools.partial(jax.jit, static_argnames=("n_rounds", "n_newton"))
def _multi_opt_blens(blens, rks, parts, sched, pws, t_min, t_max,
                     n_rounds: int, n_newton: int):
    """Joint all-branch Newton over linked partitions (one shared blens)."""
    dtype = parts[0][0].dtype
    rks_t = [jnp.asarray(r, dtype) for r in rks]

    def lg(b):
        tot = 0.0
        for (tipP, pack), pw, rk in zip(parts, pws, rks_t):
            tot = tot + pruning.tree_loglik(b * rk, tipP, sched, pack, pw)[0]
        return tot

    def one_round(carry, _):
        blens, logL_prev = carry
        thetas, scales, packs = [], [], []
        for (tipP, pack), rk in zip(parts, rks_t):
            P = pruning.transition_tensors((blens * rk).astype(dtype), pack)
            dp = pruning.down_pass(P, tipP, sched)
            up = pruning.up_pass(P, dp, tipP, sched, pack["root_freqs"])
            th = pruning.edge_thetas(up, dp, sched["edge_src"], pack)
            thetas.append(th.theta)
            scales.append(th.scale)
            packs.append(pack)

        newton = jax.vmap(
            lambda t_e, ths, scs: _joint_newton(
                ths, scs, t_e, packs, pws, rks_t, t_min, t_max, n_newton),
            in_axes=(0, 0, 0))
        prop = newton(blens.astype(dtype), tuple(thetas), tuple(scales))
        prop = jnp.clip(prop, t_min, t_max)

        def body(state):
            cur, _, k = state
            cur = 0.5 * (cur + blens)
            return cur, lg(cur), k + 1

        def cond(state):
            cur, lcur, k = state
            return (lcur < logL_prev - 1e-9) & (k < 4)

        l_prop = lg(prop)
        prop, l_new, _ = jax.lax.while_loop(
            cond, body, (prop, l_prop, jnp.zeros((), jnp.int32)))
        return (prop, l_new), l_new

    l0 = lg(blens)
    (blens, logL), _ = jax.lax.scan(one_round, (blens, l0), None,
                                    length=n_rounds)
    return blens, logL


@functools.partial(jax.jit, static_argnames=("n_newton", "return_site_lp"))
def _multi_nni_eval(cand_arrays, blens, rks, buffers, packs, pws, sched,
                    t_min, t_max, n_newton: int = 4,
                    return_site_lp: bool = False):
    """Joint NNI scoring across linked partitions.

    buffers: tuple of (DownPass, up_in, up_scale, P) per partition.
    Returns (logl [n,3], t_opt [n,3]); the central branch of every variant is
    re-optimized jointly over partitions (reference analog:
    PhyloSuperTreePlen NNI bookkeeping, tree/phylosupertreeplen.cpp).
    """
    iu, iv, sc_, eid = cand_arrays
    dtype = buffers[0][0].all.dtype
    rks_t = [jnp.asarray(r, dtype) for r in rks]
    child_src = sched["child_src"]
    child_edge = sched["child_edge"]

    def one(iu_, iv_, sc__, eid_):
        t0 = blens[eid_]
        # per-partition theta buffers for the three variants
        var_thetas = [[], [], []]
        var_scales = [[], [], []]
        for (dp, up_in, up_sc, P), pack in zip(buffers, packs):
            m_a, s_a = pruning.gather_messages(dp, P, child_src[iu_, 0],
                                               child_edge[iu_, 0])
            m_b, s_b = pruning.gather_messages(dp, P, child_src[iu_, 1],
                                               child_edge[iu_, 1])
            m_c, s_c = pruning.gather_messages(dp, P, child_src[iv_, sc__],
                                               child_edge[iv_, sc__])
            rest = up_in[iv_]
            s_rest = up_sc[iv_]
            Uc = pack["U"][pack["cat_mix"]]
            Vc = pack["V"][pack["cat_mix"]]

            def theta_of(down, out):
                a = jnp.einsum("cxk,cxp->ckp", Uc, out, precision=HIGHEST)
                b = jnp.einsum("cky,cyp->ckp", Vc, down, precision=HIGHEST)
                return a * b

            for vi, (down, s_down, out, s_out) in enumerate([
                    (m_a * m_c, s_a + s_c, rest * m_b, s_rest + s_b),
                    (m_b * m_c, s_b + s_c, rest * m_a, s_rest + s_a),
                    (m_a * m_b, s_a + s_b, rest * m_c, s_rest + s_c)]):
                var_thetas[vi].append(theta_of(down, out))
                var_scales[vi].append(s_down + s_out)

        logls, ts, lps = [], [], []
        for vi in range(3):
            ths = tuple(var_thetas[vi])
            scs = tuple(var_scales[vi])
            t_opt = _joint_newton(ths, scs, t0, packs, pws, rks_t,
                                  t_min, t_max, n_newton)
            tot = 0.0
            lp_parts = []
            for th, sc, pack, pw, rk in zip(ths, scs, packs, pws, rks_t):
                lk, _, _ = pruning.branch_lh_derivs(
                    th, sc, t_opt * rk, pack, pack["log_ptn_invar"], pw,
                    order=0)
                tot = tot + lk
                if return_site_lp:
                    lp_parts.append(pruning.branch_site_lp(
                        th, sc, t_opt * rk, pack, pack["log_ptn_invar"]))
            logls.append(tot)
            ts.append(t_opt)
            if return_site_lp:
                lps.append(tuple(lp_parts))
        out = (jnp.stack(logls), jnp.stack(ts))
        if return_site_lp:
            # per-partition tuple of [3, Pp_k] (concat on host: Pp_k differ)
            return out + (tuple(jnp.stack([lps[v][k] for v in range(3)])
                                for k in range(len(packs))),)
        return out

    return jax.vmap(one)(iu, iv, sc_, eid)


@jax.jit
def _passes_buffers(blens, tipP, sched, pack):
    """Down+up passes -> (DownPass, up_in, up_scale, P) for NNI eval."""
    P = pruning.transition_tensors(blens.astype(tipP.dtype), pack)
    dp = pruning.down_pass(P, tipP, sched)
    up = pruning.up_pass(P, dp, tipP, sched, pack["root_freqs"])
    return dp, up.up_in, up.up_scale, P


def _passes_buffers5(blens, tipP, sched, pack):
    """Down+up passes -> (DownPass, UpPass, P) with the FULL up buffers
    (edge outside partials) needed by five-branch NNI evaluation."""
    P = pruning.transition_tensors(blens.astype(tipP.dtype), pack)
    dp = pruning.down_pass(P, tipP, sched)
    up = pruning.up_pass(P, dp, tipP, sched, pack["root_freqs"])
    return dp, up, P


@functools.partial(jax.jit, static_argnames=("n_rounds", "n_newton"))
def _multi_nni5_eval(cand_arrays, blens, rks, buffers, packs, pws, sched,
                     t_min, t_max, n_rounds: int = 2, n_newton: int = 2):
    """Five-branch NNI evaluation for LINKED partitions: the (a, b, c,
    d, e) master lengths around each candidate are re-optimized by
    coordinate Newton with derivatives summed over partitions through
    the per-partition rate scalers (the round-4 VERDICT Next #6 gap;
    reference analog: PhyloSuperTreePlen's per-part NNI bookkeeping,
    tree/phylosupertreeplen.h:38, tree/phylosupertree.cpp:30-73).

    Returns (logl [n, 3], t_e [n, 3], t5 [n, 3, 5]).
    """
    iu, iv, sc_, eid = cand_arrays
    dtype = buffers[0][0].all.dtype
    rks_t = [jnp.asarray(r, dtype) for r in rks]
    child_src = sched["child_src"]
    child_edge = sched["child_edge"]
    n_int = child_src.shape[0]
    L = buffers[0][0].all.shape[0] - n_int
    thresh, rescale, _ = pruning.scaling_consts(dtype)
    UVs = [(pack["U"][pack["cat_mix"]], pack["V"][pack["cat_mix"]])
           for pack in packs]

    def resc(x, sc):
        mx = x.max(axis=(0, 1))
        need = mx < thresh
        return (x * jnp.where(need, rescale, 1.0).astype(dtype),
                sc + need.astype(jnp.int32))

    def theta_of(k, out, down):
        Uc, Vc = UVs[k]
        return pruning.apply_PT(Uc, out) * pruning.apply_P(Vc, down)

    def Pt(k, t):
        """Per-partition transition at master length t (scaled by rk)."""
        return pruning.transition_tensors(
            (t * rks_t[k])[None], packs[k])[0]

    def one(iu_, iv_, sc__, eid_):
        ea = child_edge[iu_, 0]
        eb = child_edge[iu_, 1]
        ec = child_edge[iv_, sc__]
        is_root = iv_ == n_int - 1
        ed = jnp.where(is_root, 0, L + iv_)
        pa = [b[0].all[child_src[iu_, 0]] for b in buffers]
        sa_ = [b[0].scale[child_src[iu_, 0]] for b in buffers]
        pb = [b[0].all[child_src[iu_, 1]] for b in buffers]
        sb = [b[0].scale[child_src[iu_, 1]] for b in buffers]
        pc = [b[0].all[child_src[iv_, sc__]] for b in buffers]
        scs_c = [b[0].scale[child_src[iv_, sc__]] for b in buffers]
        Eds = [b[1].edge_E[ed] for b in buffers]
        sEds = [b[1].edge_E_scale[ed] for b in buffers]
        roots = [b[1].up_in[iv_] for b in buffers]
        sroots = [b[1].up_scale[iv_] for b in buffers]
        t0 = jnp.stack([blens[ea], blens[eb], blens[ec], blens[ed],
                        blens[eid_]])

        def newton_joint(outs, downs, scs, t):
            ths = tuple(theta_of(k, outs[k], downs[k])
                        for k in range(len(buffers)))
            return _joint_newton(ths, tuple(scs), t, packs, pws, rks_t,
                                 t_min, t_max, n_newton)

        def score_variant(px1, sx1, px2, sx2, px3, sx3, idx1, idx2, idx3):
            def round_body(_, ts):
                t1, t2, t3 = ts[idx1], ts[idx2], ts[idx3]
                td, te = ts[3], ts[4]
                K = len(buffers)
                m1 = [pruning.apply_P(Pt(k, t1), px1[k]) for k in range(K)]
                m2 = [pruning.apply_P(Pt(k, t2), px2[k]) for k in range(K)]
                m3 = [pruning.apply_P(Pt(k, t3), px3[k]) for k in range(K)]
                out_v, s_out = [], []
                for k in range(K):
                    ov = jnp.where(is_root, roots[k],
                                   pruning.apply_PT(Pt(k, td), Eds[k]))
                    out_v.append(ov)
                    s_out.append(jnp.where(is_root, sroots[k], sEds[k]))
                down_u, s_du, out_e, s_oe = [], [], [], []
                for k in range(K):
                    d, sd = resc(m1[k] * m2[k], sx1[k] + sx2[k])
                    o, so = resc(out_v[k] * m3[k], s_out[k] + sx3[k])
                    down_u.append(d); s_du.append(sd)
                    out_e.append(o); s_oe.append(so)
                te = newton_joint(out_e, down_u,
                                  [s_du[k] + s_oe[k] for k in range(K)],
                                  te)
                m_u = [pruning.apply_P(Pt(k, te), down_u[k])
                       for k in range(K)]
                out_3, s_o3 = [], []
                for k in range(K):
                    o, so = resc(out_v[k] * m_u[k], s_out[k] + s_du[k])
                    out_3.append(o); s_o3.append(so)
                t3 = newton_joint(out_3, px3,
                                  [s_o3[k] + sx3[k] for k in range(K)],
                                  t3)
                out_u = [pruning.apply_PT(Pt(k, te), out_e[k])
                         for k in range(K)]
                o1, s_o1 = [], []
                for k in range(K):
                    o, so = resc(out_u[k] * m2[k], s_oe[k] + sx2[k])
                    o1.append(o); s_o1.append(so)
                t1 = newton_joint(o1, px1,
                                  [s_o1[k] + sx1[k] for k in range(K)],
                                  t1)
                m1 = [pruning.apply_P(Pt(k, t1), px1[k]) for k in range(K)]
                o2, s_o2 = [], []
                for k in range(K):
                    o, so = resc(out_u[k] * m1[k], s_oe[k] + sx1[k])
                    o2.append(o); s_o2.append(so)
                t2 = newton_joint(o2, px2,
                                  [s_o2[k] + sx2[k] for k in range(K)],
                                  t2)
                m2 = [pruning.apply_P(Pt(k, t2), px2[k]) for k in range(K)]
                down_v, s_dv = [], []
                for k in range(K):
                    d, sd = resc(m_u[k] * m3[k], s_du[k] + sx3[k])
                    down_v.append(d); s_dv.append(sd)
                td_new = newton_joint(Eds, down_v,
                                      [s_dv[k] + sEds[k]
                                       for k in range(K)], td)
                td = jnp.where(is_root, td, td_new)
                ts = ts.at[idx1].set(t1).at[idx2].set(t2).at[idx3].set(t3)
                ts = ts.at[3].set(td).at[4].set(te)
                return ts

            ts = jax.lax.fori_loop(0, n_rounds, round_body, t0)
            t1, t2, t3 = ts[idx1], ts[idx2], ts[idx3]
            K = len(buffers)
            tot = 0.0
            for k in range(K):
                m1 = pruning.apply_P(Pt(k, t1), px1[k])
                m2 = pruning.apply_P(Pt(k, t2), px2[k])
                m3 = pruning.apply_P(Pt(k, t3), px3[k])
                ov = jnp.where(is_root, roots[k],
                               pruning.apply_PT(Pt(k, ts[3]), Eds[k]))
                so = jnp.where(is_root, sroots[k], sEds[k])
                d, sd = resc(m1 * m2, sx1[k] + sx2[k])
                o, soe = resc(ov * m3, so + sx3[k])
                th = theta_of(k, o, d)
                lk, _, _ = pruning.branch_lh_derivs(
                    th, sd + soe, ts[4] * rks_t[k], packs[k],
                    packs[k]["log_ptn_invar"], pws[k], order=0)
                tot = tot + lk
            return tot, ts[4], ts

        l0, te0, ts0 = score_variant(pa, sa_, pc, scs_c, pb, sb, 0, 2, 1)
        l1, te1, ts1 = score_variant(pb, sb, pc, scs_c, pa, sa_, 1, 2, 0)
        l2, te2, ts2 = score_variant(pa, sa_, pb, sb, pc, scs_c, 0, 1, 2)
        return (jnp.stack([l0, l1, l2]), jnp.stack([te0, te1, te2]),
                jnp.stack([ts0, ts1, ts2]))

    return jax.vmap(one)(iu, iv, sc_, eid)


# ------------------------------------------------------------------- engine
class PartitionEngine:
    """Drop-in engine for partitioned supermatrices (duck-types the parts of
    LikelihoodEngine used by search/NNI/model optimization)."""

    def __init__(self, super_aln: SuperAlignment, models: list, rates: list,
                 partition_type: str = "edge-proportional",
                 dtype=jnp.float32, pattern_pad: int = 64,
                 asc_flags: list[bool] | None = None):
        assert partition_type in ("edge-proportional", "edge-equal",
                                  "unlinked", "edge-linked")
        if partition_type == "edge-linked":
            partition_type = "edge-proportional"
        self.aln = super_aln
        self.partition_type = partition_type
        self.models = models
        self.rates = rates
        self.dtype = jnp.dtype(dtype)
        asc_flags = asc_flags or [False] * len(models)
        self.engines = [
            LikelihoodEngine(p, m, r, dtype=dtype, pattern_pad=pattern_pad,
                             asc=a)
            for p, m, r, a in zip(super_aln.partitions, models, rates,
                                  asc_flags)]
        K = len(self.engines)
        self.part_rates = np.ones(K, dtype=np.float64)
        w = np.array([p.nsites for p in super_aln.partitions], np.float64)
        self._site_w = w / w.sum()
        # unlinked mode: per-partition branch lengths for the current topology
        self._ul_blens: list[np.ndarray] | None = None
        self._ul_tid: str | None = None

    # -------------------------------------------------------------- helpers
    @property
    def K(self) -> int:
        return len(self.engines)

    @property
    def model(self):
        return self.models[0]

    def _parts(self):
        return tuple((e._dev_tipP, e._dev_pack) for e in self.engines)

    def _pws(self):
        return tuple(e._dev_pw for e in self.engines)

    def _packs(self):
        return tuple(e._dev_pack for e in self.engines)

    def _rks(self):
        if self.partition_type == "edge-proportional":
            return tuple(float(r) for r in self.part_rates)
        return tuple(1.0 for _ in self.engines)

    def refresh_model(self, k: int | None = None) -> None:
        if k is None:
            for e in self.engines:
                e.refresh_model()
        else:
            self.engines[k].refresh_model()

    def schedule_arrays(self, sched):
        return {k: jnp.asarray(v) for k, v in
                sched.to_device_arrays().items()}

    # ------------------------------------------------------------- loglik
    def loglik_tree(self, tree: Tree) -> float:
        return self.loglik_sched(build_schedule(tree))

    def loglik_sched(self, sched) -> float:
        sa = self.schedule_arrays(sched)
        blens = jnp.asarray(sched.blens, self.dtype)
        if self.partition_type == "unlinked" and self._ul_blens is not None:
            bl_k = [jnp.asarray(b, self.dtype) for b in self._ul_blens]
        else:
            bl_k = [blens * r for r in self._rks()]
        tot, _ = _multi_loglik(tuple(bl_k), self._parts(), sa, self._pws())
        return float(tot)

    def site_lp(self, tree: Tree) -> tuple[float, np.ndarray]:
        """(logL, concatenated per-pattern log-likelihoods)."""
        sched = build_schedule(tree)
        sa = self.schedule_arrays(sched)
        blens = jnp.asarray(sched.blens, self.dtype)
        if self.partition_type == "unlinked" and \
                self._ul_tid == tree.topology_id():
            bl_k = [jnp.asarray(b, self.dtype) for b in self._ul_blens]
        else:
            bl_k = [blens * r for r in self._rks()]
        tot, lps = _multi_loglik(tuple(bl_k), self._parts(), sa, self._pws())
        out = np.concatenate([
            np.asarray(lp)[: p.num_patterns]
            for lp, p in zip(lps, self.aln.partitions)])
        return float(tot), out

    def part_loglik(self, sched, k: int, blens=None) -> float:
        """One partition's logL at (shared blens * r_k) or explicit blens."""
        from iqtree2_tpu.engine import _loglik_jit
        e = self.engines[k]
        if blens is None:
            blens = np.asarray(sched.blens) * self._rks()[k]
        logL, _ = _loglik_jit(jnp.asarray(blens, self.dtype), e._dev_tipP,
                              self._sched_cache(sched), e._dev_pack,
                              e._dev_pw)
        return float(logL)

    def _sched_cache(self, sched):
        """Device schedule arrays, cached per schedule object."""
        if getattr(self, "_sc_key", None) is not sched:
            self._sc_key = sched
            self._sc_val = self.schedule_arrays(sched)
        return self._sc_val

    # ----------------------------------------------------- branch optimizer
    def optimize_branches(self, tree: Tree, n_rounds: int = 10,
                          n_newton: int = 4,
                          t_min: float = DEFAULT_MIN_BLEN,
                          t_max: float = DEFAULT_MAX_BLEN) -> float:
        sched = build_schedule(tree)
        sa = self.schedule_arrays(sched)
        tmin = jnp.asarray(t_min, self.dtype)
        tmax = jnp.asarray(t_max, self.dtype)
        if self.partition_type == "unlinked":
            tid = tree.topology_id()
            if self._ul_tid == tid and self._ul_blens is not None:
                starts = self._ul_blens
            else:
                starts = [np.maximum(sched.blens, t_min)] * self.K
            total = 0.0
            new_bl = []
            for k, e in enumerate(self.engines):
                from iqtree2_tpu.engine import _optimize_blens_jit
                bl, logL = _optimize_blens_jit(
                    jnp.asarray(starts[k], self.dtype), e._dev_tipP, sa,
                    e._dev_pack, e._dev_pw, tmin, tmax, n_rounds, n_newton)
                new_bl.append(np.asarray(bl, np.float64))
                total += float(logL)
            self._ul_blens = new_bl
            self._ul_tid = tid
            mean_bl = np.average(np.stack(new_bl), axis=0,
                                 weights=self._site_w)
            write_blens_to_tree(tree, sched, mean_bl)
            return total

        blens = jnp.asarray(np.maximum(sched.blens, t_min), self.dtype)
        new_blens, logL = _multi_opt_blens(
            blens, self._rks(), self._parts(), sa, self._pws(),
            tmin, tmax, n_rounds, n_newton)
        write_blens_to_tree(tree, sched, np.asarray(new_blens, np.float64))
        return float(logL)

    # --------------------------------------------------------- rate scalars
    def optimize_part_rates(self, tree: Tree) -> float:
        """Optimize per-partition rate multipliers (edge-proportional mode),
        then renormalize so the site-weighted mean rate is 1 (absorbed into
        branch lengths). Reference analog: PartitionModelPlen part_rate
        optimization (model/partitionmodel.cpp)."""
        if self.partition_type != "edge-proportional" or self.K == 1:
            return self.loglik_tree(tree)
        from iqtree2_tpu.engine import _loglik_jit
        from iqtree2_tpu.utils.optimize import brent_minimize
        sched = build_schedule(tree)
        sa = self._sched_cache(sched)
        blens = jnp.asarray(sched.blens, self.dtype)
        for k, e in enumerate(self.engines):
            def obj(r):
                lg, _ = _loglik_jit(blens * jnp.asarray(r, self.dtype),
                                    e._dev_tipP, sa, e._dev_pack, e._dev_pw)
                return -float(lg)
            r, _ = brent_minimize(obj, 1e-3, 100.0,
                                  guess=float(self.part_rates[k]))
            self.part_rates[k] = r
        # renormalize: weighted mean rate -> 1, scale blens to compensate
        mean = float(np.sum(self._site_w * self.part_rates))
        self.part_rates /= mean
        for key in tree.blen:
            tree.blen[key] *= mean
        return self.loglik_tree(tree)

    # ------------------------------------------------------------- NNI eval
    def evaluate_nni_batch(self, sched, cand_arrays, t_min=DEFAULT_MIN_BLEN,
                           t_max=DEFAULT_MAX_BLEN,
                           return_site_lp: bool = False,
                           nni5: bool = False):
        sa = self._sched_cache(sched)
        blens = jnp.asarray(sched.blens, self.dtype)
        if nni5:
            # five-branch joint coordinate Newton across partitions
            # (round-4 VERDICT Next #6; _multi_nni5_eval)
            buffers = []
            for k, e in enumerate(self.engines):
                buffers.append(_passes_buffers5(
                    blens * self._rks()[k], e._dev_tipP, sa, e._dev_pack))
            logl, t_e, t5 = _multi_nni5_eval(
                jnp.asarray(cand_arrays), blens, self._rks(),
                tuple(buffers), self._packs(), self._pws(), sa,
                jnp.asarray(t_min, self.dtype),
                jnp.asarray(t_max, self.dtype))
            return np.asarray(logl), np.asarray(t_e), np.asarray(t5)
        buffers = []
        for k, e in enumerate(self.engines):
            buffers.append(_passes_buffers(blens * self._rks()[k],
                                           e._dev_tipP, sa, e._dev_pack))
        out = _multi_nni_eval(
            cand_arrays, blens, self._rks(), tuple(buffers), self._packs(),
            self._pws(), sa, jnp.asarray(t_min, self.dtype),
            jnp.asarray(t_max, self.dtype), return_site_lp=return_site_lp)
        if return_site_lp:
            logl, t_opt, lps = out
            lp = np.concatenate(
                [np.asarray(l)[:, :, : p.num_patterns]
                 for l, p in zip(lps, self.aln.partitions)], axis=2)
            return np.asarray(logl), np.asarray(t_opt), lp
        logl, t_opt = out
        return np.asarray(logl), np.asarray(t_opt)
