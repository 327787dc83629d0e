"""The level-batched XLA pruning passes against the independent float64
oracle (tests/reference_impl.py), per pattern, in float32 and float64,
on AliSim data over tree sizes and model families; and the up pass
checked through the edge thetas: the branch likelihood rebuilt from any
edge's theta buffer at that edge's length is the tree likelihood."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iqtree2_tpu.data.alignment import Alignment
from iqtree2_tpu.engine import LikelihoodEngine
from iqtree2_tpu.model.dna import make_dna_model
from iqtree2_tpu.model.protein import make_protein_model
from iqtree2_tpu.model.rates import RateGamma, RateGammaInvar
from iqtree2_tpu.ops import pruning
from iqtree2_tpu.simulator import simulate_alignment
from iqtree2_tpu.tree.schedule import build_schedule
from iqtree2_tpu.treeutils import random_tree

from .reference_impl import brute_force_site_lp

# float32: each of the ~2n per-node products and rescales rounds at
# ~6e-8 relative (measured here: |d lp| <= 9e-6 at lp ~ -100); float64
# rounding is ~1e-16 relative (measured: <= 2e-11)
TOL = {"float32": dict(rtol=1e-6, atol=3e-5),
       "float64": dict(rtol=1e-12, atol=1e-9)}


def _model(kind):
    if kind == "LG+G4":
        return make_protein_model("LG"), RateGamma(4, alpha=0.8), "AA"
    model = make_dna_model("GTR", freqs=np.array([0.3, 0.2, 0.2, 0.3]),
                           freq_type="user",
                           rate_params=np.array([1.5, 4.0, 1.2, 0.8, 5.0]))
    if kind == "GTR+I+G4":
        return model, RateGammaInvar(4, alpha=0.6, p_invar=0.2), "DNA"
    return model, RateGamma(4, alpha=0.6), "DNA"


def _problem(ntaxa, kind, nsites=192, seed=0):
    rng = np.random.default_rng([ntaxa, seed])
    model, rates, st = _model(kind)
    tree = random_tree(ntaxa, "yule", rng)
    seqs = simulate_alignment(tree, model, rates, nsites, rng)
    aln = Alignment.from_sequences(
        tree.taxon_names, [seqs[n] for n in tree.taxon_names], seqtype=st)
    return aln, tree, model, rates


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["GTR+G4", "GTR+I+G4", "LG+G4"])
@pytest.mark.parametrize("ntaxa", [8, 33, 80])
def test_site_lp_matches_reference(ntaxa, kind, dtype):
    aln, tree, model, rates = _problem(ntaxa, kind)
    want = brute_force_site_lp(aln, tree, model, rates)
    eng = LikelihoodEngine(aln, model, rates, dtype=jnp.dtype(dtype))
    logL, lp = eng.site_lp(tree)
    assert lp.shape == want.shape
    np.testing.assert_allclose(lp, want, **TOL[dtype])
    total = float((aln.pattern_weights * want).sum())
    assert logL == pytest.approx(total, rel=TOL[dtype]["rtol"] * 10)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ntaxa", [8, 33])
def test_edge_thetas_rebuild_tree_loglik(ntaxa, dtype):
    aln, tree, model, rates = _problem(ntaxa, "GTR+I+G4", seed=1)
    eng = LikelihoodEngine(aln, model, rates, dtype=jnp.dtype(dtype))
    sched = build_schedule(tree)
    sa = eng.schedule_arrays(sched)
    pack, pw = eng._dev_pack, eng._dev_pw
    blens = jnp.asarray(sched.blens, eng.dtype)

    @jax.jit
    def per_edge(b):
        P = pruning.transition_tensors(b, pack)
        dp, up = pruning.both_passes(P, eng._dev_tipP, sa, pack)
        th = pruning.edge_thetas(up, dp, sa["edge_src"], pack)
        return jax.vmap(lambda t, th_e, sc_e: pruning.branch_lh_derivs(
            th_e, sc_e, t, pack, pack["log_ptn_invar"], pw, order=0)[0])(
            b, th.theta, th.scale)

    got = np.asarray(per_edge(blens))
    want = eng.loglik_sched(sched)
    assert got.shape == (sched.n_edges,)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype]["rtol"] * 10)
