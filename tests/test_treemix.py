"""Tree-mixture (+T) tests (reference: IQTreeMix, tree/iqtreemix.h:21)."""
import numpy as np
import jax.numpy as jnp

from tests.helpers import dna_problem
from iqtree2_tpu.engine import LikelihoodEngine
from iqtree2_tpu.model.treemix import TreeMixture
from iqtree2_tpu.tree.topology import Tree


def _mk(seed=21, ntaxa=8, npat=96):
    eng32, t1 = dna_problem(ntaxa, npat=npat, seed=seed)
    eng = LikelihoodEngine(eng32.aln, eng32.model, eng32.rates,
                           dtype=jnp.float64)
    rng = np.random.default_rng(seed + 1)
    t2 = Tree.random_topology(eng.aln.names, rng)
    return eng, t1, t2


def test_treemix_degenerate_weight_one():
    """With weight ~1 on tree 1, mixture logL ~= tree 1 logL."""
    eng, t1, t2 = _mk()
    tm = TreeMixture(eng, [t1, t2], weights=[1.0 - 1e-12, 1e-12])
    want = eng.loglik_tree(t1)
    got = tm.loglik()
    assert abs(got - want) < 1e-6


def test_treemix_em_improves_and_dominates():
    eng, t1, t2 = _mk(seed=33)
    tm = TreeMixture(eng, [t1, t2])
    l0 = tm.loglik()
    l1 = tm.fit(n_iter=5)
    assert l1 >= l0 - 1e-9
    assert abs(tm.weights.sum() - 1.0) < 1e-12
    # mixture must fit at least as well as its best single component
    best_single = max(eng.loglik_tree(t1), eng.loglik_tree(t2))
    assert l1 >= best_single - 0.5


def test_factory_parses_plus_T():
    from iqtree2_tpu.model.factory import build_model
    eng32, _ = dna_problem(6, npat=32, seed=1)
    _, _, extras = build_model("GTR+G4+T", eng32.aln)
    assert extras.get("treemix") is True
