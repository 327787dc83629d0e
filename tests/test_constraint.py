"""Constraint trees (-g): searched topologies must contain the constraint
splits (reference: tree/constrainttree.cpp)."""
import numpy as np
import jax.numpy as jnp

from tests.helpers import dna_problem
from iqtree2_tpu.tree.constraint import TopologyConstraint
from iqtree2_tpu.tree.topology import Tree
from iqtree2_tpu.ops.pars import random_stepwise_addition
from iqtree2_tpu.search.perturb import random_nnis
from iqtree2_tpu.search.search import SearchParams, TreeSearch


def test_constraint_parsing_and_compat():
    names = [f"t{i}" for i in range(8)]
    c = TopologyConstraint("((t0,t1),(t2,t3));", names)
    assert frozenset({0, 1}) in c.splits or frozenset({2, 3}) in c.splits
    rng = np.random.default_rng(0)
    ok = bad = 0
    for _ in range(30):
        t = Tree.random_topology(names, rng)
        if c.compatible(t):
            ok += 1
            sp = {frozenset(s & c.mask) for s in t.splits().keys()}
            sp |= {frozenset(c.mask - s) for s in sp}
            assert all(s in sp for s in c.splits)
        else:
            bad += 1
    assert ok > 0 and bad > 0   # the check must discriminate


def test_stepwise_addition_respects_constraint():
    eng, _ = dna_problem(10, npat=64, seed=1)
    names = eng.aln.names
    c = TopologyConstraint("((t0,t1,t2),(t3,t4));", names)
    rng = np.random.default_rng(3)
    for _ in range(10):
        t = random_stepwise_addition(eng.aln, rng, constraint=c)
        assert c.compatible(t)


def test_random_nnis_respect_constraint():
    names = [f"t{i}" for i in range(10)]
    c = TopologyConstraint("((t0,t1),(t2,t3,t4));", names)
    rng = np.random.default_rng(5)
    t = None
    while t is None or not c.compatible(t):
        t = Tree.random_topology(names, rng)
    for _ in range(20):
        random_nnis(t, rng, 0.8, constraint=c)
        assert c.compatible(t)


def test_search_respects_constraint():
    eng, _ = dna_problem(9, npat=64, seed=8)
    names = eng.aln.names
    c = TopologyConstraint("((t0,t5),(t1,t6));", names)
    sp = SearchParams(n_init_trees=5, n_nni_trees=3, pop_size=2, seed=4,
                      fixed_iterations=4, min_iterations=1)
    res = TreeSearch(eng, eng.aln, sp, constraint=c).run()
    assert c.compatible(res.best_tree)
    for it in res.candidates.items:
        assert c.compatible(it.tree)
