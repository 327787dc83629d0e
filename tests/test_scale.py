"""Large-tree smoke tests: the engine must handle >=500 taxa without OOM
(reference: memory-saving mode, tree/memslot.h:44 — ours is the
recompute-based up pass over one unified partials buffer)."""
import numpy as np

from tests.helpers import dna_problem
from iqtree2_tpu.tree.schedule import build_schedule


def test_560_taxa_loglik_and_blen_opt():
    eng, tree = dna_problem(560, npat=128, seed=42)
    logL = eng.loglik_tree(tree)
    assert np.isfinite(logL) and logL < 0
    t = tree.copy()
    l2 = eng.optimize_branches(t, n_rounds=2)
    assert l2 >= logL - 1e-3

    # deep-tree scaling: many rescale events must accumulate correctly
    sched = build_schedule(tree)
    for (a, b) in list(t.blen):
        t.set_blen(a, b, 1.2)         # long branches -> heavy underflow
    l3 = eng.loglik_tree(t)
    assert np.isfinite(l3)
