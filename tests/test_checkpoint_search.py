"""Mid-search checkpoint/resume: an interrupted search must resume and
produce the IDENTICAL final tree and candidate set as an uninterrupted run
(reference: doTreeSearch checkpoint guards, tree/iqtree.cpp:2221-2233).

Iterations run in lockstep blocks of K candidates (one fused batched
dispatch per NNI round — search.py batch_iterations); checkpoints land
exactly on block boundaries, so the K-block is the atomic resume unit and
interruption points are block-aligned (like the reference's MPI-rank
iteration batches).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from tests.helpers import dna_problem
from iqtree2_tpu.search.search import SearchParams, TreeSearch
from iqtree2_tpu.search.ufboot import UFBoot
from iqtree2_tpu.utils.checkpoint import Checkpoint


def _search(eng, aln, ckp, ufboot=None, fixed_iterations=8):
    sp = SearchParams(n_init_trees=6, n_nni_trees=4, pop_size=2,
                      seed=7, fixed_iterations=fixed_iterations,
                      min_iterations=1)
    return TreeSearch(eng, aln, sp, ckp=ckp, ufboot=ufboot)


def test_resume_identical(tmp_path):
    eng, _ = dna_problem(10, npat=96, seed=2)
    aln = eng.aln

    # uninterrupted run: two full 8-iteration blocks
    res_full = _search(eng, aln, None, fixed_iterations=16).run()

    # interrupted after one full block (8 = the batch size: checkpoints
    # land on block boundaries, the atomic resume unit)
    ckp_path = tmp_path / "s.ckp.gz"
    ckp = Checkpoint(ckp_path, dump_interval=0.0)
    _search(eng, aln, ckp, fixed_iterations=8).run()
    assert ckp_path.exists()

    # resume: fresh searcher, same params, full iteration budget
    ckp2 = Checkpoint(ckp_path, dump_interval=0.0)
    ckp2.load()
    assert ckp2.get("search.iteration") == 8
    res_resumed = _search(eng, aln, ckp2, fixed_iterations=16).run()

    assert res_resumed.best_tree.topology_id() == \
        res_full.best_tree.topology_id()
    assert abs(res_resumed.best_logL - res_full.best_logL) < 1e-6
    got = [(it.topo_id, round(it.logL, 8)) for it in res_resumed.candidates.items]
    want = [(it.topo_id, round(it.logL, 8)) for it in res_full.candidates.items]
    assert got == want


def test_resume_with_ufboot(tmp_path):
    eng, _ = dna_problem(8, npat=64, seed=9)
    aln = eng.aln
    uf_full = UFBoot(aln, n_replicates=50, seed=7)
    res_full = _search(eng, aln, None, ufboot=uf_full,
                       fixed_iterations=16).run()

    ckp = Checkpoint(tmp_path / "u.ckp.gz", dump_interval=0.0)
    uf1 = UFBoot(aln, n_replicates=50, seed=7)
    _search(eng, aln, ckp, ufboot=uf1, fixed_iterations=8).run()

    ckp2 = Checkpoint(tmp_path / "u.ckp.gz", dump_interval=0.0)
    ckp2.load()
    uf2 = UFBoot(aln, n_replicates=50, seed=7)
    res2 = _search(eng, aln, ckp2, ufboot=uf2, fixed_iterations=16).run()

    assert res2.best_tree.topology_id() == res_full.best_tree.topology_id()
    np.testing.assert_allclose(uf2.boot_logl, uf_full.boot_logl, atol=1e-4)
    assert uf2.boot_trees == uf_full.boot_trees
