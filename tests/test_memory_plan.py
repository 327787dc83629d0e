"""Device-memory plan of the tree search (engine.batch_limit,
engine.nni_cand_chunk): how many trees one batched program holds, and
how many NNI candidates one tree's fused round scores at once. The CPU
backend reports no memory limit, so the plan is exercised here with the
free memory faked; the chunked and grouped programs themselves run for
real and must agree with the unbounded ones."""
import numpy as np
import pytest

from iqtree2_tpu.engine import (_BATCH_SLABS_PER_NODE as B,
                                _SERIAL_SLABS_PER_NODE as N,
                                _SLABS_PER_CANDIDATE as CAND,
                                LikelihoodEngine)
from tests.helpers import dna_problem

# 10 taxa: 18 tree nodes, 7 NNI candidates of 3 variants each
NTAXA = 10


def _fake_free(monkeypatch, slabs):
    monkeypatch.setattr(LikelihoodEngine, "_free_device_slabs",
                        lambda self: slabs)


def test_cpu_backend_sets_no_memory_bound():
    eng, _ = dna_problem(NTAXA, npat=64, seed=1)
    assert eng._free_device_slabs() is None
    assert eng.batch_limit(8) == 8
    assert eng.nni_cand_chunk() is None


@pytest.mark.parametrize("free,k,expected", [
    (1e9, 8, 8),            # everything fits: k unchanged
    (B * 18 * 3.5, 8, 3),   # 3.5 trees' worth of batch program
    (B * 18 * 0.5, 8, 1),   # not even one: serial
    (B * 18 * 5, 2, 2),     # never more than asked for
])
def test_batch_limit_from_free_memory(monkeypatch, free, k, expected):
    eng, _ = dna_problem(NTAXA, npat=64, seed=1)
    _fake_free(monkeypatch, free)
    assert eng.batch_limit(k) == expected


@pytest.mark.parametrize("free,expected", [
    (1e9, None),                        # all 7 candidates at once
    (N * 18 + 3 * CAND * 7, None),      # exactly fits
    (N * 18 + 3 * CAND * 5, 4),         # room for 5: a power of two below
    (N * 18 * 0.5, 1),                  # no room: one at a time
])
def test_nni_cand_chunk_from_free_memory(monkeypatch, free, expected):
    eng, _ = dna_problem(NTAXA, npat=64, seed=1)
    _fake_free(monkeypatch, free)
    assert eng.nni_cand_chunk() == expected


@pytest.mark.parametrize("chunk", [1, 4])
def test_chunked_nni_round_matches_unchunked(monkeypatch, chunk):
    """Scoring candidates chunk by chunk (padded to whole chunks) gives
    the same fused NNI round as scoring them all at once."""
    from iqtree2_tpu.ops.nni import build_nni_candidates
    from iqtree2_tpu.tree.schedule import build_schedule

    eng, tree = dna_problem(NTAXA, npat=96, seed=2)

    def run():
        t = tree.copy()
        s = build_schedule(t)
        c = build_nni_candidates(t, s)
        arr = np.stack([c.iu, c.iv, c.slot_c, c.edge_id])
        return eng.optimize_and_evaluate_nnis(t, s, arr, nni5=True,
                                              want_lp=True)

    whole = run()
    monkeypatch.setattr(LikelihoodEngine, "nni_cand_chunk",
                        lambda self: chunk)
    parts = run()
    assert len(whole) == len(parts) == 5
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("group", [1, 2])
def test_optimize_branches_batch_in_groups(monkeypatch, group):
    """Five trees optimized in groups (or one by one) reach the logLs of
    one five-tree dispatch."""
    from iqtree2_tpu.tree.topology import Tree

    eng, _ = dna_problem(NTAXA, npat=96, seed=3)
    rng = np.random.default_rng(4)
    trees = [Tree.random_topology(eng.aln.names, rng) for _ in range(5)]
    one = eng.optimize_branches_batch([t.copy() for t in trees])
    monkeypatch.setattr(LikelihoodEngine, "batch_limit",
                        lambda self, k: min(k, group))
    grouped = eng.optimize_branches_batch([t.copy() for t in trees])
    assert len(grouped) == 5
    np.testing.assert_allclose(grouped, one, atol=1e-2)


def test_search_without_room_for_a_batch_runs_serially(monkeypatch):
    """A device too small for one batched program gives the search of
    IQTREE2_TPU_SEARCH_BATCH=1."""
    from iqtree2_tpu.search.search import SearchParams, TreeSearch

    def search():
        eng, _ = dna_problem(NTAXA, npat=96, seed=6)
        ts = TreeSearch(eng, eng.aln, SearchParams(
            n_init_trees=4, n_nni_trees=3, pop_size=2, seed=3,
            fixed_iterations=3))
        return ts, ts.run()

    monkeypatch.setenv("IQTREE2_TPU_SEARCH_BATCH", "1")
    _, serial = search()
    monkeypatch.setenv("IQTREE2_TPU_SEARCH_BATCH", "8")
    _fake_free(monkeypatch, B * 18 * 0.5)
    ts, bounded = search()
    assert ts.batch_iterations == 1
    assert bounded.best_logL == pytest.approx(serial.best_logL, abs=1e-4)
    assert bounded.best_tree.topology_id() == serial.best_tree.topology_id()
