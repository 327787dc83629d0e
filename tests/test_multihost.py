"""Distributed search control plane: an n-process run must produce the
IDENTICAL final tree as a 1-process run (deterministic BSP rounds;
reference analog: MPI search parallelism, tree/iqtree.cpp:4337-4479).
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

REPO = Path(__file__).parent.parent

WORKER = textwrap.dedent("""
    import sys, json
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {repo!r} + "/tests")
    from tests.helpers import dna_problem
    from iqtree2_tpu.parallel.multihost import DistributedSearch, FileGossip

    rank, nranks, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    eng, _ = dna_problem(8, npat=64, seed=2)
    g = FileGossip(root, rank, nranks)
    ds = DistributedSearch(eng, eng.aln, g, rank, nranks, seed=5,
                           n_init_trees=6, n_rounds=2, round_size=4)
    tree, logL = ds.run()
    print("RESULT", json.dumps({{"tid": tree.topology_id(),
                                 "logL": logL}}))
""")


def _run_rank(rank, nranks, root):
    script = WORKER.format(repo=str(REPO))
    return subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(nranks), str(root)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-2000:]
    for ln in out.splitlines():
        if ln.startswith("RESULT "):
            return json.loads(ln[7:])
    raise AssertionError(f"no RESULT line in: {out[-500:]}")


def test_two_process_equals_one_process(tmp_path):
    p1 = _run_rank(0, 1, tmp_path / "g1")
    r1 = _result(p1)

    pa = _run_rank(0, 2, tmp_path / "g2")
    pb = _run_rank(1, 2, tmp_path / "g2")
    ra, rb = _result(pa), _result(pb)

    assert ra["tid"] == rb["tid"] == r1["tid"]
    assert abs(ra["logL"] - r1["logL"]) < 1e-9
    assert abs(rb["logL"] - r1["logL"]) < 1e-9


def test_ufboot_replicate_slicing():
    """Distributed UFBoot: each rank RELL-scores only its replicate
    slice (1/N of the work), and the gossip champion-merge reconstructs
    the full replicate set (round-4 VERDICT Next #8; reference:
    tree/iqtree.cpp:352-362 per-process sample ranges)."""
    import sys
    sys.path.insert(0, str(REPO) + "/tests")
    from tests.helpers import dna_problem
    from iqtree2_tpu.search.ufboot import UFBoot

    eng, tree = dna_problem(8, npat=64, seed=2)
    R = 40
    full = UFBoot(eng.aln, n_replicates=R, seed=3)
    s0 = UFBoot(eng.aln, n_replicates=R, seed=3)
    s1 = UFBoot(eng.aln, n_replicates=R, seed=3)
    s0.set_replicate_slice(0, R // 2)
    s1.set_replicate_slice(R // 2, R)

    rng = np.random.default_rng(0)
    from iqtree2_tpu.tree.topology import Tree
    for i in range(6):
        t = Tree.random_topology(eng.aln.names, rng)
        logL, lp = eng.site_lp(t)
        full.add_tree(t, lp, tree_logL=logL)
        s0.add_tree(t, lp, tree_logL=logL)
        s1.add_tree(t, lp, tree_logL=logL)

    # per-rank work is confined to the slice
    assert not np.isfinite(s0.boot_logl[R // 2:]).any()
    assert not np.isfinite(s1.boot_logl[: R // 2]).any()
    # champion-merge (max per replicate) reconstructs the full run
    merged = np.maximum(s0.boot_logl, s1.boot_logl)
    np.testing.assert_allclose(merged, full.boot_logl, rtol=0, atol=1e-6)
    for r in range(R):
        owner = s0 if r < R // 2 else s1
        assert owner.boot_trees[r] == full.boot_trees[r]
