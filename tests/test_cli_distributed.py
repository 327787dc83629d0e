"""End-to-end CLI distributed search: two ranks over FileGossip must both
finish and produce the SAME tree (BSP-deterministic merge,
parallel/multihost.py), and a single rank given a gossip directory runs
the same BSP search and reproduces it.
"""
import os
import subprocess
import sys
from pathlib import Path

GOLDEN = Path(__file__).parent / "golden"
REPO = Path(__file__).parent.parent


def test_two_rank_cli_search_agrees(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # own cache dir: executables serialized under the
    # subprocess backend config abort when deserialized
    # by the 8-device in-process suite
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "jaxcache")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = []
    for prefix, nranks, rank in (("run", 2, 0), ("run", 2, 1),
                                 ("one", 1, 0)):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "iqtree2_tpu",
             "-s", str(GOLDEN / "example.phy"), "-m", "HKY",
             "-pre", str(tmp_path / prefix), "-redo", "-seed", "7",
             "-ninit", "6", "-ntop", "2", "-nbest", "2", "-n", "8",
             "--dist-nranks", str(nranks), "--dist-rank", str(rank),
             "--dist-dir", str(tmp_path / f"gossip_{nranks}")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, (so[-1500:], se[-1500:])
    from iqtree2_tpu.tree.topology import Tree
    a = Tree.from_newick((tmp_path / "run.treefile").read_text().strip(),
                         None)
    for other in ("run.rank1.treefile", "one.treefile"):
        b = Tree.from_newick((tmp_path / other).read_text().strip(),
                             a.taxon_names)
        assert set(a.splits().keys()) == set(b.splits().keys()), other
