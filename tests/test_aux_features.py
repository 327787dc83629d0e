"""TBE supports, symmetry tests, and PD analysis."""
import numpy as np

from tests.helpers import dna_problem
from iqtree2_tpu.tree.topology import Tree
from iqtree2_tpu.tbe import tbe_supports, transfer_distances, _split_matrix
from iqtree2_tpu.symtest import divergence_matrix, pair_symtest, run_symtest
from iqtree2_tpu.pd import greedy_pd, pd_score


def test_tbe_identical_trees_full_support():
    rng = np.random.default_rng(0)
    names = [f"t{i}" for i in range(10)]
    t = Tree.random_topology(names, rng)
    sup = tbe_supports(t, [t.to_newick()] * 5, names)
    assert sup and all(abs(v - 100.0) < 1e-9 for v in sup.values())


def test_tbe_between_zero_and_one_and_beats_classic():
    rng = np.random.default_rng(4)
    names = [f"t{i}" for i in range(12)]
    t = Tree.random_topology(names, rng)
    boots = []
    for i in range(10):
        b = t.copy()
        from iqtree2_tpu.search.perturb import random_nnis
        random_nnis(b, rng, 0.3)
        boots.append(b.to_newick())
    sup = tbe_supports(t, boots, names)
    assert all(0.0 <= v <= 100.0 for v in sup.values())
    # classic support counts exact split matches; TBE >= classic by def
    from collections import Counter
    cnt = Counter()
    for nwk in boots:
        for s in Tree.from_newick(nwk, names).splits().keys():
            cnt[s] += 1
    for s, e in t.splits().items():
        classic = 100.0 * cnt.get(s, 0) / len(boots)
        assert sup[Tree._key(*e)] >= classic - 1e-9


def test_symtest_symmetric_data_accepts():
    # perfectly symmetric divergence matrix => Bowker statistic 0, p = 1
    N = np.array([[50, 5, 3, 2], [5, 40, 4, 1],
                  [3, 4, 60, 6], [2, 1, 6, 30]], dtype=float)
    r = pair_symtest(N)
    assert r.bowker == 0.0 and r.p_bowker == 1.0
    # asymmetric matrix rejects
    N2 = N.copy()
    N2[0, 1] = 40.0
    r2 = pair_symtest(N2)
    assert r2.bowker > 10 and r2.p_bowker < 0.01


def test_symtest_runs_on_alignment():
    eng, _ = dna_problem(6, npat=64, seed=3)
    r = run_symtest(eng.aln)
    assert np.isfinite(r.bowker) and 0.0 <= r.p_bowker <= 1.0


def test_greedy_pd_matches_bruteforce():
    import itertools
    rng = np.random.default_rng(8)
    names = [f"t{i}" for i in range(7)]
    t = Tree.random_topology(names, rng)
    for (a, b) in list(t.blen):
        t.set_blen(a, b, float(rng.uniform(0.05, 1.0)))
    for k in (2, 3, 4):
        taxa, pd, _ = greedy_pd(t, k)
        best = max(pd_score(t, list(c))
                   for c in itertools.combinations(range(7), k))
        assert abs(pd - best) < 1e-9, (k, pd, best)


def test_lsd_dating_recovers_clock():
    """Exact clock tree: substitutions = rate * time; the WLS dating must
    recover rate and node dates exactly (reference: lsd::buildTimeTree)."""
    from iqtree2_tpu.timetree import date_tree, timetree_newick
    rate = 0.02
    # rooted truth: root(date 0) -> A(3) -> {t0(8), t1(6)};
    #                           -> B(3) -> {t2(5), t3(9)}
    names = ["t0", "t1", "t2", "t3"]
    t = Tree(names)
    A, B = t.new_node(), t.new_node()
    t.add_edge(A, 0, 5 * rate)
    t.add_edge(A, 1, 3 * rate)
    t.add_edge(B, 2, 2 * rate)
    t.add_edge(B, 3, 6 * rate)
    t.add_edge(A, B, 6 * rate)       # true root at the exact middle
    tip_dates = {0: 8.0, 1: 6.0, 2: 5.0, 3: 9.0}
    dates, r, parent, tt, root = date_tree(t, tip_dates,
                                           root_edge=(A, B))
    assert abs(r - rate) / rate < 1e-8
    assert abs(dates[root] - 0.0) < 1e-6
    assert abs(dates[A] - 3.0) < 1e-6 and abs(dates[B] - 3.0) < 1e-6
    nwk = timetree_newick(tt, dates, parent, root)
    assert nwk.count("(") >= 2

    # constraint handling: a negative-length edge gets collapsed, never
    # a child older than its parent
    t.set_blen(A, 0, 1e-4)           # t0 nearly at A's date
    dates2, r2, parent2, _, root2 = date_tree(t, tip_dates,
                                              root_edge=(A, B))
    for v, p in parent2.items():
        if p is not None:
            assert dates2[v] >= dates2[p] - 1e-9


def test_date_file_parse():
    from iqtree2_tpu.timetree import parse_date_file
    d = parse_date_file("3\nt0 2001.5\nt2 2010\n# c\nt1 1999\n",
                        ["t0", "t1", "t2"])
    assert d == {0: 2001.5, 2: 2010.0, 1: 1999.0}


def test_yaml_models_and_datatypes(tmp_path):
    """--mdef YAML definitions (phylo-yaml analog)."""
    import jax.numpy as jnp
    from iqtree2_tpu.io.yamlmodels import load_definitions, DATATYPES, \
        MODELS
    from iqtree2_tpu.model.factory import build_model
    from iqtree2_tpu.engine import LikelihoodEngine
    from iqtree2_tpu.data.alignment import Alignment

    y = tmp_path / "defs.yml"
    y.write_text("""
- datatype: RY
  state: [R, Y]
  missing: "?-"
- model: MYRY
  datatype: RY
  rates: [1.0]
  frequencies: [0.6, 0.4]
- model: MYUNREST
  datatype: DNA
  reversible: false
  matrix: [[0, 1, 2, 1], [1, 0, 1, 2], [2, 1, 0, 1], [1, 2, 1, 0]]
""")
    dts, mds = load_definitions(str(y))
    assert dts == ["RY"] and set(mds) == {"MYRY", "MYUNREST"}

    aln = Alignment.from_sequences(
        ["a", "b", "c", "d"],
        ["RRYY?R", "RYYYRR", "YRYRRY", "RRYYRY"], seqtype="RY")
    assert aln.num_states == 2
    m, r, _ = build_model("MYRY+G2", aln)
    eng = LikelihoodEngine(aln, m, r, dtype=jnp.float64, pattern_pad=8)
    t = Tree.random_topology(aln.names, np.random.default_rng(0))
    assert np.isfinite(eng.loglik_tree(t))

    # nonreversible matrix model on DNA data
    from tests.helpers import dna_problem
    engd, td = dna_problem(5, npat=16, seed=3)
    m2, r2, _ = build_model("MYUNREST", engd.aln)
    assert not m2.is_reversible()
    eng2 = LikelihoodEngine(engd.aln, m2, r2, dtype=jnp.float64,
                            pattern_pad=16)
    assert np.isfinite(eng2.loglik_tree(td))


def test_terrace_detection_and_enumeration():
    """A tree whose partitions never see taxa {4,5} together with enough
    context lies on a terrace; full coverage does not
    (reference: runterraceanalysis, terraphast)."""
    from iqtree2_tpu.terrace import check_terrace, enumerate_terrace, \
        induced_fingerprint
    rng = np.random.default_rng(3)
    names = [f"t{i}" for i in range(6)]
    t = Tree.random_topology(names, rng)
    # partition 1 sees taxa 0-3, partition 2 sees taxa 2-5
    sets_terrace = [{0, 1, 2, 3}, {2, 3, 4, 5}]
    full = [set(range(6)), set(range(6))]
    assert not check_terrace(t, full)
    assert enumerate_terrace(t, full, cap=50) == 1
    # with partial coverage at least SOME random trees sit on terraces
    found = 0
    for seed in range(8):
        tt = Tree.random_topology(names, np.random.default_rng(seed))
        if check_terrace(tt, sets_terrace):
            assert enumerate_terrace(tt, sets_terrace, cap=50) > 1
            found += 1
    assert found > 0


def test_whtest_discriminates():
    """WH-test (whtest/whtest.h): homogeneous data accepts, data generated
    under two very different Q matrices rejects more strongly."""
    import jax.numpy as jnp
    from iqtree2_tpu.whtest import run_whtest, wh_statistic
    from iqtree2_tpu.simulator import simulate_alignment
    from iqtree2_tpu.data.alignment import Alignment
    from iqtree2_tpu.model.dna import make_dna_model
    from iqtree2_tpu.model.rates import RateModel
    from iqtree2_tpu.engine import LikelihoodEngine

    rng = np.random.default_rng(5)
    names = [f"t{i}" for i in range(6)]
    tree = Tree.random_topology(names, rng)
    for (a, b) in list(tree.blen):
        tree.set_blen(a, b, 0.3)
    m_hom = make_dna_model("GTR", freqs=np.array([0.25] * 4),
                           freq_type="user",
                           rate_params=np.array([1.0, 3.0, 1.0, 1.0, 3.0]))
    seqs = simulate_alignment(tree, m_hom, RateModel(), 2000, rng)
    aln = Alignment.from_sequences(list(seqs.keys()), list(seqs.values()),
                                   seqtype="DNA")
    eng = LikelihoodEngine(aln, m_hom, RateModel(), dtype=jnp.float64)
    res = run_whtest(aln, tree, eng, n_sim=20, seed=1)
    assert res["p_value"] is not None and res["p_value"] > 0.04

    # heterogeneous: half the sites under a very different model
    m2 = make_dna_model("GTR", freqs=np.array([0.4, 0.1, 0.1, 0.4]),
                        freq_type="user",
                        rate_params=np.array([8.0, 0.2, 5.0, 0.1, 1.0]))
    s1 = simulate_alignment(tree, m_hom, RateModel(), 1000, rng)
    s2 = simulate_alignment(tree, m2, RateModel(), 1000, rng)
    seqs_h = {k: s1[k] + s2[k] for k in s1}
    aln_h = Alignment.from_sequences(list(seqs_h.keys()),
                                     list(seqs_h.values()), seqtype="DNA")
    stat_hom = wh_statistic(aln)
    stat_het = wh_statistic(aln_h)
    assert stat_het > stat_hom


def test_terrace_exact_count_matches_bfs():
    """Exact supertree counting (terraphast analog) agrees with the BFS
    enumeration on small cases (reference: /root/reference/terraphast)."""
    from iqtree2_tpu.terrace import count_terrace_exact, enumerate_terrace
    rng = np.random.default_rng(11)
    names = [f"t{i}" for i in range(7)]
    checked = 0
    for trial in range(12):
        t = Tree.random_topology(names, rng)
        sets = []
        for _ in range(int(rng.integers(2, 4))):
            keep = {0} | {i for i in range(1, 7) if rng.random() < 0.7}
            if len(keep) < 4:
                keep |= {1, 2, 3}
            sets.append(keep)
        exact = count_terrace_exact(t, sets)
        assert exact is not None
        assert exact == enumerate_terrace(t, sets, cap=100000)
        checked += 1
    assert checked == 12
    # full coverage => singleton terrace
    t = Tree.random_topology(names, rng)
    assert count_terrace_exact(t, [set(range(7))] * 2) == 1
    # no comprehensive taxon => falls back (None)
    assert count_terrace_exact(t, [{0, 1, 2, 3}, {3, 4, 5, 6},
                                   {1, 2, 5, 6}]) is None


def test_budget_pd_exact():
    """Tree-knapsack budget PD equals brute force (reference: pda -bud)."""
    import itertools
    from iqtree2_tpu.pd import budget_pd
    rng = np.random.default_rng(21)
    names = [f"t{i}" for i in range(7)]
    for trial in range(8):
        t = Tree.random_topology(names, rng)
        for (a, b) in list(t.blen):
            t.set_blen(a, b, float(rng.uniform(0.1, 2.0)))
        costs = {i: int(rng.integers(1, 4)) for i in range(7)}
        B = int(rng.integers(3, 10))
        sel, val = budget_pd(t, B, costs)
        best = 0.0
        for r in range(2, 8):
            for combo in itertools.combinations(range(7), r):
                if sum(costs[i] for i in combo) <= B:
                    best = max(best, pd_score(t, list(combo)))
        assert abs(val - best) < 1e-9
        assert sum(costs[i] for i in sel) <= B
        assert abs(pd_score(t, sel) - val) < 1e-9


def test_pd_areas_endemism_complementarity():
    from iqtree2_tpu.pd import (greedy_pd_areas, pd_complementarity,
                                pd_endemism, pd_user_sets)
    rng = np.random.default_rng(31)
    names = [f"t{i}" for i in range(8)]
    t = Tree.random_topology(names, rng)
    areas = {"A": [0, 1, 2], "B": [3, 4], "C": [5, 6, 7]}
    scores = pd_user_sets(t, areas)
    assert all(v >= 0 for v in scores.values())
    best, bpd = greedy_pd_areas(t, areas, 2)
    assert len(best) == 2 and bpd > 0
    # endemism of an area <= its PD; complementarity non-negative
    en = pd_endemism(t, areas)
    for nm in areas:
        assert -1e-12 <= en[nm] <= scores[nm] + 1e-12
    comp = pd_complementarity(t, areas, ["A"])
    assert set(comp) == {"B", "C"}
    assert all(v >= -1e-12 for v in comp.values())
    # complementarity = PD(A+X) - PD(A)
    from iqtree2_tpu.pd import pd_score as ps
    assert abs(comp["B"] - (ps(t, [0, 1, 2, 3, 4]) - ps(t, [0, 1, 2]))) \
        < 1e-9


def test_dating_fixed_rate_outgroup_and_ci():
    """Given-rate mode pins omega; outgroup rooting picks the right
    edge; CIs bracket the point estimates (reference: LSD2 -w/-g/-f,
    main/timetree.cpp:216-249)."""
    from iqtree2_tpu.timetree import (date_tree, date_tree_ci,
                                      dates_from_names,
                                      outgroup_root_edge)
    rate = 0.02
    names = ["t0", "t1", "t2", "t3"]
    t = Tree(names)
    A, B = t.new_node(), t.new_node()
    t.add_edge(A, 0, 5 * rate)
    t.add_edge(A, 1, 3 * rate)
    t.add_edge(B, 2, 2 * rate)
    t.add_edge(B, 3, 6 * rate)
    t.add_edge(A, B, 6 * rate)
    tip_dates = {0: 8.0, 1: 6.0, 2: 5.0, 3: 9.0}
    # fixed-rate: pinning the true rate must keep the exact solution
    d, r, parent, tt, root = date_tree(t, tip_dates, root_edge=(A, B),
                                       fixed_rate=rate)
    assert abs(r - rate) / rate < 1e-3
    assert abs(d[A] - 3.0) < 1e-4
    # root_date pin
    d2, _, _, _, root2 = date_tree(t, tip_dates, root_edge=(A, B),
                                   root_date=0.0)
    assert abs(d2[root2] - 0.0) < 1e-4
    # outgroup rooting: t3 as outgroup -> edge (B, 3)
    a, b = outgroup_root_edge(t, ["t3"], names)
    assert {a, b} == {B, 3}
    # two-taxon outgroup {t2, t3} -> the (A, B) edge
    a, b = outgroup_root_edge(t, ["t2", "t3"], names)
    assert {a, b} == {A, B}
    # CIs: replicates bracket the point estimate
    ci, rci = date_tree_ci(t, tip_dates, seq_len=5000, n_reps=40,
                           clock_sd=0.0, root_edge=(A, B), seed=7)
    assert rci[0] <= rate * 1.05 and rci[1] >= rate * 0.95
    assert root in ci or len(ci) > 0
    # TAXNAME date extraction
    d = dates_from_names(["a|2001.5", "b", "c|1999"])
    assert d == {0: 2001.5, 2: 1999.0}
