"""Topology tests, AliSim simulation, ASR, and site-rate posteriors."""

import numpy as np

import jax.numpy as jnp

from iqtree2_tpu.data.alignment import Alignment
from iqtree2_tpu.engine import LikelihoodEngine
from iqtree2_tpu.model.factory import build_model
from iqtree2_tpu.simulator import simulate_alignment
from iqtree2_tpu.tree.topology import Tree
from iqtree2_tpu.treetesting import evaluate_trees


def _sim_problem(seed=7, nsites=400, ntaxa=8):
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ntaxa)]
    tree = Tree.random_topology(names, rng)
    for k in tree.blen:
        tree.blen[k] = rng.uniform(0.05, 0.4)
    dummy = Alignment.from_sequences(names, ["ACGT"] * ntaxa, seqtype="DNA")
    model, rates, _ = build_model("HKY{3.0}+F{0.3,0.2,0.2,0.3}+G{0.8}",
                                  dummy)
    seqs = simulate_alignment(tree, model, rates, nsites, rng)
    aln = Alignment.from_sequences(names, [seqs[n] for n in names],
                                   seqtype="DNA")
    return tree, aln, rng


def test_simulator_recovers_frequencies():
    tree, aln, _ = _sim_problem(nsites=3000)
    freqs = aln.state_frequencies()
    assert np.abs(freqs - np.array([0.3, 0.2, 0.2, 0.3])).max() < 0.04


def test_treetests_prefer_true_tree():
    tree, aln, rng = _sim_problem()
    model, rates, _ = build_model("HKY+G", aln)
    eng = LikelihoodEngine(aln, model, rates, dtype=jnp.float64)
    true_t = tree.copy()
    bad_t = Tree.random_topology(aln.names, np.random.default_rng(999))
    lps = []
    for t in (true_t, bad_t):
        eng.optimize_branches(t, n_rounds=6)
        _, lp = eng.site_lp(t)
        lps.append(lp)
    res = evaluate_trees(np.stack(lps), aln.pattern_weights, nboot=2000,
                         rng=np.random.default_rng(5))
    assert res.logL[0] > res.logL[1]
    assert res.bp_rell[0] > 0.9
    assert res.p_au is None or res.p_au[0] > 0.5
    # all p-values of the ML tree itself must be >= those of the bad tree
    assert res.p_kh[0] >= res.p_kh[1]
    assert res.p_sh[0] >= res.p_sh[1]
    assert res.c_elw[0] > res.c_elw[1]


def test_asr_recovers_root_states():
    """Marginal ASR on simulated data: posteriors are valid distributions
    and confident sites match the simulating process's tip consensus."""
    tree, aln, _ = _sim_problem(nsites=300, seed=11)
    model, rates, _ = build_model("HKY{3.0}+F{0.3,0.2,0.2,0.3}+G{0.8}", aln)
    eng = LikelihoodEngine(aln, model, rates, dtype=jnp.float64)
    post, nodes, sched = eng.ancestral_posteriors(tree)
    assert post.shape[0] == len(nodes)
    s = post.sum(axis=1)
    assert np.allclose(s, 1.0, atol=1e-6)
    # confident calls should dominate at conserved columns
    mat = aln.expand_to_sites()  # [sites, taxa]
    conserved = (mat == mat[:, :1]).all(axis=1)
    if conserved.any():
        site = np.nonzero(conserved)[0][0]
        p = aln.site_to_pattern[site]
        state = mat[site, 0]
        assert post[0, state, p] > 0.9


def test_site_rate_posterior_orders_by_variability():
    tree, aln, _ = _sim_problem(nsites=500, seed=13)
    model, rates, _ = build_model("HKY+G", aln)
    eng = LikelihoodEngine(aln, model, rates, dtype=jnp.float64)
    eng.optimize_branches(tree, n_rounds=4)
    mean_rate, cat_post = eng.site_rate_posterior(tree)
    assert mean_rate.shape[0] == aln.num_patterns
    assert np.allclose(cat_post.sum(axis=0), 1.0, atol=1e-6)
    # constant patterns must get lower posterior rates than variable ones
    const = aln.is_constant_pattern()
    if const.any() and (~const).any():
        assert mean_rate[const].mean() < mean_rate[~const].mean()


def test_alisim_indels_and_mimic():
    """AliSim indel simulation (alisimulator.h:241-274) + input
    mimicking."""
    import numpy as np
    from iqtree2_tpu.simulator import (mimic_alignment,
                                       simulate_alignment_indel)
    from iqtree2_tpu.model.dna import make_dna_model
    from iqtree2_tpu.model.rates import RateGamma
    from iqtree2_tpu.tree.topology import Tree
    from iqtree2_tpu.data.alignment import Alignment

    rng = np.random.default_rng(7)
    names = [f"t{i}" for i in range(6)]
    tree = Tree.random_topology(names, rng)
    for (a, b) in list(tree.blen):
        tree.set_blen(a, b, 0.2)
    m = make_dna_model("HKY", freqs=np.full(4, 0.25), freq_type="user")
    r = RateGamma(4, alpha=1.0)
    seqs = simulate_alignment_indel(tree, m, r, 200, rng,
                                    ins_rate=0.05, del_rate=0.05)
    lens = {len(s) for s in seqs.values()}
    assert len(lens) == 1                      # aligned (gap-padded)
    assert len(seqs) == 6
    joined = "".join(seqs.values())
    assert "-" in joined                       # indels happened
    assert set(joined) <= set("ACGT-")

    # mimicking copies the gap mask
    src = Alignment.from_sequences(
        names, ["ACGT-A" * 10, "A-GTAA" * 10, "ACG--A" * 10,
                "ACGTAA" * 10, "--GTAA" * 10, "ACGTA-" * 10],
        seqtype="DNA")
    sim = mimic_alignment(src, tree, m, r, rng)
    for i, n in enumerate(names):
        orig = ("ACGT-A", "A-GTAA", "ACG--A", "ACGTAA", "--GTAA",
                "ACGTA-")[i] * 10
        got = sim[n]
        assert len(got) == len(orig)
        for a_, b_ in zip(orig, got):
            assert (a_ == "-") == (b_ == "-")


def test_ufboot_refinement_and_ml_site_rates():
    """-bnni refinement (refineBootTrees) + RateMeyerHaeseler ML rates."""
    import numpy as np
    import jax.numpy as jnp
    from tests.helpers import dna_problem
    from iqtree2_tpu.engine import LikelihoodEngine
    from iqtree2_tpu.search.ufboot import UFBoot
    from iqtree2_tpu.siterates import site_rates_ml

    eng32, tree = dna_problem(8, npat=64, seed=14)
    eng = LikelihoodEngine(eng32.aln, eng32.model, eng32.rates,
                           dtype=jnp.float64)
    uf = UFBoot(eng.aln, n_replicates=10, seed=3)
    # seed champions with a deliberately unoptimized tree
    _, lp = eng.site_lp(tree)
    uf.add_tree(tree, lp, tree_logL=float((lp * eng.aln.pattern_weights
                                           ).sum()))
    before = uf.boot_logl.copy()
    n_improved = uf.refine_boot_trees(eng)
    assert n_improved > 0
    assert (uf.boot_logl >= before - 1e-9).all()

    rates, lp_best = site_rates_ml(eng, tree, n_grid=17)
    assert rates.shape == (eng.aln.num_patterns,)
    assert (rates > 0).all() and np.isfinite(lp_best).all()
    # ML-rate per-site lp must dominate the rate-1 lp
    _, lp1 = eng.site_lp(tree)
    assert (lp_best >= lp1 - 1e-6).all()


def test_sankoff_parsimony():
    """Sankoff with unit costs must equal Fitch; asymmetric costs differ
    (reference: tree/phylotreepars.cpp:636)."""
    import numpy as np
    from tests.helpers import dna_problem
    from iqtree2_tpu.ops import pars
    from iqtree2_tpu.tree.topology import Tree

    eng, tree = dna_problem(8, npat=48, seed=21)
    aln = eng.aln
    masks = pars.state_bitmasks(aln)
    w = aln.pattern_weights
    fitch = pars.fitch_score(tree, masks, w)
    S = 4
    unit = np.ones((S, S)) - np.eye(S)
    sank = pars.sankoff_score(tree, aln.tip_codes(), w, unit,
                              aln.seqtype.tip_table)
    assert abs(sank - fitch) < 1e-9
    # transversion-weighted costs change the score
    cost = unit.copy()
    cost[0, 2] = cost[2, 0] = cost[1, 3] = cost[3, 1] = 0.5   # ts cheap
    sank2 = pars.sankoff_score(tree, aln.tip_codes(), w, cost,
                               aln.seqtype.tip_table)
    assert sank2 < sank

    # the on-chip min-plus scan agrees with the host DP on both costs
    dev1 = pars.sankoff_score_device(tree, aln.tip_codes(), w, unit,
                                     aln.seqtype.tip_table)
    dev2 = pars.sankoff_score_device(tree, aln.tip_codes(), w, cost,
                                     aln.seqtype.tip_table)
    assert abs(dev1 - sank) < 1e-3
    assert abs(dev2 - sank2) < 1e-3


def test_modelfinder_auto_mode():
    """-m AUTO: rate schemes on the first base, then bases with the best
    scheme (reference ordering, main/phylotesting.cpp:1347)."""
    from tests.helpers import dna_problem
    from iqtree2_tpu.modelfinder import run_modelfinder
    from iqtree2_tpu.params import Params

    eng, tree = dna_problem(6, npat=64, seed=19)
    p = Params(seed=1, model_eps=0.5)
    res = run_modelfinder(eng.aln, p, log=lambda s: None, mode="AUTO",
                          tree=tree)
    assert res["best"]
    # AUTO must test far fewer candidates than the full MFP grid
    assert len(res["table"]) < 60
