"""Analysis orchestrator: the runPhyloAnalysis analog.

Reference: main/phyloanalysis.cpp:4103 — load alignment, build/select model,
start-tree reconstruction, tree search (or fixed-topology evaluation),
branch supports, report writing; checkpoint-guarded phases throughout.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

from iqtree2_tpu.data.alignment import Alignment
from iqtree2_tpu.engine import LikelihoodEngine
from iqtree2_tpu.io import report as report_io
from iqtree2_tpu.io.alignment_io import read_alignment
from iqtree2_tpu.model.factory import build_model
from iqtree2_tpu.model.optimize import optimize_model_parameters
from iqtree2_tpu.params import Params
from iqtree2_tpu.search.nni import nni_optimize
from iqtree2_tpu.search.search import SearchParams, TreeSearch
from iqtree2_tpu.search.ufboot import UFBoot
from iqtree2_tpu.tree.topology import Tree
from iqtree2_tpu.utils.checkpoint import Checkpoint


class Logger:
    def __init__(self, path, verbose=1):
        self.f = open(path, "w") if path else None
        self.verbose = verbose

    def __call__(self, msg: str) -> None:
        if self.verbose:
            print(msg)
            sys.stdout.flush()
        if self.f:
            self.f.write(msg + "\n")
            self.f.flush()

    def close(self):
        if self.f:
            self.f.close()



def _run_serial_search(search, params, eng, aln, ckp, ufboot, log,
                       search_info):
    """Single-process stochastic search (checkpoint-guarded) + final
    thorough model refit. Returns (tree, logL)."""
    if ckp.get("search.finished") and not params.redo:
        fin = ckp.get("search.finished")
        tree = Tree.from_newick(fin["tree"], aln.names)
        search_info["Number of iterations"] = fin["iterations"]
        log(f"Search already finished per checkpoint "
            f"(logL {fin['logL']:.4f})")
        if ufboot is not None and ckp.get("search.ufboot") is not None:
            ufboot.load_state_dict(ckp.get("search.ufboot"))
        # model params evolve during the quick init + search; refit
        _fit_model(eng, tree, max(params.model_eps, 0.1))
    else:
        # initial quick model fit on a start tree before searching
        if not params.pmsf:
            log("Performing quick initial model optimization...")
            import numpy as _np

            from iqtree2_tpu.ops.pars import random_stepwise_addition
            t0 = random_stepwise_addition(
                aln, _np.random.default_rng(params.seed))
            optimize_model_parameters(eng, t0,
                                      epsilon=max(params.model_eps, 0.1))
        res = search.run()
        tree = res.best_tree
        log(f"Search done: {res.n_iterations} iterations, "
            f"best logL {res.best_logL:.4f}")
        search_info["Number of iterations"] = res.n_iterations
        ckp.put("search.finished",
                {"tree": tree.to_newick(), "logL": res.best_logL,
                 "iterations": res.n_iterations})
        ckp.dump(force=True)
    # final thorough optimization
    logL = _fit_model(eng, tree, params.model_eps)
    return tree, logL


def _fit_model(eng, tree, eps, **kw):
    """Model+branch refit that also accepts the PMSF SSFEngine (whose only
    free parameters are branch lengths and the Gamma shape) and the
    heterotachy MixlenEngine (per-class branch lengths + EM weights)."""
    from iqtree2_tpu.model.pmsf import SSFEngine
    if isinstance(eng, SSFEngine):
        eng.optimize_branches(tree)
        eng.optimize_alpha(tree)
        return eng.optimize_branches(tree, n_rounds=4)
    from iqtree2_tpu.model.heterotachy import MixlenEngine
    if isinstance(eng, MixlenEngine):
        # substitution-model params on mean lengths, then mixlen EM rounds
        optimize_model_parameters(eng, tree, epsilon=max(eps, 0.1), **kw)
        return eng.optimize_mixlen(tree)
    return optimize_model_parameters(eng, tree, epsilon=eps, **kw)


def run_analysis(params: Params) -> dict:
    """Full single-alignment analysis. Returns a result summary dict."""
    t_start = time.time()
    prefix = params.prefix
    log = Logger(f"{prefix}.log", params.verbose)
    ckp = Checkpoint(None if params.no_checkpoint else f"{prefix}.ckp.gz")
    if not params.redo:
        ckp.load()
    if ckp.get("finished") and not params.redo:
        log("Checkpoint indicates a finished run; use redo to restart.")

    import jax.numpy as jnp
    dtype = jnp.float64 if params.use_f64 else jnp.float32

    if params.mdef_file:
        from iqtree2_tpu.io.yamlmodels import load_definitions
        dts, mds = load_definitions(params.mdef_file)
        log(f"Loaded YAML definitions: datatypes {dts or '-'}, "
            f"models {mds or '-'}")

    log(f"Reading alignment {params.aln_file} ...")
    aln = read_alignment(params.aln_file, seqtype=params.seqtype)
    log(f"Alignment: {aln.ntaxa} sequences, {aln.nsites} sites, "
        f"{aln.num_patterns} patterns ({aln.seqtype.name})")

    # ---------------- model setup / ModelFinder ---------------------------
    model_selection = None
    model_str = params.model
    if model_str.upper() == "WHTEST":
        # Weiss-von Haeseler model-homogeneity test (-m WHTEST;
        # reference: main/phyloanalysis.cpp:2815 -> whtest/whtest.h:25)
        import dataclasses as _dc
        base = _dc.replace(params, model="GTR+G")
        res = run_analysis(base)
        from iqtree2_tpu.whtest import run_whtest
        eng_w = LikelihoodEngine(aln, res["model"], res["rates"],
                                 dtype=dtype)
        wh = run_whtest(aln, res["tree"], eng_w, n_sim=100,
                        seed=params.seed, log=log)
        with open(f"{prefix}.whtest", "w") as f:
            f.write(f"WH-test statistic: {wh['statistic']}\n"
                    f"p-value: {wh['p_value']}\n"
                    f"simulations: {wh.get('n_sim')}\n")
        log(f"WH-test written to {prefix}.whtest")
        log.close()
        return {**res, "whtest": wh}
    if model_str.upper() in ("MFP", "TEST", "MF", "TESTONLY",
                         "AUTO"):
        from iqtree2_tpu.modelfinder import run_modelfinder
        mf = run_modelfinder(aln, params, log=log, ckp=ckp)
        model_selection = mf
        model_str = mf["best"]
        log(f"Best-fit model: {model_str}")
        if params.model.upper() in ("MF", "TESTONLY"):
            elapsed = time.time() - t_start
            log(f"ModelFinder-only run finished ({elapsed:.2f}s)")
            return {"model_selection": mf}
    model, rates, extras = build_model(model_str, aln)
    if extras.get("mixlen"):
        from iqtree2_tpu.model.heterotachy import MixlenEngine
        eng = MixlenEngine(aln, model, rates, dtype=dtype)
    else:
        eng = LikelihoodEngine(aln, model, rates, dtype=dtype,
                               asc=extras.get("asc", False))

    rng = np.random.default_rng(params.seed)

    if params.symtest:
        from iqtree2_tpu.symtest import run_symtest, write_symtest_csv
        results = []
        if hasattr(aln, "partitions"):
            for part in aln.partitions:
                results.append((part.name, run_symtest(part)))
        else:
            results.append(("alignment", run_symtest(aln)))
        write_symtest_csv(f"{prefix}.symtest.csv", results)
        for name, r in results:
            log(f"SymTest [{name}]: Bowker={r.bowker:.3f} "
                f"(p={r.p_bowker:.4g}), Stuart p={r.p_stuart:.4g}, "
                f"internal p={r.p_internal:.4g}")
        log(f"Symmetry tests written to {prefix}.symtest.csv")

    # ---------------- PMSF two-pass (--pmsf) ------------------------------
    # Reference: computeSiteFrequencyModel (main/phyloanalysis.cpp:3744):
    # fit the profile mixture on a guide tree, derive posterior-mean site
    # frequencies, then run the whole analysis under the (much cheaper)
    # site-specific-frequency model.
    if params.pmsf:
        from iqtree2_tpu.model.mixture import MixtureModel
        if not isinstance(model, MixtureModel):
            raise SystemExit("--pmsf requires a profile mixture model "
                             "(e.g. -m LG+C20+G)")
        from iqtree2_tpu.model.pmsf import run_pmsf
        if params.user_tree or params.start_tree:
            gt_file = params.user_tree or params.start_tree
            guide = Tree.from_newick(Path(gt_file).read_text(), aln.names)
        else:
            from iqtree2_tpu.ops.pars import random_stepwise_addition
            guide = random_stepwise_addition(aln, rng)
        log("PMSF guide fit (full mixture)...")
        optimize_model_parameters(eng, guide,
                                  epsilon=max(params.model_eps, 0.1))
        ssf_eng, _, _, prof = run_pmsf(aln, eng, guide, log=log,
                                       dtype=dtype)
        with open(f"{prefix}.sitefreq", "w") as f:
            for s in range(aln.nsites):
                p = aln.site_to_pattern[s]
                f.write(f"{s + 1} " +
                        " ".join(f"{x:.6f}" for x in prof[p]) + "\n")
        log(f"PMSF site frequencies written to {prefix}.sitefreq")
        eng = ssf_eng   # downstream phases run under the SSF model

    # ---------------- tree: fixed topology or search ----------------------
    search_info = {}
    support = None
    ufboot = None
    if params.ufboot_replicates > 0:
        if params.boot_spec.upper() in ("GENE", "GENESITE"):
            raise SystemExit("-bsam GENE/GENESITE requires partitioned "
                             "data (-p/-q/-Q)")
        ufboot = UFBoot(aln, n_replicates=params.ufboot_replicates,
                        seed=params.seed)

    if extras.get("treemix"):
        # +T tree mixture: trees from -te (one newick per line)
        from iqtree2_tpu.model.treemix import TreeMixture
        if not params.user_tree:
            raise SystemExit("+T (tree mixture) requires -te FILE with "
                             "two or more trees")
        trees_t = _read_tree_set(params.user_tree, aln.names)
        log(f"Tree mixture (+T): {len(trees_t)} trees")
        optimize_model_parameters(eng, trees_t[0].copy(),
                                  epsilon=max(params.model_eps, 0.1))
        tm = TreeMixture(eng, trees_t,
                         weights=extras.get("treemix_weights"))
        logL = tm.fit(log=log)
        tree = tm.trees[int(np.argmax(tm.weights))]
        with open(f"{prefix}.treefile", "w") as f:
            for t in tm.trees:
                f.write(t.to_newick() + "\n")
        search_info["Tree mixture weights"] = \
            ", ".join(f"{w:.4f}" for w in tm.weights)
        elapsed = time.time() - t_start
        report_io.write_iqtree_report(
            f"{prefix}.iqtree", params=params, aln=aln, model=model,
            rates=rates, tree=tree, logL=logL, search_info=search_info,
            model_selection=None, support=None, elapsed=elapsed,
            tree_tests=None)
        ckp.put("finished", True)
        ckp.dump(force=True)
        log(f"Tree-mixture analysis done in {elapsed:.2f}s; mixture logL "
            f"{logL:.4f}")
        log.close()
        return {"logL": logL, "trees": tm.trees,
                "weights": tm.weights.tolist(), "elapsed": elapsed}

    # ---------------- distributed search (MPI-mode analog) ----------------
    gossip = None
    dist_rank, dist_nranks = params.dist_rank, params.dist_nranks
    if dist_nranks > 1 or params.dist_dir:
        # a gossip directory selects the BSP-deterministic search even
        # for one rank, whose tree every rank count reproduces
        from iqtree2_tpu.parallel.multihost import FileGossip
        if not params.dist_dir:
            raise SystemExit("--dist-nranks > 1 requires --dist-dir "
                             "(shared gossip directory)")
        gossip = FileGossip(params.dist_dir, dist_rank, dist_nranks)
        log(f"Distributed search: rank {dist_rank}/{dist_nranks} "
            f"(FileGossip at {params.dist_dir})")
    else:
        import os as _os
        if _os.environ.get("JAX_COORDINATOR_ADDRESS"):
            from iqtree2_tpu.parallel.multihost import (JaxGossip,
                                                        init_distributed)
            dist_rank, dist_nranks = init_distributed()
            if dist_nranks > 1:
                gossip = JaxGossip(dist_rank, dist_nranks)
                log(f"Distributed search: rank {dist_rank}/{dist_nranks} "
                    f"(jax.distributed collective transport)")

    if params.user_tree:
        log(f"Reading fixed topology from {params.user_tree}")
        tree = Tree.from_newick(Path(params.user_tree).read_text(),
                                aln.names)
        if params.fix_branch_lengths:
            # only model parameters
            fixed_any = model.num_free_params() + rates.num_free_params()
            if fixed_any:
                _optimize_model_only(eng, tree, params)
            logL = eng.loglik_tree(tree)
        else:
            logL = _fit_model(eng, tree, params.model_eps)
    else:
        sp = SearchParams(
            n_init_trees=params.n_init_trees,
            n_nni_trees=params.n_nni_trees,
            pop_size=params.pop_size,
            pertub_strength=params.pertub_strength,
            loglh_epsilon=params.loglh_epsilon,
            seed=params.seed,
            min_iterations=(params.min_iterations
                            if params.n_iterations is None
                            else params.n_iterations),
            max_iterations=params.max_iterations,
            unsuccess_iteration=params.unsuccess_iteration,
            fixed_iterations=params.n_iterations)
        constraint = None
        if params.constraint_tree:
            from iqtree2_tpu.tree.constraint import TopologyConstraint
            constraint = TopologyConstraint(
                Path(params.constraint_tree).read_text(), aln.names)
            log(f"Constraint tree (-g): {len(constraint.splits)} splits "
                f"over {len(constraint.mask)} taxa will be enforced")
        if gossip is not None:
            # BSP-deterministic multi-rank search: every rank converges to
            # the SAME tree (parallel/multihost.py), so each rank can
            # finish the analysis independently on its own prefix
            from iqtree2_tpu.parallel.multihost import DistributedSearch
            if not params.pmsf:
                log("Performing quick initial model optimization...")
                from iqtree2_tpu.ops.pars import random_stepwise_addition
                t0_ = random_stepwise_addition(
                    aln, np.random.default_rng(params.seed))
                optimize_model_parameters(eng, t0_,
                                          epsilon=max(params.model_eps,
                                                      0.1))
            round_size = max(dist_nranks, 4)
            n_rounds = max(1, -(-sp.min_iterations // round_size))
            fin = ckp.get("dist_search.finished")
            if fin and not params.redo:
                # resume semantics match the serial path: an interrupted
                # multi-rank run short-circuits to the recorded result
                # instead of redoing the whole search on every rank
                tree = Tree.from_newick(fin["tree"], aln.names)
                best_logL = fin["logL"]
                log(f"Distributed search already finished per checkpoint "
                    f"(logL {best_logL:.4f})")
                if ufboot is not None and \
                        ckp.get("search.ufboot") is not None:
                    ufboot.load_state_dict(ckp.get("search.ufboot"))
            else:
                ds = DistributedSearch(
                    eng, aln, gossip, dist_rank, dist_nranks,
                    seed=params.seed, n_init_trees=sp.n_init_trees,
                    n_nni_trees=sp.n_nni_trees, pop_size=sp.pop_size,
                    round_size=round_size, n_rounds=n_rounds,
                    pertub_strength=sp.pertub_strength, ufboot=ufboot,
                    log=log, constraint=constraint)
                tree, best_logL = ds.run()
                ckp.put("dist_search.finished",
                        {"tree": tree.to_newick(digits=17),
                         "logL": best_logL})
                if ufboot is not None:
                    ckp.put("search.ufboot", ufboot.state_dict())
                ckp.dump(force=True)
            log(f"Distributed search done: best logL {best_logL:.4f}")
            search_info["Number of iterations"] = round_size * n_rounds
            search_info["Distributed ranks"] = dist_nranks
            logL = _fit_model(eng, tree, params.model_eps)
        else:
            search = TreeSearch(eng, aln, sp, ufboot=ufboot, log=log,
                                ckp=ckp, constraint=constraint)
            tree, logL = _run_serial_search(search, params, eng, aln, ckp,
                                            ufboot, log, search_info)

    # ---------------- supports -------------------------------------------
    if ufboot is not None:
        if params.bnni:
            ufboot.refine_boot_trees(eng, log=log)
        support = ufboot.supports_for(tree)
        if params.tbe:
            # transfer bootstrap expectation over the replicate trees
            # (reference: --tbe via booster, main/phyloanalysis.cpp:3668)
            from iqtree2_tpu.tbe import tbe_supports
            reps = [ufboot.trees_newick[t] for t in ufboot.boot_trees
                    if t is not None]
            support = {k: round(v) for k, v in
                       tbe_supports(tree, reps, aln.names).items()}
        contree = ufboot.consensus_tree()
        report_io.write_treefile(f"{prefix}.contree", contree)
        ufboot.write_splits_nex(f"{prefix}.splits.nex")
        # .ufboot replicate trees
        with open(f"{prefix}.ufboot", "w") as f:
            for tid in ufboot.boot_trees:
                if tid is not None:
                    f.write(ufboot.trees_newick[tid] + "\n")
        search_info["UFBoot replicates"] = params.ufboot_replicates
    if params.alrt_replicates > 0 or params.abayes:
        from iqtree2_tpu.tests_branch import test_all_branches
        br = test_all_branches(eng, tree,
                               n_rell=max(params.alrt_replicates, 1000),
                               rng=rng,
                               do_abayes=params.abayes)
        support = _merge_support(tree, support, br)

    # ---------------- user-tree topology tests ---------------------------
    tree_tests = None
    if params.user_trees_file:
        from iqtree2_tpu.treetesting import (format_treetest_table,
                                             run_tree_tests)
        log(f"Evaluating user trees from {params.user_trees_file} "
            f"({params.topo_test_replicates} RELL replicates"
            f"{', AU test' if params.do_au_test else ''})...")
        trees_z = _read_tree_set(params.user_trees_file, aln.names)
        res_z, opt_z = run_tree_tests(eng, trees_z, params, log=log)
        tree_tests = format_treetest_table(res_z)
        with open(f"{prefix}.trees", "w") as f:
            for t in opt_z:
                f.write(t.to_newick() + "\n")
        with open(f"{prefix}.treelh", "w") as f:
            for v in res_z.logL:
                f.write(f"{v:.6f}\n")

    # ---------------- outputs --------------------------------------------
    out_root = None
    if params.outgroup:
        og0 = params.outgroup.split(",")[0]
        if og0 not in aln.names:
            raise SystemExit(f"ERROR: outgroup taxon '{og0}' not found "
                             f"in alignment")
        out_root = aln.names.index(og0)
    report_io.write_treefile(f"{prefix}.treefile", tree, support=support,
                             root=out_root)
    if params.write_site_lh:
        _, lp = eng.site_lp(tree)
        site_lp = lp[aln.site_to_pattern]
        with open(f"{prefix}.sitelh", "w") as f:
            f.write(f"1 {aln.nsites}\n")
            f.write("Site_Lh " +
                    " ".join(f"{x:.5f}" for x in site_lp) + "\n")
    if params.write_site_rate:
        mean_rate, cat_post = eng.site_rate_posterior(tree)
        cat_best = cat_post.argmax(axis=0)
        with open(f"{prefix}.rate", "w") as f:
            f.write("# Site-specific posterior mean rates (empirical "
                    "Bayes)\nSite\tRate\tCategory\n")
            for s in range(aln.nsites):
                p = aln.site_to_pattern[s]
                f.write(f"{s + 1}\t{mean_rate[p]:.5f}\t"
                        f"{cat_best[p] + 1}\n")
    if params.write_site_prob:
        # -wspr/-wspm/-wspmr: per-site posterior probability of each
        # rate/mixture category (reference printSiteProbCategory,
        # main/phyloanalysis.cpp:2225-2226)
        _, cat_post = eng.site_rate_posterior(tree)
        C = cat_post.shape[0]
        mix = np.asarray(eng.pack_np.cat_mix)
        n_mix = int(mix.max()) + 1
        mode = params.write_site_prob
        if mode == "mixture" and n_mix > 1:
            # sum rate categories within each mixture class
            agg = np.zeros((n_mix, cat_post.shape[1]))
            for c in range(C):
                agg[mix[c]] += cat_post[c]
            cols, post = ([f"p{m + 1}" for m in range(n_mix)], agg)
        else:
            cols = [f"p{c + 1}" for c in range(C)]
            post = cat_post
        with open(f"{prefix}.siteprob", "w") as f:
            f.write("Site\t" + "\t".join(cols) + "\n")
            for s in range(aln.nsites):
                p = aln.site_to_pattern[s]
                f.write(f"{s + 1}\t" + "\t".join(
                    f"{post[c, p]:.5f}" for c in range(post.shape[0]))
                    + "\n")
        log(f"Site category posteriors written to {prefix}.siteprob")
    if params.write_ml_rate:
        from iqtree2_tpu.siterates import site_rates_ml, write_mlrate
        mlr, _ = site_rates_ml(eng, tree)
        write_mlrate(f"{prefix}.mlrate", aln, mlr)
        log(f"Per-site ML rates written to {prefix}.mlrate")
    if params.do_asr:
        _write_asr(f"{prefix}.state", eng, tree, aln)
        log(f"Ancestral states written to {prefix}.state")
    if params.write_ml_dist:
        from iqtree2_tpu.ops.distances import ml_distances
        D = ml_distances(aln, eng.model, dtype=eng.dtype)
        with open(f"{prefix}.mldist", "w") as f:
            f.write(f"{aln.ntaxa}\n")
            for i, n in enumerate(aln.names):
                f.write(f"{n:<12}" +
                        " ".join(f"{D[i, j]:.6f}"
                                 for j in range(aln.ntaxa)) + "\n")
    # ---------------- root position test (--root-test) --------------------
    if params.root_test:
        from iqtree2_tpu.roottest import (rooted_newick, run_root_test,
                                          write_roottest_csv)
        log("Root position test: evaluating every branch as root "
            "(doRootTest analog + RELL rootstrap)...")
        rres = run_root_test(aln, tree, model, rates,
                             dtype=eng.dtype, log=log)
        write_roottest_csv(f"{prefix}.roottest.csv", rres)
        ra, rb = rres.branches[rres.best]
        with open(f"{prefix}.rooted.nwk", "w") as f:
            f.write(rooted_newick(tree, ra, rb) + "\n")
        search_info["Best root branch"] = rres.labels[rres.best]
        search_info["Rootstrap of best root"] = (
            f"{rres.rootstrap[rres.best]:.3f}")
        log(f"Root test -> {prefix}.roottest.csv; rooted tree -> "
            f"{prefix}.rooted.nwk")

    # ---------------- time tree (--date) ----------------------------------
    if params.date_file:
        from iqtree2_tpu.timetree import (date_tree, date_tree_ci,
                                          dates_from_names,
                                          outgroup_root_edge,
                                          parse_date_file,
                                          timetree_newick, timetree_nexus,
                                          write_lsd_report)
        if params.date_file == "TAXNAME":
            dates = dates_from_names(aln.names)
        else:
            dates = parse_date_file(Path(params.date_file).read_text(),
                                    aln.names)
        root_edge = None
        if params.outgroup:
            root_edge = outgroup_root_edge(
                tree, params.outgroup.split(","), aln.names)
            if params.date_no_outgroup:
                # LSD -G: root on the outgroup edge but keep outgroup
                # tips out of the WLS fit
                og = {aln.names.index(n)
                      for n in params.outgroup.split(",")}
                dates = {k: v for k, v in dates.items() if k not in og}
        fixed_rate = float(params.date_rate) if params.date_rate else None
        root_date = float(params.date_root) if params.date_root else None
        log(f"Least-squares dating with {len(dates)} tip dates "
            f"(LSD2 analog)...")
        nd, rate, parent, tt, root = date_tree(
            tree, dates, root_edge=root_edge, fixed_rate=fixed_rate,
            root_date=root_date)
        with open(f"{prefix}.timetree.nwk", "w") as f:
            f.write(timetree_newick(tt, nd, parent, root) + "\n")
        dci = rci = None
        if params.date_ci > 0:
            log(f"Dating confidence intervals: {params.date_ci} "
                f"branch-resampling replicates (clock sd "
                f"{params.clock_sd})...")
            dci, rci = date_tree_ci(
                tree, dates, seq_len=aln.nsites, n_reps=params.date_ci,
                clock_sd=params.clock_sd, root_edge=root_edge,
                fixed_rate=fixed_rate, root_date=root_date,
                seed=params.seed)
            search_info["Rate 95% CI"] = (f"[{rci[0]:.6g}, "
                                          f"{rci[1]:.6g}]")
        with open(f"{prefix}.timetree.nex", "w") as f:
            f.write(timetree_nexus(tt.copy(), nd, parent, root,
                                   aln.names, ci=dci))
        write_lsd_report(f"{prefix}.timetree.lsd", nd, rate, root, tt,
                         aln.names, rate_ci=rci, date_ci=dci,
                         n_reps=params.date_ci)
        search_info["Clock rate (subst/site/time)"] = f"{rate:.6g}"
        search_info["Root date"] = f"{nd[root]:.6g}"
        log(f"Time tree -> {prefix}.timetree.nwk/.nex/.lsd  "
            f"rate {rate:.6g}  root date {nd[root]:.6g}")

    elapsed = time.time() - t_start
    report_io.write_iqtree_report(
        f"{prefix}.iqtree", params=params, aln=aln, model=model,
        rates=rates, tree=tree, logL=logL, search_info=search_info,
        model_selection=model_selection, support=support, elapsed=elapsed,
        tree_tests=tree_tests)
    ckp.put("finished", True)
    ckp.dump(force=True)
    log(f"Analysis finished in {elapsed:.2f} sec. "
        f"Best logL: {logL:.4f}")
    log(f"Results written to {prefix}.iqtree / {prefix}.treefile")
    log.close()
    return {"logL": logL, "tree": tree, "model": model, "rates": rates,
            "support": support, "elapsed": elapsed}


def run_standard_bootstrap(params: Params) -> dict:
    """Classic non-parametric bootstrap (-b N): N full tree reconstructions
    on resampled alignments; supports = split frequencies mapped onto the
    ML tree of the original alignment. Reference analog:
    runStandardBootstrap (main/phyloanalysis.cpp:3425)."""
    import dataclasses

    from iqtree2_tpu.search.ufboot import greedy_consensus

    prefix = params.prefix
    n_boot = params.standard_bootstrap
    base = dataclasses.replace(params, standard_bootstrap=0)
    log = Logger(None, params.verbose)

    # original ML analysis
    res = run_analysis(base)
    tree = res["tree"]
    aln = read_alignment(params.aln_file, seqtype=params.seqtype)
    rng = np.random.default_rng(params.seed ^ 0xB00)

    from collections import Counter
    split_counts: Counter = Counter()
    boot_trees = []
    from iqtree2_tpu.io.alignment_io import write_phylip
    import tempfile
    for b in range(n_boot):
        log(f"===> START BOOTSTRAP REPLICATE {b + 1}/{n_boot}")
        baln = aln.bootstrap_alignment(rng)
        with tempfile.TemporaryDirectory() as td:
            bfile = f"{td}/boot{b}.phy"
            write_phylip(baln, bfile)
            bp = dataclasses.replace(
                base, aln_file=bfile, out_prefix=f"{td}/boot{b}",
                seed=params.seed + 1000 + b, verbose=0,
                no_checkpoint=True,
                n_iterations=(params.n_iterations
                              if params.n_iterations is not None else None))
            bres = run_analysis(bp)
        bt = bres["tree"]
        boot_trees.append(bt.to_newick())
        for s in bt.splits().keys():
            split_counts[s] += 1
    with open(f"{prefix}.boottrees", "w") as f:
        f.write("\n".join(boot_trees) + "\n")

    support = {}
    for s, (a_, b_) in tree.splits().items():
        support[tree._key(a_, b_)] = round(
            100.0 * split_counts.get(s, 0) / n_boot)
    report_io.write_treefile(f"{prefix}.treefile", tree, support=support)
    contree = greedy_consensus(
        {s: c / n_boot for s, c in split_counts.items()}, aln.names)
    report_io.write_treefile(f"{prefix}.contree", contree)
    log(f"Standard bootstrap done: {n_boot} replicates "
        f"-> {prefix}.boottrees, supports on {prefix}.treefile")
    return {"tree": tree, "support": support, "boot_trees": boot_trees}


def _read_tree_set(path, names) -> list:
    """Read a set of Newick trees (one per line, or a NEXUS trees block)."""
    text = Path(path).read_text()
    trees = []
    if text.lstrip().upper().startswith("#NEXUS"):
        from iqtree2_tpu.io.nexus import parse_nexus
        nx = parse_nexus(text)
        for _, nwk in nx.trees:
            trees.append(Tree.from_newick(nwk, names))
    else:
        for ln in text.splitlines():
            ln = ln.strip()
            if ln:
                trees.append(Tree.from_newick(ln, names))
    return trees


def _write_asr(path, eng, tree, aln) -> None:
    """Write marginal ancestral state posteriors (.state file; reference
    output of -asr, SURVEY A10)."""
    post, node_ids, sched = eng.ancestral_posteriors(tree)
    chars = aln.seqtype.state_chars[: aln.num_states]
    s2p = aln.site_to_pattern
    with open(path, "w") as f:
        f.write("# Ancestral state reconstruction (marginal posteriors)\n")
        f.write("Node\tSite\tState\t" +
                "\t".join(f"p_{c}" for c in chars) + "\n")
        for i, node in enumerate(node_ids):
            name = f"Node{node}"
            pp = post[i]  # [S, P]
            best = pp.argmax(axis=0)
            for s in range(aln.nsites):
                p = s2p[s]
                probs = "\t".join(f"{pp[x, p]:.5f}"
                                  for x in range(len(chars)))
                f.write(f"{name}\t{s + 1}\t{chars[best[p]]}\t{probs}\n")


def _optimize_model_only(eng, tree, params):
    from iqtree2_tpu.model import jaxfit
    fitted = jaxfit.try_fit(eng, tree, fix_blens=True,
                            epsilon=params.model_eps)
    if fitted is not None:
        return fitted
    from iqtree2_tpu.tree.schedule import build_schedule
    from iqtree2_tpu.utils.optimize import lbfgsb_minimize
    model, rates = eng.model, eng.rates
    sched = build_schedule(tree)
    x_model = model.get_params()
    x_rates = rates.get_params()
    nm = len(x_model)
    x0 = np.concatenate([x_model, x_rates])
    if not len(x0):
        return
    lo_m, hi_m = model.param_bounds() if nm else (np.zeros(0), np.zeros(0))
    lo_r, hi_r = rates.param_bounds() if len(x_rates) else \
        (np.zeros(0), np.zeros(0))
    lo, hi = np.concatenate([lo_m, lo_r]), np.concatenate([hi_m, hi_r])

    def obj(x):
        if nm:
            model.set_params(x[:nm])
        if len(x) > nm:
            rates.set_params(x[nm:])
        eng.refresh_model()
        return -eng.loglik_sched(sched)

    xb, _ = lbfgsb_minimize(obj, np.clip(x0, lo, hi), lo, hi)
    obj(xb)


def _merge_support(tree, support, branch_tests):
    """Combine UFBoot percents with aLRT/aBayes into 'aLRT/UFBoot' labels."""
    out = dict(support or {})
    for key, vals in branch_tests.items():
        label = "/".join(f"{v:.3g}" if isinstance(v, float) else str(v)
                         for v in vals)
        if key in out:
            out[key] = f"{label}/{out[key]:g}"
        else:
            out[key] = label
    return out
