"""Command-line interface mirroring the reference iqtree2 flag surface.

Reference analog: parseArg (utils/tools.cpp:1015) + main dispatch
(main/main.cpp:2183). Usage:

  python -m iqtree2_tpu -s ALN [-m MODEL] [-te TREE] [-bb 1000] [...]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from iqtree2_tpu.params import Params


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="iqtree2_tpu",
        description="Maximum-likelihood phylogenomics on JAX "
                    "(IQ-TREE 2 capability target)")
    p.add_argument("-s", dest="aln_file", help="alignment file")
    p.add_argument("-st", dest="seqtype",
                   help="sequence type (DNA/AA/BIN/MORPH/CODON)")
    p.add_argument("-m", dest="model", default="MFP",
                   help="model string or MFP/TEST/MF")
    p.add_argument("-p", "-spp", dest="partition_edge_prop",
                   help="partition file (edge-proportional)")
    p.add_argument("-q", dest="partition_edge_equal",
                   help="partition file (edge-linked equal)")
    p.add_argument("-S", dest="partition_topo_unlinked", default="",
                   help="topology-UNLINKED partitions: one independent "
                        "tree per locus (PhyloSuperTreeUnlinked analog)")
    p.add_argument("-Q", dest="partition_unlinked",
                   help="partition file (unlinked/separate)")
    p.add_argument("-te", dest="user_tree",
                   help="fixed user topology (evaluate only)")
    p.add_argument("-t", dest="start_tree", help="starting tree file")
    p.add_argument("-g", dest="constraint_tree", help="constraint tree")
    p.add_argument("-pre", "--prefix", dest="out_prefix", default="")
    p.add_argument("-seed", "--seed", dest="seed", type=int, default=1)
    p.add_argument("-n", dest="n_iterations", type=int, default=None)
    p.add_argument("-nstop", dest="unsuccess_iteration", type=int,
                   default=100)
    p.add_argument("-ninit", dest="n_init_trees", type=int, default=100)
    p.add_argument("-ntop", dest="n_nni_trees", type=int, default=20)
    p.add_argument("-nbest", dest="pop_size", type=int, default=5)
    p.add_argument("-pers", dest="pertub_strength", type=float, default=0.5)
    p.add_argument("-bb", "-B", dest="ufboot_replicates", type=int,
                   default=0, help="ultrafast bootstrap replicates")
    p.add_argument("-b", dest="standard_bootstrap", type=int, default=0,
                   help="standard nonparametric bootstrap replicates")
    p.add_argument("-alrt", dest="alrt_replicates", type=int, default=0)
    p.add_argument("-abayes", dest="abayes", action="store_true")
    p.add_argument("-lbp", dest="lbp_replicates", type=int, default=0)
    p.add_argument("--runs", dest="num_runs", type=int, default=1)
    p.add_argument("-bnni", dest="bnni", action="store_true",
                   help="refine UFBoot replicate trees by NNI under "
                        "resampled weights (refineBootTrees)")
    p.add_argument("--mlrate", dest="write_ml_rate", action="store_true",
                   help="per-site ML rates (RateMeyerHaeseler analog, "
                        ".mlrate)")
    p.add_argument("--tbe", dest="tbe", action="store_true",
                   help="transfer bootstrap expectation supports "
                        "(booster/booster.h)")
    p.add_argument("-mset", dest="mset", default="",
                   help="comma-separated base models for ModelFinder")
    p.add_argument("-mrate", dest="mrate", default="",
                   help="comma-separated rate schemes (E,I,G,I+G,R)")
    p.add_argument("-cmax", dest="cmax", type=int, default=10,
                   help="max categories for +R rate models")
    p.add_argument("-merit", dest="merit", default="BIC",
                   choices=["AIC", "AICc", "BIC"],
                   help="model-selection criterion "
                        "(reference: params.model_test_criterion)")
    p.add_argument("-bsam", "--sampling", dest="boot_spec", default="",
                   choices=["", "SITE", "GENE", "GENESITE"],
                   help="bootstrap resampling unit for partitioned data "
                        "(reference: -bsam, alignment/alignment.cpp:3709)")
    p.add_argument("--dist-nranks", dest="dist_nranks", type=int, default=1,
                   help="distributed search: total process count "
                        "(launch one process per rank; reference analog: "
                        "the MPI run mode)")
    p.add_argument("--dist-rank", dest="dist_rank", type=int, default=0,
                   help="distributed search: this process's rank")
    p.add_argument("--dist-dir", dest="dist_dir", default="",
                   help="distributed search: shared gossip directory "
                        "(FileGossip); omit under jax.distributed to use "
                        "the collective transport")
    p.add_argument("--merge", dest="merge_algorithm", default="greedy",
                   choices=["greedy", "kmeans"],
                   help="partition merging algorithm for -m MF+MERGE "
                        "(kmeans: cluster by partition tree length, "
                        "doKmeansClustering analog)")
    p.add_argument("--root-test", dest="root_test", action="store_true",
                   help="evaluate every branch as a root position "
                        "(nonreversible models; doRootTest + rootstrap)")
    p.add_argument("--symtest-remove-bad", dest="symtest_remove_bad",
                   action="store_true",
                   help="drop partitions failing the symmetry test "
                        "(reference: main/phyloanalysis.cpp:3920)")
    p.add_argument("--symtest-pval", dest="symtest_pval", type=float,
                   default=0.05, help="symmetry-test p-value cutoff")
    p.add_argument("--symtest", dest="symtest", action="store_true",
                   help="matched-pairs symmetry tests (doSymTest)")
    p.add_argument("-blfix", dest="fix_branch_lengths",
                   action="store_true")
    p.add_argument("-blmin", dest="min_branch_length", type=float,
                   default=1e-6)
    p.add_argument("-blmax", dest="max_branch_length", type=float,
                   default=10.0)
    p.add_argument("-me", dest="model_eps", type=float, default=0.01)
    p.add_argument("--mdef", dest="mdef_file", default="",
                   help="YAML model/datatype definition file "
                        "(phylo-yaml analog)")
    p.add_argument("--date", dest="date_file", default="",
                   help="tip-date file for least-squares dating, or "
                        "TAXNAME to parse dates from taxon names "
                        "(LSD2 analog, main/timetree.cpp)")
    p.add_argument("--date-ci", dest="date_ci", type=int, default=0,
                   help="number of branch-resampling replicates for "
                        "dating confidence intervals (LSD2 -f)")
    p.add_argument("--clock-sd", dest="clock_sd", type=float, default=0.2,
                   help="relaxed-clock lognormal stddev for --date-ci "
                        "replicates (LSD2 -q)")
    p.add_argument("--date-root", dest="date_root", default="",
                   help="fix the root date (LSD2 -a)")
    p.add_argument("--date-rate", dest="date_rate", default="",
                   help="fix the clock rate instead of estimating it "
                        "(LSD2 -w given-rate mode)")
    p.add_argument("--date-no-outgroup", dest="date_no_outgroup",
                   action="store_true",
                   help="root with -o outgroup but exclude it from "
                        "dating (LSD2 -G)")
    p.add_argument("-o", dest="outgroup", default="",
                   help="comma-separated outgroup taxa for rooting "
                        "the output / time tree")
    p.add_argument("--pmsf", dest="pmsf", action="store_true",
                   help="posterior mean site frequency two-pass for "
                        "profile mixtures (reference: "
                        "computeSiteFrequencyModel)")
    p.add_argument("-redo", "--redo", dest="redo", action="store_true")
    p.add_argument("-wsl", dest="write_site_lh", action="store_true")
    p.add_argument("-wsr", dest="write_site_rate", action="store_true",
                   help="write per-site posterior mean rates (.rate)")
    p.add_argument("-wspr", dest="write_site_prob", action="store_const",
                   const="ratecat", default="",
                   help="write per-site rate-category posterior "
                        "probabilities (.siteprob)")
    p.add_argument("-wspm", dest="write_site_prob", action="store_const",
                   const="mixture",
                   help="write per-site mixture-class posteriors "
                        "(.siteprob)")
    p.add_argument("-wspmr", "-wsprm", dest="write_site_prob",
                   action="store_const", const="mixture_ratecat",
                   help="write per-site mixture+rate category "
                        "posteriors (.siteprob)")
    p.add_argument("-z", dest="user_trees_file", default="",
                   help="evaluate a set of user trees (topology tests)")
    p.add_argument("-zb", dest="topo_test_replicates", type=int,
                   default=10000, help="RELL replicates for -z tests")
    p.add_argument("-au", dest="do_au_test", action="store_true",
                   help="perform the approximately-unbiased (AU) test")
    p.add_argument("-asr", dest="do_asr", action="store_true",
                   help="ancestral state reconstruction (.state)")
    p.add_argument("-mldist", dest="write_ml_dist", action="store_true",
                   help="write ML pairwise distances (.mldist)")
    p.add_argument("-lmap", dest="lmap_quartets", type=int, default=0,
                   help="likelihood mapping with N quartets (.lmap.svg)")
    p.add_argument("--gcf", dest="gcf_tree_file", default="",
                   help="gene-tree file for gene concordance factors")
    p.add_argument("--scf", dest="scf_quartets", type=int, default=0,
                   help="quartets per branch for site concordance factors")
    p.add_argument("-rf", dest="rf_tree_file", default="",
                   help="compute RF distance between -t tree(s) and FILE")
    p.add_argument("-rf_all", dest="rf_all", action="store_true",
                   help="all-to-all RF distances of the -t tree set")
    p.add_argument("-pd", dest="pd_k", type=int, default=0,
                   help="phylogenetic diversity: best k-taxon subset of "
                        "the -t tree (pda/ analog)")
    p.add_argument("-bud", dest="pd_budget", type=float, default=0.0,
                   help="PD under a budget: maximize PD with total "
                        "taxon cost <= BUDGET (pda -bud)")
    p.add_argument("-cost", dest="pd_cost", default="",
                   help="taxon cost file for -bud ('taxon cost' lines, "
                        "pda -cost; default all costs 1)")
    p.add_argument("-pdsets", dest="pd_sets", default="",
                   help="score user-defined taxon sets / areas from "
                        "FILE ('name: t1 t2 ...' lines; pda user-set "
                        "mode) — with -pd K picks the best K areas")
    p.add_argument("-endem", dest="pd_endem", action="store_true",
                   help="with -pdsets: also compute PD endemism per "
                        "area (pda -endem)")
    p.add_argument("-comp", dest="pd_comp", default="",
                   help="with -pdsets: PD complementarity given "
                        "comma-separated area names (pda -comp)")
    p.add_argument("-con", dest="consensus_of", default="",
                   help="majority-rule consensus of trees in FILE")
    p.add_argument("-r", dest="random_tree_n", type=int, default=0,
                   help="generate a random tree with N taxa")
    p.add_argument("-rtype", dest="random_tree_model", default="yule",
                   help="random tree model: yule|uniform|caterpillar|"
                        "balanced|star")
    p.add_argument("--f64", dest="use_f64", action="store_true",
                   help="float64 likelihood (parity mode)")
    p.add_argument("-nt", "-T", dest="num_threads", default="AUTO",
                   help="(accepted for compatibility; XLA manages cores)")
    p.add_argument("--quiet", dest="quiet", action="store_true")
    p.add_argument("--alisim", dest="alisim", default="",
                   help="simulate alignments (AliSim analog)")
    p.add_argument("--length", dest="sim_length", type=int, default=1000)
    p.add_argument("--num-alignments", dest="sim_num_alignments", type=int,
                   default=1)
    p.add_argument("--indel", dest="indel", default="",
                   help="insertion,deletion rates for AliSim (e.g. "
                        "0.03,0.1; simulator/alisimulator.h:241)")
    p.add_argument("--indel-size", dest="indel_size", type=float,
                   default=3.0, help="mean geometric indel size")
    p.add_argument("--alisim-nprocs", dest="sim_nprocs", type=int,
                   default=1, help="MPI-style AliSim split: total workers")
    p.add_argument("--alisim-rank", dest="sim_rank", type=int, default=0,
                   help="this worker's rank (simulates replicates "
                        "rank, rank+nprocs, ...)")
    return p


def params_from_args(args) -> Params:
    pr = Params()
    for f in vars(pr):
        if hasattr(args, f):
            setattr(pr, f, getattr(args, f))
    if args.partition_topo_unlinked:
        pr.partition_file = args.partition_topo_unlinked
        pr.partition_type = "topo-unlinked"
    elif args.partition_edge_prop:
        pr.partition_file = args.partition_edge_prop
        pr.partition_type = "edge-proportional"
    elif args.partition_edge_equal:
        pr.partition_file = args.partition_edge_equal
        pr.partition_type = "edge-equal"
    elif args.partition_unlinked:
        pr.partition_file = args.partition_unlinked
        pr.partition_type = "unlinked"
    if args.quiet:
        pr.verbose = 0
    if not pr.out_prefix:
        pr.out_prefix = pr.aln_file or pr.partition_file or "iqtree2_tpu"
    if pr.dist_rank > 0:
        # every rank converges to the same result (BSP-deterministic
        # merge); rank-suffixed prefixes avoid output-file races
        pr.out_prefix += f".rank{pr.dist_rank}"
    return pr


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    pr = params_from_args(args)
    import jax

    # persistent compile cache: program shapes recur across runs
    # (utils/compilecache.py says where it lives)
    from iqtree2_tpu.utils.compilecache import enable_compile_cache
    enable_compile_cache(min_compile_secs=1.0)
    # Precision policy: the likelihood runs in float32 unless --f64 asks
    # for float64 everywhere. Global x64 is set BEFORE any engine is built
    # so --f64 arrays are real float64; default runs keep it off, and the
    # float64 model fits scope x64 themselves (model/jaxfit.py).
    if pr.use_f64:
        jax.config.update("jax_enable_x64", True)
    if args.alisim:
        from iqtree2_tpu.simulator import run_alisim
        run_alisim(pr)
        return 0
    if pr.random_tree_n > 0:
        import numpy as np
        from iqtree2_tpu.treeutils import random_tree
        t = random_tree(pr.random_tree_n, pr.random_tree_model,
                        np.random.default_rng(pr.seed))
        out = (pr.out_prefix or "random") + ".treefile"
        with open(out, "w") as f:
            f.write(t.to_newick() + "\n")
        print(f"Random {pr.random_tree_model} tree with "
              f"{pr.random_tree_n} taxa -> {out}")
        return 0
    if pr.consensus_of:
        from iqtree2_tpu.analysis import _read_tree_set
        from iqtree2_tpu.treeutils import consensus_tree
        from iqtree2_tpu.tree.topology import Tree
        first = _read_tree_set(pr.consensus_of, None)
        names = first[0].taxon_names
        trees = _read_tree_set(pr.consensus_of, names)
        con, freqs = consensus_tree(trees, names)
        support = {}
        for s, (a, b) in con.splits().items():
            support[Tree._key(a, b)] = round(100.0 * freqs.get(s, 0.0))
        out = (pr.out_prefix or pr.consensus_of) + ".contree"
        with open(out, "w") as f:
            f.write(con.to_newick(support=support) + "\n")
        print(f"Majority-rule consensus of {len(trees)} trees -> {out}")
        return 0
    if (getattr(args, "pd_k", 0) > 0 or getattr(args, "pd_budget", 0)
            or getattr(args, "pd_sets", "")):
        from iqtree2_tpu.analysis import _read_tree_set
        from iqtree2_tpu.pd import (budget_pd, greedy_pd, greedy_pd_areas,
                                    parse_cost_file, parse_sets_file,
                                    pd_complementarity, pd_endemism,
                                    pd_user_sets, write_pda_report)
        src_t = pr.start_tree or pr.user_tree
        if not src_t:
            print("error: PD analysis requires -t TREE", file=sys.stderr)
            return 2
        trees = _read_tree_set(src_t, None)
        t = trees[0]
        out = (pr.out_prefix or src_t) + ".pda"
        if getattr(args, "pd_sets", ""):
            sets = parse_sets_file(Path(args.pd_sets).read_text(),
                                   t.taxon_names)
            scores = pd_user_sets(t, sets)
            with open(out, "w") as f:
                f.write("PD of user-defined taxon sets/areas "
                        "(pda user-set mode)\n")
                for nm, v in scores.items():
                    f.write(f"  {nm}\tPD = {v:.6f}\n")
                if args.pd_k > 0:
                    best, bpd = greedy_pd_areas(t, sets, args.pd_k)
                    f.write(f"Best {args.pd_k} areas: "
                            f"{', '.join(best)}  PD = {bpd:.6f}\n")
                if getattr(args, "pd_endem", False):
                    f.write("PD endemism per area:\n")
                    for nm, v in pd_endemism(t, sets).items():
                        f.write(f"  {nm}\t{v:.6f}\n")
                if getattr(args, "pd_comp", ""):
                    given = args.pd_comp.split(",")
                    f.write(f"PD complementarity given "
                            f"{args.pd_comp}:\n")
                    for nm, v in pd_complementarity(t, sets,
                                                    given).items():
                        f.write(f"  {nm}\t{v:.6f}\n")
            print(f"PD set analysis -> {out}")
            return 0
        if getattr(args, "pd_budget", 0):
            costs = {}
            if getattr(args, "pd_cost", ""):
                costs = parse_cost_file(Path(args.pd_cost).read_text(),
                                        t.taxon_names)
            taxa, pd = budget_pd(t, args.pd_budget, costs)
            with open(out, "w") as f:
                f.write(f"Budgeted phylogenetic diversity (tree "
                        f"knapsack DP)\nbudget = {args.pd_budget:g}  "
                        f"PD = {pd:.6f}\nTaxa:\n")
                for x in taxa:
                    f.write(f"  {t.taxon_names[x]}\n")
            print(f"Budget PD (B={args.pd_budget:g}): {pd:.6f} -> {out}")
            return 0
        taxa, pd, steps = greedy_pd(t, args.pd_k)
        write_pda_report(out, t, taxa, pd, steps)
        print(f"Greedy PD (k={args.pd_k}): {pd:.6f} -> {out}")
        return 0
    if pr.rf_tree_file or pr.rf_all:
        from iqtree2_tpu.analysis import _read_tree_set
        from iqtree2_tpu.treeutils import rf_distance, rf_matrix
        src = pr.start_tree or pr.user_tree or pr.rf_tree_file
        base = _read_tree_set(src, None)
        names = base[0].taxon_names
        base = _read_tree_set(src, names)
        if pr.rf_all or not pr.rf_tree_file or pr.rf_tree_file == src:
            D = rf_matrix(base)
            out = (pr.out_prefix or src) + ".rfdist"
            with open(out, "w") as f:
                f.write(f"{len(base)}\n")
                for i, row in enumerate(D):
                    f.write(f"t{i + 1} " + " ".join(map(str, row)) + "\n")
            print(f"All-to-all RF distances ({len(base)} trees) -> {out}")
        else:
            other = _read_tree_set(pr.rf_tree_file, names)
            for i, t1 in enumerate(base):
                for j, t2 in enumerate(other):
                    print(f"RF(tree{i + 1}, tree{j + 1}) = "
                          f"{rf_distance(t1, t2)}")
        return 0
    if not pr.aln_file and not pr.partition_file:
        print("error: -s ALIGNMENT is required", file=sys.stderr)
        return 2
    if pr.partition_file:
        if pr.partition_type == "topo-unlinked":
            from iqtree2_tpu.partition_analysis import \
                run_unlinked_topology_analysis
            run_unlinked_topology_analysis(pr)
            return 0
        from iqtree2_tpu.partition_analysis import run_partition_analysis
        run_partition_analysis(pr)
        return 0
    from iqtree2_tpu.analysis import run_analysis
    if pr.standard_bootstrap > 0:
        from iqtree2_tpu.analysis import run_standard_bootstrap
        run_standard_bootstrap(pr)
        return 0
    if pr.num_runs > 1:
        from iqtree2_tpu.analysis import run_analysis
        best = None
        for r in range(pr.num_runs):
            import dataclasses
            pri = dataclasses.replace(pr, seed=pr.seed + r,
                                      out_prefix=f"{pr.prefix}.run{r + 1}")
            res = run_analysis(pri)
            if best is None or res["logL"] > best["logL"]:
                best = res
        print(f"Best of {pr.num_runs} runs: logL {best['logL']:.4f}")
        return 0
    run_analysis(pr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
