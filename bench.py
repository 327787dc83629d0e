#!/usr/bin/env python
"""Benchmark: site-pattern likelihood throughput of the pruning engine.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.

Primary workload: full-tree log-likelihood (GTR+G4, DNA) on a synthetic
64-taxon x 16384-pattern alignment, float32, steady-state (inputs prestaged
on device; post-compile). value = pattern-edge-category evaluations per
second = patterns * n_edges * n_categories / sec_per_logL — the unit of
work of the reference's inner kernel loop (computePartialLikelihoodSIMD,
tree/phylokernelnew.h:1290).

detail adds: a 1000-taxon logL wall, a protein (LG+G4) logL wall, the
branch-length-optimization wall used for vs_baseline, the end-to-end
search and ModelFinder walls on example.phy, and the device (platform,
kind, count) with the card's name and power limit. It needs a GPU and
fails without one.

vs_baseline: wall-clock of the reference iqtree2 binary doing the same task
(fixed-topology branch-length + model optimization, same data/model) on
THIS host's CPUs, divided by our wall for optimize_branches to convergence.
The reference binary here runs on 2 cores; BASELINE.md's formal target is
10x a 64-core host, so detail.vs_baseline_64core_est linearly extrapolates
cores (64/ncores) as the stated normalization.
"""

import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).parent
sys.path.insert(0, str(REPO))

BASELINE_FILE = REPO / "tests" / "golden" / "bench_baseline.json"
REF_BIN = Path("/root/ref_build/iqtree2")

NTAXA = 64
NPAT = 16384
NCAT = 4


def make_problem(ntaxa=NTAXA, npat=NPAT, seed=12345):
    import jax.numpy as jnp

    from iqtree2_tpu.data.alignment import Alignment
    from iqtree2_tpu.data import seqtypes
    from iqtree2_tpu.engine import LikelihoodEngine
    from iqtree2_tpu.model.dna import make_dna_model
    from iqtree2_tpu.model.rates import RateGamma
    from iqtree2_tpu.tree.topology import Tree

    rng = np.random.default_rng(seed)
    st = seqtypes.dna_type()
    pat = rng.integers(0, 4, size=(npat, ntaxa)).astype(np.int32)
    codes = seqtypes.DNA_STATE_TO_CODE[pat]
    aln = Alignment(names=[f"t{i}" for i in range(ntaxa)], seqtype=st,
                    patterns=codes,
                    pattern_weights=np.ones(npat),
                    site_to_pattern=np.arange(npat, dtype=np.int32))
    model = make_dna_model("GTR", freqs=np.array([0.3, 0.2, 0.2, 0.3]),
                           freq_type="user",
                           rate_params=np.array([1.5, 4.0, 1.2, 0.8, 5.0]))
    rates = RateGamma(NCAT, alpha=0.6)
    eng = LikelihoodEngine(aln, model, rates, dtype=jnp.float32)
    tree = Tree.random_topology(aln.names, rng)
    return eng, tree


def make_problem_protein(ntaxa=64, npat=4096, seed=4242):
    """LG+G4 protein workload (S=20)."""
    import jax.numpy as jnp

    from iqtree2_tpu.data import seqtypes
    from iqtree2_tpu.data.alignment import Alignment
    from iqtree2_tpu.engine import LikelihoodEngine
    from iqtree2_tpu.model.protein import make_protein_model
    from iqtree2_tpu.model.rates import RateGamma
    from iqtree2_tpu.tree.topology import Tree

    rng = np.random.default_rng(seed)
    st = seqtypes.protein_type()
    pat = rng.integers(0, 20, size=(npat, ntaxa))
    codes = np.asarray(pat, np.int64)
    aln = Alignment(names=[f"t{i}" for i in range(ntaxa)], seqtype=st,
                    patterns=codes, pattern_weights=np.ones(npat),
                    site_to_pattern=np.arange(npat, dtype=np.int32))
    model = make_protein_model("LG")
    rates = RateGamma(NCAT, alpha=0.8)
    eng = LikelihoodEngine(aln, model, rates, dtype=jnp.float32)
    tree = Tree.random_topology(aln.names, rng)
    return eng, tree


def time_loglik(eng, tree, n_evals=8, chain=256, reps=3, k_chains=3):
    """Steady-state sec per full-tree logL.

    Each sample times k_chains back-to-back in-program chains of `chain`
    dependent evaluations, ended by np.asarray() of the LAST result (the
    in-order device queue guarantees every prior dispatch finished);
    sample = wall / (k_chains * chain). `reps` samples are taken; the
    headline is their median. If the spread exceeds 1.5x the JSON carries
    "unstable": true and the headline falls back to the max sample.

    Each chain iteration perturbs branch lengths by the iteration index
    (so XLA cannot hoist the body) with a vanishing data dependency on
    the running sum (so evaluations serialize at runtime, matching how
    the optimizers consume the kernel).
    """
    import jax
    import jax.numpy as jnp

    from iqtree2_tpu.ops import pruning
    from iqtree2_tpu.tree.schedule import build_schedule

    sched = build_schedule(tree)
    sa = eng.schedule_arrays(sched)
    blens = jnp.asarray(sched.blens, eng.dtype)

    # device buffers ride as ARGUMENTS (closure-captured arrays would be
    # embedded as constants in the compile payload — hundreds of MB)
    @jax.jit
    def _step(b, tipP, sa_, pack, pw):
        logL, _ = pruning.tree_loglik(b, tipP, sa_, pack, pw)
        return logL

    @functools.partial(jax.jit, static_argnames=("n",))
    def _chained(b, tipP, sa_, pack, pw, n):
        def body(i, acc):
            scale = (1.0 + 1e-6 * (i.astype(jnp.float32) + 1.0)
                     + acc * jnp.float32(1e-30))
            logL, _ = pruning.tree_loglik(b * scale, tipP, sa_, pack, pw)
            return acc + logL
        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    def step(b):
        return _step(b, eng._dev_tipP, sa, eng._dev_pack, eng._dev_pw)

    # per-dispatch wall (for reference only), same conservation trick
    w = step(blens)
    np.asarray(w)
    t0 = time.perf_counter()
    outs = [step(blens * jnp.float32(1.0 + 1e-6 * i))
            for i in range(n_evals)]
    np.asarray(outs[-1])
    per_dispatch = (time.perf_counter() - t0) / n_evals

    f = _chained(blens, eng._dev_tipP, sa, eng._dev_pack, eng._dev_pw,
                 chain)
    np.asarray(f)                      # warm compile + settle queue
    samples = []
    for r in range(reps):
        t0 = time.perf_counter()
        outs = [_chained(blens * jnp.float32(1.0 + 1e-7 * (r + k)),
                         eng._dev_tipP, sa, eng._dev_pack, eng._dev_pw,
                         chain) for k in range(k_chains)]
        np.asarray(outs[-1])
        samples.append((time.perf_counter() - t0) / (k_chains * chain))
    samples.sort()
    med = samples[len(samples) // 2]
    unstable = samples[-1] > 1.5 * samples[0]
    per_eval = samples[-1] if unstable else med
    return (per_eval, float(step(blens)), sched, per_dispatch,
            {"samples_us": [round(x * 1e6, 2) for x in samples],
             "unstable": unstable})


def time_blen_opt_device(eng, tree, n_rounds=10, k=4):
    """Wall per branch optimization with no host synchronization between
    calls: k chained dependent dispatches ended by ONE host fetch."""
    import jax.numpy as jnp

    from iqtree2_tpu import engine as E
    from iqtree2_tpu.tree.schedule import build_schedule

    sched = build_schedule(tree)
    sa = eng.schedule_arrays(sched)
    blens = jnp.asarray(np.maximum(sched.blens, 1e-6), eng.dtype)
    kind = eng._opt_kind()
    tmin = eng._dev_scalar(1e-6)
    tmax = eng._dev_scalar(10.0)

    def call(b):
        return E._opt_flat_jit(b, eng._dev_tipP, sa, eng._dev_pack,
                               eng._dev_pw, tmin, tmax, kind=kind,
                               n_rounds=n_rounds)
    np.asarray(call(blens))               # compile + settle
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        o = jnp.append(blens, 0.0)        # [blens, logL] layout
        for i in range(k):
            o = call(o[:-1] * jnp.float32(1.0 + 1e-7 * i))
        np.asarray(o)
        walls.append((time.perf_counter() - t0) / k)
    walls.sort()
    return walls[1]


def time_blen_opt(eng, tree, n_rounds=10):
    """Wall for one full branch-length optimization (the vs_baseline task).

    Warmup uses the SAME n_rounds (a static jit arg) so the timed call is
    steady-state, matching how search uses the optimizer (compiled once,
    called per candidate/iteration)."""
    t = tree.copy()
    eng.optimize_branches(t, n_rounds=n_rounds)   # compile
    t = tree.copy()
    t0 = time.perf_counter()
    logL = eng.optimize_branches(t, n_rounds=n_rounds)
    return time.perf_counter() - t0, logL


def _run_e2e(model: str):
    """One end-to-end analysis on example.phy, in this process: a second
    process would fail to get the card's memory."""
    from iqtree2_tpu.analysis import run_analysis
    from iqtree2_tpu.params import Params
    with tempfile.TemporaryDirectory() as td:
        pr = Params()
        pr.aln_file = str(REPO / "tests" / "golden" / "example.phy")
        pr.model = model
        pr.seed = 42
        pr.out_prefix = f"{td}/run"
        pr.verbose = 0
        pr.no_checkpoint = True
        t0 = time.perf_counter()
        res = run_analysis(pr)
        wall = time.perf_counter() - t0
    out = {"wall": wall, "logL": float(res.get("logL") or 0.0)}
    sel = res.get("model_selection")
    if sel:
        out["best"] = sel["best"]
    return out


def bench_search_wall():
    """Wall-clock to ML tree on the flagship config (BASELINE.md metric:
    example.phy 17 taxa x 1998 sites, GTR+G, full stochastic search with
    default iteration counts + final model refit). The reference binary is
    absent from this round's image; round-3 measured it at seconds on the
    2-core host."""
    out = _run_e2e("GTR+G")
    return out["wall"], out["logL"]


def bench_mfp_wall():
    """ModelFinder (-m MF) wall on example.phy (round-3 VERDICT ask #8)."""
    out = _run_e2e("MF")
    return out["wall"], out.get("best", "")


def bench_reference():
    """Reference binary: fixed-topology branch+model optimization wall."""
    if not REF_BIN.exists():
        return None

    from iqtree2_tpu.io.alignment_io import write_phylip

    eng, tree = make_problem()
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        write_phylip(eng.aln, td / "bench.phy")
        (td / "bench.nwk").write_text(tree.to_newick())
        t0 = time.perf_counter()
        r = subprocess.run(
            [str(REF_BIN), "-s", "bench.phy", "-te", "bench.nwk",
             "-m", "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}+G{0.6}",
             "-nt", str(os.cpu_count() or 1), "-pre", "bench", "-seed", "7",
             "-redo"],
            cwd=td, capture_output=True, timeout=3600)
        dt = time.perf_counter() - t0
        if r.returncode != 0:
            return None
        return dt


def main():
    from iqtree2_tpu.utils.device import card_info, device_record, require_gpu
    card = card_info()           # before JAX takes the card
    dev = require_gpu()
    from iqtree2_tpu.utils.compilecache import enable_compile_cache
    enable_compile_cache(min_compile_secs=0.0)
    # Precision policy as in the CLI's default mode: float32 likelihood,
    # global x64 off; the float64 model fits scope x64 themselves
    # (model/jaxfit.py).
    eng, tree = make_problem()
    sec_per_eval, logL, sched, sec_dispatch, meth = time_loglik(eng, tree)
    n_edges = sched.n_edges
    evals_per_sec = NPAT * n_edges * NCAT / sec_per_eval

    opt_wall, opt_logL = time_blen_opt(eng, tree)
    opt_dev = time_blen_opt_device(eng, tree)

    # 1000-taxon secondary config
    eng2, tree2 = make_problem(ntaxa=1000, npat=NPAT, seed=777)
    sec_1000, logL_1000, _, _, meth_1000 = time_loglik(
        eng2, tree2, n_evals=8, chain=64)
    opt1000_wall, opt1000_logL = time_blen_opt(eng2, tree2, n_rounds=10)

    # protein row: LG+G4, S=20
    prot = {}
    try:
        engp, treep = make_problem_protein()
        sec_p, logL_p, sched_p, _, meth_p = time_loglik(
            engp, treep, n_evals=4, chain=64)
        prot = {
            "protein_evals_per_sec": round(
                4096 * sched_p.n_edges * NCAT / sec_p, 1),
            "protein_sec_per_logL": round(sec_p, 6),
            "protein_logL": logL_p,
            "protein_samples_us": meth_p["samples_us"],
        }
    except Exception as e:       # noqa: BLE001 — bench must not die
        print(f"# protein bench failed: {e}", file=sys.stderr)

    # flagship end-to-end walls (BASELINE.md "wall-clock to ML tree")
    search_wall = search_logL = mfp_wall = None
    mfp_best = ""
    if os.environ.get("BENCH_SKIP_E2E") != "1":
        try:
            search_wall, search_logL = bench_search_wall()
        except Exception as e:       # noqa: BLE001 — bench must not die
            print(f"# search bench failed: {e}", file=sys.stderr)
        try:
            mfp_wall, mfp_best = bench_mfp_wall()
        except Exception as e:       # noqa: BLE001
            print(f"# MF bench failed: {e}", file=sys.stderr)

    baseline = None
    if BASELINE_FILE.exists():
        baseline = json.loads(BASELINE_FILE.read_text())
    refresh = os.environ.get("BENCH_REFRESH_BASELINE") == "1"
    if (baseline is None or refresh) and REF_BIN.exists():
        ref_wall = bench_reference()
        if ref_wall is not None:
            baseline = {"reference_blen_opt_wall_s": ref_wall,
                        "ncores": os.cpu_count(),
                        "note": "iqtree2 binary, same 64x16384 GTR+G data, "
                                f"{os.cpu_count()}-core CPU host"}
            BASELINE_FILE.write_text(json.dumps(baseline, indent=2))

    vs = vs64 = None
    if baseline and "reference_blen_opt_wall_s" in baseline:
        vs = baseline["reference_blen_opt_wall_s"] / opt_wall
        ncores = baseline.get("ncores") or 2
        vs64 = vs * ncores / 64.0   # linear-scaling extrapolation (stated)

    print(json.dumps({
        "metric": "pattern_edge_cat_evals_per_sec",
        "value": round(evals_per_sec, 1),
        "unit": "evals/s",
        "vs_baseline": round(vs, 2) if vs else None,
        "detail": {
            "sec_per_full_tree_logL": round(sec_per_eval, 6),
            "sec_per_logL_per_dispatch": round(sec_dispatch, 6),
            "chain_samples_us": meth["samples_us"],
            "unstable": meth["unstable"],
            "chain_samples_1000taxa_us": meth_1000["samples_us"],
            "timing_method": "K back-to-back in-program chains ended "
                             "by a host fetch; median of 3 samples, max "
                             "on >1.5x spread (see time_loglik)",
            "ntaxa": NTAXA, "patterns": NPAT, "categories": NCAT,
            "logL": logL,
            "blen_opt_wall_s": round(opt_wall, 3),
            "blen_opt_device_est_s": round(opt_dev, 4),
            "vs_baseline_64core_device_est": (
                round(baseline["reference_blen_opt_wall_s"] / opt_dev
                      * (baseline.get("ncores") or 2) / 64.0, 3)
                if baseline and "reference_blen_opt_wall_s" in baseline
                else None),
            "blen_opt_logL": opt_logL,
            "sec_per_logL_1000taxa": round(sec_1000, 6),
            "logL_1000taxa": logL_1000,
            "blen_opt_1000taxa_wall_s": round(opt1000_wall, 3),
            "blen_opt_1000taxa_logL": opt1000_logL,
            "wall_to_ml_tree_s": (round(search_wall, 2)
                                  if search_wall else None),
            "search_logL": search_logL,
            "mf_wall_s": round(mfp_wall, 2) if mfp_wall else None,
            "mf_best_model": mfp_best,
            "vs_baseline_64core_est": round(vs64, 3) if vs64 else None,
            **prot,
            "baseline_task": "fixed-topology branch-length optimization "
                             "wall vs reference binary on this host",
            "device": device_record(dev),
            "card": card,
        },
    }))


if __name__ == "__main__":
    main()
