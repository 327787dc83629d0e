#!/usr/bin/env python
"""Smoke test of iqtree2_tpu on an NVIDIA GPU, through the user entry points.

    python chip_smoke.py                # phases 0-4 on one card
    python chip_smoke.py --four-cards   # distributed search + sharded step

Default phases (one process, one card):
  0. the card (nvidia-smi, read before JAX starts) and JAX's device;
  1. golden parity of ``cli.main`` on example.phy (-te, GTR+G), float32
     and --f64;
  2. likelihood and 10-round branch optimization at 1000 taxa x 20,000
     sites (GTR+G4) and 200 taxa x 5,000 sites (LG+G4) of AliSim data,
     float32 on the card against the float64 host oracle
     (tests/reference_impl.py) and the float64 engine on the card;
  3. a default GTR+G tree search on example.phy, and GTR+G with UFBoot
     1000 on 100 taxa x 10,000 simulated sites;
  4. ModelFinder (-m MF) on example.phy.

--four-cards runs only the sharded likelihood, Newton step, RELL and NNI
batch of ``__graft_entry__.dryrun_multichip`` at 1000 taxa x 65,536
patterns against one card, then a 1-rank and a 4-rank distributed search
(one child process per card) whose trees must be identical. Both run in
child processes; this process touches JAX only afterwards.

Each phase prints one JSON line with its wall and compile seconds and its
checked numbers beside their bars. The last line is
``{"ok": true, "device": {...}}`` when every phase passed; otherwise the
script exits non-zero without it. It also exits non-zero when JAX's
device is not a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"
EXAMPLE = GOLDEN / "example.phy"

# golden logL of `iqtree2 -s example.phy -te ref_tree.nwk -m GTR+G`
# (tests/golden/golden.json g4_gtrg_opt)
GOLDEN_GTRG = -21161.9433
# bars held on the CPU by tests/test_cli_precision.py
F32_CLI_BAR = -21162.05
F64_CLI_SLACK = 2e-3
# ModelFinder winner of the same `-m MF` run on the CPU backend
MF_WINNER = "TIM2+I+G"

# phase-2 sizes: (ntaxa, nsites, model)
LIKELIHOOD_CASES = ((1000, 20000, "GTR+G4"), (200, 5000, "LG+G4"))
# float32 vs float64 bars, a few times the largest reading on an H100
# (PERF.md): per-pattern |d lp| 1.0e-4 (1000 taxa) and 5.2e-5 (LG+G4);
# relative |d logL| 2.0e-7 after the 10-round optimization
LP_BAR = 3e-4
REL_LOGL_BAR = 1e-6
# search iterations capped so each phase takes minutes, compile included
UFBOOT_TAXA, UFBOOT_SITES, UFBOOT_ITERS = 100, 10000, 8
FOUR_TAXA, FOUR_SITES, FOUR_ITERS = 200, 10000, 4
DRYRUN_TAXA, DRYRUN_PATTERNS = 1000, 65536
# each --four-cards child phase; a cold compile cache needs most of it
CHILD_TIMEOUT_S = 900


class CompileClock:
    """Sums XLA backend-compile seconds (persistent-cache loads included)
    and counts persistent-cache hits, through jax.monitoring. Tracing and
    lowering are left out: nested jits report them once per level."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax
        self.secs = 0.0
        self.cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def _dur(self, event, duration, **_):
        if event == self.EVENT:
            self.secs += duration

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1


class Phases:
    """Runs phases, prints one JSON line each, remembers failures."""

    def __init__(self, clock: CompileClock | None):
        self.clock = clock
        self.dev = None
        self.failed: list[str] = []

    def _peak(self):
        return ((self.dev.memory_stats() or {}).get("peak_bytes_in_use")
                if self.dev is not None else None)

    def run(self, name, fn):
        c0 = self.clock.secs if self.clock else 0.0
        h0 = self.clock.cache_hits if self.clock else 0
        rec = {"phase": name}
        checks: list[dict] = []
        peak0 = self._peak()
        t0 = time.perf_counter()
        try:
            rec.update(fn(checks) or {})
        except Exception:                         # noqa: BLE001
            traceback.print_exc()
            rec["error"] = traceback.format_exc(limit=3).splitlines()[-1]
        rec["wall_s"] = time.perf_counter() - t0
        # the process-wide peak, where this phase raised it
        peak = self._peak()
        if peak is not None and peak != peak0:
            rec["peak_bytes_in_use"] = peak
        if self.clock:
            rec["compile_s"] = self.clock.secs - c0
            rec["cache_hits"] = self.clock.cache_hits - h0
        rec["checks"] = checks
        rec["ok"] = "error" not in rec and all(c["ok"] for c in checks)
        if not rec["ok"]:
            self.failed.append(name)
        print(json.dumps(rec, default=float), flush=True)
        return rec


def check(checks, name, value, op, bar):
    ok = {">=": value >= bar, "<=": value <= bar, "==": value == bar}[op]
    checks.append({"name": name, "value": value, "op": op, "bar": bar,
                   "ok": bool(ok)})
    return ok


def report_logl(prefix: str) -> float:
    text = Path(prefix + ".iqtree").read_text()
    return float(re.search(r"Log-likelihood of the tree: (-[\d.]+)",
                           text).group(1))


def run_cli(args: list[str], prefix: str) -> None:
    from iqtree2_tpu import cli
    rc = cli.main(args + ["-pre", prefix, "-redo", "--quiet"])
    if rc != 0:
        raise RuntimeError(f"cli.main{args} returned {rc}")


def simulated_alignment(ntaxa, nsites, kind, seed):
    """(Alignment, simulating tree, model, rates, {name: sequence}) from
    AliSim."""
    import numpy as np

    from iqtree2_tpu.data.alignment import Alignment
    from iqtree2_tpu.model.dna import make_dna_model
    from iqtree2_tpu.model.protein import make_protein_model
    from iqtree2_tpu.model.rates import RateGamma
    from iqtree2_tpu.simulator import simulate_alignment
    from iqtree2_tpu.treeutils import random_tree

    rng = np.random.default_rng(seed)
    if kind == "LG+G4":
        model, rates, st = make_protein_model("LG"), RateGamma(4, 0.8), "AA"
    else:
        model = make_dna_model(
            "GTR", freqs=np.array([0.3, 0.2, 0.2, 0.3]), freq_type="user",
            rate_params=np.array([1.5, 4.0, 1.2, 0.8, 5.0]))
        rates, st = RateGamma(4, 0.6), "DNA"
    tree = random_tree(ntaxa, "yule", rng)
    seqs = simulate_alignment(tree, model, rates, nsites, rng)
    seqs = {n: seqs[n] for n in tree.taxon_names}
    aln = Alignment.from_sequences(list(seqs), list(seqs.values()),
                                   seqtype=st)
    return aln, tree, model, rates, seqs


# ------------------------------------------------------------------ phases
def phase_device(checks, dev, card):
    import jax

    from iqtree2_tpu import native
    return {"card": card, "platform": dev.platform,
            "kind": dev.device_kind, "count": len(jax.devices()),
            "native_host_library": native.available(),
            "jax": jax.__version__}


def phase_golden(checks, tmp):
    import jax
    args = ["-s", str(EXAMPLE), "-te", str(GOLDEN / "ref_tree.nwk"),
            "-m", "GTR+G"]
    t0 = time.perf_counter()
    run_cli(args, f"{tmp}/g32")
    wall32 = time.perf_counter() - t0
    l32 = report_logl(f"{tmp}/g32")
    check(checks, "f32_logL_floor", l32, ">=", F32_CLI_BAR)
    check(checks, "f32_logL_ceiling", l32, "<=", GOLDEN_GTRG + 1.0)
    t0 = time.perf_counter()
    try:
        run_cli(args + ["--f64"], f"{tmp}/g64")
    finally:
        jax.config.update("jax_enable_x64", False)   # back to the default
    wall64 = time.perf_counter() - t0
    l64 = report_logl(f"{tmp}/g64")
    check(checks, "f64_logL_floor", l64, ">=", GOLDEN_GTRG - F64_CLI_SLACK)
    check(checks, "f64_logL_ceiling", l64, "<=", GOLDEN_GTRG + 1.0)
    return {"f32_logL": l32, "f64_logL": l64, "golden": GOLDEN_GTRG,
            "f32_wall_s": wall32, "f64_wall_s": wall64}


def phase_likelihood(checks, ntaxa, nsites, kind):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from iqtree2_tpu.engine import LikelihoodEngine
    from tests.reference_impl import brute_force_site_lp

    out = {"ntaxa": ntaxa, "nsites": nsites, "model": kind}
    t0 = time.perf_counter()
    aln, tree, model, rates, _ = simulated_alignment(ntaxa, nsites, kind,
                                                     seed=ntaxa)
    out["patterns"] = aln.num_patterns
    out["simulate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_lp = brute_force_site_lp(aln, tree, model, rates)
    ref_logL = float((aln.pattern_weights * ref_lp).sum())
    out["reference_host_s"] = time.perf_counter() - t0

    def timed(fn):
        t = time.perf_counter()
        r = fn()
        return r, time.perf_counter() - t

    # float32: the default precision of every analysis
    e32 = LikelihoodEngine(aln, model, rates, dtype=jnp.float32)
    (l32, lp32), out["f32_first_call_s"] = timed(lambda: e32.site_lp(tree))
    _, out["f32_loglik_s"] = timed(lambda: e32.site_lp(tree))
    t32 = tree.copy()
    o32, out["f32_opt10_first_call_s"] = timed(
        lambda: e32.optimize_branches(t32, n_rounds=10))
    # float64 on the card, global x64 scoped to this block
    jax.config.update("jax_enable_x64", True)
    try:
        e64 = LikelihoodEngine(aln, model, rates, dtype=jnp.float64)
        (l64, lp64), out["f64_first_call_s"] = timed(
            lambda: e64.site_lp(tree))
        t64 = tree.copy()
        o64, out["f64_opt10_first_call_s"] = timed(
            lambda: e64.optimize_branches(t64, n_rounds=10))
    finally:
        jax.config.update("jax_enable_x64", False)

    d32 = float(np.max(np.abs(lp32 - ref_lp)))
    d64 = float(np.max(np.abs(lp64 - ref_lp)))
    d3264 = float(np.max(np.abs(lp32 - lp64)))
    out.update(logL_reference=ref_logL, logL_f32=l32, logL_f64=l64,
               max_dlp_f32_vs_reference=d32, max_dlp_f64_vs_reference=d64,
               max_dlp_f32_vs_f64=d3264, opt10_logL_f32=o32,
               opt10_logL_f64=o64)
    check(checks, "max_dlp_f32_vs_reference", d32, "<=", LP_BAR)
    check(checks, "max_dlp_f32_vs_f64", d3264, "<=", LP_BAR)
    check(checks, "max_dlp_f64_vs_reference", d64, "<=", 1e-8)
    check(checks, "rel_dlogL_f32_vs_reference",
          abs(l32 - ref_logL) / abs(ref_logL), "<=", REL_LOGL_BAR)
    check(checks, "opt10_f32_gain", o32 - l32, ">=", 0.0)
    check(checks, "opt10_f64_gain", o64 - l64, ">=", 0.0)
    check(checks, "rel_dopt10_f32_vs_f64", abs(o32 - o64) / abs(o64), "<=",
          REL_LOGL_BAR)
    return out


def phase_search(checks, tmp):
    run_cli(["-s", str(EXAMPLE), "-m", "GTR+G"], f"{tmp}/search")
    logL = report_logl(f"{tmp}/search")
    # the fixed reference tree's optimum under the same model
    check(checks, "search_logL", logL, ">=", -21161.94)
    return {"logL": logL}


def phase_ufboot(checks, tmp):
    from iqtree2_tpu.simulator import write_phylip_seqs
    _, tree, _, _, seqs = simulated_alignment(UFBOOT_TAXA, UFBOOT_SITES,
                                              "GTR+G4", seed=7)
    path = f"{tmp}/sim100.phy"
    write_phylip_seqs(path, seqs)
    Path(f"{tmp}/sim100_true.nwk").write_text(tree.to_newick() + "\n")
    t0 = time.perf_counter()
    run_cli(["-s", path, "-m", "GTR+G", "-bb", "1000", "-n",
             str(UFBOOT_ITERS)], f"{tmp}/bb")
    search_s = time.perf_counter() - t0
    ml = report_logl(f"{tmp}/bb")
    run_cli(["-s", path, "-m", "GTR+G", "-te", f"{tmp}/sim100_true.nwk"],
            f"{tmp}/true")
    true_opt = report_logl(f"{tmp}/true")
    n_boot = sum(1 for ln in Path(f"{tmp}/bb.ufboot").read_text()
                 .splitlines() if ln.strip())
    check(checks, "treefile_written", Path(f"{tmp}/bb.treefile").exists(),
          "==", True)
    check(checks, "contree_written", Path(f"{tmp}/bb.contree").exists(),
          "==", True)
    check(checks, "ufboot_trees", n_boot, "==", 1000)
    check(checks, "ml_minus_true_tree_reoptimized", ml - true_opt, ">=",
          -0.5)
    return {"ntaxa": UFBOOT_TAXA, "nsites": UFBOOT_SITES,
            "iterations": UFBOOT_ITERS, "search_ufboot_s": search_s,
            "ml_logL": ml, "true_tree_reoptimized_logL": true_opt}


def phase_modelfinder(checks, tmp):
    run_cli(["-s", str(EXAMPLE), "-m", "MF"], f"{tmp}/mf")
    m = re.search(r"Best-fit model: (\S+)",
                  Path(f"{tmp}/mf.log").read_text())
    best = m.group(1) if m else ""
    check(checks, "winner", best, "==", MF_WINNER)
    return {"best_model": best}


# ------------------------------------------------------------ four cards
def _child_env(**extra):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), **extra)


def _wait_all(procs, timeout):
    """communicate() with every child within one deadline; children still
    running at the deadline are killed. Returns [(rc, stdout, stderr)]."""
    deadline = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        outs.append((p.returncode, so, se))
    return outs


def _rank_cmd(aln_path, prefix, nranks, rank, gdir):
    return [sys.executable, "-m", "iqtree2_tpu", "-s", aln_path,
            "-m", "GTR+G", "-seed", "7", "-n", str(FOUR_ITERS),
            "-pre", prefix, "-redo", "--quiet", "--dist-nranks",
            str(nranks), "--dist-rank", str(rank), "--dist-dir", gdir]


def phase_sharded(checks):
    """``dryrun_multichip`` on the four cards, in a child process that
    exits before the search children take the cards. The dryrun asserts
    its own bars against one card and returns what it measured."""
    code = ("import json, __graft_entry__ as g; print('DRYRUN ' + "
            f"json.dumps(g.dryrun_multichip(4, ntaxa={DRYRUN_TAXA}, "
            f"npat={DRYRUN_PATTERNS})))")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                         env=_child_env(), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    (rc, so, se), = _wait_all([p], CHILD_TIMEOUT_S)
    lines = [ln for ln in so.splitlines() if ln.startswith("DRYRUN ")]
    if rc != 0 or not lines:
        raise RuntimeError(f"dryrun child rc={rc}: {se[-1500:]}")
    check(checks, "dryrun_passed", True, "==", True)
    return json.loads(lines[-1][len("DRYRUN "):])


def phase_distributed(checks, tmp):
    """1-rank and 4-rank distributed searches, one child per card. Both
    runs start together; card 0 holds two processes, so every child gets
    an explicit share of its card's memory."""
    from iqtree2_tpu.simulator import write_phylip_seqs
    from iqtree2_tpu.tree.topology import Tree
    _, _, _, _, seqs = simulated_alignment(FOUR_TAXA, FOUR_SITES, "GTR+G4",
                                           seed=11)
    path = f"{tmp}/sim200.phy"
    write_phylip_seqs(path, seqs)
    jobs = [("one", 0, 1, 0)] + [("four", k, 4, k) for k in range(4)]
    procs = [subprocess.Popen(
        _rank_cmd(path, f"{tmp}/{name}", nranks, rank,
                  f"{tmp}/gossip_{name}"),
        env=_child_env(XLA_PYTHON_CLIENT_MEM_FRACTION="0.45",
                       CUDA_VISIBLE_DEVICES=str(card)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, card, nranks, rank in jobs]
    t0 = time.perf_counter()
    outs = _wait_all(procs, CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for (rc, _, se), job in zip(outs, jobs):
        if rc != 0:
            raise RuntimeError(f"rank job {job} rc={rc} after {wall:.0f} s:"
                               f" {se[-1500:]}")
    nwk1 = Path(f"{tmp}/one.treefile").read_text().strip()
    nwk4 = [Path(f"{tmp}/four{'' if k == 0 else f'.rank{k}'}.treefile")
            .read_text().strip() for k in range(4)]
    t1 = Tree.from_newick(nwk1, None)
    splits1 = set(t1.splits())
    same = [set(Tree.from_newick(s, t1.taxon_names).splits()) == splits1
            for s in nwk4]
    check(checks, "four_rank_trees_equal_one_rank", all(same), "==", True)
    return {"ntaxa": FOUR_TAXA, "nsites": FOUR_SITES,
            "iterations": FOUR_ITERS, "wall_children_s": wall,
            "logL_one_rank": report_logl(f"{tmp}/one"),
            "logL_four_rank": [report_logl(f"{tmp}/four" + (
                "" if k == 0 else f".rank{k}")) for k in range(4)]}


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card distributed and sharded "
                         "phases")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from iqtree2_tpu.utils.device import (card_info, device_record,
                                          require_gpu)

    card = card_info()                  # before JAX reserves the card
    print(f"card: {card if card else 'not found (no nvidia-smi)'}",
          flush=True)
    tmp_ctx = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmp_ctx.name
    phases = Phases(None)
    if args.four_cards:
        # children take the cards before this process touches JAX
        phases.run("sharded_dryrun_4_cards", phase_sharded)
        phases.run("distributed_search_1_vs_4_ranks",
                   lambda c: phase_distributed(c, tmp))

    try:
        dev = require_gpu()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    from iqtree2_tpu.utils.compilecache import enable_compile_cache
    cache_dir = enable_compile_cache(min_compile_secs=1.0)
    phases.clock = CompileClock()
    phases.dev = dev
    phases.run("device", lambda c: dict(
        phase_device(c, dev, card), compile_cache=cache_dir))
    if args.four_cards:
        expect = 4
    else:
        phases.run("golden_cli_parity", lambda c: phase_golden(c, tmp))
        for ntaxa, nsites, kind in LIKELIHOOD_CASES:
            phases.run(f"likelihood_{kind}_{ntaxa}x{nsites}",
                       lambda c, a=(ntaxa, nsites, kind):
                       phase_likelihood(c, *a))
        phases.run("search_example_GTR+G", lambda c: phase_search(c, tmp))
        phases.run("search_ufboot1000_sim100",
                   lambda c: phase_ufboot(c, tmp))
        phases.run("modelfinder_example", lambda c: phase_modelfinder(c, tmp))
        expect = 1
    tmp_ctx.cleanup()
    record = device_record(dev)
    if phases.failed or record["count"] != expect:
        print(f"failed phases: {phases.failed}; device count "
              f"{record['count']}, expected {expect}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
