#!/usr/bin/env python
"""Device memory of the XLA likelihood and search programs.

    python tools/xla_probe.py 200x16384 1000x16384

For each NTAXAxNPAT, compiles the search programs for a random GTR+G4
problem of that size and prints compiled.memory_analysis(), with the
temporary bytes also as "slabs": one node's float32 partials [C, S, Ppat]
per tree node (per tree for the batched programs). The search's memory
plan (engine._BATCH_SLABS_PER_NODE and its neighbours) is set from these.
Sizes of 512 taxa or more compile only the serial programs.

One JSON line per program; all of them also go to
chiprun_out/xla_probe.json.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _mem(compiled, slab, per):
    m = compiled.memory_analysis()
    rec = {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes") if hasattr(m, k)}
    rec["temp_slabs_per_node"] = rec.get("temp_size_in_bytes", 0) / slab / per
    return rec


def memory(ntaxa, npat, out):
    import jax.numpy as jnp

    from bench import make_problem
    from iqtree2_tpu import engine as E
    from iqtree2_tpu.ops.nni import build_nni_candidates
    from iqtree2_tpu.tree.schedule import build_schedule
    from iqtree2_tpu.tree.topology import Tree

    eng, _ = make_problem(ntaxa=ntaxa, npat=npat)
    slab = (eng.pack_np.cat_rate.shape[0] * eng.aln.num_states * eng.Pp
            * eng.dtype.itemsize)
    n_nodes = 2 * ntaxa - 2
    lo, hi = eng._dev_scalar(E.DEFAULT_MIN_BLEN), eng._dev_scalar(
        E.DEFAULT_MAX_BLEN)
    rng = np.random.default_rng(0)
    trees = [Tree.random_topology(eng.aln.names, rng) for _ in range(2)]
    scheds = [build_schedule(t) for t in trees]
    cands = [np.stack([c.iu, c.iv, c.slot_c, c.edge_id]) for c in (
        build_nni_candidates(t, s) for t, s in zip(trees, scheds))]
    blens = [jnp.asarray(np.maximum(s.blens, 1e-6), eng.dtype)
             for s in scheds]
    sa = eng.schedule_arrays(scheds[0])
    common = (eng._dev_tipP, sa, eng._dev_pack, eng._dev_pw, lo, hi)

    def record(name, lower, per=n_nodes, **extra):
        t0 = time.perf_counter()
        try:
            rec = _mem(lower().compile(), slab, per)
        except Exception as e:                          # noqa: BLE001
            rec = {"error": repr(e)[:400]}
        rec.update(program=name, ntaxa=ntaxa, patterns=eng.Pp,
                   slab_bytes=slab, compile_s=time.perf_counter() - t0,
                   **extra)
        out.append(rec)
        print(json.dumps(rec), flush=True)

    record("opt10_serial", lambda: E._opt_flat_jit.lower(
        blens[0], *common, kind="std", n_rounds=10))
    chunk = 256 if ntaxa >= 512 else 32
    for c in (None, chunk):
        record("nni_round_serial", lambda c=c: E._opt_nni_flat_jit.lower(
            jnp.asarray(cands[0]), blens[0], *common, n_rounds=2,
            nni5=True, cand_chunk=c), cand_chunk=c)
    if ntaxa >= 512:
        return
    for k in (1, 2):
        sd = eng._stack_scheds(scheds[:k])
        cand = jnp.asarray(np.stack(cands[:k]))
        b = jnp.stack(blens[:k])
        bc = (eng._dev_tipP, sd, eng._dev_pack, eng._dev_pw, lo, hi)
        record("nni_round_batch", lambda: E._opt_nni_flat_batch_jit.lower(
            cand, b, *bc, n_rounds=2, nni5=True), per=n_nodes * k, k=k)
        record("opt4_batch", lambda: E._opt_flat_batch_jit.lower(
            b, *bc, n_rounds=4), per=n_nodes * k, k=k)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="+", metavar="NTAXAxNPAT")
    args = ap.parse_args(argv)
    out: list[dict] = []
    for size in args.sizes:
        ntaxa, npat = (int(v) for v in size.split("x"))
        memory(ntaxa, npat, out)
    dest = REPO / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "xla_probe.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
