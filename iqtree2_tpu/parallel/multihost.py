"""Multi-host distributed tree search: replicated controllers with
candidate-tree gossip, deterministic BSP rounds, and UFBoot state merge.

Reference analog: the MPI search parallelism (utils/MPIHelper.h:118-136
sendCheckpoint/recvCheckpoint, tree/iqtree.cpp:4337 syncCandidateTrees,
:4406 syncCurrentTree, :4479 sendStopMessage): each rank runs independent
perturb+NNI iterations and exchanges candidate trees / UFBoot deltas as
serialized key-value blobs.

Redesign for determinism: search proceeds in BSP ROUNDS of K iterations.
Iteration i is owned by rank (i mod nranks); its RNG stream is seeded by
(seed, i) and it perturbs a candidate chosen from the LAST ROUND's merged
candidate snapshot — so the merged state after every round is a pure
function of (seed, data), independent of the number of ranks. An
n-process run therefore produces EXACTLY the same tree as a 1-process
run (the reference's MPI mode makes no such guarantee).

Transports:
  - FileGossip: shared-directory barrier files (works for multi-process
    tests and cluster shared filesystems)
  - JaxGossip: jax.experimental.multihost_utils.process_allgather over
    the jax.distributed control plane (multi-process jobs; numeric
    site-sharding rides the jax Mesh independently — SURVEY §2c
    distributed reduction)

init_distributed() wires jax.distributed.initialize() from standard env
vars when present.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np

from iqtree2_tpu.search.candidate import CandidateSet
from iqtree2_tpu.search.nni import nni_optimize
from iqtree2_tpu.search.perturb import random_nnis
from iqtree2_tpu.tree.topology import Tree


def init_distributed() -> tuple[int, int]:
    """Initialize jax.distributed from the environment when configured.

    Returns (process_index, process_count)."""
    import jax
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord and os.environ.get("JAX_NUM_PROCESSES"):
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=int(os.environ.get("JAX_PROCESS_ID", "0")))
    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


class FileGossip:
    """Shared-directory all-gather of JSON blobs with a round barrier."""

    def __init__(self, root: str | Path, rank: int, nranks: int,
                 timeout: float = 600.0):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.rank = rank
        self.nranks = nranks
        self.timeout = timeout

    def allgather(self, round_id: int, payload: dict) -> list[dict]:
        me = self.root / f"r{round_id:06d}_rank{self.rank}.json"
        tmp = me.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload))
        tmp.replace(me)
        out = []
        t0 = time.time()
        for k in range(self.nranks):
            f = self.root / f"r{round_id:06d}_rank{k}.json"
            while not f.exists():
                if time.time() - t0 > self.timeout:
                    raise TimeoutError(f"gossip barrier timed out on {f}")
                time.sleep(0.02)
            while True:   # atomic rename guarantees full content
                try:
                    out.append(json.loads(f.read_text()))
                    break
                except json.JSONDecodeError:
                    time.sleep(0.02)
        return out


class JaxGossip:
    """process_allgather of UTF-8 JSON (padded uint8) over jax.distributed."""

    MAXLEN = 4 << 20

    def __init__(self, rank: int, nranks: int):
        self.rank = rank
        self.nranks = nranks

    def allgather(self, round_id: int, payload: dict) -> list[dict]:
        import jax.numpy as jnp
        from jax.experimental import multihost_utils
        raw = json.dumps(payload).encode()
        assert len(raw) < self.MAXLEN, "gossip payload too large"
        buf = np.zeros(self.MAXLEN + 8, np.uint8)
        n = len(raw)
        buf[:8] = np.frombuffer(np.int64(n).tobytes(), np.uint8)
        buf[8: 8 + n] = np.frombuffer(raw, np.uint8)
        allb = multihost_utils.process_allgather(jnp.asarray(buf))
        out = []
        for k in range(allb.shape[0]):
            row = np.asarray(allb[k])
            ln = int(np.frombuffer(row[:8].tobytes(), np.int64)[0])
            out.append(json.loads(row[8: 8 + ln].tobytes().decode()))
        return out


class DistributedSearch:
    """BSP-round tree search over any gossip transport.

    A 1-rank instance is the deterministic serial reference; n ranks
    split each round's iterations and merge results identically."""

    def __init__(self, eng, aln, gossip, rank: int, nranks: int,
                 seed: int = 1, n_init_trees: int = 20,
                 n_nni_trees: int = 10, pop_size: int = 5,
                 round_size: int | None = None, n_rounds: int = 4,
                 pertub_strength: float = 0.5, ufboot=None,
                 log=lambda s: None, constraint=None,
                 slice_ufboot: bool = True):
        self.eng = eng
        self.aln = aln
        self.gossip = gossip
        self.rank = rank
        self.nranks = nranks
        self.seed = seed
        self.n_init = n_init_trees
        self.pop_size = pop_size
        self.round_size = round_size or max(nranks, 4)
        self.n_rounds = n_rounds
        self.strength = pertub_strength
        self.cands = CandidateSet(max_size=n_nni_trees, max_top=pop_size)
        self.ufboot = ufboot
        self.log = log
        self.constraint = constraint   # -g topology constraint (enforced
        #                                in starts, perturbation and NNI)
        if ufboot is not None and slice_ufboot and nranks > 1:
            # distributed UFBoot: each rank RELL-updates only its
            # replicate slice; the gossip champion-merge fills the rest
            # (reference: tree/iqtree.cpp:352-362 sample ranges)
            R = ufboot.n_replicates
            ufboot.set_replicate_slice(rank * R // nranks,
                                       (rank + 1) * R // nranks)

    # ------------------------------------------------------------ helpers
    def _iter_result(self, i: int, snapshot: list[tuple[str, float]]):
        """Run ONE search iteration with an iteration-seeded RNG stream
        against the frozen candidate snapshot."""
        rng = np.random.default_rng((self.seed, 0xD15C0, i))
        k = min(self.pop_size, len(snapshot))
        nwk, _ = snapshot[rng.integers(0, k)]
        t = Tree.from_newick(nwk, self.aln.names)
        random_nnis(t, rng, self.strength, constraint=self.constraint)
        res = nni_optimize(self.eng, t, loglh_epsilon=0.001,
                           constraint=self.constraint)
        lp = None
        if self.ufboot is not None:
            _, lp = self.eng.site_lp(t)
        return t, res.logL, lp

    def _merge_round(self, blobs: list[dict]) -> None:
        """Deterministic merge: apply every iteration's result in
        iteration order (the merged state is rank-count independent)."""
        items = []
        for blob in blobs:
            for it_s, (nwk, logL) in blob["results"].items():
                items.append((int(it_s), nwk, logL))
        for i, nwk, logL in sorted(items):
            self.cands.update(Tree.from_newick(nwk, self.aln.names),
                              float(logL))
        if self.ufboot is not None:
            # champion merge per replicate: max logl, earliest iteration
            # tie-break (reference: saveUFBoot/restoreUFBoot in
            # syncCurrentTree)
            for blob in blobs:
                ub = blob.get("ufboot")
                if not ub:
                    continue
                logl = np.asarray(ub["boot_logl"])
                better = logl > self.ufboot.boot_logl + 1e-12
                for r in np.nonzero(better)[0]:
                    tid = ub["boot_trees"][r]
                    self.ufboot.boot_logl[r] = logl[r]
                    self.ufboot.boot_trees[r] = tid
                    if tid is not None and \
                            tid not in self.ufboot.trees_newick:
                        self.ufboot.trees_newick[tid] = \
                            ub["trees_newick"][tid]

    # --------------------------------------------------------------- run
    def run(self):
        # round 0: deterministic init (identical on all ranks, iteration
        # split): stepwise-addition parsimony starts
        from iqtree2_tpu.ops.pars import random_stepwise_addition
        results: dict[int, tuple[str, float]] = {}
        for i in range(self.n_init):
            if i % self.nranks != self.rank:
                continue
            rng = np.random.default_rng((self.seed, 0x1217, i))
            t = random_stepwise_addition(self.aln, rng,
                                         constraint=self.constraint)
            logL = self.eng.optimize_branches(t, n_rounds=4)
            if self.ufboot is not None:
                _, lp = self.eng.site_lp(t)
                self.ufboot.add_tree(t, lp, tree_logL=logL)
            results[i] = (t.to_newick(digits=17), logL)
        self._merge_round(self.gossip.allgather(0, self._blob(results)))

        for rnd in range(1, self.n_rounds + 1):
            snapshot = [(it.tree.to_newick(digits=17), it.logL)
                        for it in self.cands.items]
            results = {}
            base = rnd * 1_000_000
            for j in range(self.round_size):
                i = base + j
                if j % self.nranks != self.rank:
                    continue
                t, logL, lp = self._iter_result(i, snapshot)
                if self.ufboot is not None and lp is not None:
                    self.ufboot.add_tree(t, lp, tree_logL=logL)
                results[i] = (t.to_newick(digits=17), logL)
            self._merge_round(
                self.gossip.allgather(rnd, self._blob(results)))
            self.log(f"[rank {self.rank}] round {rnd}: best "
                     f"{self.cands.best_score():.4f}")
        best = self.cands.best()
        return best.tree.copy(), best.logL

    def _blob(self, results) -> dict:
        blob = {"results": {str(k): v for k, v in results.items()}}
        if self.ufboot is not None:
            blob["ufboot"] = {
                "boot_logl": self.ufboot.boot_logl.tolist(),
                "boot_trees": self.ufboot.boot_trees,
                "trees_newick": self.ufboot.trees_newick,
            }
        return blob
