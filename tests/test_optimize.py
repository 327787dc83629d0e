"""Model-parameter optimization and NNI search vs reference golden values."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from iqtree2_tpu.engine import LikelihoodEngine
from iqtree2_tpu.io.alignment_io import read_alignment
from iqtree2_tpu.model.dna import make_dna_model
from iqtree2_tpu.model.factory import build_model
from iqtree2_tpu.model.optimize import optimize_model_parameters
from iqtree2_tpu.model.rates import RateGamma
from iqtree2_tpu.search.nni import nni_optimize
from iqtree2_tpu.tree.topology import Tree

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def example_aln():
    return read_alignment(GOLDEN / "example.phy", seqtype="DNA")


@pytest.fixture(scope="module")
def ref_tree(example_aln):
    return Tree.from_newick((GOLDEN / "ref_tree.nwk").read_text(),
                            example_aln.names)


@pytest.fixture(scope="module")
def golden():
    return json.loads((GOLDEN / "golden.json").read_text())


def test_model_factory_parses():
    aln = read_alignment(GOLDEN / "example.phy", seqtype="DNA")
    for s in ["GTR+G", "HKY+I+G4", "JC", "GTR{1.0,2.0,1.5,0.8,3.0}+F+R3",
              "TN+I", "K2P+G{0.5}"]:
        model, rates, _ = build_model(s, aln)
        assert model.num_states == 4


def test_gtr_g_optimization_matches_reference(example_aln, ref_tree, golden):
    """g4: GTR+G free params + branch lengths on the reference topology.

    Reference logL: -21161.9433 (g4_gtrg_opt).
    """
    model, rates, _ = build_model("GTR+G", example_aln)
    eng = LikelihoodEngine(example_aln, model, rates, dtype=jnp.float64)
    t = ref_tree.copy()
    logL = optimize_model_parameters(eng, t, epsilon=0.01)
    assert logL == pytest.approx(golden["logL"]["g4_gtrg_opt"], abs=0.5)


def test_nni_search_from_bionj(example_aln, golden):
    """NNI hill-climbing from a BIONJ start should reach (or beat) the
    reference HKY search logL (g0: -23117.03)."""
    from iqtree2_tpu.ops.distances import ml_distances
    from iqtree2_tpu.search.bionj import bionj_tree

    model, rates, _ = build_model("HKY", example_aln)
    eng = LikelihoodEngine(example_aln, model, rates, dtype=jnp.float64)
    D = ml_distances(example_aln, model, dtype=jnp.float64)
    t = bionj_tree(D, example_aln.names)
    t.clamp_blens(1e-6, 10.0)
    res = nni_optimize(eng, t)
    # model params (kappa, freqs) still at empirical init; optimize them
    logL = optimize_model_parameters(eng, t, epsilon=0.01)
    assert logL >= golden["logL"]["g0_search"] - 1.0


def test_jaxfit_batch_matches_sequential(example_aln, ref_tree):
    """try_fit_batch (vmapped multi-model screening) must agree with
    per-model try_fit on the same topology."""
    import jax.numpy as jnp
    from iqtree2_tpu.engine import LikelihoodEngine
    from iqtree2_tpu.model import jaxfit
    from iqtree2_tpu.model.factory import build_model

    names = ["HKY+G", "K2P+G", "TN+G"]
    pairs = [build_model(n, example_aln)[:2] for n in names]
    eng0 = LikelihoodEngine(example_aln, pairs[0][0], pairs[0][1],
                            dtype=jnp.float32)
    batched = jaxfit.try_fit_batch(eng0, ref_tree.copy(), pairs,
                                   epsilon=0.1, dtype=jnp.float64)
    assert batched is not None and len(batched) == 3
    for name, got in zip(names, batched):
        model, rates, _ = build_model(name, example_aln)
        eng = LikelihoodEngine(example_aln, model, rates,
                               dtype=jnp.float64)
        ref = jaxfit.try_fit(eng, ref_tree.copy(), epsilon=0.1,
                             dtype=jnp.float64)
        assert got == pytest.approx(ref, abs=1.0), name


def test_nni_optimize_batch_matches_serial():
    """The lockstep batched NNI hill-climb (one vmapped dispatch per
    round) must reach the same optimum as the serial per-tree climb on
    each tree (engine._opt_nni_flat_batch_jit / nni_optimize_batch)."""
    import numpy as np
    from tests.helpers import dna_problem
    from iqtree2_tpu.search.nni import nni_optimize, nni_optimize_batch
    from iqtree2_tpu.tree.topology import Tree

    eng, _ = dna_problem(10, npat=128, seed=5)
    rng = np.random.default_rng(3)
    trees_a = [Tree.random_topology(eng.aln.names, rng) for _ in range(3)]
    trees_b = [t.copy() for t in trees_a]
    serial = [nni_optimize(eng, t).logL for t in trees_a]
    batched = [r.logL for r, _ in nni_optimize_batch(eng, trees_b)]
    for s, b in zip(serial, batched):
        assert abs(s - b) < 0.05, (s, b)
    # identical topologies reached
    for ta, tb in zip(trees_a, trees_b):
        assert ta.topology_id() == tb.topology_id()
