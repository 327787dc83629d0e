"""+E sequencing-error model (reference: model/modeldnaerror.cpp)."""
import numpy as np
import jax.numpy as jnp

from tests.helpers import dna_problem
from iqtree2_tpu.engine import LikelihoodEngine
from iqtree2_tpu.model.factory import build_model
from iqtree2_tpu.model.optimize import optimize_model_parameters


def test_eps_zero_matches_plain():
    eng32, tree = dna_problem(8, npat=64, seed=7)
    aln = eng32.aln
    m_e, r_e, ex = build_model("GTR+E{0.0001}+G4", aln)
    assert ex.get("seqerr") == "E"
    e1 = LikelihoodEngine(aln, m_e, r_e, dtype=jnp.float64)
    m_p, r_p, _ = build_model("GTR+G4", aln)
    e2 = LikelihoodEngine(aln, m_p, r_p, dtype=jnp.float64)
    a, b = e1.loglik_tree(tree), e2.loglik_tree(tree)
    assert abs(a - b) < 0.05 * abs(b) and abs(a - b) > 0  # eps tiny


def test_tip_rows_follow_reference_formula():
    from iqtree2_tpu.model.seqerror import DNAErrorModel
    from iqtree2_tpu.model.dna import make_dna_model
    from iqtree2_tpu.data import seqtypes
    inner = make_dna_model("JC")
    m = DNAErrorModel(inner, epsilon=0.09)
    table = seqtypes.dna_type().tip_table
    out = m.transform_tip_table(table)
    eps = 0.09
    # definite state (k=1): observed = 1 - 3*eps/3 = 1-eps; others eps/3
    row = out[0]   # code 0 = A
    np.testing.assert_allclose(row[0], 1 - eps)
    np.testing.assert_allclose(row[1:], eps / 3)
    # unknown (k=4): all ones
    np.testing.assert_allclose(out[14], 1.0)
    # base-specific +EA (reference: observed_lk = observed[b] ? 1 : 1-eps,
    # unobserved_lk = observed[b] ? eps : 0):
    mA = DNAErrorModel(inner, epsilon=eps, error_base=0)
    outA = mA.transform_tip_table(table)
    # observed C (code 1), A unobserved: C = 1-eps, everything else 0
    np.testing.assert_allclose(outA[1], [0.0, 1 - eps, 0.0, 0.0])
    # observed A (code 0): A = 1, others = eps
    np.testing.assert_allclose(outA[0], [1.0, eps, eps, eps])


def test_epsilon_is_optimized():
    eng32, tree = dna_problem(8, npat=96, seed=17)
    aln = eng32.aln
    m, r, _ = build_model("HKY+E", aln)
    m0, _, _ = build_model("HKY", aln)
    assert m.num_free_params() == m0.num_free_params() + 1  # + epsilon
    eng = LikelihoodEngine(aln, m, r, dtype=jnp.float64)
    logL = optimize_model_parameters(eng, tree.copy(), epsilon=0.05,
                                     max_rounds=2)
    assert np.isfinite(logL)
    assert 1e-4 <= m.epsilon <= 0.5
