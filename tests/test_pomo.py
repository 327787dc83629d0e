"""PoMo polymorphism-aware model (reference: model/modelpomo.h:40)."""
import numpy as np
import jax.numpy as jnp

from tests.helpers import dna_problem
from iqtree2_tpu.engine import LikelihoodEngine
from iqtree2_tpu.model.factory import build_model
from iqtree2_tpu.model.pomo import PoMoModel


def test_pomo_state_space_and_q():
    m = PoMoModel(N=9)
    assert m.num_states == 4 + 6 * 8 == 52   # modelpomo.cpp:177
    Q = m.build_Q()
    np.testing.assert_allclose(Q.sum(axis=1), 0.0, atol=1e-12)
    assert (Q - np.diag(np.diag(Q)) >= 0).all()
    pi = m.stationary(Q)
    np.testing.assert_allclose(pi.sum(), 1.0)
    np.testing.assert_allclose(pi @ Q, 0.0, atol=1e-10)


def test_pomo_tip_sampling():
    from iqtree2_tpu.data import seqtypes
    m = PoMoModel(N=9)
    t = m.transform_tip_table(seqtypes.dna_type().tip_table)
    assert t.shape == (15, 52)
    # observed A: fixed A = 1; state {k A, (N-k) C} = k/N
    code_a = 0
    np.testing.assert_allclose(t[code_a, 0], 1.0)
    np.testing.assert_allclose(t[code_a, m.poly_index(0, 5)], 5 / 9)
    np.testing.assert_allclose(t[code_a, m.poly_index(3, 4)], 0.0)  # C/G


def test_pomo_engine_runs():
    eng32, tree = dna_problem(6, npat=32, seed=2)
    aln = eng32.aln
    model, rates, extras = build_model("GTR+P+G2", aln)
    assert extras.get("pomo") == 9
    eng = LikelihoodEngine(aln, model, rates, dtype=jnp.float64)
    logL = eng.loglik_tree(tree)
    assert np.isfinite(logL) and logL < 0
    l2 = eng.optimize_branches(tree, n_rounds=3)
    assert l2 >= logL - 1e-6
