"""Shared fixtures for the tests: a seeded random DNA problem."""
import jax.numpy as jnp
import numpy as np

from iqtree2_tpu.data import seqtypes
from iqtree2_tpu.data.alignment import Alignment
from iqtree2_tpu.engine import LikelihoodEngine
from iqtree2_tpu.model.dna import make_dna_model
from iqtree2_tpu.model.rates import RateGamma
from iqtree2_tpu.tree.topology import Tree


def dna_problem(ntaxa, npat, seed=0, ncat=4):
    """(float32 GTR+G engine, random tree) on ``npat`` uniform random
    DNA patterns of ``ntaxa`` taxa."""
    rng = np.random.default_rng(seed)
    st = seqtypes.dna_type()
    pat = rng.integers(0, 4, size=(npat, ntaxa)).astype(np.int32)
    codes = seqtypes.DNA_STATE_TO_CODE[pat]
    aln = Alignment(names=[f"t{i}" for i in range(ntaxa)], seqtype=st,
                    patterns=codes, pattern_weights=np.ones(npat),
                    site_to_pattern=np.arange(npat, dtype=np.int32))
    model = make_dna_model("GTR", freqs=np.array([0.3, 0.2, 0.2, 0.3]),
                           freq_type="user",
                           rate_params=np.array([1.5, 4.0, 1.2, 0.8, 5.0]))
    rates = RateGamma(ncat, alpha=0.6)
    eng = LikelihoodEngine(aln, model, rates, dtype=jnp.float32)
    tree = Tree.random_topology(aln.names, rng)
    return eng, tree
