"""iqtree2_tpu — a phylogenomic maximum-likelihood framework on JAX.

A from-scratch re-design of the capabilities of IQ-TREE 2 for accelerators
through JAX/XLA: Felsenstein pruning expressed as batched JAX einsums over per-site partial-likelihood tensors, substitution models via
eigendecomposition, branch-length Newton optimization through theta buffers,
stochastic NNI tree search driven from the host, UFBoot replicates and
ModelFinder grids as extra batch dimensions, and site sharding across device
meshes with psum reductions.
"""

__version__ = "0.1.0"

from iqtree2_tpu.data.alignment import Alignment
from iqtree2_tpu.tree.topology import Tree

__all__ = ["Alignment", "Tree", "__version__"]
