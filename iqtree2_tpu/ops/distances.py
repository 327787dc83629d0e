"""Pairwise sequence distances: Hamming (JC-corrected) and batched ML
distances.

Reference analogs: utils/hammingdistance.h (vectorized observed distance),
alignment/alignmentpairwise.cpp (per-pair ML distance via 1-D Newton on the
pair frequency table — SURVEY A11). Here all T = L(L-1)/2 pair tables
are built once ([T, S, S]) and Newton runs batched over pairs on device —
one shot instead of the reference's OpenMP pair loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST
import numpy as np

from iqtree2_tpu.data.alignment import Alignment

MAX_DIST = 9.0  # reference: MAX_GENETIC_DIST


def pair_frequency_tables(aln: Alignment) -> tuple[np.ndarray, np.ndarray]:
    """[T, S, S] weighted co-occurrence counts over definite-state sites for
    every unordered pair, plus the [T, 2] pair index list."""
    codes = aln.tip_codes()          # [L, P]
    tbl = aln.seqtype.tip_table
    S = aln.num_states
    L = aln.ntaxa
    definite = tbl.sum(1) == 1.0
    state_of = tbl.argmax(1)
    is_def = definite[codes]         # [L, P]
    st = state_of[codes]             # [L, P]
    w = aln.pattern_weights
    pairs = [(i, j) for i in range(L) for j in range(i + 1, L)]
    T = len(pairs)
    F = np.zeros((T, S, S), dtype=np.float64)
    for t, (i, j) in enumerate(pairs):
        ok = is_def[i] & is_def[j]
        np.add.at(F[t], (st[i][ok], st[j][ok]), w[ok])
    return F, np.asarray(pairs, dtype=np.int32)


def hamming_jc_distances(aln) -> np.ndarray:
    """[L, L] JC-corrected observed distances (fast init / fallback)."""
    if hasattr(aln, "partitions"):  # SuperAlignment: site-weighted average
        w = np.array([p.nsites for p in aln.partitions], np.float64)
        Ds = [hamming_jc_distances(p) for p in aln.partitions]
        return np.tensordot(w / w.sum(), np.stack(Ds), axes=1)
    codes = aln.tip_codes()
    tbl = aln.seqtype.tip_table
    S = aln.num_states
    definite = tbl.sum(1) == 1.0
    state_of = tbl.argmax(1)
    is_def = definite[codes]
    st = np.where(is_def, state_of[codes], -1)
    w = aln.pattern_weights
    L = aln.ntaxa
    D = np.zeros((L, L))
    for i in range(L):
        ok = (st[i][None, :] >= 0) & (st >= 0)
        diff = ((st != st[i][None, :]) & ok) * w[None, :]
        tot = ok * w[None, :]
        with np.errstate(invalid="ignore", divide="ignore"):
            p = diff.sum(1) / np.maximum(tot.sum(1), 1e-9)
        k = (S - 1.0) / S
        p = np.minimum(p, k * 0.9999)
        D[i] = -k * np.log(1.0 - p / k)
    np.fill_diagonal(D, 0.0)
    return np.maximum(D, 0.0)


@functools.partial(jax.jit, static_argnames=("n_iter",))
def _ml_dist_newton(F, t0, eigvals, U, V, n_iter: int = 20):
    """Batched 1-D Newton maximizing sum_xy F log P_xy(t) per pair."""
    dtype = F.dtype
    lam = eigvals[0]
    Uu, Vv = U[0], V[0]

    def pt(t):
        # [.., S, S] transition matrix per pair
        e = jnp.exp(lam * t[..., None])
        return jnp.maximum(
            jnp.einsum("xk,pk,ky->pxy", Uu, e, Vv, precision=HIGHEST), 1e-12)

    def body(i, t):
        P = pt(t)
        e = jnp.exp(lam * t[..., None])
        P1 = jnp.einsum("xk,pk,ky->pxy", Uu, e * lam, Vv, precision=HIGHEST)    # dP/dt
        P2 = jnp.einsum("xk,pk,ky->pxy", Uu, e * lam * lam, Vv, precision=HIGHEST)
        r = P1 / P
        d1 = jnp.einsum("pxy,pxy->p", F, r, precision=HIGHEST)
        d2 = jnp.einsum("pxy,pxy->p", F, P2 / P - r * r, precision=HIGHEST)
        step = jnp.where(d2 < 0, -d1 / d2, jnp.sign(d1) * 0.5 * t)
        t_new = jnp.clip(t + step, 1e-6, MAX_DIST)
        return t_new

    return jax.lax.fori_loop(0, n_iter, body, t0.astype(dtype))


def ml_distances(aln: Alignment, model, dtype=jnp.float64) -> np.ndarray:
    """[L, L] ML pairwise distance matrix under the given (single-rate)
    substitution model. Reference analog: computeMLDist
    (main/phyloanalysis.cpp:1932)."""
    F, pairs = pair_frequency_tables(aln)
    eig = model.get_eigensystem()
    D0 = hamming_jc_distances(aln)
    t0 = np.array([max(D0[i, j], 1e-4) for i, j in pairs])
    t = _ml_dist_newton(jnp.asarray(F, dtype), jnp.asarray(t0, dtype),
                        jnp.asarray(eig.eigvals, dtype),
                        jnp.asarray(eig.U, dtype),
                        jnp.asarray(eig.V, dtype))
    t = np.asarray(t)
    L = aln.ntaxa
    D = np.zeros((L, L))
    for k, (i, j) in enumerate(pairs):
        D[i, j] = D[j, i] = t[k]
    return D
