"""Bit-parallel Fitch parsimony (host numpy).

States are bitmasks in uint64 (supports up to 64 states: DNA=4, AA=20,
codon=61). Reference analogs: tree/phylotreepars.cpp:32 (Fitch kernel),
pll/fastDNAparsimony.c (randomized stepwise addition used for start trees).

The pattern axis is vectorized with numpy; edge-candidate scoring during
stepwise addition is batched as one [n_edges, patterns] operation.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu.data.alignment import Alignment
from iqtree2_tpu.tree.topology import Tree


def state_bitmasks(aln) -> np.ndarray:
    """[ntaxa, patterns] uint64 bitmask of compatible states per tip.

    SuperAlignments concatenate per-partition masks along the pattern axis
    (bitmask width is per-column, so mixed state counts coexist)."""
    if hasattr(aln, "partitions"):  # SuperAlignment
        return np.concatenate([state_bitmasks(p) for p in aln.partitions],
                              axis=1)
    tbl = aln.seqtype.tip_table  # [codes, S]
    S = aln.num_states
    if S > 64:
        raise ValueError("parsimony bitmasks support up to 64 states")
    weights = (1 << np.arange(S, dtype=np.uint64))
    code_masks = (tbl > 0) @ weights  # [codes]
    code_masks = code_masks.astype(np.uint64)
    return code_masks[aln.tip_codes()]  # [L, P]


def fitch_combine(a: np.ndarray, b: np.ndarray):
    """Fitch downpass combine: (sets, extra_cost_mask)."""
    inter = a & b
    empty = inter == 0
    out = np.where(empty, a | b, inter)
    return out, empty


def fitch_score(tree: Tree, masks: np.ndarray,
                weights: np.ndarray) -> float:
    """Weighted Fitch parsimony score of a topology.

    Uses the native bit-parallel kernel (native/iqtree2_native.cpp
    it2_fitch_score; reference analog tree/phylotreepars.cpp:32) when
    available; multifurcations are binarized into combine chains."""
    from iqtree2_tpu import native
    if native.available():
        root = tree._default_root()
        L = tree.ntaxa
        rows: list[tuple[int, int]] = []
        idx: dict[int, int] = {}
        for v, p in tree.postorder(root):
            if tree.is_leaf(v):
                idx[v] = v
                continue
            kids = [idx[u] for u in tree.adj[v] if u != p]
            acc = kids[0]
            for u in kids[1:]:
                rows.append((acc, u))
                acc = L + len(rows) - 1
            idx[v] = acc
        if rows:
            out = native.fitch_score(
                masks, weights, np.asarray(rows, dtype=np.int32))
            if out is not None:
                return out
    root = tree._default_root()
    P = masks.shape[1]
    cost = np.zeros(P, dtype=np.float64)
    sets: dict[int, np.ndarray] = {}
    for v, p in tree.postorder(root):
        if tree.is_leaf(v):
            sets[v] = masks[v]
            continue
        kids = [u for u in tree.adj[v] if u != p]
        acc = sets[kids[0]]
        for u in kids[1:]:
            acc, extra = fitch_combine(acc, sets[u])
            cost += extra
        sets[v] = acc
    return float((cost * weights).sum())


def sankoff_score(tree: Tree, codes: np.ndarray, weights: np.ndarray,
                  cost: np.ndarray, tip_table: np.ndarray) -> float:
    """Weighted Sankoff parsimony with an arbitrary state-change cost
    matrix (reference: the Sankoff kernel, tree/phylotreepars.cpp:636).

    codes: [L, P] tip codes; cost: [S, S]; tip_table: [ncodes, S]
    indicator rows (ambiguity = 0-cost for every compatible state).
    Vectorized over patterns: S_v(x, p) = sum_children min_y (c(x,y) +
    S_u(y, p)).
    """
    S = cost.shape[0]
    BIG = 1e30
    # tip state costs: 0 for compatible states, BIG otherwise
    tip_cost = np.where(tip_table > 0, 0.0, BIG)      # [ncodes, S]
    root = tree._default_root()
    dp: dict[int, np.ndarray] = {}
    for v, p in tree.postorder(root):
        if tree.is_leaf(v):
            dp[v] = tip_cost[codes[v]].T              # [S, P]
            continue
        acc = None
        for u in tree.adj[v]:
            if u == p:
                continue
            # min over child state y of cost[x, y] + dp[u][y]
            m = (cost[:, :, None] + dp[u][None, :, :]).min(axis=1)
            acc = m if acc is None else acc + m
        dp[v] = acc
    return float((dp[root].min(axis=0) * weights).sum())


def sankoff_score_device(tree: Tree, codes: np.ndarray,
                         weights: np.ndarray, cost: np.ndarray,
                         tip_table: np.ndarray) -> float:
    """On-chip Sankoff: the min-plus analog of the level-batched pruning
    scan (ops/pruning.down_pass) over the same TreeSchedule arrays —
    each step does one batched [G, 2, S, S, P] min-reduction instead of a
    sum-product contraction. Reference: the Sankoff kernel of
    tree/phylotreepars.cpp:636 (computePartialParsimonySankoff).
    """
    import jax
    import jax.numpy as jnp

    from iqtree2_tpu.tree.schedule import build_schedule

    if not tree.check_binary_unrooted():
        # TreeSchedule assumes exactly two children per internal node; a
        # multifurcating tree would silently mis-score on device
        return sankoff_score(tree, codes, weights, cost, tip_table)

    S = cost.shape[0]
    BIG = 1e9
    sched = build_schedule(tree)
    arrs = sched.to_device_arrays()
    tip_cost = np.where(tip_table > 0, 0.0, BIG)        # [ncodes, S]
    tipC = np.transpose(tip_cost[codes], (0, 2, 1))     # [L, S, P]

    @jax.jit
    def run(tipC, cost, child_src, child_edge, step_node, weights):
        L, _, Pp = tipC.shape
        n_int = child_src.shape[0]
        DP0 = jnp.full((L + n_int, S, Pp), BIG, jnp.float32)
        DP0 = DP0.at[:L].set(tipC)

        def body(DP, nid):
            nid_c = jnp.minimum(nid, n_int - 1)
            src = DP[child_src[nid_c]]                  # [G, 2, S, Pp]
            m = jnp.min(cost[None, None, :, :, None]
                        + src[:, :, None, :, :], axis=3)
            acc = jnp.minimum(m.sum(axis=1), BIG)       # [G, S, Pp]
            out_idx = jnp.where(nid < n_int, L + nid, L + n_int)
            return DP.at[out_idx].set(acc, mode="drop"), None

        DP, _ = jax.lax.scan(body, DP0, step_node)
        # fold leaf 0 into the root (schedule convention)
        m0 = jnp.min(cost[:, :, None] + tipC[0][None, :, :], axis=1)
        total = jnp.min(DP[L + n_int - 1] + m0, axis=0)  # [Pp]
        return jnp.sum(total * weights)

    return float(run(jnp.asarray(tipC, jnp.float32),
                     jnp.asarray(cost, jnp.float32),
                     jnp.asarray(arrs["child_src"]),
                     jnp.asarray(arrs["child_edge"]),
                     jnp.asarray(arrs["step_node"]),
                     jnp.asarray(weights, jnp.float32)))


def _insert_leaf(tree: Tree, leaf: int, a: int, b: int):
    """Split edge (a, b) by a new node carrying ``leaf``; returns (new
    node, the edge's old length)."""
    mid = tree.new_node()
    lold = tree.get_blen(a, b)
    tree.remove_edge(a, b)
    tree.add_edge(a, mid, lold * 0.5)
    tree.add_edge(mid, b, lold * 0.5)
    tree.add_edge(mid, leaf, 0.1)
    return mid, lold


def random_stepwise_addition(aln: Alignment, rng: np.random.Generator,
                             subsample: int | None = None,
                             constraint=None) -> Tree:
    """Randomized stepwise-addition parsimony tree.

    Insert taxa in random order, each at the edge minimizing the Fitch
    insertion cost (batched over all candidate edges). Reference analog:
    pllComputeRandomizedStepwiseAdditionParsimonyTree (tree/iqtree.cpp:746).
    Without a constraint the native library picks the edges (the same
    ones, bit-sliced over patterns); this Python loop is its fallback.

    constraint: optional TopologyConstraint (-g) — insertion edges that
    would break a constraint split are rejected (cheapest compatible edge
    wins; reference: ConstraintTree gating in stepwise addition).
    """
    masks = state_bitmasks(aln)
    w = aln.pattern_weights
    L = aln.ntaxa
    order = list(rng.permutation(L))
    tree = Tree(aln.names)
    if L < 4:
        if L == 2:
            tree.add_edge(order[0], order[1], 0.1)
        elif L == 3:
            c = tree.new_node()
            for x in order:
                tree.add_edge(c, x, 0.1)
        return tree

    first3 = [order.pop(), order.pop(), order.pop()]
    hub = tree.new_node()
    for x in first3:
        tree.add_edge(hub, x, 0.1)
    rest = list(reversed(order))
    if constraint is None:
        from iqtree2_tpu import native
        chosen = native.stepwise_addition(masks, w, first3 + rest)
        if chosen is not None:
            for leaf, (a, b) in zip(rest, chosen):
                _insert_leaf(tree, leaf, int(a), int(b))
            return tree

    for leaf in rest:
        # Fitch down+up sets for the current tree, per edge.
        # Root at the hub: the partial tree may not contain leaf 0 yet,
        # so Tree._default_root() is not usable here.
        root = hub
        sets: dict[int, np.ndarray] = {}
        post = list(tree.postorder(root))
        for v, p in post:
            if tree.is_leaf(v):
                sets[v] = masks[v]
            else:
                kids = [u for u in tree.adj[v] if u != p]
                acc = sets[kids[0]]
                for u in kids[1:]:
                    acc, _ = fitch_combine(acc, sets[u])
                sets[v] = acc
        # uppass context per node (state set seen from parent side)
        up: dict[int, np.ndarray] = {root: None}
        for v, p in reversed(post):
            if tree.is_leaf(v) and v != root:
                continue
            kids = [u for u in tree.adj[v] if u != p]
            for u in kids:
                ctx = up[v]
                acc = None
                for u2 in kids:
                    if u2 == u:
                        continue
                    acc = sets[u2] if acc is None else \
                        fitch_combine(acc, sets[u2])[0]
                if ctx is not None:
                    acc = ctx if acc is None else fitch_combine(acc, ctx)[0]
                up[u] = acc
        # candidate edges: all (child u, parent v) pairs
        edges = []
        ctx_sets = []
        for v, p in post:
            if p == -1:
                continue
            down = sets[v]
            upc = up[v]
            ctx = down if upc is None else fitch_combine(down, upc)[0]
            edges.append((v, p))
            ctx_sets.append(ctx)
        C = np.stack(ctx_sets)                    # [E, P]
        x = masks[leaf][None, :]                  # [1, P]
        delta = (((C & x) == 0) * w[None, :]).sum(axis=1)

        if constraint is None or leaf not in constraint.mask:
            _insert_leaf(tree, leaf, *edges[int(np.argmin(delta))])
        else:
            placed = False
            for ei in np.argsort(delta):
                a, b = edges[int(ei)]
                mid, lold = _insert_leaf(tree, leaf, a, b)
                if constraint.compatible(tree):
                    placed = True
                    break
                tree.remove_edge(a, mid)          # undo
                tree.remove_edge(mid, b)
                tree.remove_edge(mid, leaf)
                tree.add_edge(a, b, lold)
            if not placed:   # no compatible edge (should not happen)
                _insert_leaf(tree, leaf, *edges[int(np.argmin(delta))])
    return tree
