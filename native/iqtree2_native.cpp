// Native host runtime for iqtree2_tpu: the CPU-side components that the
// reference implements in C/C++ and that dominate HOST time at scale —
// alignment pattern compression (reference: Alignment::buildPattern,
// alignment/alignment.cpp:1725), bit-parallel Fitch parsimony
// (tree/phylotreepars.cpp:32) and randomized stepwise addition
// (tree/iqtree.cpp:746).
//
// Exposed through a plain C ABI consumed by iqtree2_tpu/native.py via
// ctypes; every entry point is pure (caller-allocated buffers, no global
// state) so the Python fallbacks remain drop-in equivalent.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <string>
#include <tuple>

namespace {

// State sets bit-sliced: plane s of a node holds bit s of the set for 64
// patterns per word; a node's set is S planes of W words.
struct Sets {
    int64_t S, W;
    std::vector<uint64_t> buf;
    Sets(int64_t n, int64_t S_, int64_t W_)
        : S(S_), W(W_), buf(static_cast<size_t>(n * S_ * W_), 0) {}
    uint64_t* at(int64_t v) { return buf.data() + v * S * W; }
};

// Fitch combine a, b -> out (out may alias a or b): the intersection
// where it is not empty, else the union.
void fitch_combine(const uint64_t* a, const uint64_t* b, uint64_t* out,
                   int64_t S, int64_t W) {
    uint64_t inter[64];
    for (int64_t w = 0; w < W; w++) {
        uint64_t any = 0;
        for (int64_t s = 0; s < S; s++) {
            inter[s] = a[s * W + w] & b[s * W + w];
            any |= inter[s];
        }
        for (int64_t s = 0; s < S; s++)
            out[s * W + w] = inter[s] | (~any & (a[s * W + w] | b[s * W + w]));
    }
}

void remove_first(std::vector<int64_t>& v, int64_t x) {
    v.erase(std::find(v.begin(), v.end(), x));
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// Pattern compression: site columns -> unique patterns + weights.
// codes: [L * nsites] int32 (taxon-major rows); outputs:
//   out_patterns [L * nsites] (only the first n_pat columns valid),
//   out_weights [nsites], out_site2pat [nsites].
// Returns the number of unique patterns.
int64_t it2_compress_patterns(const int32_t* codes, int64_t L,
                              int64_t nsites, int32_t* out_patterns,
                              double* out_weights,
                              int32_t* out_site2pat) {
    std::unordered_map<std::string, int64_t> seen;
    seen.reserve(static_cast<size_t>(nsites) * 2);
    std::string key(static_cast<size_t>(L) * sizeof(int32_t), '\0');
    std::vector<int32_t> col(L);
    int64_t n_pat = 0;
    for (int64_t s = 0; s < nsites; s++) {
        for (int64_t t = 0; t < L; t++) col[t] = codes[t * nsites + s];
        std::memcpy(&key[0], col.data(), key.size());
        auto it = seen.find(key);
        if (it == seen.end()) {
            int64_t p = n_pat++;
            seen.emplace(key, p);
            for (int64_t t = 0; t < L; t++)
                out_patterns[t * nsites + p] = col[t];
            out_weights[p] = 1.0;
            out_site2pat[s] = static_cast<int32_t>(p);
        } else {
            out_weights[it->second] += 1.0;
            out_site2pat[s] = static_cast<int32_t>(it->second);
        }
    }
    return n_pat;
}

// ---------------------------------------------------------------------
// Bit-parallel weighted Fitch score over a postorder schedule.
// masks: [L * P] uint64 state bitmasks; w: [P] weights;
// child_src: [n_int * 2] unified child rows (tips < L, internal L+i).
// Scratch: sets [(L + n_int) * P] uint64 is caller-allocated.
double it2_fitch_score(const uint64_t* masks, const double* w,
                       const int32_t* child_src, int64_t n_int,
                       int64_t L, int64_t P, uint64_t* sets) {
    std::memcpy(sets, masks,
                static_cast<size_t>(L) * P * sizeof(uint64_t));
    double cost = 0.0;
    for (int64_t i = 0; i < n_int; i++) {
        const uint64_t* a = sets + static_cast<int64_t>(
            child_src[2 * i]) * P;
        const uint64_t* b = sets + static_cast<int64_t>(
            child_src[2 * i + 1]) * P;
        uint64_t* o = sets + (L + i) * P;
        for (int64_t p = 0; p < P; p++) {
            uint64_t inter = a[p] & b[p];
            if (inter) {
                o[p] = inter;
            } else {
                o[p] = a[p] | b[p];
                cost += w[p];
            }
        }
    }
    return cost;
}

// ---------------------------------------------------------------------
// Randomized stepwise-addition parsimony: the insertion edge of every
// added taxon. masks: [L * P] uint64 per-pattern state bitmasks (S state
// bits); wint: [P] integer weights below 2^nwbits; seq: [L] taxa, the
// first three joined at hub node L, the rest inserted in order. Each taxon
// goes on the first edge, in postorder from the hub, of least Fitch cost
// against the state set at that edge; new internal nodes are L+1, L+2, ...
// Adjacency order and every tie follow ops/pars.py's Python version step
// for step, so both build the same tree. out: [(L - 3) * 2] (child,
// parent) of each chosen edge.
void it2_stepwise_addition(const uint64_t* masks, const int64_t* wint,
                           int64_t L, int64_t P, int64_t S, int64_t nwbits,
                           const int64_t* seq, int64_t* out) {
    const int64_t W = (P + 63) / 64;
    const int64_t n_nodes = 2 * L;
    Sets leaf(L, S, W), down(n_nodes, S, W), up(n_nodes, S, W), ctx(1, S, W);
    for (int64_t t = 0; t < L; t++)
        for (int64_t p = 0; p < P; p++)
            for (int64_t s = 0; s < S; s++)
                if ((masks[t * P + p] >> s) & 1)
                    leaf.at(t)[s * W + p / 64] |= uint64_t(1) << (p % 64);
    // weight bit planes and the valid-pattern mask
    std::vector<uint64_t> wbits(static_cast<size_t>(nwbits * W), 0);
    std::vector<uint64_t> valid(static_cast<size_t>(W), 0);
    for (int64_t p = 0; p < P; p++) {
        valid[p / 64] |= uint64_t(1) << (p % 64);
        for (int64_t k = 0; k < nwbits; k++)
            if ((wint[p] >> k) & 1)
                wbits[k * W + p / 64] |= uint64_t(1) << (p % 64);
    }
    std::vector<std::vector<int64_t>> adj(n_nodes);
    auto add_edge = [&](int64_t a, int64_t b) {
        adj[a].push_back(b);
        adj[b].push_back(a);
    };
    const int64_t hub = L;
    int64_t next_id = L + 1;
    for (int k = 0; k < 3; k++) add_edge(hub, seq[k]);
    std::vector<char> has_up(n_nodes);
    std::vector<std::pair<int64_t, int64_t>> post;
    std::vector<std::tuple<int64_t, int64_t, bool>> stack;
    std::vector<int64_t> kids;
    for (int64_t i = 3; i < L; i++) {
        const int64_t leaf_id = seq[i];
        // postorder from the hub (Tree.postorder)
        post.clear();
        stack.assign(1, {hub, -1, false});
        while (!stack.empty()) {
            auto [v, p, done] = stack.back();
            stack.pop_back();
            if (done) {
                post.emplace_back(v, p);
                continue;
            }
            stack.emplace_back(v, p, true);
            for (int64_t u : adj[v])
                if (u != p) stack.emplace_back(u, v, false);
        }
        // down sets
        for (auto [v, p] : post) {
            uint64_t* d = down.at(v);
            if (v < L) {
                std::memcpy(d, leaf.at(v), S * W * sizeof(uint64_t));
                continue;
            }
            bool first = true;
            for (int64_t u : adj[v]) {
                if (u == p) continue;
                if (first)
                    std::memcpy(d, down.at(u), S * W * sizeof(uint64_t));
                else
                    fitch_combine(d, down.at(u), d, S, W);
                first = false;
            }
        }
        // up sets: the state set seen from each node's parent side
        has_up[hub] = 0;
        for (auto it = post.rbegin(); it != post.rend(); ++it) {
            auto [v, p] = *it;
            if (v < L) continue;
            kids.clear();
            for (int64_t u : adj[v])
                if (u != p) kids.push_back(u);
            for (int64_t u : kids) {
                uint64_t* o = up.at(u);
                bool first = true;
                for (int64_t u2 : kids) {
                    if (u2 == u) continue;
                    if (first)
                        std::memcpy(o, down.at(u2), S * W * sizeof(uint64_t));
                    else
                        fitch_combine(o, down.at(u2), o, S, W);
                    first = false;
                }
                if (has_up[v]) {
                    if (first)
                        std::memcpy(o, up.at(v), S * W * sizeof(uint64_t));
                    else
                        fitch_combine(o, up.at(v), o, S, W);
                    first = false;
                }
                has_up[u] = !first;
            }
        }
        // insertion cost of each edge: weighted patterns whose edge set
        // misses every state of the new taxon
        const uint64_t* x = leaf.at(leaf_id);
        int64_t best = -1, best_a = -1, best_b = -1;
        for (auto [v, p] : post) {
            if (p == -1) continue;
            const uint64_t* c = down.at(v);
            if (has_up[v]) {
                fitch_combine(down.at(v), up.at(v), ctx.at(0), S, W);
                c = ctx.at(0);
            }
            int64_t cost = 0;
            for (int64_t w = 0; w < W; w++) {
                uint64_t hit = 0;
                for (int64_t s = 0; s < S; s++) hit |= c[s * W + w] & x[s * W + w];
                const uint64_t miss = ~hit & valid[w];
                for (int64_t k = 0; k < nwbits; k++)
                    cost += static_cast<int64_t>(
                        __builtin_popcountll(miss & wbits[k * W + w])) << k;
            }
            if (best < 0 || cost < best) {
                best = cost;
                best_a = v;
                best_b = p;
            }
        }
        out[2 * (i - 3)] = best_a;
        out[2 * (i - 3) + 1] = best_b;
        // insert: a - mid - b, mid - leaf (Tree.remove_edge/add_edge)
        const int64_t mid = next_id++;
        remove_first(adj[best_a], best_b);
        remove_first(adj[best_b], best_a);
        add_edge(best_a, mid);
        add_edge(mid, best_b);
        add_edge(mid, leaf_id);
    }
}

}  // extern "C"
