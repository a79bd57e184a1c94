// Native HNSW builder over packed binary fingerprints (Tanimoto metric).
//
// Host-side counterpart of the reference's C++ usearch core (SURVEY.md §2
// rows 1-2): multithreaded insertion with per-node locks, SIMD-friendly
// popcount distance, exact HNSW semantics (greedy descent, efC beam,
// diversity-heuristic neighbor selection with keep-pruned backfill,
// bidirectional relink with re-prune). Fresh implementation of the published
// algorithm (Malkov & Yashunin 2016) — not derived from usearch.
//
// The caller (rad_tpu.native) pre-samples levels, sorts ids level-descending
// (the rad_tpu id scheme) and passes pre-allocated, -1-filled adjacency
// tables; this code only fills them, so the Python side owns all memory.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread hnsw_builder.cpp

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Dist {
    const uint32_t* packed;
    const int32_t* pops;
    int words;

    inline float operator()(int64_t a, int64_t b) const {
        const uint32_t* pa = packed + a * words;
        const uint32_t* pb = packed + b * words;
        int inter = 0;
        int w = 0;
        // 64-bit strides: one POPCNT per two words (compile with -mpopcnt)
        for (; w + 2 <= words; w += 2) {
            uint64_t xa, xb;
            std::memcpy(&xa, pa + w, 8);
            std::memcpy(&xb, pb + w, 8);
            inter += __builtin_popcountll(xa & xb);
        }
        for (; w < words; ++w)
            inter += __builtin_popcount(pa[w] & pb[w]);
        int uni = pops[a] + pops[b] - inter;
        if (uni <= 0) return 0.0f;
        return 1.0f - (float)inter / (float)uni;
    }
};

struct Layer {
    int32_t* table;  // [n_l, cap]
    int64_t n;
    int cap;
    inline int32_t* row(int64_t i) const { return table + i * cap; }
};

struct Candidate {
    float d;
    int64_t id;
};
// Tie-breaking matches the Python reference's (d, id) tuple heaps exactly,
// so single-threaded native builds are bit-identical to the numpy builder.
struct CmpMin {  // pops smallest (d, id)
    bool operator()(const Candidate& a, const Candidate& b) const {
        return a.d != b.d ? a.d > b.d : a.id > b.id;
    }
};
struct CmpMax {  // pops largest d, ties -> smallest id (python (-d, id) heap)
    bool operator()(const Candidate& a, const Candidate& b) const {
        return a.d != b.d ? a.d < b.d : a.id > b.id;
    }
};
inline bool cand_less(const Candidate& a, const Candidate& b) {
    return a.d != b.d ? a.d < b.d : a.id < b.id;
}

struct VisitedPool {
    std::vector<uint32_t> stamp;
    uint32_t epoch = 0;
    void reset(int64_t n) {
        if ((int64_t)stamp.size() != n) stamp.assign(n, 0);
        if (++epoch == 0) { std::fill(stamp.begin(), stamp.end(), 0); epoch = 1; }
    }
    inline bool test_and_set(int64_t i) {
        if (stamp[i] == epoch) return true;
        stamp[i] = epoch;
        return false;
    }
};

// beam search on one layer over nodes < limit; vis must be sized to the
// total node count (allocated once, epoch-stamped)
void search_layer(const Dist& dist, int64_t q, const Layer& layer,
                  std::vector<Candidate>& entries, int ef, int64_t limit,
                  int64_t n_total, VisitedPool& vis,
                  std::vector<Candidate>& out) {
    std::priority_queue<Candidate, std::vector<Candidate>, CmpMin> cand;
    std::priority_queue<Candidate, std::vector<Candidate>, CmpMax> result;
    vis.reset(n_total);
    for (auto& e : entries) {
        if (e.id >= limit || vis.test_and_set(e.id)) continue;
        cand.push(e);
        result.push(e);
        if ((int)result.size() > ef) result.pop();
    }
    while (!cand.empty()) {
        Candidate c = cand.top();
        if ((int)result.size() >= ef && c.d > result.top().d) break;
        cand.pop();
        const int32_t* row = layer.row(c.id);
        for (int k = 0; k < layer.cap; ++k) {
            int32_t nb = row[k];
            if (nb < 0) break;
            if (nb >= limit || vis.test_and_set(nb)) continue;
            float d = dist(q, nb);
            if ((int)result.size() < ef || d < result.top().d) {
                cand.push({d, nb});
                result.push({d, nb});
                if ((int)result.size() > ef) result.pop();
            }
        }
    }
    out.clear();
    while (!result.empty()) { out.push_back(result.top()); result.pop(); }
    std::sort(out.begin(), out.end(), cand_less);
}

// Algorithm 4: diversity heuristic + keep-pruned backfill
void select_neighbors(const Dist& dist, const std::vector<Candidate>& cand,
                      int m, std::vector<int64_t>& out) {
    out.clear();
    std::vector<int64_t> pruned;
    for (const auto& c : cand) {
        if ((int)out.size() >= m) break;
        bool ok = true;
        for (int64_t s : out) {
            if (dist(c.id, s) <= c.d) { ok = false; break; }
        }
        if (ok) out.push_back(c.id);
        else pruned.push_back(c.id);
    }
    for (int64_t p : pruned) {
        if ((int)out.size() >= m) break;
        out.push_back(p);
    }
}

struct Builder {
    Dist dist;
    std::vector<Layer> layers;
    const int32_t* levels;
    int max_level;
    int m;
    int ef_c;
    std::vector<std::mutex> locks;
    int64_t n_total = 0;

    void link(int level, int64_t a, const std::vector<int64_t>& nbrs) {
        int32_t* row = layers[level].row(a);
        int cap = layers[level].cap;
        int k = 0;
        for (; k < (int)nbrs.size() && k < cap; ++k) row[k] = (int32_t)nbrs[k];
        for (; k < cap; ++k) row[k] = -1;
    }

    void add_reverse(int level, int64_t b, int64_t a) {
        std::lock_guard<std::mutex> g(locks[b]);
        int32_t* row = layers[level].row(b);
        int cap = layers[level].cap;
        int cnt = 0;
        for (; cnt < cap; ++cnt) {
            if (row[cnt] == a) return;
            if (row[cnt] < 0) break;
        }
        if (cnt < cap) { row[cnt] = (int32_t)a; return; }
        // overflow: re-prune with the heuristic over existing + a
        std::vector<Candidate> cand;
        cand.reserve(cap + 1);
        for (int k = 0; k < cap; ++k) cand.push_back({dist(b, row[k]), row[k]});
        cand.push_back({dist(b, a), a});
        std::sort(cand.begin(), cand.end(), cand_less);
        std::vector<int64_t> sel;
        select_neighbors(dist, cand, cap, sel);
        int k = 0;
        for (; k < (int)sel.size(); ++k) row[k] = (int32_t)sel[k];
        for (; k < cap; ++k) row[k] = -1;
    }

    void insert(int64_t i, VisitedPool& vis, std::vector<Candidate>& scratch) {
        int l_i = levels[i];
        int64_t ep = 0;
        float d_ep = dist(i, 0);
        // wait-free visibility: nodes only link to already-built prefix via
        // the `limit` argument (= i). Rows of unbuilt nodes are all -1.
        for (int lc = max_level; lc > l_i; --lc) {
            // whole-row argmin then move (matches the numpy reference's
            // descent exactly; first-improvement stepping diverges on ties)
            bool improved = true;
            while (improved) {
                improved = false;
                const int32_t* row = layers[lc].row(ep);
                float best_d = d_ep;
                int64_t best = -1;
                for (int k = 0; k < layers[lc].cap; ++k) {
                    int32_t nb = row[k];
                    if (nb < 0) break;
                    if (nb >= i) continue;
                    float d = dist(i, nb);
                    if (d < best_d) { best_d = d; best = nb; }
                }
                if (best >= 0) { d_ep = best_d; ep = best; improved = true; }
            }
        }
        std::vector<Candidate> entries{{d_ep, ep}};
        for (int lc = std::min(l_i, max_level); lc >= 0; --lc) {
            search_layer(dist, i, layers[lc], entries, ef_c, i, n_total, vis,
                         scratch);
            // select up to the layer capacity (2M on layer 0), matching the
            // reference builder's per-layer cap
            int cap = layers[lc].cap;
            std::vector<int64_t> sel;
            select_neighbors(dist, scratch, cap, sel);
            {
                std::lock_guard<std::mutex> g(locks[i]);
                link(lc, i, sel);
            }
            for (int64_t b : sel) add_reverse(lc, b, i);
            if (!scratch.empty()) entries = scratch;
        }
    }
};

// query->node distance (the query vector is not a library row)
struct QDist {
    const uint32_t* packed;
    const int32_t* pops;
    int words;
    const uint32_t* q;
    int32_t qpop;

    inline float operator()(int64_t b) const {
        const uint32_t* pb = packed + b * words;
        int inter = 0;
        int w = 0;
        for (; w + 2 <= words; w += 2) {
            uint64_t xa, xb;
            std::memcpy(&xa, q + w, 8);
            std::memcpy(&xb, pb + w, 8);
            inter += __builtin_popcountll(xa & xb);
        }
        for (; w < words; ++w)
            inter += __builtin_popcount(q[w] & pb[w]);
        int uni = qpop + pops[b] - inter;
        if (uni <= 0) return 0.0f;
        return 1.0f - (float)inter / (float)uni;
    }
};

// layer-0 beam for a query vector (same control flow as search_layer, with
// the query-distance functor and no id limit — the whole graph is built)
void search_layer_query(const QDist& qd, const Layer& layer,
                        std::vector<Candidate>& entries, int ef,
                        int64_t n_total, VisitedPool& vis,
                        std::vector<Candidate>& out) {
    std::priority_queue<Candidate, std::vector<Candidate>, CmpMin> cand;
    std::priority_queue<Candidate, std::vector<Candidate>, CmpMax> result;
    vis.reset(n_total);
    for (auto& e : entries) {
        if (vis.test_and_set(e.id)) continue;
        cand.push(e);
        result.push(e);
        if ((int)result.size() > ef) result.pop();
    }
    while (!cand.empty()) {
        Candidate c = cand.top();
        if ((int)result.size() >= ef && c.d > result.top().d) break;
        cand.pop();
        const int32_t* row = layer.row(c.id);
        for (int k = 0; k < layer.cap; ++k) {
            int32_t nb = row[k];
            if (nb < 0) break;
            if (vis.test_and_set(nb)) continue;
            float d = qd(nb);
            if ((int)result.size() < ef || d < result.top().d) {
                cand.push({d, nb});
                result.push({d, nb});
                if ((int)result.size() > ef) result.pop();
            }
        }
    }
    out.clear();
    while (!result.empty()) { out.push_back(result.top()); result.pop(); }
    std::sort(out.begin(), out.end(), cand_less);
}

}  // namespace

extern "C" {

// tables: array of max_level+1 pointers, tables[l] = int32[n_l * cap_l]
// pre-filled with -1. levels must be non-increasing; node 0 has max level.
int rad_build_hnsw(const uint32_t* packed, const int32_t* pops, int64_t n,
                   int32_t words, const int32_t* levels,
                   const int64_t* layer_sizes, int32_t max_level,
                   int32_t** tables, const int32_t* layer_caps,
                   int32_t connectivity, int32_t ef_construction,
                   int32_t n_threads) {
    if (n <= 0) return 0;
    Builder b{
        Dist{packed, pops, (int)words},
        {}, levels, (int)max_level, (int)connectivity,
        (int)ef_construction, std::vector<std::mutex>((size_t)n), n};
    for (int l = 0; l <= max_level; ++l)
        b.layers.push_back({tables[l], layer_sizes[l], (int)layer_caps[l]});

    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt == 1) {
        VisitedPool vis;
        std::vector<Candidate> scratch;
        for (int64_t i = 1; i < n; ++i) b.insert(i, vis, scratch);
        return 0;
    }
    // multithreaded: workers claim the next id but wait until all ids below
    // a sliding window are built, bounding out-of-order visibility like
    // usearch's concurrent add.
    std::atomic<int64_t> next{1};
    auto worker = [&]() {
        VisitedPool vis;
        std::vector<Candidate> scratch;
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            b.insert(i, vis, scratch);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return 0;
}

// Batched k-NN search over a built graph — the host-side counterpart of
// usearch's Index.search (reference SURVEY.md §2 row 1): greedy descent
// through the upper layers, then an expansion_search-wide beam on layer 0.
// Node 0 is the entry point (the rad_tpu id scheme sorts ids by level
// descending). Multithreaded over queries; each thread keeps its own
// epoch-stamped visited pool. Returns node ids (key mapping is the Python
// side's job, as in graph/storage.py).
int rad_search_knn(const uint32_t* packed, const int32_t* pops, int64_t n,
                   int32_t words, const int64_t* layer_sizes,
                   int32_t max_level, int32_t** tables,
                   const int32_t* layer_caps, const uint32_t* queries,
                   const int32_t* q_pops, int64_t nq, int32_t k,
                   int32_t ef, int32_t n_threads, float* out_d,
                   int64_t* out_i) {
    if (n <= 0 || nq <= 0) return 0;
    std::vector<Layer> layers;
    for (int l = 0; l <= max_level; ++l)
        layers.push_back({tables[l], layer_sizes[l], (int)layer_caps[l]});
    int beam = ef > k ? ef : k;

    auto run_query = [&](int64_t qi, VisitedPool& vis,
                         std::vector<Candidate>& scratch) {
        QDist qd{packed, pops, (int)words, queries + qi * words, q_pops[qi]};
        int64_t ep = 0;
        float d_ep = qd(0);
        for (int lc = max_level; lc >= 1; --lc) {
            bool improved = true;
            while (improved) {
                improved = false;
                const int32_t* row = layers[lc].row(ep);
                float best_d = d_ep;
                int64_t best = -1;
                for (int kk = 0; kk < layers[lc].cap; ++kk) {
                    int32_t nb = row[kk];
                    if (nb < 0) break;
                    float d = qd(nb);
                    if (d < best_d) { best_d = d; best = nb; }
                }
                if (best >= 0) { d_ep = best_d; ep = best; improved = true; }
            }
        }
        std::vector<Candidate> entries{{d_ep, ep}};
        search_layer_query(qd, layers[0], entries, beam, n, vis, scratch);
        for (int j = 0; j < k; ++j) {
            if (j < (int)scratch.size()) {
                out_d[qi * k + j] = scratch[j].d;
                out_i[qi * k + j] = scratch[j].id;
            } else {
                out_d[qi * k + j] = 1e30f;
                out_i[qi * k + j] = -1;
            }
        }
    };

    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt == 1 || nq == 1) {
        VisitedPool vis;
        std::vector<Candidate> scratch;
        for (int64_t qi = 0; qi < nq; ++qi) run_query(qi, vis, scratch);
        return 0;
    }
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
        VisitedPool vis;
        std::vector<Candidate> scratch;
        for (;;) {
            int64_t qi = next.fetch_add(1);
            if (qi >= nq) break;
            run_query(qi, vis, scratch);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return 0;
}

// Batch SMILES fingerprinting — the native library-ingestion data loader
// (the role RDKit fingerprinting plays in the reference's workflow,
// examples/DUDEZ_example.ipynb:92-118, when RDKit is absent). MUST stay
// bit-identical to rad_tpu.fp.pack._hash_fingerprint_bits: FNV-1a 64 over
// every byte-substring of length 1..2*radius+1, LSB-first bit packing.
// `buf` is the concatenated UTF-8 strings, `offsets` the [n+1] boundaries;
// `out` is a pre-zeroed [n, ceil(n_bits/32)] uint32 row-major array.
int rad_fingerprint_smiles(const char* buf, const int64_t* offsets,
                           int64_t n, int32_t n_bits, int32_t radius,
                           uint32_t* out, int32_t n_threads) {
    if (n <= 0 || n_bits <= 0) return 0;
    int words = (n_bits + 31) / 32;
    int max_len = 2 * radius + 1;

    auto do_one = [&](int64_t i) {
        const unsigned char* s =
            (const unsigned char*)buf + offsets[i];
        int64_t len = offsets[i + 1] - offsets[i];
        uint32_t* row = out + i * words;
        bool any = false;
        for (int L = 1; L <= max_len; ++L) {
            for (int64_t p = 0; p + L <= len; ++p) {
                uint64_t h = 0xCBF29CE484222325ull;
                for (int j = 0; j < L; ++j) {
                    h ^= (uint64_t)s[p + j];
                    h *= 0x100000001B3ull;
                }
                uint64_t bit = h % (uint64_t)n_bits;
                row[bit >> 5] |= 1u << (bit & 31);
                any = true;
            }
        }
        if (!any) row[0] |= 1u;
    };

    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt == 1 || n < 256) {
        for (int64_t i = 0; i < n; ++i) do_one(i);
        return 0;
    }
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            do_one(i);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return 0;
}

// Brute-force exact top-k by Tanimoto (ground truth / CPU baseline).
void rad_bruteforce_topk(const uint32_t* packed, const int32_t* pops,
                         int64_t n, int32_t words, const uint32_t* queries,
                         const int32_t* q_pops, int64_t nq, int32_t k,
                         float* out_d, int64_t* out_i) {
    for (int64_t q = 0; q < nq; ++q) {
        const uint32_t* pq = queries + q * words;
        std::priority_queue<Candidate, std::vector<Candidate>, CmpMax> heap;
        for (int64_t i = 0; i < n; ++i) {
            const uint32_t* pi = packed + i * words;
            int inter = 0;
            for (int w = 0; w < words; ++w)
                inter += __builtin_popcount(pq[w] & pi[w]);
            int uni = q_pops[q] + pops[i] - inter;
            float d = uni <= 0 ? 0.0f : 1.0f - (float)inter / (float)uni;
            if ((int)heap.size() < k) heap.push({d, i});
            else if (d < heap.top().d) { heap.pop(); heap.push({d, i}); }
        }
        std::vector<Candidate> res;
        while (!heap.empty()) { res.push_back(heap.top()); heap.pop(); }
        std::sort(res.begin(), res.end(), cand_less);
        for (int j = 0; j < k; ++j) {
            if (j < (int)res.size()) {
                out_d[q * k + j] = res[j].d;
                out_i[q * k + j] = res[j].id;
            } else {
                out_d[q * k + j] = 1e30f;
                out_i[q * k + j] = -1;
            }
        }
    }
}

}  // extern "C"
