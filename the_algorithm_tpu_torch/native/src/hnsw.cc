// HNSW approximate-nearest-neighbor index (host-side, C++).
//
// Equivalent capability to the reference's Java implementation
// (ann/src/main/java/com/twitter/ann/hnsw/HnswIndex.java: insert at :153,
// searchKnn at :538): hierarchical small-world graph per Malkov & Yashunin,
// greedy descent through upper layers, beam search (ef) at layer 0,
// bidirectional links pruned to M (2M at layer 0).
//
// Concurrency (r4, ≡ HnswIndex.java:153-226's per-item lock striping +
// volatile entry point): INSERTS RUN CONCURRENTLY. Slot allocation (vector
// copy + level draw) serializes on one small mutex; the expensive graph
// phase (beam searches + link updates) runs in parallel, guarded by a
// 256-way stripe of per-node mutexes. Neighbor lists are COPY-ON-WRITE
// (atomically swapped shared_ptr<const vector>), so SEARCHES ARE WAIT-FREE
// — no lock at all on the read path, the C++ analog of the reference's
// volatile immutable link lists. Vector data and node records live in
// fixed-size chunks whose top-level pointer tables are preallocated, so
// nothing a reader can touch is ever reallocated; the published element
// count is an acquire/release atomic.
//
// Metrics match ann/common/Metric.scala:88-222: L2, InnerProduct (negated as
// a distance), Cosine (1 - cos). Serialization: flat binary dump/load.
//
// C ABI only (ctypes-friendly); no external dependencies.

#include <algorithm>
#include <array>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <queue>
#include <random>
#include <unordered_set>
#include <vector>

namespace {

enum MetricKind : int32_t { kL2 = 0, kInnerProduct = 1, kCosine = 2 };

using LinkList = std::shared_ptr<const std::vector<int32_t>>;

struct Node {
  int64_t id;
  int32_t level;
  // neighbors[l]: COW link list, atomically swapped under the stripe lock
  std::vector<LinkList> neighbors;

  LinkList links(int32_t layer) const {
    return std::atomic_load_explicit(&neighbors[layer],
                                     std::memory_order_acquire);
  }
};

constexpr size_t kChunkBits = 13;  // 8192 elements per chunk
constexpr size_t kChunk = 1 << kChunkBits;
constexpr size_t kMaxChunks = 1 << 16;  // 536M elements max
constexpr size_t kStripes = 256;

struct HnswIndex {
  int32_t dim;
  int32_t metric;
  int32_t m;                // max links per node, layers > 0
  int32_t m0;               // max links at layer 0 (2·m)
  int32_t ef_construction;
  double level_mult;        // 1 / ln(m)
  std::atomic<int32_t> entry_point{-1};
  std::atomic<int32_t> max_level{-1};
  std::atomic<int32_t> count{0};  // published elements (release on insert)
  // chunked storage: top-level pointer tables preallocated at create, so
  // readers never observe a reallocation
  std::vector<std::unique_ptr<float[]>> data_chunks;
  std::vector<std::unique_ptr<Node[]>> node_chunks;
  std::mt19937_64 rng;
  std::mutex alloc_lock;    // slot allocation + rng + chunk growth
  std::mutex promote_lock;  // entry-point/max-level promotion
  mutable std::array<std::mutex, kStripes> stripes;  // per-node link locks

  std::mutex& stripe(int32_t u) const { return stripes[(size_t)u % kStripes]; }

  const float* vec(int32_t idx) const {
    return data_chunks[(size_t)idx >> kChunkBits].get() +
           ((size_t)idx & (kChunk - 1)) * dim;
  }
  Node& node(int32_t idx) const {
    return node_chunks[(size_t)idx >> kChunkBits][(size_t)idx & (kChunk - 1)];
  }

  float dist(const float* a, const float* b) const {
    float acc = 0.f;
    if (metric == kL2) {
      for (int32_t i = 0; i < dim; ++i) {
        float d = a[i] - b[i];
        acc += d * d;
      }
      return acc;  // squared L2 ranks identically
    }
    for (int32_t i = 0; i < dim; ++i) acc += a[i] * b[i];
    return metric == kCosine ? 1.f - acc : -acc;
  }

  // beam search within one layer: returns up to ef closest (dist, idx),
  // ascending by distance. Wait-free: link lists load via COW snapshots.
  std::vector<std::pair<float, int32_t>> search_layer(
      const float* q, int32_t entry, int32_t layer, int32_t ef) const {
    std::priority_queue<std::pair<float, int32_t>> best;  // max-heap
    std::priority_queue<std::pair<float, int32_t>,
                        std::vector<std::pair<float, int32_t>>,
                        std::greater<>> frontier;  // min-heap
    std::unordered_set<int32_t> visited;
    float d0 = dist(q, vec(entry));
    best.emplace(d0, entry);
    frontier.emplace(d0, entry);
    visited.insert(entry);
    while (!frontier.empty()) {
      auto [d, u] = frontier.top();
      if (d > best.top().first && (int32_t)best.size() >= ef) break;
      frontier.pop();
      LinkList nbrs = node(u).links(layer);
      if (!nbrs) continue;
      for (int32_t v : *nbrs) {
        if (!visited.insert(v).second) continue;
        float dv = dist(q, vec(v));
        if ((int32_t)best.size() < ef || dv < best.top().first) {
          best.emplace(dv, v);
          frontier.emplace(dv, v);
          if ((int32_t)best.size() > ef) best.pop();
        }
      }
    }
    std::vector<std::pair<float, int32_t>> out(best.size());
    for (size_t i = best.size(); i-- > 0;) {
      out[i] = best.top();
      best.pop();
    }
    return out;
  }

  // Neighbor selection per the paper's Algorithm 4 (diversity heuristic):
  // keep a candidate only if it is closer to the query than to every
  // already-selected neighbor; pruned candidates back-fill remaining slots.
  std::vector<std::pair<float, int32_t>> select_heuristic(
      std::vector<std::pair<float, int32_t>> cand, int32_t max_links) const {
    if ((int32_t)cand.size() <= max_links) return cand;
    std::sort(cand.begin(), cand.end());
    std::vector<std::pair<float, int32_t>> out, discarded;
    for (auto& c : cand) {
      if ((int32_t)out.size() >= max_links) break;
      bool diverse = true;
      for (auto& s : out) {
        if (dist(vec(c.second), vec(s.second)) < c.first) {
          diverse = false;
          break;
        }
      }
      (diverse ? out : discarded).push_back(c);
    }
    for (auto& c : discarded) {
      if ((int32_t)out.size() >= max_links) break;
      out.push_back(c);
    }
    return out;
  }

  // add `idx` to u's links at `layer`, pruning to max_links — COW under
  // the stripe lock (readers keep their snapshot)
  void link_locked(int32_t u, int32_t layer, int32_t idx, int32_t max_links) {
    std::lock_guard<std::mutex> g(stripe(u));
    LinkList cur = node(u).links(layer);
    auto next = std::make_shared<std::vector<int32_t>>(
        cur ? *cur : std::vector<int32_t>{});
    next->push_back(idx);
    if ((int32_t)next->size() > max_links) {
      std::vector<std::pair<float, int32_t>> scored;
      scored.reserve(next->size());
      for (int32_t v : *next) scored.emplace_back(dist(vec(u), vec(v)), v);
      auto kept = select_heuristic(std::move(scored), max_links);
      next->clear();
      for (auto& c : kept) next->push_back(c.second);
    }
    std::atomic_store_explicit(&node(u).neighbors[layer],
                               LinkList(std::move(next)),
                               std::memory_order_release);
  }

  int32_t insert(const float* v_in, int64_t id) {
    int32_t idx, level;
    const float* v;
    {
      // serialized slot allocation: chunk growth + vector copy + level draw
      std::lock_guard<std::mutex> g(alloc_lock);
      idx = count.load(std::memory_order_relaxed);
      size_t chunk = (size_t)idx >> kChunkBits;
      if (chunk >= kMaxChunks) return -1;
      if (!data_chunks[chunk]) {
        data_chunks[chunk] = std::make_unique<float[]>(kChunk * (size_t)dim);
        node_chunks[chunk] = std::make_unique<Node[]>(kChunk);
      }
      float* dst = data_chunks[chunk].get() +
                   ((size_t)idx & (kChunk - 1)) * dim;
      std::memcpy(dst, v_in, sizeof(float) * dim);
      if (metric == kCosine) {
        float n = 0.f;
        for (int32_t i = 0; i < dim; ++i) n += dst[i] * dst[i];
        n = std::sqrt(std::max(n, 1e-30f));
        for (int32_t i = 0; i < dim; ++i) dst[i] /= n;
      }
      v = dst;
      std::uniform_real_distribution<double> unif(0.0, 1.0);
      level = (int32_t)std::floor(-std::log(std::max(unif(rng), 1e-12)) *
                                  level_mult);
      Node& nd = node(idx);
      nd.id = id;
      nd.level = level;
      nd.neighbors.assign((size_t)level + 1, LinkList{});
      // publish: readers may now visit idx (with empty links, like the
      // reference's partially-linked in-flight items)
      count.store(idx + 1, std::memory_order_release);
    }

    int32_t ep = entry_point.load(std::memory_order_acquire);
    if (ep < 0) {
      std::lock_guard<std::mutex> g(promote_lock);
      if (entry_point.load(std::memory_order_acquire) < 0) {
        max_level.store(level, std::memory_order_release);
        entry_point.store(idx, std::memory_order_release);
        return idx;
      }
      ep = entry_point.load(std::memory_order_acquire);
    }

    // concurrent graph phase: greedy descent above the node's level
    int32_t top = max_level.load(std::memory_order_acquire);
    for (int32_t l = top; l > level; --l) {
      bool improved = true;
      float d = dist(v, vec(ep));
      while (improved) {
        improved = false;
        if (l > node(ep).level) break;
        LinkList nbrs = node(ep).links(l);
        if (!nbrs) break;
        for (int32_t u : *nbrs) {
          float du = dist(v, vec(u));
          if (du < d) {
            d = du;
            ep = u;
            improved = true;
          }
        }
      }
    }
    // connect at each layer ≤ min(level, top)
    for (int32_t l = std::min(level, top); l >= 0; --l) {
      auto cand = search_layer(v, ep, l, ef_construction);
      if (cand.empty()) continue;
      ep = cand.front().second;
      auto selected = select_heuristic(cand, m);
      auto mine = std::make_shared<std::vector<int32_t>>();
      int32_t cap = l == 0 ? m0 : m;
      for (auto& [d, u] : selected) {
        mine->push_back(u);
        link_locked(u, l, idx, cap);
      }
      {
        // MERGE with any backlinks concurrent inserters already added via
        // link_locked(idx, …) — an unconditional store would drop them
        // (lost edge → recall degradation).
        std::lock_guard<std::mutex> g(stripe(idx));
        LinkList cur = node(idx).links(l);
        if (cur && !cur->empty()) {
          for (int32_t u : *cur)
            if (std::find(mine->begin(), mine->end(), u) == mine->end())
              mine->push_back(u);
          if ((int32_t)mine->size() > cap) {
            std::vector<std::pair<float, int32_t>> scored;
            scored.reserve(mine->size());
            for (int32_t u : *mine) scored.emplace_back(dist(v, vec(u)), u);
            auto kept = select_heuristic(std::move(scored), cap);
            mine->clear();
            for (auto& c : kept) mine->push_back(c.second);
          }
        }
        std::atomic_store_explicit(&node(idx).neighbors[l],
                                   LinkList(std::move(mine)),
                                   std::memory_order_release);
      }
    }
    if (level > max_level.load(std::memory_order_acquire)) {
      std::lock_guard<std::mutex> g(promote_lock);
      if (level > max_level.load(std::memory_order_acquire)) {
        max_level.store(level, std::memory_order_release);
        entry_point.store(idx, std::memory_order_release);
      }
    }
    return idx;
  }

  int32_t search(const float* q_in, int32_t k, int32_t ef, int64_t* out_ids,
                 float* out_dists) const {
    int32_t ep = entry_point.load(std::memory_order_acquire);
    if (ep < 0) return 0;
    std::vector<float> qbuf(q_in, q_in + dim);
    float* q = qbuf.data();
    if (metric == kCosine) {
      float n = 0.f;
      for (int32_t i = 0; i < dim; ++i) n += q[i] * q[i];
      n = std::sqrt(std::max(n, 1e-30f));
      for (int32_t i = 0; i < dim; ++i) q[i] /= n;
    }
    for (int32_t l = max_level.load(std::memory_order_acquire); l > 0; --l) {
      bool improved = true;
      float d = dist(q, vec(ep));
      while (improved) {
        improved = false;
        if (l > node(ep).level) break;
        LinkList nbrs = node(ep).links(l);
        if (!nbrs) break;
        for (int32_t u : *nbrs) {
          float du = dist(q, vec(u));
          if (du < d) {
            d = du;
            ep = u;
            improved = true;
          }
        }
      }
    }
    auto cand = search_layer(q, ep, 0, std::max(ef, k));
    int32_t n = std::min((int32_t)cand.size(), k);
    for (int32_t i = 0; i < n; ++i) {
      out_ids[i] = node(cand[i].second).id;
      // report true L2 (not squared) to match Metric.scala conventions
      out_dists[i] =
          metric == kL2 ? std::sqrt(std::max(cand[i].first, 0.f)) : cand[i].first;
    }
    return n;
  }
};

constexpr uint64_t kMagic = 0x484e53575450ull;  // "TPWSNH"

}  // namespace

extern "C" {

void* tpurecsys_hnsw_create(int32_t dim, int32_t metric, int32_t m,
                            int32_t ef_construction, uint64_t seed) {
  auto* h = new HnswIndex();
  h->dim = dim;
  h->metric = metric;
  h->m = m;
  h->m0 = 2 * m;
  h->ef_construction = ef_construction;
  h->level_mult = 1.0 / std::log((double)m);
  h->rng.seed(seed);
  h->data_chunks.resize(kMaxChunks);
  h->node_chunks.resize(kMaxChunks);
  return h;
}

void tpurecsys_hnsw_free(void* h) { delete (HnswIndex*)h; }

uint64_t tpurecsys_hnsw_size(void* h) {
  return (uint64_t)((HnswIndex*)h)->count.load(std::memory_order_acquire);
}

int32_t tpurecsys_hnsw_insert(void* h, const float* vec, int64_t id) {
  return ((HnswIndex*)h)->insert(vec, id);
}

// batch insert: n vectors laid out [n, dim]
void tpurecsys_hnsw_insert_batch(void* h, const float* vecs,
                                 const int64_t* ids, uint64_t n) {
  auto* idx = (HnswIndex*)h;
  for (uint64_t i = 0; i < n; ++i)
    idx->insert(vecs + i * idx->dim, ids[i]);
}

int32_t tpurecsys_hnsw_search(void* h, const float* q, int32_t k, int32_t ef,
                              int64_t* out_ids, float* out_dists) {
  return ((HnswIndex*)h)->search(q, k, ef, out_ids, out_dists);
}

int tpurecsys_hnsw_save(void* hp, const char* path) {
  auto* h = (HnswIndex*)hp;
  // Blocks new slot allocations; inserts already past the alloc phase may
  // still be linking concurrently. Snapshot order matters: read the entry
  // point FIRST, then the count — an entry point is only ever promoted to
  // an idx that count has already published, so ep < n is guaranteed.
  std::lock_guard<std::mutex> g(h->alloc_lock);
  int32_t ep = h->entry_point.load(std::memory_order_acquire);
  int32_t maxl = h->max_level.load(std::memory_order_acquire);
  int32_t n = h->count.load(std::memory_order_acquire);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint64_t header[8] = {kMagic, (uint64_t)h->dim, (uint64_t)h->metric,
                        (uint64_t)h->m, (uint64_t)h->ef_construction,
                        (uint64_t)n,
                        (uint64_t)(int64_t)ep,
                        (uint64_t)(int64_t)maxl};
  std::fwrite(header, sizeof(header), 1, f);
  for (int32_t i = 0; i < n; ++i)
    std::fwrite(h->vec(i), sizeof(float), h->dim, f);
  std::vector<int32_t> kept;
  for (int32_t i = 0; i < n; ++i) {
    Node& nd = h->node(i);
    int64_t meta[2] = {nd.id, nd.level};
    std::fwrite(meta, sizeof(meta), 1, f);
    for (int32_t l = 0; l <= nd.level; ++l) {
      LinkList nbrs = nd.links(l);
      // Drop backlinks to idx >= n: an in-flight insert past the count
      // snapshot may have linked itself into nodes < n; serializing those
      // edges would leave the file referencing elements it doesn't hold.
      kept.clear();
      if (nbrs)
        for (int32_t u : *nbrs)
          if (u < n) kept.push_back(u);
      uint32_t cnt = (uint32_t)kept.size();
      std::fwrite(&cnt, sizeof(cnt), 1, f);
      if (cnt) std::fwrite(kept.data(), sizeof(int32_t), cnt, f);
    }
  }
  std::fclose(f);
  return 0;
}

void* tpurecsys_hnsw_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  uint64_t header[8];
  if (std::fread(header, sizeof(header), 1, f) != 1 || header[0] != kMagic) {
    std::fclose(f);
    return nullptr;
  }
  auto* h = (HnswIndex*)tpurecsys_hnsw_create(
      (int32_t)header[1], (int32_t)header[2], (int32_t)header[3],
      (int32_t)header[4], 0);
  int32_t n = (int32_t)header[5];
  h->entry_point.store((int32_t)(int64_t)header[6]);
  h->max_level.store((int32_t)(int64_t)header[7]);
  for (int32_t i = 0; i < n; ++i) {
    size_t chunk = (size_t)i >> kChunkBits;
    if (!h->data_chunks[chunk]) {
      h->data_chunks[chunk] =
          std::make_unique<float[]>(kChunk * (size_t)h->dim);
      h->node_chunks[chunk] = std::make_unique<Node[]>(kChunk);
    }
    float* dst = h->data_chunks[chunk].get() +
                 ((size_t)i & (kChunk - 1)) * h->dim;
    if (std::fread(dst, sizeof(float), h->dim, f) != (size_t)h->dim) {
      std::fclose(f);
      delete h;
      return nullptr;
    }
  }
  for (int32_t i = 0; i < n; ++i) {
    int64_t meta[2];
    if (std::fread(meta, sizeof(meta), 1, f) != 1) {
      std::fclose(f);
      delete h;
      return nullptr;
    }
    Node& nd = h->node(i);
    nd.id = meta[0];
    nd.level = (int32_t)meta[1];
    nd.neighbors.assign((size_t)meta[1] + 1, LinkList{});
    for (int32_t l = 0; l <= nd.level; ++l) {
      uint32_t cnt;
      if (std::fread(&cnt, sizeof(cnt), 1, f) != 1) {
        std::fclose(f);
        delete h;
        return nullptr;
      }
      auto lst = std::make_shared<std::vector<int32_t>>(cnt);
      if (cnt && std::fread(lst->data(), sizeof(int32_t), cnt, f) != cnt) {
        std::fclose(f);
        delete h;
        return nullptr;
      }
      nd.neighbors[l] = std::move(lst);
    }
  }
  h->count.store(n, std::memory_order_release);
  std::fclose(f);
  return h;
}

}  // extern "C"
