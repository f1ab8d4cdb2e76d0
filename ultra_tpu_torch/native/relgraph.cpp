// Native host-side join of the graph of relations for ultra_tpu_torch.
//
// Replaces the reference's torch.sparse matmul relation-graph construction
// (tasks.py:144-199 of the reference) -- which UltraQuery training re-runs
// per projection step per batch (ultraquery.py:199-203) -- with a bitset
// join over (node, relation) incidence pairs. The port's copy of
// ultra_tpu/native/relgraph.cpp.
//
// Semantics: nodes of the output graph are the R relation types; an edge
// (r1, r2, m) exists for meta-relation m in {h2h=0, t2t=1, h2t=2, t2h=3}
// iff some node n has (r1 in heads(n)) x (r2 in heads(n)) etc. Only the
// nonzero pattern matters (the reference discards the degree-normalized
// values, tasks.py:181-193). Edges come out by meta-relation, then r1,
// then r2, ascending: the order of tasks.py::relation_graph_arrays_numpy.
//
// Built at first use with g++ -O3 and loaded through ctypes (no pybind):
// ultra_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

// scratch shared between build and fetch: ctypes releases the GIL, so the
// caller holds a lock across the pair
std::vector<int64_t> g_src, g_dst, g_typ;

struct Incidence {
  // CSR: for each node, the sorted distinct relations incident as head/tail
  std::vector<int64_t> offs;
  std::vector<int32_t> rels;
};

Incidence build_incidence(const int64_t* nodes, const int64_t* types,
                          const uint8_t* live, int64_t e, int64_t v) {
  std::vector<std::pair<int64_t, int32_t>> pairs;
  pairs.reserve(e);
  for (int64_t i = 0; i < e; ++i) {
    if (live && !live[i]) continue;
    pairs.emplace_back(nodes[i], (int32_t)types[i]);
  }
  std::sort(pairs.begin(), pairs.end());
  pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());

  Incidence inc;
  inc.offs.assign(v + 1, 0);
  inc.rels.reserve(pairs.size());
  for (auto& p : pairs) inc.offs[p.first + 1]++;
  for (int64_t n = 0; n < v; ++n) inc.offs[n + 1] += inc.offs[n];
  for (auto& p : pairs) inc.rels.push_back(p.second);
  return inc;
}

void join(const Incidence& a, const Incidence& b, int64_t v, int64_t r,
          int64_t meta, std::vector<uint64_t>& bits) {
  const int64_t words = (r + 63) / 64;
  std::fill(bits.begin(), bits.end(), 0);
  for (int64_t n = 0; n < v; ++n) {
    const int64_t a0 = a.offs[n], a1 = a.offs[n + 1];
    const int64_t b0 = b.offs[n], b1 = b.offs[n + 1];
    if (a0 == a1 || b0 == b1) continue;
    for (int64_t i = a0; i < a1; ++i) {
      uint64_t* row = bits.data() + (int64_t)a.rels[i] * words;
      for (int64_t j = b0; j < b1; ++j) {
        const int32_t rb = b.rels[j];
        row[rb >> 6] |= (uint64_t)1 << (rb & 63);
      }
    }
  }
  for (int64_t r1 = 0; r1 < r; ++r1) {
    const uint64_t* row = bits.data() + r1 * words;
    for (int64_t w = 0; w < words; ++w) {
      uint64_t x = row[w];
      while (x) {
        const int bit = __builtin_ctzll(x);
        x &= x - 1;
        g_src.push_back(r1);
        g_dst.push_back(w * 64 + bit);
        g_typ.push_back(meta);
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns the number of relation-graph edges; results staged for fetch.
int64_t relgraph_build(const int64_t* edge_heads, const int64_t* edge_tails,
                       const int64_t* edge_types, const uint8_t* live,
                       int64_t e, int64_t v, int64_t r) {
  g_src.clear();
  g_dst.clear();
  g_typ.clear();

  Incidence eh = build_incidence(edge_heads, edge_types, live, e, v);
  Incidence et = build_incidence(edge_tails, edge_types, live, e, v);

  std::vector<uint64_t> bits((size_t)r * ((r + 63) / 64));
  join(eh, eh, v, r, /*h2h=*/0, bits);
  join(et, et, v, r, /*t2t=*/1, bits);
  join(eh, et, v, r, /*h2t=*/2, bits);
  join(et, eh, v, r, /*t2h=*/3, bits);
  return (int64_t)g_src.size();
}

void relgraph_fetch(int64_t* src_out, int64_t* dst_out, int64_t* typ_out) {
  std::memcpy(src_out, g_src.data(), g_src.size() * sizeof(int64_t));
  std::memcpy(dst_out, g_dst.data(), g_dst.size() * sizeof(int64_t));
  std::memcpy(typ_out, g_typ.data(), g_typ.size() * sizeof(int64_t));
}

}  // extern "C"
