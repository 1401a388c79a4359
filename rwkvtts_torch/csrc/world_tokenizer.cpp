// Native greedy longest-match tokenizer core for the RWKV world vocabulary.
//
// The reference's tokenizer is a Python object trie
// (tokenizer/rwkv_tokenizer.py:39-96); serving and ETL call it per request,
// so the byte-level match is the hot host-side op. This is a compact
// vector-backed trie with binary-searched children and longest-match
// backtracking, exposed through a C ABI for ctypes.
//
// Vocab transport: Python parses the published vocab file (its token reprs
// are Python literals) and hands over a binary blob of records:
//   [int32 id][int32 len][len bytes] ...
//
// Host C++, not a GPU kernel: rwkvtts_torch/utils/native.py builds it at
// first use with
//   g++ -O3 -shared -fPIC -std=c++17 -o libworld_tokenizer_<hash>.so world_tokenizer.cpp
// and binds it through ctypes (NativeTrieEncoder).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct Edge {
  uint8_t byte;
  int32_t child;
};

struct Node {
  int32_t token_id = -1;  // token ending at this node, or -1
  int32_t edges_begin = 0;
  int32_t edges_len = 0;
};

struct Trie {
  // construction-time adjacency (sorted + flattened on finalize)
  std::vector<std::vector<Edge>> tmp_children;
  std::vector<Node> nodes;
  std::vector<Edge> edges;

  int32_t add_node() {
    nodes.push_back(Node{});
    tmp_children.emplace_back();
    return static_cast<int32_t>(nodes.size()) - 1;
  }

  void insert(const uint8_t* bytes, int32_t len, int32_t id) {
    int32_t cur = 0;
    for (int32_t i = 0; i < len; ++i) {
      uint8_t b = bytes[i];
      auto& ch = tmp_children[cur];
      int32_t next = -1;
      for (const auto& e : ch) {
        if (e.byte == b) { next = e.child; break; }
      }
      if (next < 0) {
        next = add_node();
        tmp_children[cur].push_back(Edge{b, next});
      }
      cur = next;
    }
    nodes[cur].token_id = id;
  }

  void finalize() {
    edges.clear();
    for (size_t i = 0; i < nodes.size(); ++i) {
      auto& ch = tmp_children[i];
      std::sort(ch.begin(), ch.end(),
                [](const Edge& a, const Edge& b) { return a.byte < b.byte; });
      nodes[i].edges_begin = static_cast<int32_t>(edges.size());
      nodes[i].edges_len = static_cast<int32_t>(ch.size());
      edges.insert(edges.end(), ch.begin(), ch.end());
    }
    tmp_children.clear();
    tmp_children.shrink_to_fit();
  }

  inline int32_t step(int32_t node, uint8_t b) const {
    const Node& n = nodes[node];
    const Edge* lo = edges.data() + n.edges_begin;
    const Edge* hi = lo + n.edges_len;
    // binary search over sorted edges
    while (lo < hi) {
      const Edge* mid = lo + (hi - lo) / 2;
      if (mid->byte < b) lo = mid + 1;
      else if (mid->byte > b) hi = mid;
      else return mid->child;
    }
    return -1;
  }
};

}  // namespace

extern "C" {

void* wt_create(const uint8_t* blob, int64_t blob_len) {
  auto* t = new Trie();
  t->add_node();  // root
  int64_t off = 0;
  while (off + 8 <= blob_len) {
    int32_t id, len;
    std::memcpy(&id, blob + off, 4);
    std::memcpy(&len, blob + off + 4, 4);
    off += 8;
    if (off + len > blob_len) break;
    t->insert(blob + off, len, id);
    off += len;
  }
  t->finalize();
  return t;
}

void wt_destroy(void* h) { delete static_cast<Trie*>(h); }

// Greedy longest match. Returns token count, or -(pos+1) on an
// unencodable byte at `pos`, or -1000000000 if out capacity is exceeded.
int64_t wt_encode(void* h, const uint8_t* text, int64_t len, int32_t* out,
                  int64_t cap) {
  const Trie& t = *static_cast<Trie*>(h);
  int64_t i = 0, n_out = 0;
  while (i < len) {
    int32_t node = 0;
    int32_t best_id = -1;
    int64_t best_end = i;
    int64_t j = i;
    while (j < len) {
      node = t.step(node, text[j]);
      if (node < 0) break;
      ++j;
      if (t.nodes[node].token_id >= 0) {
        best_id = t.nodes[node].token_id;
        best_end = j;
      }
    }
    if (best_id < 0) return -(i + 1);
    if (n_out >= cap) return -1000000000;
    out[n_out++] = best_id;
    i = best_end;
  }
  return n_out;
}

}  // extern "C"
