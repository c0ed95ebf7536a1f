// Native host runtime for probly-search-tpu.
//
// The reference's indexing hot path is per-occurrence trie insertion in Rust
// (reference src/index.rs:119-157).  Here the host-side analogue —
// tokenize -> intern -> sorted term ids — runs as native code feeding the
// vectorized CSR packing (index/bulk.py).  The tokenizer reproduces the
// reference's conventions: split on the single space character, drop empty
// tokens (index.rs:100-110), byte-wise term ordering (Rust String Ord).
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <string_view>
#include <unordered_map>
#include <vector>

extern "C" {

struct TokenizeResult {
  // Occurrence stream (one entry per non-empty token, in document order).
  int32_t* term_ids;     // sorted-term id per occurrence
  int64_t n_tokens;
  int64_t* doc_token_counts;  // tokens per document [n_docs]
  // Sorted unique term table.
  char* terms_blob;      // '\0'-separated, lexicographic (byte-wise)
  int64_t terms_blob_len;
  int32_t* term_byte_lens;  // utf-8 byte length per term
  int64_t n_terms;
};

// Tokenize n_docs texts (concatenated in `blob`, doc d = bytes
// [offs[d], offs[d+1])), intern terms, return the occurrence stream with
// ids into the SORTED unique term table.
TokenizeResult* psearch_tokenize_index(const char* blob, const int64_t* offs,
                                       int64_t n_docs) {
  auto* res = new TokenizeResult();
  std::vector<int32_t> occ_ids;   // provisional (first-seen) ids
  std::vector<std::string_view> terms;  // first-seen order
  std::unordered_map<std::string_view, int32_t> intern;
  res->doc_token_counts = new int64_t[n_docs > 0 ? n_docs : 1];

  occ_ids.reserve((offs[n_docs] - offs[0]) / 5 + 8);
  for (int64_t d = 0; d < n_docs; ++d) {
    const char* p = blob + offs[d];
    const char* end = blob + offs[d + 1];
    int64_t count = 0;
    while (p <= end) {
      const char* sp = static_cast<const char*>(
          memchr(p, ' ', static_cast<size_t>(end - p)));
      const char* tok_end = sp ? sp : end;
      if (tok_end > p) {  // drop empty tokens (index.rs:100-110)
        std::string_view term(p, static_cast<size_t>(tok_end - p));
        auto it = intern.find(term);
        int32_t id;
        if (it == intern.end()) {
          id = static_cast<int32_t>(terms.size());
          intern.emplace(term, id);
          terms.push_back(term);
        } else {
          id = it->second;
        }
        occ_ids.push_back(id);
        ++count;
      }
      if (!sp) break;
      p = sp + 1;
    }
    res->doc_token_counts[d] = count;
  }

  // Sort the term table byte-wise (== Rust String Ord == numpy U order for
  // valid UTF-8) and remap occurrence ids.
  const int64_t T = static_cast<int64_t>(terms.size());
  std::vector<int32_t> order(T);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return terms[a] < terms[b];
  });
  std::vector<int32_t> rank(T);
  for (int64_t i = 0; i < T; ++i) rank[order[i]] = static_cast<int32_t>(i);

  res->n_tokens = static_cast<int64_t>(occ_ids.size());
  res->term_ids = new int32_t[res->n_tokens > 0 ? res->n_tokens : 1];
  for (int64_t i = 0; i < res->n_tokens; ++i)
    res->term_ids[i] = rank[occ_ids[i]];

  int64_t blob_len = 0;
  for (auto& t : terms) blob_len += static_cast<int64_t>(t.size()) + 1;
  res->terms_blob = new char[blob_len > 0 ? blob_len : 1];
  res->term_byte_lens = new int32_t[T > 0 ? T : 1];
  char* w = res->terms_blob;
  for (int64_t i = 0; i < T; ++i) {
    std::string_view t = terms[order[i]];
    memcpy(w, t.data(), t.size());
    w += t.size();
    *w++ = '\0';
    res->term_byte_lens[i] = static_cast<int32_t>(t.size());
  }
  res->terms_blob_len = blob_len;
  res->n_terms = T;
  return res;
}

void psearch_free_result(TokenizeResult* res) {
  delete[] res->term_ids;
  delete[] res->doc_token_counts;
  delete[] res->terms_blob;
  delete[] res->term_byte_lens;
  delete res;
}

// ------------------------------------------------------------------------
// One-shot CSR builder (single field): tokenize + intern + per-(term, doc)
// term frequencies + CSR pack, all in one native pass.  Replaces the
// vectorized-numpy pair counting (8M-element packed sorts measured ~10 s
// per 1M docs on this host's single core) with O(tokens + postings) work:
// per-doc counting against a last-seen-doc array, then a counting-sort
// scatter by term.  Pairs are emitted in document order, so within each
// term the scatter preserves ascending doc ids — the CSR invariant the
// device merge relies on (index/segment.py build_segment).

struct CsrResult {
  // Sorted unique term table (as in TokenizeResult).
  char* terms_blob;
  int64_t terms_blob_len;
  int32_t* term_byte_lens;
  int64_t n_terms;
  // CSR postings over sorted term ids.
  int64_t* offsets;   // [n_terms + 1]
  int32_t* post_doc;  // [n_postings] — doc index within the batch
  int32_t* post_tf;   // [n_postings]
  int64_t n_postings;
  int64_t* doc_token_counts;  // [n_docs]
};

CsrResult* psearch_tokenize_csr(const char* blob, const int64_t* offs,
                                int64_t n_docs) {
  auto* res = new CsrResult();
  std::vector<std::string_view> terms;  // first-seen order
  std::unordered_map<std::string_view, int32_t> intern;
  res->doc_token_counts = new int64_t[n_docs > 0 ? n_docs : 1];

  // Pair stream in doc order: (first-seen term id, doc, tf).
  std::vector<int32_t> pair_term, pair_doc, pair_tf;
  std::vector<int32_t> last_doc;   // per first-seen term id
  std::vector<int32_t> tf_local;   // per first-seen term id
  std::vector<int32_t> touched;
  pair_term.reserve((offs[n_docs] - offs[0]) / 8 + 8);

  for (int64_t d = 0; d < n_docs; ++d) {
    const char* p = blob + offs[d];
    const char* end = blob + offs[d + 1];
    int64_t count = 0;
    touched.clear();
    while (p <= end) {
      const char* sp = static_cast<const char*>(
          memchr(p, ' ', static_cast<size_t>(end - p)));
      const char* tok_end = sp ? sp : end;
      if (tok_end > p) {
        std::string_view term(p, static_cast<size_t>(tok_end - p));
        auto it = intern.find(term);
        int32_t id;
        if (it == intern.end()) {
          id = static_cast<int32_t>(terms.size());
          intern.emplace(term, id);
          terms.push_back(term);
          last_doc.push_back(-1);
          tf_local.push_back(0);
        } else {
          id = it->second;
        }
        if (last_doc[id] != static_cast<int32_t>(d)) {
          last_doc[id] = static_cast<int32_t>(d);
          tf_local[id] = 1;
          touched.push_back(id);
        } else {
          ++tf_local[id];
        }
        ++count;
      }
      if (!sp) break;
      p = sp + 1;
    }
    res->doc_token_counts[d] = count;
    for (int32_t id : touched) {
      pair_term.push_back(id);
      pair_doc.push_back(static_cast<int32_t>(d));
      pair_tf.push_back(tf_local[id]);
    }
  }

  // Sorted term table + first-seen-id -> rank remap.
  const int64_t T = static_cast<int64_t>(terms.size());
  std::vector<int32_t> order(T);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return terms[a] < terms[b];
  });
  std::vector<int32_t> rank(T);
  for (int64_t i = 0; i < T; ++i) rank[order[i]] = static_cast<int32_t>(i);

  // Counting-sort scatter by sorted term id (doc order preserved per term).
  const int64_t P = static_cast<int64_t>(pair_term.size());
  res->offsets = new int64_t[T + 1]();
  for (int64_t i = 0; i < P; ++i) ++res->offsets[rank[pair_term[i]] + 1];
  for (int64_t t = 0; t < T; ++t) res->offsets[t + 1] += res->offsets[t];
  res->post_doc = new int32_t[P > 0 ? P : 1];
  res->post_tf = new int32_t[P > 0 ? P : 1];
  std::vector<int64_t> cursor(res->offsets, res->offsets + T);
  for (int64_t i = 0; i < P; ++i) {
    const int64_t pos = cursor[rank[pair_term[i]]]++;
    res->post_doc[pos] = pair_doc[i];
    res->post_tf[pos] = pair_tf[i];
  }
  res->n_postings = P;

  int64_t blob_len = 0;
  for (auto& t : terms) blob_len += static_cast<int64_t>(t.size()) + 1;
  res->terms_blob = new char[blob_len > 0 ? blob_len : 1];
  res->term_byte_lens = new int32_t[T > 0 ? T : 1];
  char* w = res->terms_blob;
  for (int64_t i = 0; i < T; ++i) {
    std::string_view t = terms[order[i]];
    memcpy(w, t.data(), t.size());
    w += t.size();
    *w++ = '\0';
    res->term_byte_lens[i] = static_cast<int32_t>(t.size());
  }
  res->terms_blob_len = blob_len;
  res->n_terms = T;
  return res;
}

void psearch_free_csr(CsrResult* res) {
  delete[] res->terms_blob;
  delete[] res->term_byte_lens;
  delete[] res->offsets;
  delete[] res->post_doc;
  delete[] res->post_tf;
  delete[] res->doc_token_counts;
  delete res;
}

// ------------------------------------------------------------------------
// Multi-field one-shot CSR builder.  Same O(tokens + postings) pipeline as
// psearch_tokenize_csr, generalized to F fields: one shared intern table,
// one posting row per distinct (term, doc) carrying an F-wide tf vector
// (the Segment post_tf[P, F] layout, index/segment.py), postings emitted in
// document order per term (the CSR doc-ascending invariant the device
// merge relies on).  Two front-ends share the core:
//   * psearch_tokenize_csr_multi — text cells, native space tokenization
//     (default whitespace tokenizer semantics, index.rs:100-110);
//   * psearch_intern_csr_multi — pre-tokenized streams (custom tokenizers
//     tokenize in Python; intern+count+pack stay native — VERDICT r2 #7).
// Cells are DOC-MAJOR: cell(d, f) = d * n_fields + f.

struct CsrMultiResult {
  char* terms_blob;
  int64_t terms_blob_len;
  int32_t* term_byte_lens;
  int64_t n_terms;
  int64_t* offsets;   // [n_terms + 1]
  int32_t* post_doc;  // [n_postings] — doc index within the batch
  int32_t* post_tf;   // [n_postings * n_fields] row-major
  int64_t n_postings;
  int64_t* cell_token_counts;  // [n_docs * n_fields] doc-major
};

namespace {

// Open-addressing string interner: node-based std::unordered_map measured
// ~2x slower on high-unique-term corpora (one malloc + pointer chase per
// insert); FNV-1a + linear probing over a flat int32 table, stored hashes
// so growth never re-reads term bytes.
struct Interner {
  std::vector<std::string_view> terms;  // first-seen order
  std::vector<uint64_t> hashes;         // per first-seen id
  std::vector<int32_t> table;           // -1 = empty
  size_t mask = 0;

  static inline uint64_t hash_sv(std::string_view s) {
    uint64_t h = 1469598103934665603ull;
    for (unsigned char c : s) {
      h ^= c;
      h *= 1099511628211ull;
    }
    return h;
  }

  void init(size_t hint) {
    size_t cap = 64;
    while (cap < hint * 2) cap <<= 1;
    table.assign(cap, -1);
    mask = cap - 1;
    terms.reserve(hint);
    hashes.reserve(hint);
  }

  void grow() {
    size_t cap = (mask + 1) * 2;
    table.assign(cap, -1);
    mask = cap - 1;
    for (size_t i = 0; i < terms.size(); ++i) {
      size_t p = hashes[i] & mask;
      while (table[p] >= 0) p = (p + 1) & mask;
      table[p] = static_cast<int32_t>(i);
    }
  }

  // Returns (id, is_new).
  inline std::pair<int32_t, bool> see(std::string_view term) {
    const uint64_t h = hash_sv(term);
    size_t p = h & mask;
    while (true) {
      const int32_t id = table[p];
      if (id < 0) {
        const int32_t nid = static_cast<int32_t>(terms.size());
        terms.push_back(term);
        hashes.push_back(h);
        table[p] = nid;
        if (terms.size() * 10 > (mask + 1) * 7) grow();
        return {nid, true};
      }
      if (hashes[id] == h && terms[id] == term) return {id, false};
      p = (p + 1) & mask;
    }
  }
};

struct MultiBuildState {
  Interner intern;
  std::vector<int32_t> last_doc;  // per first-seen id
  std::vector<int32_t> tf_local;  // per first-seen id, F slots each
  std::vector<int32_t> touched;
  std::vector<int32_t> pair_term, pair_doc;
  std::vector<int32_t> pair_tf;  // F entries per pair
  int64_t F;

  explicit MultiBuildState(int64_t n_fields) : F(n_fields) { intern.init(64); }

  void reserve_terms(int64_t hint) {
    intern.init(static_cast<size_t>(hint > 16 ? hint : 16));
  }

  inline int64_t see(std::string_view term, int32_t d, int64_t f) {
    auto [id, is_new] = intern.see(term);
    if (is_new) {
      last_doc.push_back(-1);
      tf_local.resize(tf_local.size() + F, 0);
    }
    if (last_doc[id] != d) {
      last_doc[id] = d;
      std::fill_n(tf_local.begin() + id * F, F, 0);
      touched.push_back(id);
    }
    ++tf_local[id * F + f];
    return id;
  }

  inline void end_doc(int32_t d) {
    for (int32_t id : touched) {
      pair_term.push_back(id);
      pair_doc.push_back(d);
      for (int64_t f = 0; f < F; ++f) pair_tf.push_back(tf_local[id * F + f]);
    }
    touched.clear();
  }

  CsrMultiResult* finish() {
    auto* res = new CsrMultiResult();
    const auto& terms = intern.terms;
    const int64_t T = static_cast<int64_t>(terms.size());
    // Sort by an 8-byte big-endian prefix key (== byte-wise order when it
    // differs; full compare on ties) — most terms resolve in one uint64
    // compare instead of a memcmp call.
    std::vector<uint64_t> pfx(T);
    for (int64_t i = 0; i < T; ++i) {
      uint64_t k = 0;
      const std::string_view t = terms[i];
      const size_t n = t.size() < 8 ? t.size() : 8;
      for (size_t b = 0; b < n; ++b)
        k |= static_cast<uint64_t>(static_cast<unsigned char>(t[b]))
             << (56 - 8 * b);
      pfx[i] = k;
    }
    std::vector<int32_t> order(T);
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
      if (pfx[a] != pfx[b]) return pfx[a] < pfx[b];
      return terms[a] < terms[b];
    });
    std::vector<int32_t> rank(T);
    for (int64_t i = 0; i < T; ++i) rank[order[i]] = static_cast<int32_t>(i);

    const int64_t P = static_cast<int64_t>(pair_term.size());
    res->offsets = new int64_t[T + 1]();
    for (int64_t i = 0; i < P; ++i) ++res->offsets[rank[pair_term[i]] + 1];
    for (int64_t t = 0; t < T; ++t) res->offsets[t + 1] += res->offsets[t];
    res->post_doc = new int32_t[P > 0 ? P : 1];
    res->post_tf = new int32_t[P * F > 0 ? P * F : 1];
    std::vector<int64_t> cursor(res->offsets, res->offsets + T);
    for (int64_t i = 0; i < P; ++i) {
      const int64_t pos = cursor[rank[pair_term[i]]]++;
      res->post_doc[pos] = pair_doc[i];
      std::copy_n(pair_tf.begin() + i * F, F, res->post_tf + pos * F);
    }
    res->n_postings = P;

    int64_t blob_len = 0;
    for (auto& t : terms) blob_len += static_cast<int64_t>(t.size()) + 1;
    res->terms_blob = new char[blob_len > 0 ? blob_len : 1];
    res->term_byte_lens = new int32_t[T > 0 ? T : 1];
    char* w = res->terms_blob;
    for (int64_t i = 0; i < T; ++i) {
      std::string_view t = terms[order[i]];
      memcpy(w, t.data(), t.size());
      w += t.size();
      *w++ = '\0';
      res->term_byte_lens[i] = static_cast<int32_t>(t.size());
    }
    res->terms_blob_len = blob_len;
    res->n_terms = T;
    return res;
  }
};

}  // namespace

CsrMultiResult* psearch_tokenize_csr_multi(const char* blob,
                                           const int64_t* offs,
                                           int64_t n_docs, int64_t n_fields) {
  MultiBuildState st(n_fields);
  const int64_t n_cells = n_docs * n_fields;
  auto* counts = new int64_t[n_cells > 0 ? n_cells : 1];
  st.pair_term.reserve((offs[n_cells] - offs[0]) / 8 + 8);
  st.reserve_terms((offs[n_cells] - offs[0]) / 8);

  for (int64_t d = 0; d < n_docs; ++d) {
    for (int64_t f = 0; f < n_fields; ++f) {
      const int64_t cell = d * n_fields + f;
      const char* p = blob + offs[cell];
      const char* end = blob + offs[cell + 1];
      int64_t count = 0;
      while (p <= end) {
        const char* sp = static_cast<const char*>(
            memchr(p, ' ', static_cast<size_t>(end - p)));
        const char* tok_end = sp ? sp : end;
        if (tok_end > p) {  // drop empty tokens (index.rs:100-110)
          st.see(std::string_view(p, static_cast<size_t>(tok_end - p)),
                 static_cast<int32_t>(d), f);
          ++count;
        }
        if (!sp) break;
        p = sp + 1;
      }
      counts[cell] = count;
    }
    st.end_doc(static_cast<int32_t>(d));
  }
  CsrMultiResult* res = st.finish();
  res->cell_token_counts = counts;
  return res;
}

CsrMultiResult* psearch_intern_csr_multi(const char* blob,
                                         const int64_t* tok_offs,
                                         const int64_t* cell_counts,
                                         int64_t n_docs, int64_t n_fields) {
  MultiBuildState st(n_fields);
  const int64_t n_cells = n_docs * n_fields;
  auto* counts = new int64_t[n_cells > 0 ? n_cells : 1];
  int64_t tok = 0;
  int64_t total_toks = 0;
  for (int64_t c = 0; c < n_cells; ++c) total_toks += cell_counts[c];
  st.pair_term.reserve(total_toks / 2 + 8);
  st.reserve_terms(total_toks / 2);

  for (int64_t d = 0; d < n_docs; ++d) {
    for (int64_t f = 0; f < n_fields; ++f) {
      const int64_t cell = d * n_fields + f;
      for (int64_t i = 0; i < cell_counts[cell]; ++i, ++tok) {
        st.see(std::string_view(
                   blob + tok_offs[tok],
                   static_cast<size_t>(tok_offs[tok + 1] - tok_offs[tok])),
               static_cast<int32_t>(d), f);
      }
      counts[cell] = cell_counts[cell];
    }
    st.end_doc(static_cast<int32_t>(d));
  }
  CsrMultiResult* res = st.finish();
  res->cell_token_counts = counts;
  return res;
}

void psearch_free_csr_multi(CsrMultiResult* res) {
  delete[] res->terms_blob;
  delete[] res->term_byte_lens;
  delete[] res->offsets;
  delete[] res->post_doc;
  delete[] res->post_tf;
  delete[] res->cell_token_counts;
  delete res;
}

}  // extern "C"
