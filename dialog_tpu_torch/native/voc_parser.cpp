// Fast parser for DBoW2 text vocabularies (ORBvoc.txt).
//
// The reference loads its 145 MB shipped vocabulary with a line-by-line
// C++ std::stringstream parse taking ~10 s at startup (canonical
// TemplatedVocabulary::loadFromTextFile - SURVEY.md S2.2 "ORB vocabulary
// blob"). This parser memory-maps nothing fancy - it just scans the buffer
// once with hand-rolled integer/float parsing, filling flat arrays the
// Python side converts to the engine's packed codebook.
//
// Format (after the "k L scoring weighting" header line), one node per line:
//   parent_id is_leaf d_0 ... d_31 weight
//
// Built at first use by dialog_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -o build/dialog_tpu_torch/libnative_voc_parser_<hash>.so voc_parser.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

struct VocHeader {
  int32_t k;
  int32_t levels;
  int32_t scoring;
  int32_t weighting;
  int64_t n_nodes;
};

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  return p;
}

static inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
  p = skip_ws(p, end);
  bool neg = (p < end && *p == '-');
  if (neg) ++p;
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = neg ? -v : v;
  return p;
}

static inline const char* parse_f64(const char* p, const char* end, double* out) {
  p = skip_ws(p, end);
  char* q;
  *out = strtod(p, &q);
  return q;
}

// First pass: header + node count. Returns 0 on success.
int voc_scan(const char* buf, int64_t len, VocHeader* hdr) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t k, L, sc, wt;
  p = parse_i64(p, end, &k);
  p = parse_i64(p, end, &L);
  p = parse_i64(p, end, &sc);
  p = parse_i64(p, end, &wt);
  if (k <= 0 || L <= 0) return -1;
  // count remaining lines with content (each node = 35 whitespace fields)
  int64_t fields = 0;
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
    ++fields;
  }
  if (fields % 35 != 0) return -2;
  hdr->k = (int32_t)k;
  hdr->levels = (int32_t)L;
  hdr->scoring = (int32_t)sc;
  hdr->weighting = (int32_t)wt;
  hdr->n_nodes = fields / 35;
  return 0;
}

// Second pass: fill the output arrays (caller allocates to n_nodes).
int voc_parse(const char* buf, int64_t len, int64_t n_nodes,
              int32_t* parent, uint8_t* is_leaf, uint8_t* desc,
              double* weight) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t tmp;
  // skip header
  for (int i = 0; i < 4; ++i) p = parse_i64(p, end, &tmp);
  for (int64_t n = 0; n < n_nodes; ++n) {
    int64_t par, leaf;
    p = parse_i64(p, end, &par);
    p = parse_i64(p, end, &leaf);
    parent[n] = (int32_t)par;
    is_leaf[n] = (uint8_t)leaf;
    for (int b = 0; b < 32; ++b) {
      int64_t v;
      p = parse_i64(p, end, &v);
      desc[n * 32 + b] = (uint8_t)v;
    }
    p = parse_f64(p, end, &weight[n]);
    if (p > end) return -1;
  }
  return 0;
}

}  // extern "C"
