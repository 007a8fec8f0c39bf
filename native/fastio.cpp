// fastio — native data-plane for postgres_word2vec.
//
// Replaces the reference's Python/gensim embedding loaders
// (index_creation/index_utils.py:8-40 text parser; transform_vecs.py's
// gensim .bin → text conversion) with a mmap'd single-pass C++ parser:
// both the word2vec text format ("N D\n" header then "word v1 .. vd" rows)
// and the word2vec binary format ("N D\n" header then "word ␣ d×float32").
//
// Exposed as a C ABI for ctypes (no pybind11 in this image). All outputs
// are allocated here and released via fastio_free_result.
//
// Build: make -C native  (g++ -O3 -shared -fPIC)

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = ::open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (::fstat(m.fd, &st) != 0 || st.st_size == 0) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const char*>(p);
  m.size = static_cast<size_t>(st.st_size);
  return m;
}

void unmap(Mapped& m) {
  if (m.data) ::munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) ::close(m.fd);
  m.data = nullptr;
  m.fd = -1;
}

// Fast float parse: common "[-]ddd.ffffff[e±xx]" path without locale or
// allocation; falls back to strtof for unusual forms (hex, inf, nan).
inline float parse_float(const char*& p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  double mant = 0.0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    mant = mant * 10.0 + (*p++ - '0');
    any = true;
  }
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      mant += (*p++ - '0') * scale;
      scale *= 0.1;
      any = true;
    }
  }
  if (!any || (p < end && (*p == 'x' || *p == 'X'))) {
    // strtof on the raw mmap region could scan past a mapping that ends
    // exactly at a page boundary (SIGBUS) — copy the token into a
    // NUL-terminated buffer first. Tokens longer than the stack buffer
    // (pathological but legal) heap-copy instead of truncating: a
    // truncated parse would leave p mid-token and silently shift every
    // following column.
    char buf[64];
    const char* tend = start;
    while (tend < end && *tend != ' ' && *tend != '\t' && *tend != '\n' &&
           *tend != '\r')
      ++tend;
    size_t len = static_cast<size_t>(tend - start);
    char* tok = buf;
    std::string heap;
    if (len >= sizeof(buf)) {
      heap.assign(start, len);
      tok = heap.data();
    } else {
      std::memcpy(buf, start, len);
      buf[len] = '\0';
    }
    char* q = nullptr;
    float v = std::strtof(tok, &q);
    p = start + (q - tok);
    return v;
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) eneg = (*p++ == '-');
    int ex = 0;
    while (p < end && *p >= '0' && *p <= '9') ex = ex * 10 + (*p++ - '0');
    double f = 1.0;
    double base = eneg ? 0.1 : 10.0;
    while (ex) {
      if (ex & 1) f *= base;
      base *= base;
      ex >>= 1;
    }
    mant *= f;
  }
  return static_cast<float>(neg ? -mant : mant);
}

inline long parse_long(const char*& p, const char* end) {
  while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
  long v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  return v;
}

}  // namespace

extern "C" {

// Result protocol: on success returns 0 and fills outputs; non-zero is an
// errno-style failure. words_blob is '\n'-separated, words_blob_len bytes.
int fastio_parse_text(const char* path, long max_words, float** out_vecs,
                      char** out_words, long* out_words_len, long* out_n,
                      long* out_d) {
  Mapped m = map_file(path);
  if (!m.ok()) return 1;
  const char* p = m.data;
  const char* end = m.data + m.size;

  long n_hdr = parse_long(p, end);
  long d = parse_long(p, end);
  while (p < end && *p != '\n') ++p;
  if (p < end) ++p;
  if (n_hdr <= 0 || d <= 0) {
    unmap(m);
    return 2;
  }
  long cap = (max_words > 0 && max_words < n_hdr) ? max_words : n_hdr;

  float* vecs = static_cast<float*>(std::malloc(sizeof(float) * cap * d));
  char* words = static_cast<char*>(std::malloc(m.size));  // upper bound
  if (!vecs || !words) {
    std::free(vecs);
    std::free(words);
    unmap(m);
    return 3;
  }
  long n = 0;
  long wpos = 0;
  while (p < end && n < cap) {
    // word = bytes until first space
    const char* wstart = p;
    while (p < end && *p != ' ' && *p != '\n') ++p;
    if (p >= end || *p == '\n') {  // malformed row — skip
      if (p < end) ++p;
      continue;
    }
    long wlen = p - wstart;
    ++p;  // the space
    float* row = vecs + n * d;
    long i = 0;
    for (; i < d && p < end; ++i) row[i] = parse_float(p, end);
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
    if (i != d) continue;  // truncated row
    std::memcpy(words + wpos, wstart, wlen);
    wpos += wlen;
    words[wpos++] = '\n';
    ++n;
  }
  unmap(m);
  *out_vecs = vecs;
  *out_words = words;
  *out_words_len = wpos;
  *out_n = n;
  *out_d = d;
  return 0;
}

// word2vec binary format: "N D\n" then per row: word, ' ', d float32 LE,
// optional '\n'. (transform_vecs.py used gensim to convert this to text;
// here it loads directly.)
int fastio_parse_binary(const char* path, long max_words, float** out_vecs,
                        char** out_words, long* out_words_len, long* out_n,
                        long* out_d) {
  Mapped m = map_file(path);
  if (!m.ok()) return 1;
  const char* p = m.data;
  const char* end = m.data + m.size;

  long n_hdr = parse_long(p, end);
  long d = parse_long(p, end);
  while (p < end && *p != '\n') ++p;
  if (p < end) ++p;
  if (n_hdr <= 0 || d <= 0) {
    unmap(m);
    return 2;
  }
  long cap = (max_words > 0 && max_words < n_hdr) ? max_words : n_hdr;

  float* vecs = static_cast<float*>(std::malloc(sizeof(float) * cap * d));
  char* words = static_cast<char*>(std::malloc(m.size));
  if (!vecs || !words) {
    std::free(vecs);
    std::free(words);
    unmap(m);
    return 3;
  }
  long n = 0;
  long wpos = 0;
  const size_t row_bytes = sizeof(float) * d;
  while (p < end && n < cap) {
    while (p < end && (*p == '\n' || *p == ' ')) ++p;
    const char* wstart = p;
    while (p < end && *p != ' ') ++p;
    if (p >= end) break;
    long wlen = p - wstart;
    ++p;  // space
    if (static_cast<size_t>(end - p) < row_bytes) break;
    std::memcpy(vecs + n * d, p, row_bytes);
    p += row_bytes;
    std::memcpy(words + wpos, wstart, wlen);
    wpos += wlen;
    words[wpos++] = '\n';
    ++n;
  }
  unmap(m);
  *out_vecs = vecs;
  *out_words = words;
  *out_words_len = wpos;
  *out_n = n;
  *out_d = d;
  return 0;
}

void fastio_free(void* p) { std::free(p); }

// L2-normalize rows in place (vec2database.py:serialize_as_norm_array
// equivalent, done at load time).
void fastio_normalize_rows(float* vecs, long n, long d) {
  for (long i = 0; i < n; ++i) {
    float* row = vecs + i * d;
    double s = 0.0;
    for (long j = 0; j < d; ++j) s += double(row[j]) * row[j];
    if (s <= 0.0) continue;
    float inv = static_cast<float>(1.0 / std::sqrt(s));
    for (long j = 0; j < d; ++j) row[j] *= inv;
  }
}

}  // extern "C"
