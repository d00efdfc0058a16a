// A Zstandard frame decoder written to RFC 8878, with the two checksums an
// Orbax directory needs: XXH64 (the frame's content checksum) and CRC-32C
// (the OCDBT files' trailer). C++17 and the standard library only; bound to
// Python through ctypes (checkpoint/zstd.py).
//
// Covered: raw, RLE and compressed blocks; raw, RLE, Huffman-compressed
// (one or four streams) and treeless literals, Huffman weights direct or
// FSE-compressed; sequence tables predefined, RLE, FSE-compressed and
// repeated; repeat offsets; frames with or without a content size and a
// window descriptor; skippable frames; concatenated frames; the optional
// content checksum, which is verified. Dictionaries are refused. Every
// malformed input raises an error with a message; nothing is read or
// written outside the buffers.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

inline void need(bool ok, const char* what) {
  if (!ok) throw Corrupt(what);
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }   // v > 0

inline uint64_t load_le(const uint8_t* p, size_t n) {
  uint64_t v = 0;
  for (size_t i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

inline uint64_t mask64(int k) { return k >= 64 ? ~0ull : (1ull << k) - 1; }

constexpr size_t kBlockMax = 128 * 1024;

// ---- checksums ------------------------------------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    while (end - p >= 32) {
      v1 = xround(v1, load_le(p, 8));
      v2 = xround(v2, load_le(p + 8, 8));
      v3 = xround(v3, load_le(p + 16, 8));
      v4 = xround(v4, load_le(p + 24, 8));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += n;
  while (end - p >= 8) {
    h = rotl(h ^ xround(0, load_le(p, 8)), 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h = rotl(h ^ (load_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) h = rotl(h ^ (*p++ * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (uint32_t i = 0; i < 256; ++i) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n) {
  static const Crc32cTable tab;
  const auto& t = tab.t;
  uint32_t c = 0xffffffffu;
  while (n >= 8) {   // slicing by eight
    uint64_t w = load_le(p, 8) ^ c;
    c = t[7][w & 0xff] ^ t[6][(w >> 8) & 0xff] ^ t[5][(w >> 16) & 0xff] ^
        t[4][(w >> 24) & 0xff] ^ t[3][(w >> 32) & 0xff] ^ t[2][(w >> 40) & 0xff] ^
        t[1][(w >> 48) & 0xff] ^ t[0][w >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ t[0][(c ^ *p++) & 0xff];
  return c ^ 0xffffffffu;
}

// ---- bit readers ----------------------------------------------------------

// A forward little-endian bit stream (FSE table descriptions): bit i of the
// stream is bit i % 8 of byte i / 8. Reads past the end give zeros; the
// caller checks how many bytes were used.
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  uint64_t pos = 0;
  uint64_t peek(int k) const {
    size_t byte = pos >> 3;
    if (byte >= n) return 0;
    uint64_t w = load_le(p + byte, n - byte < 8 ? n - byte : 8);
    return (w >> (pos & 7)) & mask64(k);
  }
  void skip(int k) { pos += k; }
  uint64_t read(int k) {
    uint64_t v = peek(k);
    pos += k;
    return v;
  }
  size_t bytes_used() const { return (pos + 7) >> 3; }
};

// The backward bit stream of Huffman and FSE data: read from the last byte
// down, after its highest set bit (the end mark). `pos` is the number of
// bits not yet read; it goes negative when a read runs past the start,
// which reads zeros there.
struct BackwardBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;
  BackwardBits(const uint8_t* data, size_t size) : p(data), n(size) {
    need(size > 0, "empty bit stream");
    need(data[size - 1] != 0, "bit stream without its end mark");
    pos = int64_t(size - 1) * 8 + highbit(data[size - 1]);
  }
  uint64_t peek(int k) const {   // k <= 56
    if (k == 0) return 0;
    int64_t start = pos - k;
    if (start >= 0) {
      size_t byte = size_t(start >> 3);
      uint64_t w;
      if (byte + 8 <= n) {
        std::memcpy(&w, p + byte, 8);   // little-endian host
      } else {
        w = load_le(p + byte, n - byte);
      }
      return (w >> (start & 7)) & mask64(k);
    }
    if (pos <= 0) return 0;
    return (load_le(p, n < 8 ? n : 8) & mask64(int(pos))) << (-start);
  }
  uint64_t read(int k) {
    uint64_t v = peek(k);
    pos -= k;
    return v;
  }
};

// ---- FSE ------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct Fse {
  int log = -1;   // -1: no table yet (a repeat mode has nothing to repeat)
  std::vector<FseEntry> t;
};

// Reads an FSE table description (RFC 8878 4.1.1); returns the bytes used.
size_t read_ncount(const uint8_t* p, size_t n, int max_symbol, int max_log,
                   std::vector<int16_t>& norm, int& log) {
  need(n > 0, "truncated FSE table description");
  ForwardBits br{p, n};
  log = int(br.read(4)) + 5;
  need(log <= max_log, "FSE accuracy log too large");
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int symbol = 0;
  bool previous0 = false;
  norm.assign(max_symbol + 1, 0);
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous0) {
      for (;;) {
        int repeat = int(br.read(2));
        symbol += repeat;
        if (repeat != 3) break;
      }
      need(symbol <= max_symbol, "FSE zero run past the last symbol");
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint64_t low = br.peek(nbits);
    if (int(low & (threshold - 1)) < max) {
      count = int(low & (threshold - 1));
      br.skip(nbits - 1);
    } else {
      count = int(low & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.skip(nbits);
    }
    --count;   // probability: -1 stands for "less than one"
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  need(remaining == 1, "FSE probabilities do not sum to the table size");
  need(br.bytes_used() <= n, "truncated FSE table description");
  norm.resize(symbol);
  return br.bytes_used();
}

void build_fse(Fse& f, const std::vector<int16_t>& norm, int log) {
  const uint32_t size = 1u << log;
  f.log = log;
  f.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int64_t high = int64_t(size) - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      need(high >= 0, "FSE table overfull");
      f.t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s] < 0 ? 0 : norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      f.t[pos].symbol = uint16_t(s);
      do pos = (pos + step) & mask;
      while (int64_t(pos) > high);
    }
  }
  need(pos == 0, "FSE symbols not spread over the whole table");
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t s = f.t[u].symbol;
    uint32_t state = next[s]++;
    need(state > 0, "FSE state without a probability");
    int bits = log - highbit(state);
    f.t[u].bits = uint8_t(bits);
    f.t[u].base = uint16_t((state << bits) - size);
  }
}

void rle_fse(Fse& f, uint8_t symbol) {
  f.log = 0;
  f.t.assign(1, FseEntry{symbol, 0, 0});
}

// ---- Huffman --------------------------------------------------------------

struct Huffman {
  int log = 0;   // 0: no table yet
  std::vector<uint16_t> t;   // symbol | bits << 8, indexed by `log` peeked bits
};

// Reads a Huffman tree description (RFC 8878 4.2.1); returns the bytes used.
size_t read_huffman(const uint8_t* p, size_t n, Huffman& h) {
  need(n > 0, "truncated Huffman tree description");
  uint8_t weights[256] = {0};
  int count = 0;
  size_t used;
  const uint8_t header = p[0];
  if (header < 128) {   // FSE-compressed weights, two interleaved states
    used = 1 + size_t(header);
    need(used <= n, "truncated Huffman weights");
    std::vector<int16_t> norm;
    int log;
    size_t nc = read_ncount(p + 1, header, 255, 6, norm, log);
    Fse f;
    build_fse(f, norm, log);
    need(nc < header, "Huffman weights without a bit stream");
    BackwardBits br(p + 1 + nc, header - nc);
    uint32_t s1 = uint32_t(br.read(log)), s2 = uint32_t(br.read(log));
    for (;;) {
      need(count < 255, "too many Huffman weights");
      weights[count++] = uint8_t(f.t[s1].symbol);
      s1 = f.t[s1].base + uint32_t(br.read(f.t[s1].bits));
      if (br.pos < 0) {
        need(count < 255, "too many Huffman weights");
        weights[count++] = uint8_t(f.t[s2].symbol);
        break;
      }
      need(count < 255, "too many Huffman weights");
      weights[count++] = uint8_t(f.t[s2].symbol);
      s2 = f.t[s2].base + uint32_t(br.read(f.t[s2].bits));
      if (br.pos < 0) {
        need(count < 255, "too many Huffman weights");
        weights[count++] = uint8_t(f.t[s1].symbol);
        break;
      }
    }
  } else {   // four bits per weight
    count = header - 127;
    used = 1 + size_t(count + 1) / 2;
    need(used <= n, "truncated Huffman weights");
    for (int i = 0; i < count; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < count; ++i) {
    need(weights[i] <= 11, "Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  need(total > 0, "Huffman weights all zero");
  const int max_bits = highbit(total) + 1;
  need(max_bits <= 11, "Huffman code longer than 11 bits");
  const uint32_t left = (1u << max_bits) - total;
  need(left > 0 && (left & (left - 1)) == 0, "Huffman weights do not complete a tree");
  need(count < 256, "too many Huffman symbols");
  weights[count++] = uint8_t(highbit(left) + 1);   // the last symbol's weight

  uint32_t rank[13] = {0};
  for (int i = 0; i < count; ++i) ++rank[weights[i]];
  uint32_t start[13] = {0}, next = 0;
  for (int w = 1; w <= max_bits; ++w) {
    start[w] = next;
    next += rank[w] << (w - 1);
  }
  need(next == (1u << max_bits), "Huffman table incomplete");
  h.log = max_bits;
  h.t.assign(size_t(1) << max_bits, 0);
  for (int s = 0; s < count; ++s) {
    int w = weights[s];
    if (!w) continue;
    uint16_t entry = uint16_t(s | ((max_bits + 1 - w) << 8));
    for (uint32_t u = start[w]; u < start[w] + (1u << (w - 1)); ++u) h.t[u] = entry;
    start[w] += 1u << (w - 1);
  }
  return used;
}

// Decodes `k` Huffman streams (1 or 4) of the same table, stream s from
// p[s][0:n[s]] into out[s][0:count[s]]. Each stream must be consumed
// exactly. While every stream has 57 bits below its `pos`, four codes (at
// most 44 bits) of each come from one 8-byte load that starts at bit
// pos - 57 and so ends inside the stream; the streams' codes interleave,
// so their table lookups overlap.
void huffman_streams(const Huffman& h, int k, const uint8_t* const* p, const size_t* n,
                     uint8_t* const* out, const size_t* count) {
  const uint16_t* t = h.t.data();
  const int log = h.log;
  const uint64_t mask = (1u << log) - 1;
  BackwardBits br[4] = {BackwardBits(p[0], n[0]), BackwardBits(p[k - 1], n[k - 1]),
                        BackwardBits(p[k - 1], n[k - 1]), BackwardBits(p[k - 1], n[k - 1])};
  for (int s = 1; s < k; ++s) br[s] = BackwardBits(p[s], n[s]);
  size_t i[4] = {0, 0, 0, 0};
  for (;;) {
    bool room = true;
    for (int s = 0; s < k; ++s) room &= i[s] + 4 <= count[s] && br[s].pos >= 64;
    if (!room) break;
    uint64_t w[4];
    int avail[4];
    for (int s = 0; s < k; ++s) {
      const int64_t start = br[s].pos - 57;
      std::memcpy(&w[s], p[s] + (start >> 3), 8);   // little-endian host
      w[s] >>= start & 7;
      avail[s] = 57;
    }
    for (int j = 0; j < 4; ++j) {
      for (int s = 0; s < k; ++s) {
        const uint16_t e = t[(w[s] >> (avail[s] - log)) & mask];
        out[s][i[s]++] = uint8_t(e & 0xff);
        avail[s] -= e >> 8;
      }
    }
    for (int s = 0; s < k; ++s) br[s].pos -= 57 - avail[s];
  }
  for (int s = 0; s < k; ++s) {
    for (; i[s] < count[s]; ++i[s]) {
      const uint16_t e = t[br[s].peek(log)];
      out[s][i[s]] = uint8_t(e & 0xff);
      br[s].pos -= e >> 8;
    }
    need(br[s].pos == 0, "Huffman stream not consumed exactly");
  }
}

// ---- sequences' code tables (RFC 8878 3.1.1.3.2.1) -------------------------

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,    9,    10,   11,
                              12, 13, 14, 15, 16, 18, 20, 22, 24,   28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,  28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51,  59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

enum Kind { LL = 0, OF = 1, ML = 2 };
const int kMaxSymbol[3] = {35, 31, 52};
const int kMaxLog[3] = {9, 8, 9};

struct Predefined {
  Fse t[3];
  Predefined() {
    build_fse(t[LL], std::vector<int16_t>(kLLNorm, kLLNorm + 36), 6);
    build_fse(t[OF], std::vector<int16_t>(kOFNorm, kOFNorm + 29), 5);
    build_fse(t[ML], std::vector<int16_t>(kMLNorm, kMLNorm + 53), 6);
  }
};

const Fse& predefined(int kind) {
  static const Predefined tables;
  return tables.t[kind];
}

// ---- frames ---------------------------------------------------------------

struct FrameState {
  Huffman huffman;
  Fse tables[3];
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals;
};

struct Cursor {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  uint8_t u8() {
    need(pos < n, "truncated frame");
    return p[pos++];
  }
  uint64_t le(size_t k) {
    need(n - pos >= k, "truncated frame");
    uint64_t v = load_le(p + pos, k);
    pos += k;
    return v;
  }
};

// The literals section of a compressed block; returns the bytes it used.
size_t decode_literals(const uint8_t* p, size_t n, FrameState& st) {
  need(n > 0, "truncated literals section");
  const int type = p[0] & 3, format = (p[0] >> 2) & 3;
  auto& lit = st.literals;
  if (type < 2) {   // raw or RLE
    size_t header, size;
    if ((format & 1) == 0) {
      header = 1;
      size = p[0] >> 3;
    } else if (format == 1) {
      need(n >= 2, "truncated literals header");
      header = 2;
      size = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      need(n >= 3, "truncated literals header");
      header = 3;
      size = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
    need(size <= kBlockMax, "literals larger than a block");
    if (type == 0) {
      need(n - header >= size, "truncated raw literals");
      lit.assign(p + header, p + header + size);
      return header + size;
    }
    need(n > header, "truncated RLE literals");
    lit.assign(size, p[header]);
    return header + 1;
  }
  size_t header, regen, comp;
  bool four = format != 0;
  if (format < 2) {
    need(n >= 3, "truncated literals header");
    header = 3;
    uint64_t h = load_le(p, 3);
    regen = (h >> 4) & 0x3ff;
    comp = (h >> 14) & 0x3ff;
  } else if (format == 2) {
    need(n >= 4, "truncated literals header");
    header = 4;
    uint64_t h = load_le(p, 4);
    regen = (h >> 4) & 0x3fff;
    comp = (h >> 18) & 0x3fff;
  } else {
    need(n >= 5, "truncated literals header");
    header = 5;
    uint64_t h = load_le(p, 5);
    regen = (h >> 4) & 0x3ffff;
    comp = (h >> 22) & 0x3ffff;
  }
  need(regen <= kBlockMax, "literals larger than a block");
  need(n - header >= comp, "truncated compressed literals");
  const uint8_t* q = p + header;
  size_t tree = 0;
  if (type == 2) {
    tree = read_huffman(q, comp, st.huffman);
  } else {
    need(st.huffman.log > 0, "treeless literals without an earlier Huffman table");
  }
  q += tree;
  size_t streams = comp - tree;
  lit.resize(regen);
  if (!four) {
    uint8_t* o = lit.data();
    huffman_streams(st.huffman, 1, &q, &streams, &o, &regen);
  } else {
    need(streams >= 6, "truncated jump table");
    const size_t s1 = load_le(q, 2), s2 = load_le(q + 2, 2), s3 = load_le(q + 4, 2);
    need(streams - 6 >= s1 + s2 + s3, "jump table past the literals");
    const size_t part = (regen + 3) / 4;
    need(regen >= 3 * part, "literals too short for four streams");
    const uint8_t* d = q + 6;
    const uint8_t* ps[4] = {d, d + s1, d + s1 + s2, d + s1 + s2 + s3};
    const size_t ns[4] = {s1, s2, s3, streams - 6 - s1 - s2 - s3};
    uint8_t* os[4] = {lit.data(), lit.data() + part, lit.data() + 2 * part, lit.data() + 3 * part};
    const size_t cs[4] = {part, part, part, regen - 3 * part};
    huffman_streams(st.huffman, 4, ps, ns, os, cs);
  }
  return header + comp;
}

// The sequences section of a compressed block, executed onto `out`;
// `frame_start` is where this frame's output begins.
void decode_sequences(const uint8_t* p, size_t n, FrameState& st, std::vector<uint8_t>& out,
                      size_t frame_start) {
  const auto& lit = st.literals;
  need(n > 0, "truncated sequences section");
  size_t nseq, pos;
  if (p[0] < 128) {
    nseq = p[0];
    pos = 1;
  } else if (p[0] < 255) {
    need(n >= 2, "truncated sequence count");
    nseq = (size_t(p[0] - 128) << 8) + p[1];
    pos = 2;
  } else {
    need(n >= 3, "truncated sequence count");
    nseq = p[1] + (size_t(p[2]) << 8) + 0x7f00;
    pos = 3;
  }
  if (nseq == 0) {
    need(pos == n, "bytes after an empty sequences section");
    out.insert(out.end(), lit.begin(), lit.end());
    return;
  }
  need(pos < n, "truncated sequences section");
  const uint8_t modes = p[pos++];
  need((modes & 3) == 0, "reserved bits of the compression modes set");
  const int mode_of[3] = {modes >> 6, (modes >> 4) & 3, (modes >> 2) & 3};
  const Fse* table[3];
  for (int kind : {LL, OF, ML}) {
    Fse& own = st.tables[kind];
    switch (mode_of[kind]) {
      case 0:
        table[kind] = &predefined(kind);
        own = predefined(kind);   // a later repeat mode repeats it
        break;
      case 1:
        need(pos < n, "truncated RLE table");
        need(p[pos] <= kMaxSymbol[kind], "RLE symbol out of range");
        rle_fse(own, p[pos++]);
        table[kind] = &own;
        break;
      case 2: {
        std::vector<int16_t> norm;
        int log;
        pos += read_ncount(p + pos, n - pos, kMaxSymbol[kind], kMaxLog[kind], norm, log);
        build_fse(own, norm, log);
        table[kind] = &own;
        break;
      }
      default:
        need(own.log >= 0, "repeat mode without an earlier table");
        table[kind] = &own;
    }
  }
  const Fse &tll = *table[LL], &tof = *table[OF], &tml = *table[ML];
  need(pos < n, "sequences without a bit stream");
  BackwardBits br(p + pos, n - pos);
  uint32_t sll = uint32_t(br.read(tll.log));
  uint32_t sof = uint32_t(br.read(tof.log));
  uint32_t sml = uint32_t(br.read(tml.log));
  size_t lit_pos = 0;
  uint64_t* rep = st.rep;
  // The block writes at most kBlockMax bytes (checked per sequence) into
  // room made once; the unused tail is cut at the end.
  const size_t base = out.size();
  out.resize(base + kBlockMax);
  uint8_t* d = out.data();
  size_t at = base;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry &ell = tll.t[sll], &eof = tof.t[sof], &eml = tml.t[sml];
    need(eof.symbol <= 31 && eml.symbol <= 52 && ell.symbol <= 35, "sequence code out of range");
    const uint64_t ov = (1ull << eof.symbol) + br.read(eof.symbol);
    const uint64_t ml = kMLBase[eml.symbol] + br.read(kMLBits[eml.symbol]);
    const uint64_t ll = kLLBase[ell.symbol] + br.read(kLLBits[ell.symbol]);
    uint64_t offset;
    if (ov > 3) {
      offset = ov - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      const uint64_t idx = ov - 1 + (ll == 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll = ell.base + uint32_t(br.read(ell.bits));
      sml = eml.base + uint32_t(br.read(eml.bits));
      sof = eof.base + uint32_t(br.read(eof.bits));
    }
    need(lit.size() - lit_pos >= ll, "sequence past the literals");
    need(ll + ml <= base + kBlockMax - at, "block decodes past the block limit");
    std::memcpy(d + at, lit.data() + lit_pos, ll);
    lit_pos += ll;
    at += ll;
    need(offset > 0 && offset <= at - frame_start, "match offset before the frame's start");
    const uint8_t* from = d + at - offset;
    if (offset >= ml) {
      std::memcpy(d + at, from, ml);
    } else if (offset >= 8) {   // overlapping: 8 bytes at a time stay behind the writes
      for (size_t k = 0; k < ml; k += 8) std::memcpy(d + at + k, from + k, ml - k < 8 ? ml - k : 8);
    } else {
      for (size_t k = 0; k < ml; ++k) d[at + k] = from[k];
    }
    at += ml;
  }
  need(br.pos == 0, "sequence bit stream not consumed exactly");
  need(lit.size() - lit_pos <= base + kBlockMax - at, "block decodes past the block limit");
  std::memcpy(d + at, lit.data() + lit_pos, lit.size() - lit_pos);
  out.resize(at + lit.size() - lit_pos);
}

// One frame from `c` onto `out`; skippable frames are passed over.
void decode_frame(Cursor& c, std::vector<uint8_t>& out) {
  const uint32_t magic = uint32_t(c.le(4));
  if ((magic & 0xfffffff0u) == 0x184d2a50u) {
    const uint64_t size = c.le(4);
    need(c.n - c.pos >= size, "truncated skippable frame");
    c.pos += size;
    return;
  }
  need(magic == 0xfd2fb528u, "not a zstd frame (bad magic)");
  const uint8_t fhd = c.u8();
  need((fhd & 0x08) == 0, "reserved bit of the frame header set");
  const bool single = fhd & 0x20, checksum = fhd & 0x04;
  const int fcs_flag = fhd >> 6, dict_flag = fhd & 3;
  uint64_t window = 0;
  if (!single) {
    const uint8_t wd = c.u8();
    const int exponent = wd >> 3, mantissa = wd & 7;
    need(exponent <= 31, "window too large");
    const uint64_t base = 1ull << (10 + exponent);
    window = base + (base / 8) * mantissa;
  }
  static const int dict_bytes[4] = {0, 1, 2, 4};
  need(c.le(dict_bytes[dict_flag]) == 0, "frame needs a dictionary");
  static const int fcs_bytes[4] = {0, 2, 4, 8};
  const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : fcs_bytes[fcs_flag];
  const bool has_size = fcs_size > 0;
  uint64_t content = c.le(fcs_size);
  if (fcs_size == 2) content += 256;
  if (single) window = content;
  const size_t block_max = window < kBlockMax ? size_t(window) : kBlockMax;

  const size_t frame_start = out.size();
  if (has_size && content < (uint64_t(1) << 34)) out.reserve(frame_start + content);
  FrameState st;
  for (bool last = false; !last;) {
    const uint32_t bh = uint32_t(c.le(3));
    last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    need(type != 3, "reserved block type");
    const size_t before = out.size();
    if (type == 0) {
      need(c.n - c.pos >= size, "truncated raw block");
      out.insert(out.end(), c.p + c.pos, c.p + c.pos + size);
      c.pos += size;
    } else if (type == 1) {
      out.insert(out.end(), size, c.u8());
    } else {
      need(size <= block_max, "compressed block larger than the block limit");
      need(c.n - c.pos >= size, "truncated compressed block");
      const uint8_t* b = c.p + c.pos;
      const size_t used = decode_literals(b, size, st);
      decode_sequences(b + used, size - used, st, out, frame_start);
      c.pos += size;
    }
    need(out.size() - before <= block_max, "block decodes past the block limit");
  }
  const size_t produced = out.size() - frame_start;
  if (has_size) need(produced == content, "frame content size disagrees with its data");
  if (checksum) {
    const uint32_t want = uint32_t(c.le(4));
    const uint32_t got = uint32_t(xxh64(out.data() + frame_start, produced, 0));
    need(got == want, "content checksum mismatch");
  }
}

void set_error(char* err, size_t cap, const char* what) {
  if (!err || !cap) return;
  std::strncpy(err, what, cap - 1);
  err[cap - 1] = 0;
}

}  // namespace

extern "C" {

// Decodes every frame of src[0:n]. On success returns 0 and sets *out to a
// buffer of *out_len bytes (free it with zstd_free); on failure returns -1
// and writes the reason into err.
int zstd_decode(const uint8_t* src, size_t n, uint8_t** out, size_t* out_len, char* err,
                size_t err_cap) {
  *out = nullptr;
  *out_len = 0;
  try {
    need(n > 0, "empty input");
    std::vector<uint8_t> buf;
    Cursor c{src, n};
    while (c.pos < c.n) decode_frame(c, buf);
    uint8_t* mem = static_cast<uint8_t*>(std::malloc(buf.size() ? buf.size() : 1));
    need(mem != nullptr, "out of memory");
    if (!buf.empty()) std::memcpy(mem, buf.data(), buf.size());
    *out = mem;
    *out_len = buf.size();
    return 0;
  } catch (const std::exception& e) {
    set_error(err, err_cap, e.what());
    return -1;
  }
}

void zstd_free(uint8_t* p) { std::free(p); }

uint32_t zstd_crc32c(const uint8_t* p, size_t n) { return crc32c(p, n); }

}  // extern "C"
