// SGR: a minimal mmap'd indexed record-file format — the native storage
// layer replacing the reference's LMDB (C) dependency for packed image /
// caption / superpixel shards (preprocess/GCC3M/generate_lmdb_from_pickles.py
// and the COCO pickle equivalents).
//
// Layout (little-endian):
//   [8]  magic "SGRECv1\0"
//   [8]  u64 record count N
//   [N × 16] (u64 offset, u64 length) — absolute file offsets
//   blobs: each record = [u32 key_len][key bytes][payload bytes]
//
// The reader memory-maps the file; record access is zero-copy pointer
// arithmetic, safe to share across forked workers (read-only map).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'S', 'G', 'R', 'E', 'C', 'v', '1', '\0'};

struct SgrFile {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  uint64_t count = 0;
  const uint64_t* index = nullptr;  // 2*count entries (offset, length)
};

}  // namespace

extern "C" {

void* sgr_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* f = new SgrFile;
  f->fd = fd;
  f->data = static_cast<const uint8_t*>(map);
  f->size = st.st_size;
  if (std::memcmp(f->data, kMagic, 8) != 0) {
    munmap(map, st.st_size);
    ::close(fd);
    delete f;
    return nullptr;
  }
  std::memcpy(&f->count, f->data + 8, 8);
  if (16 + f->count * 16 > f->size) {
    munmap(map, st.st_size);
    ::close(fd);
    delete f;
    return nullptr;
  }
  f->index = reinterpret_cast<const uint64_t*>(f->data + 16);
  return f;
}

uint64_t sgr_count(void* handle) {
  return handle ? static_cast<SgrFile*>(handle)->count : 0;
}

// Returns 0 on success; fills pointers into the mapped region.
int sgr_record(void* handle, uint64_t i, const uint8_t** key,
               uint32_t* key_len, const uint8_t** payload,
               uint64_t* payload_len) {
  auto* f = static_cast<SgrFile*>(handle);
  if (!f || i >= f->count) return -1;
  uint64_t off = f->index[2 * i], len = f->index[2 * i + 1];
  if (off + len > f->size || len < 4) return -1;
  const uint8_t* rec = f->data + off;
  uint32_t kl;
  std::memcpy(&kl, rec, 4);
  if (4 + static_cast<uint64_t>(kl) > len) return -1;
  *key = rec + 4;
  *key_len = kl;
  *payload = rec + 4 + kl;
  *payload_len = len - 4 - kl;
  return 0;
}

void sgr_close(void* handle) {
  auto* f = static_cast<SgrFile*>(handle);
  if (!f) return;
  if (f->data) munmap(const_cast<uint8_t*>(f->data), f->size);
  if (f->fd >= 0) ::close(f->fd);
  delete f;
}

}  // extern "C"
