// RecordIO codec: mmap'd indexed reader + append writer.
//
// Framing per dmlc-core recordio (SURVEY.md §2.11, reference
// docs/architecture/note_data_loading.md): each part is
//   uint32 magic 0xced7230a
//   uint32 lrec   — upper 3 bits cflag (0 whole, 1 begin, 2 middle, 3 end),
//                   lower 29 bits payload length
//   payload, zero-padded to 4-byte alignment
// A logical record is one cflag=0 part or a 1,2*,3 chain.
#include "mxnative.h"

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

struct Part {
  int64_t payload_off;
  int64_t payload_len;
};

struct Record {
  int64_t file_off;    // offset of the first part's magic (index sidecar key)
  int32_t first_part;  // into parts vector
  int32_t n_parts;
  int64_t total_len;
};

struct Reader {
  int fd = -1;
  const uint8_t* base = nullptr;
  int64_t size = 0;
  std::vector<Part> parts;
  std::vector<Record> records;
};

// Multi-part assembly buffer. Thread-local (not per-handle) because the
// pipeline's worker threads call mxrio_get concurrently on one shared
// Reader; the returned pointer stays valid until the same thread's next
// mxrio_get.
thread_local std::vector<uint8_t> tls_scratch;

struct Writer {
  FILE* f = nullptr;
  int64_t pos = 0;
};

bool IndexFile(Reader* r) {
  int64_t off = 0;
  int32_t open_first = -1;  // first part index of an in-progress chain
  int64_t open_off = 0, open_len = 0;
  while (off + 8 <= r->size) {
    uint32_t magic, lrec;
    std::memcpy(&magic, r->base + off, 4);
    std::memcpy(&lrec, r->base + off + 4, 4);
    if (magic != kMagic) return false;
    uint32_t cflag = lrec >> 29;
    int64_t len = lrec & ((1u << 29) - 1);
    if (off + 8 + len > r->size) return false;
    r->parts.push_back({off + 8, len});
    int32_t pi = static_cast<int32_t>(r->parts.size()) - 1;
    if (cflag == 0) {
      r->records.push_back({off, pi, 1, len});
    } else if (cflag == 1) {
      open_first = pi;
      open_off = off;
      open_len = len;
    } else {  // 2 middle, 3 end
      if (open_first < 0) return false;
      open_len += len;
      if (cflag == 3) {
        r->records.push_back(
            {open_off, open_first, pi - open_first + 1, open_len});
        open_first = -1;
      }
    }
    off += 8 + len + ((-len) & 3);
  }
  return open_first < 0;
}

}  // namespace

extern "C" {

void* mxrio_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  Reader* r = new Reader();
  r->fd = fd;
  r->size = st.st_size;
  if (r->size > 0) {
    void* m = mmap(nullptr, r->size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) {
      ::close(fd);
      delete r;
      return nullptr;
    }
    r->base = static_cast<const uint8_t*>(m);
  }
  if (!IndexFile(r)) {
    mxrio_close(r);
    return nullptr;
  }
  return r;
}

int64_t mxrio_count(void* handle) {
  return static_cast<Reader*>(handle)->records.size();
}

int64_t mxrio_offset(void* handle, int64_t i) {
  Reader* r = static_cast<Reader*>(handle);
  if (i < 0 || i >= static_cast<int64_t>(r->records.size())) return -1;
  return r->records[i].file_off;
}

int64_t mxrio_index_of(void* handle, int64_t off) {
  Reader* r = static_cast<Reader*>(handle);
  int64_t lo = 0, hi = static_cast<int64_t>(r->records.size()) - 1;
  while (lo <= hi) {
    int64_t mid = (lo + hi) / 2;
    int64_t o = r->records[mid].file_off;
    if (o == off) return mid;
    if (o < off) lo = mid + 1; else hi = mid - 1;
  }
  return -1;
}

int64_t mxrio_get(void* handle, int64_t i, const uint8_t** out) {
  Reader* r = static_cast<Reader*>(handle);
  if (i < 0 || i >= static_cast<int64_t>(r->records.size())) return -1;
  const Record& rec = r->records[i];
  if (rec.n_parts == 1) {
    const Part& p = r->parts[rec.first_part];
    *out = r->base + p.payload_off;
    return p.payload_len;
  }
  tls_scratch.resize(rec.total_len);
  int64_t pos = 0;
  for (int32_t k = 0; k < rec.n_parts; ++k) {
    const Part& p = r->parts[rec.first_part + k];
    std::memcpy(tls_scratch.data() + pos, r->base + p.payload_off,
                p.payload_len);
    pos += p.payload_len;
  }
  *out = tls_scratch.data();
  return rec.total_len;
}

void mxrio_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (r->base) munmap(const_cast<uint8_t*>(r->base), r->size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

void* mxrio_writer_open(const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  return w;
}

int64_t mxrio_writer_write(void* handle, const uint8_t* buf, int64_t len) {
  Writer* w = static_cast<Writer*>(handle);
  if (len < 0 || len >= (int64_t{1} << 29)) return -1;  // lrec length field
  int64_t at = w->pos;                                  // holds 29 bits only
  uint32_t hdr[2] = {kMagic,
                     static_cast<uint32_t>(len) & ((1u << 29) - 1)};
  if (std::fwrite(hdr, 4, 2, w->f) != 2) return -1;
  if (len && std::fwrite(buf, 1, len, w->f) != static_cast<size_t>(len))
    return -1;
  static const uint8_t zeros[4] = {0, 0, 0, 0};
  int64_t pad = (-len) & 3;
  if (pad && std::fwrite(zeros, 1, pad, w->f) != static_cast<size_t>(pad))
    return -1;
  w->pos += 8 + len + pad;
  return at;
}

int mxrio_writer_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  int rc = std::fclose(w->f);
  delete w;
  return rc;
}

}  // extern "C"
