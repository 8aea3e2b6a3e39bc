// Fused decode → augment → normalize → batch pipeline.
//
// The host-side equivalent of the reference's ImageRecordIter v2 internals
// (src/io/iter_image_recordio_2.cc:513-566 thread pool +
// iter_batchloader.h batching + iter_prefetcher.h double buffering):
// worker threads each claim a whole batch of records, decode and augment
// them into a float32 NCHW buffer, and a bounded reorder queue hands
// batches to the consumer in epoch order.  Runs entirely off the Python
// thread — ctypes releases the GIL for the duration of mxpipe_next.
//
// Determinism: every record draws from an RNG seeded by
// (seed, epoch, position-in-epoch), so augmentation is reproducible
// regardless of thread scheduling — stronger than the reference, whose
// per-worker RNG makes runs schedule-dependent.
#include "mxnative.h"

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct IRHeader {
  uint32_t flag;
  float label;
  uint64_t id, id2;
};

struct Batch {
  std::vector<float> data;
  std::vector<float> label;
  int pad = 0;
};

struct Pipe {
  void* rec;  // borrowed mxrio reader
  MXPipeConfig cfg;
  std::vector<int64_t> order;
  int64_t n_batches = 0;
  uint64_t epoch = 0;

  std::vector<std::thread> workers;
  std::atomic<int64_t> next_claim{0};
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<int64_t, Batch> ready;  // batch seq -> ready batch
  int64_t next_deliver = 0;
  bool stop = false;
  uint64_t generation = 0;  // bumped per epoch so stale workers park
  std::string error;

  ~Pipe() {
    {
      std::lock_guard<std::mutex> l(mu);
      stop = true;
    }
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) t.join();
  }
};

// Parse the IRHeader + label(s) from a packed record; returns payload ptr.
const uint8_t* ParseHeader(const uint8_t* buf, int64_t len, int label_width,
                           float* label_out, int64_t* payload_len) {
  IRHeader h;
  std::memcpy(&h.flag, buf, 4);
  std::memcpy(&h.label, buf + 4, 4);
  std::memcpy(&h.id, buf + 8, 8);
  std::memcpy(&h.id2, buf + 16, 8);
  const uint8_t* p = buf + 24;
  int64_t rest = len - 24;
  if (h.flag > 0) {  // multi-label: flag = count of float32 labels
    int64_t nl = h.flag;
    if (24 + 4 * nl > len) {  // corrupted/truncated record: labels would
      *payload_len = -1;      // run past the mmap; fail the record
      return nullptr;
    }
    for (int i = 0; i < label_width; ++i) {
      float v = 0.f;
      if (i < nl) std::memcpy(&v, p + 4 * i, 4);
      label_out[i] = v;
    }
    p += 4 * nl;
    rest -= 4 * nl;
  } else {
    label_out[0] = h.label;
    for (int i = 1; i < label_width; ++i) label_out[i] = 0.f;
  }
  *payload_len = rest;
  return p;
}

// Decode + augment one record into dst (CHW float32).
bool ProcessOne(Pipe* pp, int64_t rec_idx, uint64_t rng_seed, float* dst,
                float* label_out) {
  const MXPipeConfig& c = pp->cfg;
  const uint8_t* buf;
  int64_t len = mxrio_get(pp->rec, rec_idx, &buf);
  if (len < 24) return false;
  int64_t payload_len;
  const uint8_t* payload =
      ParseHeader(buf, len, c.label_width, label_out, &payload_len);
  if (payload == nullptr || payload_len <= 0) return false;

  uint8_t* img;
  int h, w, ch;
  if (mximg_decode(payload, payload_len, c.target_c == 1 ? 1 : 3, &img, &h,
                   &w, &ch) != 0)
    return false;

  std::mt19937_64 rng(rng_seed);
  std::vector<uint8_t> owned;
  // short-side resize
  if (c.resize > 0) {
    int nh, nw;
    if (h < w) { nh = c.resize; nw = (int)((int64_t)w * c.resize / h); }
    else       { nw = c.resize; nh = (int)((int64_t)h * c.resize / w); }
    owned.resize((size_t)nh * nw * ch);
    mximg_resize(img, h, w, ch, owned.data(), nh, nw);
    mximg_free(img);
    img = nullptr;
    h = nh; w = nw;
  }
  const uint8_t* cur = owned.empty() ? img : owned.data();
  // upscale if smaller than the crop window
  if (h < c.target_h || w < c.target_w) {
    int nh = h > c.target_h ? h : c.target_h;
    int nw = w > c.target_w ? w : c.target_w;
    std::vector<uint8_t> up((size_t)nh * nw * ch);
    mximg_resize(cur, h, w, ch, up.data(), nh, nw);
    owned.swap(up);
    if (img) { mximg_free(img); img = nullptr; }
    cur = owned.data();
    h = nh; w = nw;
  }
  // crop
  int y0, x0;
  if (c.rand_crop) {
    y0 = (int)(rng() % (uint64_t)(h - c.target_h + 1));
    x0 = (int)(rng() % (uint64_t)(w - c.target_w + 1));
  } else {
    y0 = (h - c.target_h) / 2;
    x0 = (w - c.target_w) / 2;
  }
  bool mirror = c.rand_mirror && (rng() & 1);

  // normalize + HWC->CHW in one pass
  const int TH = c.target_h, TW = c.target_w, TC = c.target_c;
  for (int k = 0; k < TC; ++k) {
    float mean = c.mean[k < 3 ? k : 2], stdv = c.std_[k < 3 ? k : 2];
    float inv = c.scale / (stdv == 0.f ? 1.f : stdv);
    float* out_plane = dst + (size_t)k * TH * TW;
    for (int y = 0; y < TH; ++y) {
      const uint8_t* row = cur + ((size_t)(y0 + y) * w + x0) * ch + k;
      float* orow = out_plane + (size_t)y * TW;
      if (mirror) {
        for (int x = 0; x < TW; ++x)
          orow[x] = (row[(size_t)(TW - 1 - x) * ch] - mean) * inv;
      } else {
        for (int x = 0; x < TW; ++x) orow[x] = (row[(size_t)x * ch] - mean) * inv;
      }
    }
  }
  if (img) mximg_free(img);
  return true;
}

void WorkerLoop(Pipe* pp, uint64_t gen) {
  const MXPipeConfig& c = pp->cfg;
  const size_t img_sz = (size_t)c.target_c * c.target_h * c.target_w;
  for (;;) {
    {
      std::unique_lock<std::mutex> l(pp->mu);
      if (pp->stop || gen != pp->generation) return;
    }
    int64_t b = pp->next_claim.fetch_add(1);
    if (b >= pp->n_batches) return;
    Batch out;
    out.data.resize(img_sz * c.batch_size);
    out.label.resize((size_t)c.label_width * c.batch_size);
    int64_t start = b * c.batch_size;
    int64_t n = pp->order.size() - start;
    if (n > c.batch_size) n = c.batch_size;
    bool ok = true;
    for (int64_t i = 0; i < n && ok; ++i) {
      uint64_t seed = c.seed * 0x9E3779B97F4A7C15ull +
                      pp->epoch * 0x2545F4914F6CDD1Dull + (start + i);
      ok = ProcessOne(pp, pp->order[start + i], seed,
                      out.data.data() + img_sz * i,
                      out.label.data() + (size_t)c.label_width * i);
    }
    for (int64_t i = n; i < c.batch_size; ++i) {  // pad: repeat last sample
      std::memcpy(out.data.data() + img_sz * i,
                  out.data.data() + img_sz * (n - 1), img_sz * sizeof(float));
      std::memcpy(out.label.data() + (size_t)c.label_width * i,
                  out.label.data() + (size_t)c.label_width * (n - 1),
                  (size_t)c.label_width * sizeof(float));
    }
    out.pad = (int)(c.batch_size - n);
    std::unique_lock<std::mutex> l(pp->mu);
    if (!ok) {
      // first error wins: once non-empty the string is never reassigned,
      // so the c_str mxpipe_error hands to Python stays valid
      if (pp->error.empty())
        pp->error = "record decode failed in batch " + std::to_string(b);
      pp->cv_ready.notify_all();
      return;
    }
    pp->cv_space.wait(l, [&] {
      return pp->stop || gen != pp->generation ||
             (int)pp->ready.size() < c.queue_depth ||
             b == pp->next_deliver;  // never block the batch being waited on
    });
    if (pp->stop || gen != pp->generation) return;
    pp->ready.emplace(b, std::move(out));
    pp->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* mxpipe_create(void* rec, const MXPipeConfig* cfg) {
  if (!rec || !cfg || cfg->batch_size <= 0) return nullptr;
  Pipe* pp = new Pipe();
  pp->rec = rec;
  pp->cfg = *cfg;
  if (pp->cfg.num_threads <= 0) pp->cfg.num_threads = 1;
  if (pp->cfg.queue_depth <= 0) pp->cfg.queue_depth = 2;
  return pp;
}

void mxpipe_start_epoch(void* handle, const int64_t* order, int64_t n) {
  Pipe* pp = static_cast<Pipe*>(handle);
  {
    std::lock_guard<std::mutex> l(pp->mu);
    pp->generation++;
    pp->ready.clear();
    pp->next_deliver = 0;
    pp->error.clear();
  }
  pp->cv_space.notify_all();
  pp->cv_ready.notify_all();
  for (auto& t : pp->workers) t.join();
  pp->workers.clear();

  pp->order.assign(order, order + n);
  if (!pp->cfg.round_batch) {
    n = (n / pp->cfg.batch_size) * pp->cfg.batch_size;
    pp->order.resize(n);
  }
  pp->n_batches = (n + pp->cfg.batch_size - 1) / pp->cfg.batch_size;
  pp->next_claim.store(0);
  pp->epoch++;
  uint64_t gen = pp->generation;
  int nt = pp->cfg.num_threads;
  if (nt > pp->n_batches && pp->n_batches > 0) nt = (int)pp->n_batches;
  for (int i = 0; i < nt; ++i)
    pp->workers.emplace_back(WorkerLoop, pp, gen);
}

int mxpipe_next(void* handle, float* data, float* label, int* pad) {
  Pipe* pp = static_cast<Pipe*>(handle);
  std::unique_lock<std::mutex> l(pp->mu);
  if (pp->next_deliver >= pp->n_batches) return 1;
  pp->cv_ready.wait(l, [&] {
    return pp->stop || !pp->error.empty() ||
           pp->ready.count(pp->next_deliver) > 0;
  });
  if (pp->stop || !pp->error.empty()) return -1;
  auto it = pp->ready.find(pp->next_deliver);
  Batch b = std::move(it->second);
  pp->ready.erase(it);
  pp->next_deliver++;
  l.unlock();
  pp->cv_space.notify_all();
  std::memcpy(data, b.data.data(), b.data.size() * sizeof(float));
  std::memcpy(label, b.label.data(), b.label.size() * sizeof(float));
  *pad = b.pad;
  return 0;
}

const char* mxpipe_error(void* handle) {
  return static_cast<Pipe*>(handle)->error.c_str();
}

void mxpipe_close(void* handle) { delete static_cast<Pipe*>(handle); }

}  // extern "C"
