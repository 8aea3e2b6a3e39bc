// mxnet_tpu_torch native data path — C ABI.
//
// The host-side counterpart of the reference's C++ data layer
// (dmlc-core RecordIO codec + src/io/iter_image_recordio_2.cc fused
// decode/augment/batch thread pool).  The compute path is PyTorch on the
// card; this library owns the host-side IO hot loop: record container
// codec, JPEG/PNG decode, augmentation, and a threaded prefetch pipeline
// that assembles ready float32 NCHW batches off the Python thread (no GIL).
//
// Exposed over a flat C ABI (ctypes binding in native/__init__.py) the way
// the reference exposes its core over include/mxnet/c_api.h.
#ifndef MXNATIVE_H_
#define MXNATIVE_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// ---------------------------------------------------------------- recordio
// dmlc recordio framing: uint32 magic 0xced7230a, uint32 lrecord
// (upper 3 bits continuation flag, lower 29 length), payload padded to 4.

// Open a record file for reading; mmaps it and indexes logical records.
// Returns NULL on failure.
void* mxrio_open(const char* path);
int64_t mxrio_count(void* handle);
// Byte offset of logical record i (for index sidecars).
int64_t mxrio_offset(void* handle, int64_t i);
// Pointer/length of record i's payload. For single-part records this points
// into the mmap (zero copy); multi-part records are assembled into a
// thread-local scratch buffer (valid until the calling thread's next
// mxrio_get). Safe to call concurrently from multiple threads on one handle.
int64_t mxrio_get(void* handle, int64_t i, const uint8_t** out);
// Logical record index at byte offset `off` (-1 if not a record boundary).
int64_t mxrio_index_of(void* handle, int64_t off);
void mxrio_close(void* handle);

void* mxrio_writer_open(const char* path);
// Returns the byte offset the record was written at, or -1 on error.
int64_t mxrio_writer_write(void* handle, const uint8_t* buf, int64_t len);
int mxrio_writer_close(void* handle);

// ---------------------------------------------------------------- image
// Decode JPEG/PNG (format sniffed from magic bytes) into an RGB/gray HWC
// uint8 buffer allocated by the library.  Returns 0 on success.
// channels: 0 = keep source, 1 = force gray, 3 = force RGB.
int mximg_decode(const uint8_t* buf, int64_t len, int channels,
                 uint8_t** out, int* h, int* w, int* c);
void mximg_free(uint8_t* buf);
// Bilinear resize HWC uint8.
void mximg_resize(const uint8_t* src, int sh, int sw, int c,
                  uint8_t* dst, int dh, int dw);

// ---------------------------------------------------------------- pipeline
// Fused decode → augment → normalize → batch pipeline with worker threads
// and a bounded ready-batch queue (reference: iter_image_recordio_2.cc
// thread pool + iter_prefetcher.h double buffering).
typedef struct {
  int batch_size;
  int target_h, target_w, target_c;  // output CHW shape
  int label_width;
  int resize;          // short-side resize before crop; <=0 disables
  int rand_crop;       // else center crop
  int rand_mirror;
  float mean[3];
  float std_[3];
  float scale;
  uint64_t seed;
  int num_threads;
  int queue_depth;     // max ready batches buffered
  int round_batch;     // pad last batch by repeating the final sample
} MXPipeConfig;

// rec: handle from mxrio_open (borrowed; caller keeps it open).
void* mxpipe_create(void* rec, const MXPipeConfig* cfg);
// Begin an epoch visiting records in `order` (indices into the rec handle).
void mxpipe_start_epoch(void* handle, const int64_t* order, int64_t n);
// Copy the next ready batch into caller buffers.
//   data: batch*c*h*w float32   label: batch*label_width float32
// Returns 0 ok, 1 epoch done, -1 error (message via mxpipe_error).
int mxpipe_next(void* handle, float* data, float* label, int* pad);
const char* mxpipe_error(void* handle);
void mxpipe_close(void* handle);

#ifdef __cplusplus
}
#endif
#endif  // MXNATIVE_H_
