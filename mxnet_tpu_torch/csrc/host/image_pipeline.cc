// Native image record pipeline of mxnet_tpu_torch's input library.
//
// Reference: src/io/iter_image_recordio_2.cc:28-612 (ImageRecordIOParser2),
// the ImageNet input path: a reader thread walks the .rec file while N
// worker threads decode, resize and lay out each record, and whole batches
// cross to Python without a per-image Python cost.
//
// One reader thread parses the recordio framing ([magic][len][IRHeader]
// [jpeg bytes]) into a bounded work queue; N decode threads each decode a
// JPEG to RGB, resize it bilinearly to the target (H, W), crop and mirror
// it, and emit (label, RGB u8 HWC) into a bounded output queue;
// MXTTImagePipelineNextBatch assembles whole batches for
// mxnet_tpu_torch/io_native.py's ImageRecordIter.  With more than one
// decode thread the order of records is not deterministic.
//
// The decoder is chosen when the library is built:
// * HAVE_JPEG: libjpeg on the host (the reference's decoder);
// * HAVE_NVJPEG: nvJPEG from the CUDA toolkit, for hosts that have no
//   libjpeg headers: each decode thread decodes into device memory on its
//   own non-blocking stream and copies the RGB image back into the buffer
//   libjpeg would have filled; everything after the decode is the same
//   code.  nvJPEG's IDCT and chroma upsampling are not libjpeg's, so its
//   pixels differ from libjpeg's by a few levels;
// * neither: no JPEG decode (MXTTImagePipelineHasJpeg returns 0).
//
// Built at first use by io_native.py (g++ -O2 -std=c++17 -fPIC -pthread,
// plus -DHAVE_JPEG -ljpeg or -DHAVE_NVJPEG -lnvjpeg -lcudart_static).

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include "recordio_format.h"

#if defined(HAVE_JPEG)
#include <jpeglib.h>
#elif defined(HAVE_NVJPEG)
#include <cuda_runtime.h>
#include <nvjpeg.h>
#define HAVE_JPEG_DECODE 1
#endif
#if defined(HAVE_JPEG)
#define HAVE_JPEG_DECODE 1
#endif

namespace {

struct RawRecord {
  float label = 0.0f;
  uint64_t index = 0;            // record ordinal (per-record RNG stream)
  std::vector<uint8_t> payload;  // jpeg bytes
};

// Augmentation knobs (reference DefaultImageAugmentParam,
// src/io/image_aug_default.cc): rand_crop resizes the shorter edge
// ~1.15x above target then takes a random window; rand_mirror flips
// horizontally with p=0.5.  Deterministic per (seed, record index).
struct AugConfig {
  bool rand_crop = false;
  bool rand_mirror = false;
  uint64_t seed = 0;
};

struct Decoded {
  float label = 0.0f;
  std::vector<uint8_t> pixels;   // out_h * out_w * 3, RGB, HWC
};

template <typename T>
class BoundedQueue {
 public:
  explicit BoundedQueue(size_t cap) : cap_(cap) {}

  bool Push(T&& v) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < cap_ || done_; });
    if (done_) return false;
    q_.emplace_back(std::move(v));
    not_empty_.notify_one();
    return true;
  }

  bool Pop(T* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || done_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  // closes the queue for writers but lets readers drain remaining items
  void FinishWriting() {
    std::lock_guard<std::mutex> lk(mu_);
    done_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

 private:
  size_t cap_;
  bool done_ = false;
  std::deque<T> q_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
};

#if defined(HAVE_JPEG)
// libjpeg keeps no state between images: a decode thread's context is empty.
struct DecodeContext {
  bool ok() const { return true; }
};

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void JpegErrorExit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode JPEG bytes to RGB u8 HWC; returns false on corrupt input.
bool DecodeJpeg(DecodeContext*, const uint8_t* data, size_t size,
                std::vector<uint8_t>* out, int* width, int* height) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JpegErrorExit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  out->resize(static_cast<size_t>(*width) * (*height) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() +
                   static_cast<size_t>(cinfo.output_scanline) * (*width) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}
#elif defined(HAVE_NVJPEG)
// One nvJPEG handle for the process, made at first use (null when nvJPEG or
// the device cannot start: the library then reports no JPEG decode).
nvjpegHandle_t NvjpegHandle() {
  static nvjpegHandle_t handle = [] {
    nvjpegHandle_t h = nullptr;
    if (nvjpegCreateSimple(&h) != NVJPEG_STATUS_SUCCESS) h = nullptr;
    return h;
  }();
  return handle;
}

// A decode thread's nvJPEG state, stream and device buffer (nvJPEG states
// are not shared between threads).
struct DecodeContext {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;
  size_t dev_bytes = 0;
  bool ready = false;

  DecodeContext() {
    nvjpegHandle_t h = NvjpegHandle();
    if (h == nullptr) return;
    if (cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) !=
        cudaSuccess) {
      stream = nullptr;
      return;
    }
    if (nvjpegJpegStateCreate(h, &state) != NVJPEG_STATUS_SUCCESS) {
      state = nullptr;
      return;
    }
    ready = true;
  }

  ~DecodeContext() {
    if (dev) cudaFree(dev);
    if (state) nvjpegJpegStateDestroy(state);
    if (stream) cudaStreamDestroy(stream);
  }

  bool ok() const { return ready; }
};

// Decode JPEG bytes to RGB u8 HWC through nvJPEG: interleaved RGB into
// device memory, then copied back; returns false on corrupt input.
bool DecodeJpeg(DecodeContext* ctx, const uint8_t* data, size_t size,
                std::vector<uint8_t>* out, int* width, int* height) {
  nvjpegHandle_t h = NvjpegHandle();
  int ncomp = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(h, data, size, &ncomp, &subsampling, widths,
                         heights) != NVJPEG_STATUS_SUCCESS) {
    return false;
  }
  *width = widths[0];
  *height = heights[0];
  if (*width <= 0 || *height <= 0) return false;
  const size_t bytes = static_cast<size_t>(*width) * (*height) * 3;
  if (bytes > ctx->dev_bytes) {
    if (ctx->dev) cudaFree(ctx->dev);
    ctx->dev = nullptr;
    ctx->dev_bytes = 0;
    if (cudaMalloc(&ctx->dev, bytes) != cudaSuccess) {
      ctx->dev = nullptr;
      return false;
    }
    ctx->dev_bytes = bytes;
  }
  nvjpegImage_t img = {};
  img.channel[0] = ctx->dev;
  img.pitch[0] = static_cast<size_t>(*width) * 3;
  if (nvjpegDecode(h, ctx->state, data, size, NVJPEG_OUTPUT_RGBI, &img,
                   ctx->stream) != NVJPEG_STATUS_SUCCESS) {
    return false;
  }
  out->resize(bytes);
  if (cudaMemcpyAsync(out->data(), ctx->dev, bytes, cudaMemcpyDeviceToHost,
                      ctx->stream) != cudaSuccess) {
    return false;
  }
  return cudaStreamSynchronize(ctx->stream) == cudaSuccess;
}
#endif  // HAVE_JPEG / HAVE_NVJPEG

// Bilinear resize RGB u8 HWC (the role of the reference's cv::resize in
// DefaultImageAugmenter, src/io/image_aug_default.cc).  Fixed-point with
// a precomputed x-axis LUT: the horizontal pass is the hot loop and the
// source geometry repeats across rows.
void ResizeBilinear(const uint8_t* src, int sw, int sh, uint8_t* dst,
                    int dw, int dh) {
  if (sw == dw && sh == dh) {
    std::memcpy(dst, src, static_cast<size_t>(sw) * sh * 3);
    return;
  }
  constexpr int kBits = 11;           // 2^11 weight scale (fits 8b*11b in 32b)
  constexpr int kOne = 1 << kBits;
  const float sx = dw > 1 ? static_cast<float>(sw - 1) / (dw - 1) : 0.0f;
  const float sy = dh > 1 ? static_cast<float>(sh - 1) / (dh - 1) : 0.0f;
  std::vector<int> x0s(dw), x1s(dw), wxs(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = x * sx;
    int x0 = static_cast<int>(fx);
    x0s[x] = x0 * 3;
    x1s[x] = (x0 + 1 < sw ? x0 + 1 : sw - 1) * 3;
    wxs[x] = static_cast<int>((fx - x0) * kOne + 0.5f);
  }
  for (int y = 0; y < dh; ++y) {
    float fy = y * sy;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    int wy = static_cast<int>((fy - y0) * kOne + 0.5f);
    const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      int wx = wxs[x];
      const uint8_t* a0 = r0 + x0s[x];
      const uint8_t* b0 = r0 + x1s[x];
      const uint8_t* a1 = r1 + x0s[x];
      const uint8_t* b1 = r1 + x1s[x];
      for (int c = 0; c < 3; ++c) {
        int top = a0[c] * (kOne - wx) + b0[c] * wx;        // <= 8b+11b
        int bot = a1[c] * (kOne - wx) + b1[c] * wx;
        int v = ((top >> 2) * (kOne - wy) + (bot >> 2) * wy +
                 (1 << (2 * kBits - 3))) >> (2 * kBits - 2);
        out[x * 3 + c] = static_cast<uint8_t>(v > 255 ? 255 : v);
      }
    }
  }
}

class ImagePipeline {
 public:
  ImagePipeline(const char* path, int out_h, int out_w, int n_threads,
                size_t queue_cap, int num_parts, int part_index,
                const AugConfig& aug, size_t shuffle_buffer)
      : out_h_(out_h), out_w_(out_w), num_parts_(num_parts < 1 ? 1
                                                                : num_parts),
        part_index_(part_index), aug_(aug),
        shuffle_buffer_(shuffle_buffer),
        shuffle_rng_(static_cast<unsigned>(aug.seed ^ 0x5bd1e995)),
        work_(queue_cap ? queue_cap : 256),
        done_(queue_cap ? queue_cap : 256) {
    f_ = std::fopen(path, "rb");
    if (!f_) return;
    if (n_threads < 1) n_threads = 1;
    reader_ = std::thread([this] { this->ReadLoop(); });
    decoders_active_ = n_threads;
    for (int i = 0; i < n_threads; ++i) {
      decoders_.emplace_back([this] { this->DecodeLoop(); });
    }
  }

  ~ImagePipeline() {
    stop_ = true;
    work_.FinishWriting();
    done_.FinishWriting();
    if (reader_.joinable()) reader_.join();
    for (auto& t : decoders_) {
      if (t.joinable()) t.join();
    }
    if (f_) std::fclose(f_);
  }

  bool ok() const { return f_ != nullptr; }

  // Fill up to `batch` images; returns the number filled (0 at EOF), or -1
  // when a decode thread could not start its decoder.
  // With shuffle_buffer > 0, emits from a reservoir of decoded images in
  // random order (streaming-shuffle; the reference parser's chunk
  // shuffle plays the same role on top of im2rec-time shuffling).
  int64_t NextBatch(float* labels, uint8_t* data, int64_t batch) {
    const size_t img = static_cast<size_t>(out_h_) * out_w_ * 3;
    int64_t i = 0;
    while (i < batch) {
      Decoded d;
      if (shuffle_buffer_ > 0) {
        // top up the reservoir, then emit a random element
        while (reservoir_.size() < shuffle_buffer_) {
          Decoded x;
          if (!done_.Pop(&x)) break;
          reservoir_.emplace_back(std::move(x));
        }
        if (reservoir_.empty()) break;
        size_t j = std::uniform_int_distribution<size_t>(
            0, reservoir_.size() - 1)(shuffle_rng_);
        d = std::move(reservoir_[j]);
        reservoir_[j] = std::move(reservoir_.back());
        reservoir_.pop_back();
      } else {
        if (!done_.Pop(&d)) break;
      }
      labels[i] = d.label;
      std::memcpy(data + i * img, d.pixels.data(), img);
      ++i;
    }
    if (failed_) return -1;
    return i;
  }

 private:
  void ReadLoop() {
    uint64_t ordinal = 0;
    std::vector<uint8_t> rec;
    while (!stop_) {
      if (!mxtt::ReadRecRecord(f_, &rec)) break;
      uint64_t idx = ordinal++;
      // data-parallel sharding: worker part_index of num_parts
      // (reference ImageRecordIOParser2 kv-sharded read)
      if (static_cast<int>(idx % num_parts_) != part_index_) continue;
      if (rec.size() < 24) continue;  // not an IRHeader record
      // IRHeader: uint32 flag, float label, uint64 id[2]
      // (image_recordio.h:20-35); flag>0 = extra label floats
      uint32_t flag;
      std::memcpy(&flag, rec.data(), 4);
      size_t off = 24 + static_cast<size_t>(flag > 0 ? flag : 0) * 4;
      if (off >= rec.size()) continue;
      RawRecord r;
      r.index = idx;
      if (flag > 0) {
        std::memcpy(&r.label, rec.data() + 24, 4);
      } else {
        std::memcpy(&r.label, rec.data() + 4, 4);
      }
      r.payload.assign(rec.begin() + off, rec.end());
      if (!work_.Push(std::move(r))) break;
    }
    work_.FinishWriting();
  }

  void DecodeLoop() {
    RawRecord r;
#ifdef HAVE_JPEG_DECODE
    DecodeContext ctx;
#endif
    while (work_.Pop(&r)) {
#ifdef HAVE_JPEG_DECODE
      if (!ctx.ok()) {
        failed_ = true;  // the decoder could not start: an error, not EOF
        break;
      }
      std::vector<uint8_t> rgb;
      int w = 0, h = 0;
      if (!DecodeJpeg(&ctx, r.payload.data(), r.payload.size(), &rgb, &w,
                      &h)) {
        continue;  // skip corrupt records like the reference parser
      }
      Decoded d;
      d.label = r.label;
      d.pixels.resize(static_cast<size_t>(out_h_) * out_w_ * 3);
      std::mt19937 rng(static_cast<unsigned>(aug_.seed * 2654435761u +
                                             r.index));
      if (aug_.rand_crop) {
        // resize shorter edge to ~1.15x target, then random window
        // (DefaultImageAugmenter resize+rand_crop recipe)
        int short_t = out_h_ < out_w_ ? out_h_ : out_w_;
        int target = short_t + short_t / 7;
        int rs_w, rs_h;
        if (w < h) {
          rs_w = target;
          rs_h = static_cast<int>(static_cast<int64_t>(h) * target / w);
        } else {
          rs_h = target;
          rs_w = static_cast<int>(static_cast<int64_t>(w) * target / h);
        }
        if (rs_w < out_w_) rs_w = out_w_;
        if (rs_h < out_h_) rs_h = out_h_;
        std::vector<uint8_t> resized(
            static_cast<size_t>(rs_w) * rs_h * 3);
        ResizeBilinear(rgb.data(), w, h, resized.data(), rs_w, rs_h);
        int x0 = std::uniform_int_distribution<int>(0, rs_w - out_w_)(rng);
        int y0 = std::uniform_int_distribution<int>(0, rs_h - out_h_)(rng);
        for (int y = 0; y < out_h_; ++y) {
          std::memcpy(d.pixels.data() + static_cast<size_t>(y) * out_w_ * 3,
                      resized.data() +
                          (static_cast<size_t>(y0 + y) * rs_w + x0) * 3,
                      static_cast<size_t>(out_w_) * 3);
        }
      } else {
        ResizeBilinear(rgb.data(), w, h, d.pixels.data(), out_w_, out_h_);
      }
      if (aug_.rand_mirror &&
          std::uniform_int_distribution<int>(0, 1)(rng)) {
        for (int y = 0; y < out_h_; ++y) {
          uint8_t* row = d.pixels.data() +
                         static_cast<size_t>(y) * out_w_ * 3;
          for (int x = 0; x < out_w_ / 2; ++x) {
            for (int c = 0; c < 3; ++c) {
              std::swap(row[x * 3 + c], row[(out_w_ - 1 - x) * 3 + c]);
            }
          }
        }
      }
      if (!done_.Push(std::move(d))) break;
#else
      (void)r;
      break;
#endif
    }
    if (--decoders_active_ == 0) done_.FinishWriting();
  }

  int out_h_, out_w_;
  int num_parts_ = 1;
  int part_index_ = 0;
  AugConfig aug_;
  size_t shuffle_buffer_ = 0;
  std::vector<Decoded> reservoir_;
  std::mt19937 shuffle_rng_;
  std::FILE* f_ = nullptr;
  std::atomic<bool> stop_{false};
  std::atomic<bool> failed_{false};
  std::atomic<int> decoders_active_{0};
  BoundedQueue<RawRecord> work_;
  BoundedQueue<Decoded> done_;
  std::thread reader_;
  std::vector<std::thread> decoders_;
};

}  // namespace

extern "C" {

int MXTTImagePipelineHasJpeg() {
#if defined(HAVE_JPEG)
  return 1;
#elif defined(HAVE_NVJPEG)
  return NvjpegHandle() != nullptr ? 1 : 0;
#else
  return 0;
#endif
}

// The decoder the library was built with: "libjpeg", "nvjpeg" or "none".
const char* MXTTImagePipelineDecoder() {
#if defined(HAVE_JPEG)
  return "libjpeg";
#elif defined(HAVE_NVJPEG)
  return "nvjpeg";
#else
  return "none";
#endif
}

void* MXTTImagePipelineCreate(const char* path, int64_t out_h, int64_t out_w,
                               int64_t n_threads, int64_t queue_cap,
                               int64_t num_parts, int64_t part_index,
                               int64_t rand_crop, int64_t rand_mirror,
                               int64_t seed, int64_t shuffle_buffer) {
  AugConfig aug;
  aug.rand_crop = rand_crop != 0;
  aug.rand_mirror = rand_mirror != 0;
  aug.seed = static_cast<uint64_t>(seed);
  auto* p = new ImagePipeline(path, static_cast<int>(out_h),
                              static_cast<int>(out_w),
                              static_cast<int>(n_threads),
                              static_cast<size_t>(queue_cap),
                              static_cast<int>(num_parts),
                              static_cast<int>(part_index), aug,
                              static_cast<size_t>(shuffle_buffer));
  if (!p->ok()) {
    delete p;
    return nullptr;
  }
  return p;
}

void MXTTImagePipelineFree(void* handle) {
  delete static_cast<ImagePipeline*>(handle);
}

// labels: (batch,) f32; data: (batch, out_h, out_w, 3) u8.
int64_t MXTTImagePipelineNextBatch(void* handle, float* labels,
                                    uint8_t* data, int64_t batch) {
  return static_cast<ImagePipeline*>(handle)->NextBatch(labels, data, batch);
}

}  // extern "C"
