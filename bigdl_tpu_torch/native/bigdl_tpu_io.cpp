// bigdl_tpu_torch native host-side IO/vision library: the port's own copy
// of the JAX package's native/bigdl_tpu_io.cpp, the same C ABI and the
// same arithmetic, so the two packages decode and augment to the same bits.
//
// What runs here is HOST work that has to keep up with the card's input
// rate: the fused resize/crop/flip/normalize of image batches, JPEG
// decode, multi-threaded batch assembly and the mmap'ed record reader.
// Beyond the JAX package's ABI: btio_jpeg_encode, which makes JPEG test
// inputs on hosts without an imaging library.
// Exposed as a plain C ABI consumed via ctypes.
//
// Build (bigdl_tpu_torch/native/lib.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -march=native -o lib.so bigdl_tpu_io.cpp -lpthread -ljpeg
// or without libjpeg: add -DBTIO_NO_JPEG and drop -ljpeg.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

// JPEG decode (the OpenCV-JNI imdecode analog).  Built with -ljpeg when
// libjpeg is present; -DBTIO_NO_JPEG compiles the stubs so every other op
// still loads on boxes without the library (python falls back to PIL).
#ifndef BTIO_NO_JPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Single-image ops (uint8 HWC in, uint8/float32 HWC out)
// ---------------------------------------------------------------------------

// Bilinear resize, uint8 HWC -> uint8 HWC.
void btio_resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                             uint8_t* dst, int dh, int dw) {
  const float ry = dh > 1 ? (float)(sh - 1) / (dh - 1) : 0.f;
  const float rx = dw > 1 ? (float)(sw - 1) / (dw - 1) : 0.f;
  for (int y = 0; y < dh; ++y) {
    const float fy = y * ry;
    const int y0 = (int)fy;
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      const float fx = x * rx;
      const int x0 = (int)fx;
      const int x1 = std::min(x0 + 1, sw - 1);
      const float wx = fx - x0;
      const uint8_t* p00 = src + (y0 * sw + x0) * c;
      const uint8_t* p01 = src + (y0 * sw + x1) * c;
      const uint8_t* p10 = src + (y1 * sw + x0) * c;
      const uint8_t* p11 = src + (y1 * sw + x1) * c;
      uint8_t* q = dst + (y * dw + x) * c;
      for (int k = 0; k < c; ++k) {
        const float top = p00[k] + (p01[k] - p00[k]) * wx;
        const float bot = p10[k] + (p11[k] - p10[k]) * wx;
        q[k] = (uint8_t)std::lround(top + (bot - top) * wy);
      }
    }
  }
}

// Crop a (ch x cw) window at (oy, ox), uint8 HWC.
void btio_crop_u8(const uint8_t* src, int sh, int sw, int c, int oy, int ox,
                  uint8_t* dst, int ch_, int cw) {
  (void)sh;
  for (int y = 0; y < ch_; ++y) {
    std::memcpy(dst + y * cw * c, src + ((oy + y) * sw + ox) * c,
                (size_t)cw * c);
  }
}

// Horizontal flip in place, uint8 HWC.
void btio_hflip_u8(uint8_t* img, int h, int w, int c) {
  std::vector<uint8_t> tmp(c);
  for (int y = 0; y < h; ++y) {
    uint8_t* row = img + (size_t)y * w * c;
    for (int x = 0; x < w / 2; ++x) {
      uint8_t* a = row + (size_t)x * c;
      uint8_t* b = row + (size_t)(w - 1 - x) * c;
      std::memcpy(tmp.data(), a, c);
      std::memcpy(a, b, c);
      std::memcpy(b, tmp.data(), c);
    }
  }
}

// uint8 HWC -> float32 HWC with per-channel (x/255 - mean) / std.
void btio_normalize_f32(const uint8_t* src, int h, int w, int c,
                        const float* mean, const float* stdv, float* dst) {
  std::vector<float> scale(c), shift(c);
  for (int k = 0; k < c; ++k) {
    const float inv = 1.f / stdv[k];
    scale[k] = inv / 255.f;
    shift[k] = -mean[k] * inv;
  }
  const size_t n = (size_t)h * w;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* p = src + i * c;
    float* q = dst + i * c;
    for (int k = 0; k < c; ++k) q[k] = p[k] * scale[k] + shift[k];
  }
}

// ---------------------------------------------------------------------------
// Threaded batch pipeline: N worker threads run resize+crop+flip+normalize
// per image straight into its slot of a contiguous NHWC float32 batch.
// (Reference analog: Engine.ThreadPool invokeAndWait over per-core
// transformer chains in SampleToMiniBatch.)
// ---------------------------------------------------------------------------

struct Pipeline {
  std::vector<std::thread> workers;
  std::queue<std::function<void()>> jobs;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable done_cv;
  int outstanding = 0;
  bool stop = false;

  explicit Pipeline(int n) {
    for (int i = 0; i < n; ++i) {
      workers.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv.wait(lk, [this] { return stop || !jobs.empty(); });
            if (stop && jobs.empty()) return;
            job = std::move(jobs.front());
            jobs.pop();
          }
          job();
          {
            std::lock_guard<std::mutex> lk(mu);
            if (--outstanding == 0) done_cv.notify_all();
          }
        }
      });
    }
  }
  ~Pipeline() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : workers) t.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu);
      jobs.push(std::move(f));
      ++outstanding;
    }
    cv.notify_one();
  }
  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    done_cv.wait(lk, [this] { return outstanding == 0; });
  }
};

void* btio_pipeline_create(int num_threads) {
  return new Pipeline(std::max(1, num_threads));
}

void btio_pipeline_destroy(void* p) { delete (Pipeline*)p; }

// One image job: src uint8 HWC (sh, sw, c) -> batch slot i of a float32
// NHWC batch (n, oh, ow, c):  resize to (rh, rw) -> crop (oh, ow) at
// (cy, cx) -> optional hflip -> normalize.
// ---------------------------------------------------------------------------
// JPEG decode
// ---------------------------------------------------------------------------

#ifndef BTIO_NO_JPEG
struct BtioJpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void btio_jpeg_fail(j_common_ptr cinfo) {
  longjmp(((BtioJpegErr*)cinfo->err)->jb, 1);
}

// Peek the dimensions of an encoded JPEG; returns 0 on success.
int btio_jpeg_dims(const uint8_t* data, int64_t len, int* h, int* w,
                   int* c) {
  jpeg_decompress_struct cinfo;
  BtioJpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = btio_jpeg_fail;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = (int)cinfo.image_height;
  *w = (int)cinfo.image_width;
  *c = 3;  // decode always lands in RGB
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode into caller-allocated (h, w, 3) RGB uint8; returns 0 on success.
int btio_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* dst,
                     int h, int w) {
  jpeg_decompress_struct cinfo;
  BtioJpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = btio_jpeg_fail;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // grayscale/CMYK sources land as RGB
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_height != h || (int)cinfo.output_width != w ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = dst + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Encode (h, w, 3) RGB uint8 at `quality` into dst (capacity cap bytes);
// returns the bytes written, -1 on a libjpeg error, -2 when cap is short.
int64_t btio_jpeg_encode(const uint8_t* src, int h, int w, int quality,
                         uint8_t* dst, int64_t cap) {
  jpeg_compress_struct cinfo;
  BtioJpegErr err;
  unsigned char* buf = nullptr;
  unsigned long size = 0;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = btio_jpeg_fail;
  if (setjmp(err.jb)) {
    jpeg_destroy_compress(&cinfo);
    free(buf);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &size);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = (JSAMPROW)(src + (size_t)cinfo.next_scanline * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  int64_t n = (int64_t)size;
  if (n > cap) {
    free(buf);
    return -2;
  }
  std::memcpy(dst, buf, (size_t)n);
  free(buf);
  return n;
}

int btio_jpeg_available() { return 1; }
#else
int btio_jpeg_dims(const uint8_t*, int64_t, int*, int*, int*) { return -1; }
int btio_jpeg_decode(const uint8_t*, int64_t, uint8_t*, int, int) {
  return -1;
}
int64_t btio_jpeg_encode(const uint8_t*, int, int, int, uint8_t*, int64_t) {
  return -1;
}
int btio_jpeg_available() { return 0; }
#endif

struct ImageJob {
  const uint8_t* src;
  int sh, sw, c;
  int rh, rw;       // resize target (0 = skip resize)
  int cy, cx;       // crop offset
  int flip;         // 0/1
  const float* mean;
  const float* stdv;
  float* dst;       // slot pointer (oh*ow*c floats)
  int oh, ow;
};

// The fused pixel loop, parameterized on channel count so the c==3 hot
// case (every vision path) compiles with the inner loop unrolled; the
// always_inline + literal-3 call below makes gcc clone and constant-fold
// it rather than branch on c per channel.  (extern "C++": templates cannot
// take the file's C linkage.)
extern "C++" {
template <int C>
__attribute__((always_inline)) static inline void fused_rows(
    const ImageJob& j, float ry, const float* scale, const float* shift,
    const int32_t* xo0, const int32_t* xo1, const float* xw, int c) {
  for (int y = 0; y < j.oh; ++y) {
    const float fy = (j.cy + y) * ry;
    const int y0 = (int)fy;
    const int y1 = std::min(y0 + 1, j.sh - 1);
    const float wy = fy - y0;
    const uint8_t* row0 = j.src + (size_t)y0 * j.sw * c;
    const uint8_t* row1 = j.src + (size_t)y1 * j.sw * c;
    float* q = j.dst + (size_t)y * j.ow * c;
    for (int x = 0; x < j.ow; ++x) {
      const float wx = xw[x];
      const uint8_t* p00 = row0 + xo0[x];
      const uint8_t* p01 = row0 + xo1[x];
      const uint8_t* p10 = row1 + xo0[x];
      const uint8_t* p11 = row1 + xo1[x];
      float* o = q + (size_t)x * c;
      const int kc = C > 0 ? C : c;
      for (int k = 0; k < kc; ++k) {
        const float top = p00[k] + (p01[k] - p00[k]) * wx;
        const float bot = p10[k] + (p11[k] - p10[k]) * wx;
        const uint8_t v = (uint8_t)std::lround(top + (bot - top) * wy);
        o[k] = v * scale[k] + shift[k];
      }
    }
  }
}

static void fused_pass(const ImageJob& j, float ry, const float* scale,
                       const float* shift, const int32_t* xo0,
                       const int32_t* xo1, const float* xw) {
  if (j.c == 3) {
    fused_rows<3>(j, ry, scale, shift, xo0, xo1, xw, 3);
  } else {
    fused_rows<0>(j, ry, scale, shift, xo0, xo1, xw, j.c);
  }
}
}  // extern "C++"

// Fused single pass: for each OUTPUT pixel, bilinear-sample the source at
// the position the staged resize->crop->flip chain would have read, round
// through uint8 (so results stay byte-identical to the staged ops the
// fallbacks and parity tests compute), and write the normalized float32
// straight into the batch slot.  Versus the staged path this computes only
// the crop window's share of the resize (a 224-crop of a 256-resize skips
// 23% of the samples), elides the crop memcpy, the flip copy+swap, and the
// separate normalize read/write, and allocates no intermediate buffers —
// the per-image cost that made decode+augment the pipeline's slow stage.
static void run_image_job(const ImageJob j) {
  const int rh = (j.rh > 0) ? j.rh : j.sh;  // dims entering the crop stage
  const int rw = (j.rh > 0) ? j.rw : j.sw;
  const float ry = rh > 1 ? (float)(j.sh - 1) / (rh - 1) : 0.f;
  const float rx = rw > 1 ? (float)(j.sw - 1) / (rw - 1) : 0.f;
  std::vector<float> scale(j.c), shift(j.c);
  for (int k = 0; k < j.c; ++k) {
    const float inv = 1.f / j.stdv[k];
    scale[k] = inv / 255.f;
    shift[k] = -j.mean[k] * inv;
  }
  // per-column sample table (source offsets + weight), computed once per
  // image instead of once per pixel; flip runs AFTER crop in the staged
  // chain, so output column x reads resized column cx + (ow-1-x)
  std::vector<int32_t> xo0(j.ow), xo1(j.ow);
  std::vector<float> xw(j.ow);
  for (int x = 0; x < j.ow; ++x) {
    const int sx = j.cx + (j.flip ? (j.ow - 1 - x) : x);
    const float fx = sx * rx;
    const int x0 = (int)fx;
    xo0[x] = x0 * j.c;
    xo1[x] = std::min(x0 + 1, j.sw - 1) * j.c;
    xw[x] = fx - x0;
  }
  fused_pass(j, ry, scale.data(), shift.data(), xo0.data(), xo1.data(),
             xw.data());
}

// Submit a whole batch of image jobs described by parallel arrays, then wait.
// srcs: n pointers; dims: n*(sh,sw); geom: n*(rh,rw,cy,cx,flip);
// dst: contiguous (n, oh, ow, c) float32.
void btio_process_batch(void* pipe, int n, const uint8_t** srcs,
                        const int* dims, const int* geom, int c, int oh,
                        int ow, const float* mean, const float* stdv,
                        float* dst) {
  Pipeline* p = (Pipeline*)pipe;
  const size_t slot = (size_t)oh * ow * c;
  for (int i = 0; i < n; ++i) {
    ImageJob j;
    j.src = srcs[i];
    j.sh = dims[2 * i];
    j.sw = dims[2 * i + 1];
    j.c = c;
    j.rh = geom[5 * i];
    j.rw = geom[5 * i + 1];
    j.cy = geom[5 * i + 2];
    j.cx = geom[5 * i + 3];
    j.flip = geom[5 * i + 4];
    j.mean = mean;
    j.stdv = stdv;
    j.dst = dst + slot * i;
    j.oh = oh;
    j.ow = ow;
    p->submit([j] { run_image_job(j); });
  }
  p->wait();
}

// Decode+transform batch: srcs are ENCODED JPEG buffers (lens[i] bytes
// each); each worker decodes to RGB then runs the same resize/crop/flip/
// normalize job.  geom as in btio_process_batch.  Per-image status lands
// in status[i] (0 ok, -1 decode failure; that slot's dst is untouched).
void btio_decode_batch(void* pipe, int n, const uint8_t** srcs,
                       const int64_t* lens, const int* geom, int oh, int ow,
                       const float* mean, const float* stdv, float* dst,
                       int* status) {
  Pipeline* p = (Pipeline*)pipe;
  const size_t slot = (size_t)oh * ow * 3;
  for (int i = 0; i < n; ++i) {
    const uint8_t* src = srcs[i];
    int64_t len = lens[i];
    const int* g = geom + 5 * i;
    float* out = dst + slot * i;
    int* st = status + i;
    p->submit([src, len, g, oh, ow, mean, stdv, out, st] {
      int h, w, c;
      if (btio_jpeg_dims(src, len, &h, &w, &c) != 0) {
        *st = -1;
        return;
      }
      std::vector<uint8_t> pix((size_t)h * w * 3);
      if (btio_jpeg_decode(src, len, pix.data(), h, w) != 0) {
        *st = -1;
        return;
      }
      // bounds-check the crop against the post-resize dims — the caller
      // could not know them before decode, and run_image_job's crop
      // would read out of bounds on a violation
      const int eh = g[0] > 0 ? g[0] : h;
      const int ew = g[0] > 0 ? g[1] : w;
      if (g[2] < 0 || g[3] < 0 || g[2] + oh > eh || g[3] + ow > ew) {
        *st = -2;
        return;
      }
      ImageJob j;
      j.src = pix.data();
      j.sh = h;
      j.sw = w;
      j.c = 3;
      j.rh = g[0];
      j.rw = g[1];
      j.cy = g[2];
      j.cx = g[3];
      j.flip = g[4];
      j.mean = mean;
      j.stdv = stdv;
      j.dst = out;
      j.oh = oh;
      j.ow = ow;
      run_image_job(j);
      *st = 0;
    });
  }
  p->wait();
}

// ---------------------------------------------------------------------------
// Gather-assemble: copy rows[idx] of a (num, row_elems) float32 array into a
// contiguous batch — the SampleToMiniBatch copy, parallelized.
// ---------------------------------------------------------------------------
void btio_gather_rows_f32(void* pipe, const float* src, const int64_t* idx,
                          int n, int64_t row_elems, float* dst) {
  Pipeline* p = (Pipeline*)pipe;
  const int chunk = std::max(1, n / (int)(((Pipeline*)pipe)->workers.size() * 4));
  for (int s = 0; s < n; s += chunk) {
    const int e = std::min(n, s + chunk);
    p->submit([=] {
      for (int i = s; i < e; ++i) {
        std::memcpy(dst + (size_t)i * row_elems,
                    src + (size_t)idx[i] * row_elems,
                    sizeof(float) * row_elems);
      }
    });
  }
  p->wait();
}

// ---------------------------------------------------------------------------
// Record file reader: fixed-size records, memory-mapped — the native
// data-loader executor (the RDD-partition file-read analog).  Layout:
//   bytes 0..7   magic "BTRECv1\0"
//   bytes 8..15  uint64 record_bytes
//   bytes 16..23 uint64 n_records
//   bytes 24..   records, contiguous
// ---------------------------------------------------------------------------

struct RecordFile {
  int fd = -1;
  uint8_t* map = nullptr;
  size_t map_len = 0;
  uint64_t record_bytes = 0;
  uint64_t n_records = 0;
};

void* btio_records_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < 24) {
    ::close(fd);
    return nullptr;
  }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (m == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  uint8_t* b = (uint8_t*)m;
  if (std::memcmp(b, "BTRECv1\0", 8) != 0) {
    munmap(m, st.st_size);
    ::close(fd);
    return nullptr;
  }
  RecordFile* rf = new RecordFile();
  rf->fd = fd;
  rf->map = b;
  rf->map_len = st.st_size;
  std::memcpy(&rf->record_bytes, b + 8, 8);
  std::memcpy(&rf->n_records, b + 16, 8);
  // Overflow-safe bounds check: record_bytes * n_records can wrap uint64 for
  // a corrupt/hostile header, so divide instead of multiplying.
  if (rf->record_bytes == 0 ||
      rf->n_records > (rf->map_len - 24) / rf->record_bytes) {
    munmap(m, st.st_size);
    ::close(fd);
    delete rf;
    return nullptr;
  }
  return rf;
}

int64_t btio_records_count(void* h) {
  return h ? (int64_t)((RecordFile*)h)->n_records : -1;
}

int64_t btio_records_bytes(void* h) {
  return h ? (int64_t)((RecordFile*)h)->record_bytes : -1;
}

// Gather records[idx[0..n)] into out (n, record_bytes), fanned out over the
// pipeline's worker threads (memcpy from the mapped region; the page cache
// is the shared buffer pool).
void btio_records_gather(void* h, void* pipe, const int64_t* idx, int n,
                         uint8_t* out) {
  RecordFile* rf = (RecordFile*)h;
  const uint8_t* base = rf->map + 24;
  const size_t rb = rf->record_bytes;
  Pipeline* p = (Pipeline*)pipe;
  if (p == nullptr) {
    for (int i = 0; i < n; ++i)
      std::memcpy(out + (size_t)i * rb, base + (size_t)idx[i] * rb, rb);
    return;
  }
  const int chunk = std::max(1, n / (int)(p->workers.size() * 4));
  for (int s = 0; s < n; s += chunk) {
    const int e = std::min(n, s + chunk);
    p->submit([=] {
      for (int i = s; i < e; ++i)
        std::memcpy(out + (size_t)i * rb, base + (size_t)idx[i] * rb, rb);
    });
  }
  p->wait();
}

void btio_records_close(void* h) {
  RecordFile* rf = (RecordFile*)h;
  if (!rf) return;
  if (rf->map) munmap(rf->map, rf->map_len);
  if (rf->fd >= 0) ::close(rf->fd);
  delete rf;
}

int btio_version() { return 4; }

}  // extern "C"
