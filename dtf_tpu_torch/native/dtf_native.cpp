// dtf_native -- the port's C++ data runtime: a copy of the TFRecord
// and JPEG half of dtf_tpu/native/dtf_native.cpp (the parameter
// store, ps_store.cpp, is a library of its own: native/ps.py).
//
// The host half of the reference's tf.data C++ kernels: TFRecord
// record framing + crc32c, JPEG decode (libjpeg) incl. fused
// decode-and-crop via scanline windowing (the
// tf.image.decode_and_crop_jpeg equivalent,
// imagenet_preprocessing.py:363-368), and a multithreaded batch
// decoder that runs outside the Python GIL.
//
// Exposed as a plain C ABI consumed with ctypes.  Built at first use
// by dtf_tpu_torch/native/__init__.py into dtf_tpu_torch/_build/
// (g++ -O3 -fPIC -shared -std=c++17 ... -ljpeg -lpthread).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string_view>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <csetjmp>

extern "C" {

// ---------------------------------------------------------------------------
// crc32c (Castagnoli) — slicing-by-8
// ---------------------------------------------------------------------------

static uint32_t crc_table[8][256];

// Built once under std::call_once: callers arrive from Python threads
// with the GIL released, so first use may be concurrent.
static std::once_flag crc_once;

static void crc_build_tables() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u * (c & 1));
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = crc_table[0][i];
    for (int s = 1; s < 8; s++) {
      c = (c >> 8) ^ crc_table[0][c & 0xFF];
      crc_table[s][i] = c;
    }
  }
}

static void crc_init() { std::call_once(crc_once, crc_build_tables); }

uint32_t dtf_crc32c(const uint8_t* data, int64_t n) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t word;
    memcpy(&word, data, 8);
    word ^= c;
    c = crc_table[7][word & 0xFF] ^ crc_table[6][(word >> 8) & 0xFF] ^
        crc_table[5][(word >> 16) & 0xFF] ^ crc_table[4][(word >> 24) & 0xFF] ^
        crc_table[3][(word >> 32) & 0xFF] ^ crc_table[2][(word >> 40) & 0xFF] ^
        crc_table[1][(word >> 48) & 0xFF] ^ crc_table[0][(word >> 56) & 0xFF];
    data += 8;
    n -= 8;
  }
  while (n-- > 0) c = (c >> 8) ^ crc_table[0][(c ^ *data++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

static uint32_t masked_crc(const uint8_t* p, int64_t n) {
  uint32_t crc = dtf_crc32c(p, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// TFRecord streaming reader
// ---------------------------------------------------------------------------

struct TfrReader {
  FILE* f;
  int verify;
  std::vector<uint8_t> buf;
};

void* dtf_tfr_open(const char* path, int verify_crc) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new TfrReader{f, verify_crc, {}};
  return r;
}

// Returns record length (>=0) with *data pointing at an internal buffer
// valid until the next call; -1 on clean EOF; -2 on corruption/truncation.
int64_t dtf_tfr_next(void* handle, const uint8_t** data) {
  auto* r = static_cast<TfrReader*>(handle);
  uint8_t header[12];
  size_t got = fread(header, 1, 12, r->f);
  if (got == 0) return -1;
  if (got < 12) return -2;
  uint64_t len;
  memcpy(&len, header, 8);
  if (r->verify) {
    uint32_t crc;
    memcpy(&crc, header + 8, 4);
    if (masked_crc(header, 8) != crc) return -2;
  }
  // The length field is untrusted file content: a corrupt header must
  // surface as a catchable read error, not a std::bad_alloc (or a
  // len+4 wraparound) escaping through the C ABI.
  if (len > (1ull << 33)) return -2;  // 8 GiB: far beyond any real record
  try {
    r->buf.resize(len + 4);
  } catch (const std::bad_alloc&) {
    return -2;  // corrupt length below the cap but beyond available memory
  }
  if (fread(r->buf.data(), 1, len + 4, r->f) != len + 4) return -2;
  if (r->verify) {
    uint32_t crc;
    memcpy(&crc, r->buf.data() + len, 4);
    if (masked_crc(r->buf.data(), len) != crc) return -2;
  }
  *data = r->buf.data();
  return static_cast<int64_t>(len);
}

void dtf_tfr_close(void* handle) {
  auto* r = static_cast<TfrReader*>(handle);
  fclose(r->f);
  delete r;
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg), with optional crop window
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// Reads the header only: fills h/w. Returns 0 on success.
int dtf_jpeg_shape(const uint8_t* buf, int64_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decodes RGB into out (size ch*cw*3), reading only rows [y, y+ch) and
// columns [x, x+cw) — the fused decode-and-crop. Pass y=x=0 and
// ch=cw=full size for a plain decode. fast_dct selects JDCT_IFAST
// (~1.3-2x faster IDCT, ±1-2 LSB vs JDCT_ISLOW — fine for train-time
// augmentation, off for anything parity-sensitive). scale_num (1..7)
// selects libjpeg's DCT-space scale_num/8 scaled decode (8 = none);
// the crop window (y, x, ch, cw) is then in SCALED coordinates.
// Returns 0 on success.
static int jpeg_decode_crop_impl(const uint8_t* buf, int64_t len, int y,
                                 int x, int ch, int cw, uint8_t* out,
                                 int fast_dct, int scale_num = 8) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (fast_dct) cinfo.dct_method = JDCT_IFAST;
  if (scale_num < 8) {
    cinfo.scale_num = scale_num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  const int W = cinfo.output_width, H = cinfo.output_height;
  if (y < 0 || x < 0 || y + ch > H || x + cw > W) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  std::vector<uint8_t> row(static_cast<size_t>(W) * 3);
  uint8_t* rowp = row.data();
  if (y > 0) jpeg_skip_scanlines(&cinfo, y);
  for (int r = 0; r < ch; r++) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    memcpy(out + static_cast<size_t>(r) * cw * 3, rowp + x * 3,
           static_cast<size_t>(cw) * 3);
  }
  jpeg_abort_decompress(&cinfo);  // skip remaining rows cheaply
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int dtf_jpeg_decode_crop(const uint8_t* buf, int64_t len, int y, int x,
                         int ch, int cw, uint8_t* out) {
  return jpeg_decode_crop_impl(buf, len, y, x, ch, cw, out, 0);
}

// ---------------------------------------------------------------------------
// Multithreaded batch decode-crop: n images decoded in parallel into a
// caller-provided contiguous buffer [n, ch, cw, 3] (GIL-free on the
// Python side).  crops is n×4 ints (y, x, ch_i==ch, cw_i==cw for now).
// Returns number of failures.
// ---------------------------------------------------------------------------

int dtf_jpeg_decode_batch(const uint8_t** bufs, const int64_t* lens, int n,
                          const int* crops, int ch, int cw, uint8_t* out,
                          int num_threads) {
  std::atomic<int> next(0), failures(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const int* c = crops + i * 4;
      if (c[2] != ch || c[3] != cw) {  // fixed output layout required
        failures.fetch_add(1);
        continue;
      }
      if (dtf_jpeg_decode_crop(bufs[i], lens[i], c[0], c[1], c[2], c[3],
                               out + static_cast<size_t>(i) * ch * cw * 3)) {
        failures.fetch_add(1);
      }
    }
  };
  if (num_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; t++) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

}  // extern "C" — the templated sampler below needs C++ linkage

// ---------------------------------------------------------------------------
// Fused decode→crop→(flip)→bilinear-resize→store batch — the whole
// ImageNet train-time augmentation (imagenet_preprocessing.py
// _decode_crop_and_flip + _resize_image + _mean_image_subtraction) per
// image in one C++ pass, n images across num_threads threads, GIL-free.
// Bilinear = half-pixel centers, no antialias (tf.image.resize v2).
// Per-image variable crop windows; fixed [oh, ow] output in one of two
// wire formats (the Store policies below).
// statuses[i] = 0 ok / 1 failed (caller re-decodes failures its own
// way).  Returns the failure count.
// ---------------------------------------------------------------------------

// Output stores for the bilinear sampler.  StoreF32Sub: float32 with
// per-channel mean subtraction — the host-normalized wire.  StoreU8:
// round-half-up to uint8 (floorf(v + 0.5f), matching the Python
// fallback's np.floor(v + 0.5)) with NO normalization — the device-side
// wire: batches ship 4x fewer bytes host→device and the mean-subtract /
// standardize runs as the first op inside the compiled step.  Bilinear
// output of uint8 inputs is a convex combination in [0, 255]; the clamp
// only guards fp drift.
struct StoreF32Sub {
  float* dst;
  const float* sub;
  inline void put(size_t idx, int ch, float v) const {
    dst[idx] = v - sub[ch];
  }
};

struct StoreU8 {
  uint8_t* dst;
  inline void put(size_t idx, int ch, float v) const {
    (void)ch;
    float r = floorf(v + 0.5f);
    dst[idx] = static_cast<uint8_t>(r < 0.f ? 0.f : (r > 255.f ? 255.f : r));
  }
};

// Generic bilinear sampler: output pixel (r, c) reads source position
// (y_off + r*y_step, x_off + c*x_step), clamped — tf.image.resize v2
// semantics when y_off = 0.5*y_step - 0.5 (plain resize), and the
// aspect-preserving-resize + central-crop composition when the offsets
// carry the crop origin.
template <typename Store>
static void bilinear_sample_store(const uint8_t* src, int sh, int sw,
                                  int oh, int ow, int flip,
                                  float y_off, float y_step, float x_off,
                                  float x_step, const Store& st) {
  // column sampling tables, computed once (not per row)
  std::vector<int> xas(ow), xbs(ow);
  std::vector<float> wxs(ow);
  for (int c = 0; c < ow; c++) {
    // flip(resize(x)) == resize(flip(x)) for symmetric half-pixel
    // sampling, so the flip fuses into the source column lookup
    int cc = flip ? (ow - 1 - c) : c;
    float fx = x_off + cc * x_step;
    int x0 = static_cast<int>(floorf(fx));
    wxs[c] = fx - x0;
    xas[c] = 3 * (x0 < 0 ? 0 : (x0 >= sw ? sw - 1 : x0));
    xbs[c] = 3 * (x0 + 1 < 0 ? 0 : (x0 + 1 >= sw ? sw - 1 : x0 + 1));
  }
  for (int r = 0; r < oh; r++) {
    float fy = y_off + r * y_step;
    int y0 = static_cast<int>(floorf(fy));
    float wy = fy - y0;
    int ya = y0 < 0 ? 0 : (y0 >= sh ? sh - 1 : y0);
    int yb = y0 + 1 < 0 ? 0 : (y0 + 1 >= sh ? sh - 1 : y0 + 1);
    const uint8_t* rowa = src + static_cast<size_t>(ya) * sw * 3;
    const uint8_t* rowb = src + static_cast<size_t>(yb) * sw * 3;
    const size_t row_base = static_cast<size_t>(r) * ow * 3;
    for (int c = 0; c < ow; c++) {
      const int xa = xas[c], xb = xbs[c];
      const float wx = wxs[c];
      for (int ch = 0; ch < 3; ch++) {
        float top = (1.0f - wx) * rowa[xa + ch] + wx * rowa[xb + ch];
        float bot = (1.0f - wx) * rowb[xa + ch] + wx * rowb[xb + ch];
        st.put(row_base + c * 3 + ch, ch, (1.0f - wy) * top + wy * bot);
      }
    }
  }
}

// Dispatches the sampler on the wire format (out_u8 selects StoreU8).
static void bilinear_sample_out(const uint8_t* src, int sh, int sw,
                                void* dst, int out_u8, int oh, int ow,
                                int flip, float y_off, float y_step,
                                float x_off, float x_step,
                                const float* sub) {
  if (out_u8) {
    bilinear_sample_store(src, sh, sw, oh, ow, flip, y_off, y_step,
                          x_off, x_step,
                          StoreU8{static_cast<uint8_t*>(dst)});
  } else {
    bilinear_sample_store(src, sh, sw, oh, ow, flip, y_off, y_step,
                          x_off, x_step,
                          StoreF32Sub{static_cast<float*>(dst), sub});
  }
}

// One image: fused decode-crop-(flip)-resize-mean-subtract.  With
// scaled_decode, crops larger than the output decode at the smallest
// N/8 DCT-space scale (libjpeg-turbo scale_num=N) that keeps the
// scaled crop >= the output — engaged only for N <= 4 (crop >= 2x the
// output): measured on libjpeg-turbo, N=5..7 scaled decodes LOSE to
// the full decode (no SIMD for the odd reduced IDCT sizes, and entropy
// decode — the constant cost scaling can't skip — dominates small
// images), while N<=4 wins 10-30%.  Returns 0 on success.
static int decode_resize_one(const uint8_t* buf, int64_t len, int y, int x,
                             int ch, int cw, int flip, int oh, int ow,
                             const float* sub, void* dst, int out_u8,
                             int fast_dct, int scaled_decode,
                             std::vector<uint8_t>& tmp) {
  if (ch <= 0 || cw <= 0) return 1;
  int num = 8;
  if (scaled_decode) {
    const int n_h = (8 * oh + ch - 1) / ch;
    const int n_w = (8 * ow + cw - 1) / cw;
    const int nsel = n_h > n_w ? n_h : n_w;
    if (nsel >= 1 && nsel <= 4) num = nsel;
  }
  const float ys = static_cast<float>(ch) / oh;
  const float xs = static_cast<float>(cw) / ow;
  if (num == 8) {
    tmp.resize(static_cast<size_t>(ch) * cw * 3);
    if (jpeg_decode_crop_impl(buf, len, y, x, ch, cw, tmp.data(),
                              fast_dct))
      return 1;
    bilinear_sample_out(tmp.data(), ch, cw, dst, out_u8, oh, ow, flip,
                        0.5f * ys - 0.5f, ys, 0.5f * xs - 0.5f, xs, sub);
  } else {
    // decode window in N/8-scaled coordinates covering the crop
    const float s = num / 8.0f;
    const int y0s = y * num / 8, x0s = x * num / 8;
    const int chs = ((y + ch) * num + 7) / 8 - y0s;
    const int cws = ((x + cw) * num + 7) / 8 - x0s;
    tmp.resize(static_cast<size_t>(chs) * cws * 3);
    if (jpeg_decode_crop_impl(buf, len, y0s, x0s, chs, cws, tmp.data(),
                              fast_dct, num))
      return 1;
    // full-res source coord f sits at (f + 0.5)*s - 0.5 in scaled
    // space; carry the crop origin and window offset through
    bilinear_sample_out(tmp.data(), chs, cws, dst, out_u8, oh, ow, flip,
                        (y + 0.5f * ys) * s - 0.5f - y0s, ys * s,
                        (x + 0.5f * xs) * s - 0.5f - x0s, xs * s, sub);
  }
  return 0;
}

extern "C" {

// Capability marker: a library exporting this symbol supports the
// uint8 wire (trailing out_u8 parameter on the fused batch ops).  The
// Python layer gates uint8 mode on it so a stale .so degrades to the
// float32 wire instead of writing garbage.
int dtf_wire_u8(void) { return 1; }

// Per-image destination in the wire's element stride (px = oh*ow*3).
static inline void* dst_at(void* out, int out_u8, int i, size_t px) {
  return out_u8
      ? static_cast<void*>(static_cast<uint8_t*>(out) + i * px)
      : static_cast<void*>(static_cast<float*>(out) + i * px);
}

int dtf_jpeg_decode_crop_resize_batch(
    const uint8_t** bufs, const int64_t* lens, int n, const int* crops,
    const uint8_t* flips, int oh, int ow, const float* sub, void* out,
    uint8_t* statuses, int num_threads, int fast_dct, int scaled_decode,
    int out_u8) {
  const size_t px = static_cast<size_t>(oh) * ow * 3;
  std::atomic<int> next(0), failures(0);
  auto work = [&]() {
    std::vector<uint8_t> tmp;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const int* c = crops + i * 4;
      void* dst = dst_at(out, out_u8, i, px);
      if (decode_resize_one(bufs[i], lens[i], c[0], c[1], c[2], c[3],
                            flips ? flips[i] : 0, oh, ow, sub, dst,
                            out_u8, fast_dct, scaled_decode, tmp)) {
        statuses[i] = 1;
        failures.fetch_add(1);
        continue;
      }
      statuses[i] = 0;
    }
  };
  if (num_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; t++) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

// ---------------------------------------------------------------------------
// tf.train.Example wire parse (targeted) + distorted-bbox sampling —
// the whole per-record train path in one call: parse → JPEG header →
// sample crop → flip → fused decode-crop-resize-subtract.  This is the
// GIL-held Python work the r3 instrumentation measured as the input
// pipeline's Amdahl serial fraction, moved off the interpreter.
//
// Wire format (records.py build_example / TF parity): Example{1:
// Features{1: map entry{1: key, 2: Feature}}}; Feature{1: BytesList,
// 2: FloatList (packed), 3: Int64List (packed varints)}.
// ---------------------------------------------------------------------------

// Reads a base-128 varint; returns false on truncation.
static bool read_varint(const uint8_t*& p, const uint8_t* end,
                        uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    v |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

// Skips a field payload by wiretype; returns false on malformed input.
static bool skip_field(const uint8_t*& p, const uint8_t* end, int wt) {
  uint64_t tmp;
  switch (wt) {
    case 0: return read_varint(p, end, &tmp);
    case 1: if (end - p < 8) return false; p += 8; return true;
    case 2:
      if (!read_varint(p, end, &tmp) ||
          static_cast<uint64_t>(end - p) < tmp)
        return false;
      p += tmp;
      return true;
    case 5: if (end - p < 4) return false; p += 4; return true;
    default: return false;
  }
}

struct ParsedExample {
  const uint8_t* encoded = nullptr;  // points into the record buffer
  uint64_t encoded_len = 0;
  int64_t label = -1;
  float bbox[4] = {0.f, 0.f, 1.f, 1.f};  // ymin, xmin, ymax, xmax
  bool has_bbox = false;
};

// Extracts the first value of the named features.  Returns false on a
// wire-format error or when image/encoded / label are absent.
static bool parse_train_example(const uint8_t* rec, int64_t len,
                                ParsedExample* out) {
  const uint8_t* p = rec;
  const uint8_t* end = rec + len;
  bool bbox_seen[4] = {false, false, false, false};
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return false;
    if ((tag >> 3) != 1 || (tag & 7) != 2) {  // Example.features
      if (!skip_field(p, end, tag & 7)) return false;
      continue;
    }
    uint64_t flen;
    if (!read_varint(p, end, &flen) ||
        static_cast<uint64_t>(end - p) < flen)
      return false;
    const uint8_t* fp = p;
    const uint8_t* fend = p + flen;
    p = fend;
    while (fp < fend) {  // Features.feature map entries
      uint64_t etag;
      if (!read_varint(fp, fend, &etag)) return false;
      if ((etag >> 3) != 1 || (etag & 7) != 2) {
        if (!skip_field(fp, fend, etag & 7)) return false;
        continue;
      }
      uint64_t elen;
      if (!read_varint(fp, fend, &elen) ||
          static_cast<uint64_t>(fend - fp) < elen)
        return false;
      const uint8_t* ep = fp;
      const uint8_t* eend = fp + elen;
      fp = eend;
      const uint8_t* key = nullptr;
      uint64_t key_len = 0;
      const uint8_t* feat = nullptr;
      uint64_t feat_len = 0;
      while (ep < eend) {  // map entry: key=1, Feature=2
        uint64_t ktag;
        if (!read_varint(ep, eend, &ktag)) return false;
        if ((ktag & 7) != 2) {
          if (!skip_field(ep, eend, ktag & 7)) return false;
          continue;
        }
        uint64_t klen;
        if (!read_varint(ep, eend, &klen) ||
            static_cast<uint64_t>(eend - ep) < klen)
          return false;
        if ((ktag >> 3) == 1) {
          key = ep;
          key_len = klen;
        } else if ((ktag >> 3) == 2) {
          feat = ep;
          feat_len = klen;
        }
        ep += klen;
      }
      if (!key || !feat) continue;
      std::string_view name(reinterpret_cast<const char*>(key), key_len);
      int bbox_idx = -1;
      if (name == "image/object/bbox/ymin") bbox_idx = 0;
      else if (name == "image/object/bbox/xmin") bbox_idx = 1;
      else if (name == "image/object/bbox/ymax") bbox_idx = 2;
      else if (name == "image/object/bbox/xmax") bbox_idx = 3;
      if (name != "image/encoded" && name != "image/class/label" &&
          bbox_idx < 0)
        continue;
      // Feature: one of BytesList/FloatList/Int64List at field 1..3
      const uint8_t* vp = feat;
      const uint8_t* vend = feat + feat_len;
      while (vp < vend) {
        uint64_t vtag;
        if (!read_varint(vp, vend, &vtag)) return false;
        if ((vtag & 7) != 2) {
          if (!skip_field(vp, vend, vtag & 7)) return false;
          continue;
        }
        uint64_t vlen;
        if (!read_varint(vp, vend, &vlen) ||
            static_cast<uint64_t>(vend - vp) < vlen)
          return false;
        const uint8_t* lp = vp;
        const uint8_t* lend = vp + vlen;
        vp = lend;
        // the list message: field 1 holds the value(s)
        while (lp < lend) {
          uint64_t ltag;
          if (!read_varint(lp, lend, &ltag)) return false;
          if ((ltag >> 3) != 1) {
            if (!skip_field(lp, lend, ltag & 7)) return false;
            continue;
          }
          if ((vtag >> 3) == 1 && (ltag & 7) == 2) {  // bytes value
            uint64_t blen;
            if (!read_varint(lp, lend, &blen) ||
                static_cast<uint64_t>(lend - lp) < blen)
              return false;
            if (name == "image/encoded" && !out->encoded) {
              out->encoded = lp;
              out->encoded_len = blen;
            }
            lp += blen;
          } else if ((vtag >> 3) == 2) {  // float list
            if ((ltag & 7) == 2) {  // packed
              uint64_t plen;
              if (!read_varint(lp, lend, &plen) ||
                  static_cast<uint64_t>(lend - lp) < plen || plen < 4)
                return false;
              if (bbox_idx >= 0 && !bbox_seen[bbox_idx]) {
                memcpy(&out->bbox[bbox_idx], lp, 4);  // first value
                bbox_seen[bbox_idx] = true;
              }
              lp += plen;
            } else if ((ltag & 7) == 5) {  // unpacked
              if (lend - lp < 4) return false;
              if (bbox_idx >= 0 && !bbox_seen[bbox_idx]) {
                memcpy(&out->bbox[bbox_idx], lp, 4);
                bbox_seen[bbox_idx] = true;
              }
              lp += 4;
            } else {
              if (!skip_field(lp, lend, ltag & 7)) return false;
            }
          } else if ((vtag >> 3) == 3) {  // int64 list
            if ((ltag & 7) == 2) {  // packed varints
              uint64_t plen;
              if (!read_varint(lp, lend, &plen) ||
                  static_cast<uint64_t>(lend - lp) < plen)
                return false;
              const uint8_t* ip = lp;
              uint64_t v;
              if (name == "image/class/label" && out->label < 0 &&
                  read_varint(ip, lp + plen, &v))
                out->label = static_cast<int64_t>(v);
              lp += plen;
            } else if ((ltag & 7) == 0) {  // single varint
              uint64_t v;
              if (!read_varint(lp, lend, &v)) return false;
              if (name == "image/class/label" && out->label < 0)
                out->label = static_cast<int64_t>(v);
            } else {
              if (!skip_field(lp, lend, ltag & 7)) return false;
            }
          } else {
            if (!skip_field(lp, lend, ltag & 7)) return false;
          }
        }
      }
    }
  }
  out->has_bbox = bbox_seen[0] && bbox_seen[1] && bbox_seen[2] &&
                  bbox_seen[3];
  return out->encoded != nullptr && out->label >= 0;
}

// splitmix64: per-image deterministic stream independent of thread
// scheduling (seed ^ f(index) — stronger reproducibility than a
// shared sequential generator).
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() {
    s += 0x9E3779B97F4A7C15ull;
    uint64_t z = s;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  double uniform() {  // [0, 1)
    return (next() >> 11) * 0x1.0p-53;
  }
  double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }
  int64_t below(int64_t n) {  // [0, n)
    return static_cast<int64_t>(uniform() * n);
  }
};

// Mirror of data/imagenet.py sample_distorted_bbox (reference
// imagenet_preprocessing.py:345-361 constants): min_object_covered
// 0.1, aspect in [0.75, 1.33], area in [0.05, 1.0], 100 attempts,
// whole image on failure.
static void sample_distorted_bbox(Rng& rng, int height, int width,
                                  const float* bbox, bool has_bbox,
                                  int* out) {
  const float by0 = (has_bbox ? bbox[0] : 0.f) * height;
  const float bx0 = (has_bbox ? bbox[1] : 0.f) * width;
  const float by1 = (has_bbox ? bbox[2] : 1.f) * height;
  const float bx1 = (has_bbox ? bbox[3] : 1.f) * width;
  const float box_area =
      std::max((by1 - by0) * (bx1 - bx0), 1e-6f);
  for (int attempt = 0; attempt < 100; ++attempt) {
    const double aspect = rng.uniform(0.75, 1.33);
    const double area_frac = rng.uniform(0.05, 1.0);
    const double target_area =
        area_frac * static_cast<double>(height) * width;
    const int w = static_cast<int>(std::lround(std::sqrt(target_area * aspect)));
    const int h = static_cast<int>(std::lround(std::sqrt(target_area / aspect)));
    if (w > width || h > height || h <= 0 || w <= 0) continue;
    const int y = static_cast<int>(rng.below(height - h + 1));
    const int x = static_cast<int>(rng.below(width - w + 1));
    const float inter_h =
        std::max(0.f, std::min<float>(y + h, by1) - std::max<float>(y, by0));
    const float inter_w =
        std::max(0.f, std::min<float>(x + w, bx1) - std::max<float>(x, bx0));
    if (inter_h * inter_w / box_area >= 0.1f) {
      out[0] = y; out[1] = x; out[2] = h; out[3] = w;
      return;
    }
  }
  out[0] = 0; out[1] = 0; out[2] = height; out[3] = width;
}

// The whole train path for a batch of raw Example records.  statuses:
// 0 ok, 1 parse failed (caller reprocesses in Python), 2 decode failed
// (caller re-decodes with the RETURNED crop/flip so augmentation stays
// identical).  labels/crops/flips are always filled for status != 1.
// Returns the failure count.
int dtf_train_example_batch(
    const uint8_t** recs, const int64_t* lens, int n, uint64_t seed,
    int oh, int ow, const float* sub, int fast_dct, int scaled_decode,
    int num_threads, void* out, int32_t* labels, int32_t* crops,
    uint8_t* flips, uint8_t* statuses, int out_u8) {
  const size_t px = static_cast<size_t>(oh) * ow * 3;
  std::atomic<int> next(0), failures(0);
  auto work = [&]() {
    std::vector<uint8_t> tmp;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      ParsedExample ex;
      if (!parse_train_example(recs[i], lens[i], &ex)) {
        statuses[i] = 1;
        failures.fetch_add(1);
        continue;
      }
      labels[i] = static_cast<int32_t>(ex.label - 1);  // → [0, 1000)
      int h = 0, w = 0;
      Rng rng(seed ^ (0xA0761D6478BD642Full * (i + 1)));
      int* crop = crops + i * 4;
      if (dtf_jpeg_shape(ex.encoded, ex.encoded_len, &h, &w) ||
          h <= 0 || w <= 0) {
        statuses[i] = 1;  // undecodable header → Python whole path
        failures.fetch_add(1);
        continue;
      }
      sample_distorted_bbox(rng, h, w, ex.bbox, ex.has_bbox, crop);
      const int flip = rng.uniform() < 0.5 ? 1 : 0;
      flips[i] = static_cast<uint8_t>(flip);
      void* dst = dst_at(out, out_u8, i, px);
      if (decode_resize_one(ex.encoded, ex.encoded_len, crop[0], crop[1],
                            crop[2], crop[3], flip, oh, ow, sub, dst,
                            out_u8, fast_dct, scaled_decode, tmp)) {
        statuses[i] = 2;
        failures.fetch_add(1);
        continue;
      }
      statuses[i] = 0;
    }
  };
  if (num_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; t++) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

// ---------------------------------------------------------------------------
// Fused eval-side batch: aspect-preserving resize to shorter-side
// `resize_min` + central [oh, ow] crop + mean-subtract, in ONE sampling
// pass over a decode WINDOW (only the source rows/cols the crop
// samples are decoded — imagenet_preprocessing.py:375-394,464-480
// semantics with tf-bilinear numerics).
// ---------------------------------------------------------------------------

int dtf_jpeg_eval_batch(const uint8_t** bufs, const int64_t* lens, int n,
                        int resize_min, int oh, int ow, const float* sub,
                        void* out, uint8_t* statuses, int num_threads,
                        int fast_dct, int out_u8) {
  const size_t px = static_cast<size_t>(oh) * ow * 3;
  std::atomic<int> next(0), failures(0);
  auto work = [&]() {
    std::vector<uint8_t> tmp;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int h = 0, w = 0;
      if (dtf_jpeg_shape(bufs[i], lens[i], &h, &w) || h <= 0 || w <= 0) {
        statuses[i] = 1;
        failures.fetch_add(1);
        continue;
      }
      const float scale =
          static_cast<float>(resize_min) / (h < w ? h : w);
      const int nh = static_cast<int>(lroundf(h * scale));
      const int nw = static_cast<int>(lroundf(w * scale));
      if (nh < oh || nw < ow) {  // resize_min must cover the crop
        statuses[i] = 1;
        failures.fetch_add(1);
        continue;
      }
      const float ys = static_cast<float>(h) / nh;
      const float xs = static_cast<float>(w) / nw;
      const float y_off = ((nh - oh) / 2 + 0.5f) * ys - 0.5f;
      const float x_off = ((nw - ow) / 2 + 0.5f) * xs - 0.5f;
      // source window actually sampled (clamp handles the edges)
      int y0 = static_cast<int>(floorf(y_off));
      int y1 = static_cast<int>(floorf(y_off + (oh - 1) * ys)) + 1;
      int x0 = static_cast<int>(floorf(x_off));
      int x1 = static_cast<int>(floorf(x_off + (ow - 1) * xs)) + 1;
      y0 = y0 < 0 ? 0 : y0;
      x0 = x0 < 0 ? 0 : x0;
      y1 = y1 >= h ? h - 1 : y1;
      x1 = x1 >= w ? w - 1 : x1;
      const int wh = y1 - y0 + 1, ww = x1 - x0 + 1;
      tmp.resize(static_cast<size_t>(wh) * ww * 3);
      if (jpeg_decode_crop_impl(bufs[i], lens[i], y0, x0, wh, ww,
                                tmp.data(), fast_dct)) {
        statuses[i] = 1;
        failures.fetch_add(1);
        continue;
      }
      void* dst = dst_at(out, out_u8, i, px);
      bilinear_sample_out(tmp.data(), wh, ww, dst, out_u8,
                          oh, ow, /*flip=*/0, y_off - y0, ys,
                          x_off - x0, xs, sub);
      statuses[i] = 0;
    }
  };
  if (num_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; t++) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

}  // extern "C"
