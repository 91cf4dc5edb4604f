// Native data-loader core (port of faceposegenerator_tpu/native/loader.cpp):
// RecordIO record reads, thread-parallel libjpeg decode -> bilinear resize ->
// [-1, 1] normalise, and a stored-deflate PNG writer.
//
// The reference delegates this layer to mxnet's native RecordIO + imdecode
// (FR_training/utils/dataset.py MXFaceDataset) and to PIL in its scripts.
// The JAX package builds it as a CPython extension; here every entry point
// is a plain C function, loaded with ctypes (which releases the GIL for the
// call), so the build needs g++ and libjpeg but no Python headers.
//
// Entry points (see native/__init__.py for the Python functions over them):
//   fpg_read_idx(path, &keys, &offsets) -> n, or -1 (cannot open)
//   fpg_read_records(path, offsets, n, lengths, &bodies, err, errlen)
//       -> 0, 1 (cannot open: OSError) or 2 (bad record: ValueError)
//   fpg_decode_batch(payloads, lengths, n, out, size, nthreads, err, errlen)
//       out: float32 [n, size, size, 3] filled with (x/255 - 0.5)/0.5 RGB
//   fpg_decode_rgb(payload, len, &rgb, &w, &h, err, errlen) raw RGB8
//   fpg_write_png_batch(images, n, h, w, paths, nthreads, err, errlen)
//   fpg_free(p) releases what the entry points allocate.
//
// Build: native/__init__.py (g++ -O3 -shared -fPIC ... -ljpeg -lpthread).

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

#include <jpeglib.h>

namespace {

constexpr uint32_t kMagic = 0xCED7230A;

void set_error(char* err, int errlen, const std::string& msg) {
  if (err == nullptr || errlen <= 0) return;
  std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

// ---------------------------------------------------------------- JPEG ----

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
  char message[JMSG_LENGTH_MAX];
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->message);
  longjmp(err->jump, 1);
}

// Decodes a JPEG stream to tightly-packed RGB8. Returns false on corrupt
// input (writes the libjpeg message into `errmsg`).
bool decode_jpeg_rgb(const unsigned char* data, size_t len,
                     std::vector<unsigned char>* rgb, int* width, int* height,
                     std::string* errmsg) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    *errmsg = jerr.message;
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  const size_t row = static_cast<size_t>(*width) * 3;
  rgb->resize(row * *height);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* dst = rgb->data() + row * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &dst, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear resize (pixel-center aligned, no antialias: cv2.INTER_LINEAR
// semantics) + [-1, 1] float32 normalisation, fused in one pass.
void resize_normalize(const unsigned char* rgb, int w, int h, int size,
                      float* out) {
  const float sx = static_cast<float>(w) / size;
  const float sy = static_cast<float>(h) / size;
  const bool identity = (w == size && h == size);
  for (int y = 0; y < size; ++y) {
    float* orow = out + static_cast<size_t>(y) * size * 3;
    if (identity) {
      const unsigned char* irow = rgb + static_cast<size_t>(y) * w * 3;
      for (int i = 0; i < size * 3; ++i) {
        orow[i] = (irow[i] * (1.0f / 255.0f) - 0.5f) * 2.0f;
      }
      continue;
    }
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > h - 2) y0 = h - 2;
    if (y0 < 0) y0 = 0;
    // degenerate 1-pixel-tall/wide images: the second sample is the same
    // row/column, never one past the decoded buffer
    int y1 = (y0 + 1 < h) ? y0 + 1 : y0;
    float wy = fy - y0;
    const unsigned char* r0 = rgb + static_cast<size_t>(y0) * w * 3;
    const unsigned char* r1 = rgb + static_cast<size_t>(y1) * w * 3;
    for (int x = 0; x < size; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      if (x0 > w - 2) x0 = w - 2;
      if (x0 < 0) x0 = 0;
      int x1 = (x0 + 1 < w) ? x0 + 1 : x0;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float a = r0[x0 * 3 + c], b = r0[x1 * 3 + c];
        float cc = r1[x0 * 3 + c], d = r1[x1 * 3 + c];
        float top = a + (b - a) * wx;
        float bot = cc + (d - cc) * wx;
        float v = top + (bot - top) * wy;
        orow[x * 3 + c] = (v * (1.0f / 255.0f) - 0.5f) * 2.0f;
      }
    }
  }
}

// ----------------------------------------------------------------- PNG ----
// Stored-deflate PNG writer: valid lossless PNGs at about the speed of a
// copy. A stored (BTYPE=00) deflate stream is still a conformant PNG, costs
// one pass of CRC/adler arithmetic, and runs without the GIL.

uint32_t crc_table[256];
std::atomic<bool> crc_ready{false};
std::atomic<bool> crc_building{false};

void init_crc() {
  if (crc_ready.load()) return;
  bool expected = false;
  if (crc_building.compare_exchange_strong(expected, true)) {
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = n;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc_table[n] = c;
    }
    crc_ready.store(true);
  } else {
    while (!crc_ready.load()) {
    }
  }
}

uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
  crc ^= 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) crc = crc_table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t adler32_update(uint32_t adler, const uint8_t* p, size_t n) {
  uint32_t a = adler & 0xFFFF, b = (adler >> 16) & 0xFFFF;
  size_t i = 0;
  while (i < n) {
    size_t chunk = (n - i < 5552) ? n - i : 5552;  // overflow-safe stride
    for (size_t j = 0; j < chunk; ++j) {
      a += p[i + j];
      b += a;
    }
    a %= 65521;
    b %= 65521;
    i += chunk;
  }
  return (b << 16) | a;
}

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24);
  v.push_back(x >> 16);
  v.push_back(x >> 8);
  v.push_back(x);
}

void put_chunk(std::vector<uint8_t>& v, const char type[4], const uint8_t* data,
               size_t n) {
  put_be32(v, static_cast<uint32_t>(n));
  size_t type_at = v.size();
  v.insert(v.end(), type, type + 4);
  if (n) v.insert(v.end(), data, data + n);
  uint32_t crc = crc32_update(0, v.data() + type_at, n + 4);
  put_be32(v, crc);
}

bool write_png_rgb8(const uint8_t* rgb, int w, int h, const char* path,
                    std::string* err) {
  init_crc();
  std::vector<uint8_t> out;
  const size_t row = static_cast<size_t>(w) * 3;
  const size_t raw_len = (row + 1) * h;  // +1 filter byte per scanline
  out.reserve(raw_len + raw_len / 32768 * 5 + 128);
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A, 0x0A};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = w >> 24; ihdr[1] = w >> 16; ihdr[2] = w >> 8; ihdr[3] = w;
  ihdr[4] = h >> 24; ihdr[5] = h >> 16; ihdr[6] = h >> 8; ihdr[7] = h;
  ihdr[8] = 8; ihdr[9] = 2; ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);

  // filtered scanlines (filter 0) -> one contiguous raw buffer
  std::vector<uint8_t> raw(raw_len);
  for (int y = 0; y < h; ++y) {
    uint8_t* dst = raw.data() + static_cast<size_t>(y) * (row + 1);
    dst[0] = 0;
    std::memcpy(dst + 1, rgb + static_cast<size_t>(y) * row, row);
  }

  // IDAT: zlib header + stored deflate blocks + adler32
  std::vector<uint8_t> idat;
  idat.reserve(raw_len + raw_len / 32768 * 5 + 16);
  idat.push_back(0x78);
  idat.push_back(0x01);
  size_t off = 0;
  while (off < raw_len) {
    size_t blk = raw_len - off;
    if (blk > 65535) blk = 65535;
    const bool final = (off + blk == raw_len);
    idat.push_back(final ? 1 : 0);
    idat.push_back(blk & 0xFF);
    idat.push_back((blk >> 8) & 0xFF);
    idat.push_back(~blk & 0xFF);
    idat.push_back((~blk >> 8) & 0xFF);
    idat.insert(idat.end(), raw.data() + off, raw.data() + off + blk);
    off += blk;
  }
  uint32_t adler = adler32_update(1, raw.data(), raw_len);
  put_be32(idat, adler);
  put_chunk(out, "IDAT", idat.data(), idat.size());
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) {
    *err = std::string("open failed: ") + path;
    return false;
  }
  const bool ok = std::fwrite(out.data(), 1, out.size(), f) == out.size();
  std::fclose(f);
  if (!ok) {
    *err = std::string("short write: ") + path;
    return false;
  }
  return true;
}

// Runs fn(i) for i in [0, n) on up to `nthreads` threads; stops handing out
// indices once one call fails. Returns false if any call failed, with the
// first failure's message in `err`.
template <typename F>
bool parallel_for(int64_t n, int nthreads, F fn, std::string* err) {
  std::atomic<int64_t> next(0);
  std::atomic<bool> failed(false);
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = static_cast<int>(n);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n || failed.load(std::memory_order_relaxed)) break;
      std::string e;
      if (!fn(i, &e)) {
        bool expected = false;
        if (failed.compare_exchange_strong(expected, true)) *err = e;
        break;
      }
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return !failed.load();
}

}  // namespace

extern "C" {

void fpg_free(void* p) { std::free(p); }

// "<key>\t<offset>" lines -> two malloc'd int64 arrays (lines without a tab
// are skipped). Returns the count, or -1 if the file cannot be opened.
int64_t fpg_read_idx(const char* path, int64_t** keys_out, int64_t** offs_out) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  std::vector<int64_t> keys, offsets;
  char line[256];
  while (std::fgets(line, sizeof line, f)) {
    char* tab = std::strchr(line, '\t');
    if (!tab) continue;
    keys.push_back(std::strtoll(line, nullptr, 10));
    offsets.push_back(std::strtoll(tab + 1, nullptr, 10));
  }
  std::fclose(f);
  const size_t bytes = keys.size() * sizeof(int64_t);
  *keys_out = static_cast<int64_t*>(std::malloc(bytes ? bytes : 1));
  *offs_out = static_cast<int64_t*>(std::malloc(bytes ? bytes : 1));
  if (bytes) {
    std::memcpy(*keys_out, keys.data(), bytes);
    std::memcpy(*offs_out, offsets.data(), bytes);
  }
  return static_cast<int64_t>(keys.size());
}

// pread the bodies of the records at `offs` (thread-safe, no shared file
// position): [magic u32 | lrecord u32][body], length = lrecord & (2^29 - 1).
// The bodies go one after another into one malloc'd buffer, their lengths
// into `lengths`. Returns 0, 1 (the file cannot be opened) or 2 (a short read
// or a bad magic; the message in `err`).
int fpg_read_records(const char* path, const int64_t* offs, int64_t n,
                     int64_t* lengths, uint8_t** bodies, char* err, int errlen) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    set_error(err, errlen, std::string("cannot open ") + path);
    return 1;
  }
  std::string error;
  int64_t total = 0;
  for (int64_t i = 0; i < n && error.empty(); ++i) {
    unsigned char head[8];
    if (pread(fd, head, 8, offs[i]) != 8) {
      error = "short read at record header";
      break;
    }
    uint32_t magic, lrec;
    std::memcpy(&magic, head, 4);
    std::memcpy(&lrec, head + 4, 4);
    if (magic != kMagic) {
      error = "bad RecordIO magic";
      break;
    }
    lengths[i] = lrec & ((1u << 29) - 1);
    total += lengths[i];
  }
  uint8_t* buf = nullptr;
  if (error.empty()) {
    buf = static_cast<uint8_t*>(std::malloc(total ? total : 1));
    int64_t at = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (pread(fd, buf + at, lengths[i], offs[i] + 8) != static_cast<ssize_t>(lengths[i])) {
        error = "short read at record body";
        break;
      }
      at += lengths[i];
    }
  }
  close(fd);
  if (!error.empty()) {
    std::free(buf);
    set_error(err, errlen, error);
    return 2;
  }
  *bodies = buf;
  return 0;
}

// Decodes n JPEG streams on `nthreads` threads, each resized to size² and
// normalised into out[i]. Returns 0, or 1 with libjpeg's message in `err`.
int fpg_decode_batch(const uint8_t* const* payloads, const int64_t* lengths,
                     int64_t n, float* out, int size, int nthreads, char* err,
                     int errlen) {
  const size_t per = static_cast<size_t>(size) * size * 3;
  std::string msg;
  bool ok = parallel_for(
      n, nthreads,
      [&](int64_t i, std::string* e) {
        thread_local std::vector<unsigned char> rgb;
        int w, h;
        if (!decode_jpeg_rgb(payloads[i], static_cast<size_t>(lengths[i]), &rgb, &w, &h, e))
          return false;
        resize_normalize(rgb.data(), w, h, size, out + per * i);
        return true;
      },
      &msg);
  if (!ok) {
    set_error(err, errlen, msg);
    return 1;
  }
  return 0;
}

// One JPEG stream -> malloc'd RGB8 (w * h * 3 bytes). Returns 0, or 1 with
// libjpeg's message in `err`.
int fpg_decode_rgb(const uint8_t* payload, int64_t len, uint8_t** rgb_out,
                   int* w, int* h, char* err, int errlen) {
  std::vector<unsigned char> rgb;
  std::string msg;
  if (!decode_jpeg_rgb(payload, static_cast<size_t>(len), &rgb, w, h, &msg)) {
    set_error(err, errlen, msg);
    return 1;
  }
  *rgb_out = static_cast<uint8_t*>(std::malloc(rgb.size() ? rgb.size() : 1));
  if (!rgb.empty()) std::memcpy(*rgb_out, rgb.data(), rgb.size());
  return 0;
}

// images: uint8 [n, h, w, 3]; one PNG a path, on `nthreads` threads.
// Returns 0, or 1 with the failed write's message in `err`.
int fpg_write_png_batch(const uint8_t* images, int64_t n, int h, int w,
                        const char* const* paths, int nthreads, char* err,
                        int errlen) {
  const size_t per = static_cast<size_t>(h) * w * 3;
  init_crc();
  std::string msg;
  bool ok = parallel_for(
      n, nthreads,
      [&](int64_t i, std::string* e) { return write_png_rgb8(images + per * i, w, h, paths[i], e); },
      &msg);
  if (!ok) {
    set_error(err, errlen, msg);
    return 1;
  }
  return 0;
}

}  // extern "C"
