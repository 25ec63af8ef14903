// Native host runtime of the port: a multi-threaded prefetching stereo
// image loader (a copy of the JAX package's, which the port may not
// import).
//
// The reference reads each frame with OpenCV imread on the caller thread
// (reference test/test_system.cpp:40-43,
// include/common/read_kitii_dataset.hpp:16-60). Here N decode workers read
// and inflate PNGs ahead of the consumer into a fixed ring of reusable
// buffers, so the per-frame device step never waits on disk or zlib.
// Exposed as a plain C ABI for ctypes.
//
// PNG support: 8/16-bit, gray / gray+alpha / RGB / RGBA, non-interlaced
// (KITTI odometry images are 8-bit grayscale). The decoder follows the
// PNG spec (RFC 2083): IHDR/IDAT/IEND chunk walk, zlib inflate,
// per-scanline unfilter (None/Sub/Up/Average/Paeth), luma conversion.
// PGM (P5) is also handled.

#include <zlib.h>

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> gray;  // w*h luma
};

bool inflate_all(const uint8_t* src, size_t len, std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(len);
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END || (rc == Z_OK && zs.avail_out == 0) ||
         (rc == Z_BUF_ERROR && zs.avail_out == 0);
}

// Decode a PNG byte buffer to 8-bit luma. Returns false on malformed or
// unsupported (interlaced) input.
bool png_decode_gray(const uint8_t* data, size_t len, Image& img) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  if (len < 8 + 25 || std::memcmp(data, kSig, 8) != 0) return false;

  size_t pos = 8;
  int w = 0, h = 0, depth = 0, ctype = 0, interlace = 0;
  std::vector<uint8_t> idat;
  idat.reserve(len);
  bool saw_ihdr = false;
  while (pos + 8 <= len) {
    uint32_t clen = be32(data + pos);
    const uint8_t* typ = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + clen > len) return false;
    if (!std::memcmp(typ, "IHDR", 4)) {
      if (clen < 13) return false;
      w = int(be32(body));
      h = int(be32(body + 4));
      depth = body[8];
      ctype = body[9];
      interlace = body[12];
      saw_ihdr = true;
    } else if (!std::memcmp(typ, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + clen);
    } else if (!std::memcmp(typ, "IEND", 4)) {
      break;
    }
    pos += 12 + clen;  // len + type + crc
  }
  if (!saw_ihdr || w <= 0 || h <= 0 || interlace != 0) return false;
  if (depth != 8 && depth != 16) return false;
  int channels;
  switch (ctype) {
    case 0: channels = 1; break;   // gray
    case 2: channels = 3; break;   // rgb
    case 4: channels = 2; break;   // gray+alpha
    case 6: channels = 4; break;   // rgba
    default: return false;         // palette unsupported
  }
  const int bpp = channels * (depth / 8);     // bytes per pixel
  const size_t stride = size_t(w) * bpp;      // filtered scanline payload
  std::vector<uint8_t> raw(size_t(h) * (stride + 1));
  if (!inflate_all(idat.data(), idat.size(), raw)) return false;

  img.w = w;
  img.h = h;
  img.gray.resize(size_t(w) * h);

  std::vector<uint8_t> prev(stride, 0), cur(stride);
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw.data() + size_t(y) * (stride + 1);
    const int filter = line[0];
    const uint8_t* src = line + 1;
    switch (filter) {
      case 0:
        std::memcpy(cur.data(), src, stride);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < stride; ++i)
          cur[i] = uint8_t(src[i] + (i >= size_t(bpp) ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i) cur[i] = uint8_t(src[i] + prev[i]);
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          cur[i] = uint8_t(src[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
          cur[i] = uint8_t(src[i] + paeth(a, prev[i], c));
        }
        break;
      default:
        return false;
    }
    // luma conversion; 16-bit takes the high (big-endian first) byte.
    uint8_t* dst = img.gray.data() + size_t(y) * w;
    const int step = depth / 8;
    if (channels == 1 || channels == 2) {
      for (int x = 0; x < w; ++x) dst[x] = cur[size_t(x) * bpp];
    } else {
      for (int x = 0; x < w; ++x) {
        const uint8_t* px = cur.data() + size_t(x) * bpp;
        // ITU-R BT.601 integer luma — same weights OpenCV uses.
        dst[x] = uint8_t((299 * px[0] + 587 * px[step] + 114 * px[2 * step] +
                          500) / 1000);
      }
    }
    std::swap(prev, cur);
  }
  return true;
}

bool pgm_decode_gray(const uint8_t* data, size_t len, Image& img) {
  if (len < 2 || data[0] != 'P' || data[1] != '5') return false;
  // header: "P5" ws w ws h ws maxval ws, '#' comments allowed
  size_t pos = 2;
  long vals[3];
  for (int v = 0; v < 3; ++v) {
    while (pos < len && (std::isspace(data[pos]) || data[pos] == '#')) {
      if (data[pos] == '#')
        while (pos < len && data[pos] != '\n') ++pos;
      else
        ++pos;
    }
    long x = 0;
    if (pos >= len || !std::isdigit(data[pos])) return false;
    while (pos < len && std::isdigit(data[pos])) x = x * 10 + (data[pos++] - '0');
    vals[v] = x;
  }
  ++pos;  // single whitespace after maxval
  const long w = vals[0], h = vals[1], maxv = vals[2];
  const int step = maxv > 255 ? 2 : 1;
  if (w <= 0 || h <= 0 || pos + size_t(w) * h * step > len) return false;
  img.w = int(w);
  img.h = int(h);
  img.gray.resize(size_t(w) * h);
  for (long i = 0; i < w * h; ++i) img.gray[i] = data[pos + i * step];
  return true;
}

bool read_file(const std::string& path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) { std::fclose(f); return false; }
  buf.resize(size_t(n));
  size_t rd = std::fread(buf.data(), 1, size_t(n), f);
  std::fclose(f);
  return rd == size_t(n);
}

bool decode_any(const std::vector<uint8_t>& buf, Image& img) {
  if (buf.size() > 8 && buf[0] == 0x89) return png_decode_gray(buf.data(), buf.size(), img);
  return pgm_decode_gray(buf.data(), buf.size(), img);
}

// ---------------------------------------------------------------------
// Prefetching stereo loader
// ---------------------------------------------------------------------

struct Slot {
  Image left, right;
  int frame = -1;      // which frame occupies the slot (-1 = free)
  bool ready = false;
  bool failed = false;
};

struct Loader {
  std::vector<std::string> left, right;
  int n_frames = 0;
  int capacity = 0;
  std::vector<Slot> ring;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  int next_claim = 0;     // next frame index a worker will load
  int next_consume = 0;   // next frame index the consumer wants
  std::atomic<bool> stop{false};

  void work() {
    std::vector<uint8_t> buf;
    for (;;) {
      int frame;
      Slot* slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (stop.load() || next_claim >= n_frames) return;
        frame = next_claim++;
        slot = &ring[frame % capacity];
        // wait until the frame `capacity` before this one was consumed:
        // then this slot is free, and no frame after this one can take it
        // first (waiting for the slot to be free alone lets the claimer of
        // frame + capacity take it while this frame's thread wakes, and
        // the consumer then waits for this frame for ever)
        cv_free.wait(lk, [&] {
          return stop.load() || frame < next_consume + capacity;
        });
        if (stop.load()) return;
        slot->frame = frame;
        slot->ready = false;
        slot->failed = false;
      }
      bool ok = read_file(left[frame], buf) && decode_any(buf, slot->left);
      ok = ok && read_file(right[frame], buf) && decode_any(buf, slot->right);
      {
        std::lock_guard<std::mutex> lk(mu);
        slot->ready = true;
        slot->failed = !ok;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// One-shot decode (for tests / ad-hoc use). Returns 0 ok, -1 error,
// -2 buffer too small. out receives w*h luma bytes.
int ssv_decode_gray(const uint8_t* data, long len, uint8_t* out,
                    long out_capacity, int* w, int* h) {
  Image img;
  std::vector<uint8_t> buf(data, data + len);
  if (!decode_any(buf, img)) return -1;
  *w = img.w;
  *h = img.h;
  if (long(img.gray.size()) > out_capacity) return -2;
  std::memcpy(out, img.gray.data(), img.gray.size());
  return 0;
}

int ssv_decode_file_gray(const char* path, uint8_t* out, long out_capacity,
                         int* w, int* h) {
  std::vector<uint8_t> buf;
  Image img;
  if (!read_file(path, buf) || !decode_any(buf, img)) return -1;
  *w = img.w;
  *h = img.h;
  if (long(img.gray.size()) > out_capacity) return -2;
  std::memcpy(out, img.gray.data(), img.gray.size());
  return 0;
}

void* ssv_loader_create(const char** left, const char** right, int n,
                        int n_threads, int capacity) {
  if (n <= 0 || n_threads <= 0 || capacity <= 0) return nullptr;
  Loader* ld = new Loader();
  ld->left.assign(left, left + n);
  ld->right.assign(right, right + n);
  ld->n_frames = n;
  ld->capacity = capacity;
  ld->ring.resize(capacity);
  int nt = n_threads < n ? n_threads : n;
  for (int i = 0; i < nt; ++i)
    ld->workers.emplace_back([ld] { ld->work(); });
  return ld;
}

// Blocks until the next in-order stereo pair is decoded; copies both luma
// images into out_l/out_r. Returns the frame index, -1 at end of sequence,
// -2 on decode failure (frame is skipped, call again for the next one),
// -3 if the output buffers are too small.
int ssv_loader_next(void* handle, uint8_t* out_l, uint8_t* out_r,
                    long out_capacity, int* w, int* h) {
  Loader* ld = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(ld->mu);
  if (ld->next_consume >= ld->n_frames) return -1;
  const int frame = ld->next_consume;
  Slot& slot = ld->ring[frame % ld->capacity];
  ld->cv_ready.wait(lk, [&] { return slot.frame == frame && slot.ready; });
  int rc = frame;
  if (slot.failed) {
    rc = -2;
  } else if (long(slot.left.gray.size()) > out_capacity ||
             long(slot.right.gray.size()) > out_capacity) {
    rc = -3;
  } else {
    *w = slot.left.w;
    *h = slot.left.h;
    std::memcpy(out_l, slot.left.gray.data(), slot.left.gray.size());
    std::memcpy(out_r, slot.right.gray.data(), slot.right.gray.size());
  }
  slot.frame = -1;  // free the ring slot for the workers
  ++ld->next_consume;
  lk.unlock();
  ld->cv_free.notify_all();
  return rc;
}

void ssv_loader_destroy(void* handle) {
  Loader* ld = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stop.store(true);
  }
  ld->cv_free.notify_all();
  ld->cv_ready.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
