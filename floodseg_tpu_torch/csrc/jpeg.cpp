// Baseline JPEG decoder and encoder, and PNG row unfiltering, for the host
// data path (floodseg_tpu_torch/data/image.py). Host C++, built with the
// host compiler by ops/build.py and loaded with ctypes; a ctypes call
// releases the GIL, so the loader's threads decode frames in parallel.
//
// This is the port's counterpart of what PIL (libjpeg-turbo) does for the
// JAX package (floodseg_tpu/data/dataset.py::_imread, data/synthetic.py,
// train/predict.py), and it follows libjpeg's integer algorithms so that
// its results equal PIL's:
//   decode: Huffman baseline (SOF0/SOF1, 8-bit, one scan holding every
//           component, restart markers), the ISLOW inverse DCT (jidctint.c)
//           with its post-IDCT range table, fancy h2v1/h2v2 upsampling
//           (jdsample.c, with context rows replicated at the edges) and the
//           fixed-point YCbCr->RGB tables (jdcolor.c);
//   encode: RGB -> YCbCr tables (jccolor.c), h2v2 downsampling with its
//           1,2,1,2 bias and edge replication (jcsample.c, jcprepct.c), the
//           ISLOW forward DCT (jfdctint.c), libjpeg-turbo's reciprocal
//           quantizer (jcdctmgr.c), the IJG quality scaling (jcparam.c), the
//           standard Huffman tables, and the dummy blocks of a single-pass
//           compressor at the right and bottom edges (jccoefct.c).
// Anything else (progressive, arithmetic coding, 12-bit, lossless, CMYK,
// several scans) raises.
//
// C interface: every function returns 0 (or a byte count) on success and
// a negative value on failure; floodseg_codec_error() gives the message of
// the calling thread's last failure.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct CodecError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw CodecError(what); }

const int kZigzag[64] = {  // natural index of the k-th coefficient in zigzag order
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ------------------------------------------------------------ fixed point

const int kConstBits = 13;
const int kPass1Bits = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jidctint.c's post-IDCT range table, indexed by the descaled value & 1023
inline uint8_t idct_range(int64_t v) {
  int x = int(v & 1023);
  if (x < 128) return uint8_t(x + 128);
  if (x < 512) return 255;
  if (x < 896) return 0;
  return uint8_t(x - 896);
}

// jpeg_idct_islow: coef in natural order, dequantized with q (natural);
// writes an 8x8 block of samples at out with row stride `stride`.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qc = q + c;
    int64_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int64_t dc = int64_t(in[0]) * qc[0] * (1 << kPass1Bits);
      for (int k = 0; k < 8; k++) w[8 * k] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qc[16], z3 = int64_t(in[48]) * qc[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * qc[0];
    z3 = int64_t(in[32]) * qc[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qc[56];
    tmp1 = int64_t(in[40]) * qc[40];
    tmp2 = int64_t(in[24]) * qc[24];
    tmp3 = int64_t(in[8]) * qc[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, n);
    w[56] = descale(tmp10 - tmp3, n);
    w[8] = descale(tmp11 + tmp2, n);
    w[48] = descale(tmp11 - tmp2, n);
    w[16] = descale(tmp12 + tmp1, n);
    w[40] = descale(tmp12 - tmp1, n);
    w[24] = descale(tmp13 + tmp0, n);
    w[32] = descale(tmp13 - tmp0, n);
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; r++) {
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = idct_range(descale(w[0], kPass1Bits + 3));
      for (int k = 0; k < 8; k++) o[k] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (w[0] + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (w[0] - w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_range(descale(tmp10 + tmp3, n));
    o[7] = idct_range(descale(tmp10 - tmp3, n));
    o[1] = idct_range(descale(tmp11 + tmp2, n));
    o[6] = idct_range(descale(tmp11 - tmp2, n));
    o[2] = idct_range(descale(tmp12 + tmp1, n));
    o[5] = idct_range(descale(tmp12 - tmp1, n));
    o[3] = idct_range(descale(tmp13 + tmp0, n));
    o[4] = idct_range(descale(tmp13 - tmp0, n));
  }
}

// jpeg_fdct_islow on samples already centred (x - 128); in place, output
// scaled up by 8 as the quantizer expects.
void fdct_islow(int64_t* d) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    for (int i = 0; i < 8; i++) {
      int64_t* p = d + i * next;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int n = pass ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
      if (pass) {
        p[0] = descale(tmp10 + tmp11, kPass1Bits);
        p[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      } else {
        p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        p[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      }
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] = descale(z1 + tmp13 * FIX_0_765366865, n);
      p[6 * step] = descale(z1 + tmp12 * (-FIX_1_847759065), n);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, n);
      p[5 * step] = descale(tmp5 + z2 + z4, n);
      p[3 * step] = descale(tmp6 + z2 + z3, n);
      p[step] = descale(tmp7 + z1 + z4, n);
    }
  }
}

// ------------------------------------------------------------- Huffman

struct HuffDecoder {
  bool defined = false;
  uint8_t look_len[512];  // 9-bit lookahead: code length (0: longer code)
  uint8_t look_val[512];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

void build_decoder(HuffDecoder& h, const uint8_t* bits, const uint8_t* vals, int nvals) {
  std::memset(h.look_len, 0, sizeof(h.look_len));
  std::memcpy(h.vals, vals, nvals);
  int code = 0, p = 0;
  for (int l = 1; l <= 16; l++) {
    h.valoffset[l] = p - code;
    for (int i = 0; i < bits[l - 1]; i++, p++, code++) {
      if (l <= 9) {
        int lo = code << (9 - l), n = 1 << (9 - l);
        for (int j = 0; j < n; j++) {
          h.look_len[lo + j] = uint8_t(l);
          h.look_val[lo + j] = vals[p];
        }
      }
    }
    h.maxcode[l] = bits[l - 1] ? code - 1 : -1;
    if (code > (1 << l)) fail("corrupt JPEG: bad Huffman table");
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
}

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size, size_t pos) : d_(data), n_(size), pos_(pos) {}

  int get(int nbits) {
    if (nbits == 0) return 0;
    fill(nbits);
    int v = int((acc_ >> (cnt_ - nbits)) & ((1u << nbits) - 1));
    cnt_ -= nbits;
    return v;
  }

  int decode(const HuffDecoder& h) {
    fill(16);
    int look = int((acc_ >> (cnt_ - 9)) & 511);
    if (h.look_len[look]) {
      cnt_ -= h.look_len[look];
      return h.look_val[look];
    }
    int code = int((acc_ >> (cnt_ - 16)) & 0xffff);
    for (int l = 10; l <= 16; l++) {
      int c = code >> (16 - l);
      if (c <= h.maxcode[l]) {
        cnt_ -= l;
        return h.vals[(h.valoffset[l] + c) & 0xff];
      }
    }
    fail("corrupt JPEG: bad Huffman code");
  }

  // Drop the bits left of this interval and read the RSTn marker.
  void restart(int expected) {
    cnt_ = 0;
    acc_ = 0;
    marker_ = false;
    while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0 && d_[pos_ + 1] != 0xFF))
      pos_++;
    if (pos_ + 1 >= n_ || d_[pos_ + 1] != 0xD0 + expected)
      fail("corrupt JPEG: missing restart marker");
    pos_ += 2;
  }

 private:
  void fill(int need) {
    while (cnt_ < need) {
      uint32_t byte = 0;
      if (!marker_ && pos_ < n_) {
        byte = d_[pos_];
        if (byte == 0xFF) {
          uint8_t next = pos_ + 1 < n_ ? d_[pos_ + 1] : 0xD9;
          if (next == 0x00) {
            pos_ += 2;
          } else {
            marker_ = true;  // a marker ends the entropy data: zeros from here
            byte = 0;
          }
        } else {
          pos_++;
        }
      }
      acc_ = (acc_ << 8) | byte;
      cnt_ += 8;
    }
  }

  const uint8_t* d_;
  size_t n_, pos_;
  uint64_t acc_ = 0;
  int cnt_ = 0;
  bool marker_ = false;
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ------------------------------------------------------------- decoder

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int dsw = 0, dsh = 0;        // real downsampled size
  int stride = 0, rows = 0;    // plane size (whole blocks)
  uint8_t* plane = nullptr;    // into a per-thread buffer (see kept_buffer)
};

struct Image {
  int width = 0, height = 0;
  int adobe_transform = -1;
  std::vector<Component> comps;
};

// Per-thread buffers that keep their memory between calls: freeing and
// mapping frame-sized buffers on every call serialises the loader's
// threads on the kernel's page tables.
uint8_t* kept_buffer(int slot, size_t bytes) {
  thread_local std::vector<uint8_t> buffers[16];
  if (buffers[slot].size() < bytes) buffers[slot].resize(bytes);
  return buffers[slot].data();
}

inline uint16_t be16(const uint8_t* p) { return uint16_t((p[0] << 8) | p[1]); }

// Fancy upsampling (jdsample.c) of one output row of a component plane,
// neighbours clamped to the real samples (libjpeg replicates the edge rows
// as context and special-cases the edge columns to the same values).
// ``sum`` holds dsw + 2 ints.
void upsample_row(const Component& c, int hmax, int vmax, int y, int width, uint8_t* o,
                  int* sum) {
  const int fh = hmax / c.h, fv = vmax / c.v;
  const uint8_t* p = c.plane;
  const int i = y / fv;
  const uint8_t* r0 = p + size_t(std::min(i, c.dsh - 1)) * c.stride;
  if (fh == 1 && fv == 1) {
    std::memcpy(o, r0, width);
    return;
  }
  if (fv > 2 || fh != 2) fail("unsupported JPEG: chroma sampling other than 4:4:4, 4:2:2 and 4:2:0");
  const bool fancy = c.dsw > 2;
  if (!fancy) {
    for (int x = 0; x < width; x++) o[x] = r0[std::min(x >> 1, c.dsw - 1)];
    return;
  }
  if (fv == 1) {  // h2v1
    for (int j = 0; j < c.dsw; j++) sum[j + 1] = r0[j];
    sum[0] = sum[1];
    sum[c.dsw + 1] = sum[c.dsw];
    for (int x = 0; x < width; x++) {
      const int j = (x >> 1) + 1;
      o[x] = (x & 1) ? uint8_t((3 * sum[j] + sum[j + 1] + 2) >> 2)
                     : uint8_t((3 * sum[j] + sum[j - 1] + 1) >> 2);
    }
    return;
  }
  // h2v2: column sums 3 * nearer row + further row, the edge columns repeated
  const int i2 = std::min(std::max((y & 1) ? i + 1 : i - 1, 0), c.dsh - 1);
  const uint8_t* r1 = p + size_t(i2) * c.stride;
  for (int j = 0; j < c.dsw; j++) sum[j + 1] = 3 * r0[j] + r1[j];
  sum[0] = sum[1];
  sum[c.dsw + 1] = sum[c.dsw];
  for (int x = 0; x < width; x++) {
    const int j = (x >> 1) + 1;
    o[x] = (x & 1) ? uint8_t((3 * sum[j] + sum[j + 1] + 7) >> 4)
                   : uint8_t((3 * sum[j] + sum[j - 1] + 8) >> 4);
  }
}

struct Decoder {
  const uint8_t* d;
  size_t n;
  Image img;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffDecoder dc[4], ac[4];
  int restart_interval = 0;
  bool frame = false, scanned = false;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  // Parse markers until the frame header (header_only) or through the scan.
  void run(bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    size_t pos = 2;
    while (true) {
      while (pos < n && d[pos] != 0xFF) pos++;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) fail("corrupt JPEG: truncated before the end of the image");
      int m = d[pos++];
      if (m == 0xD9) break;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (pos + 2 > n) fail("corrupt JPEG: truncated marker");
      size_t len = be16(d + pos);
      if (len < 2 || pos + len > n) fail("corrupt JPEG: bad marker length");
      const uint8_t* s = d + pos + 2;
      size_t sl = len - 2;
      if (m == 0xC0 || m == 0xC1) {
        read_frame(s, sl);
        if (header_only) return;
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        fail("unsupported JPEG: progressive");
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        fail("unsupported JPEG: lossless");
      } else if (m >= 0xC9 && m <= 0xCD) {
        fail("unsupported JPEG: arithmetic coding");
      } else if (m == 0xC5) {
        fail("unsupported JPEG: hierarchical");
      } else if (m == 0xC4) {
        read_dht(s, sl);
      } else if (m == 0xDB) {
        read_dqt(s, sl);
      } else if (m == 0xDD) {
        if (sl < 2) fail("corrupt JPEG: bad DRI");
        restart_interval = be16(s);
      } else if (m == 0xEE && sl >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
        img.adobe_transform = s[11];
      } else if (m == 0xDA) {
        if (!frame) fail("corrupt JPEG: scan before frame header");
        if (scanned) fail("unsupported JPEG: more than one scan");
        pos = read_scan(s, sl, pos + len);
        scanned = true;
        continue;
      }
      pos += len;
    }
    if (!scanned) fail("corrupt JPEG: no scan");
  }

  void read_frame(const uint8_t* s, size_t sl) {
    if (sl < 6) fail("corrupt JPEG: bad frame header");
    if (s[0] != 8) fail("unsupported JPEG: " + std::to_string(s[0]) + "-bit samples");
    img.height = be16(s + 1);
    img.width = be16(s + 3);
    int nc = s[5];
    if (img.height == 0 || img.width == 0) fail("unsupported JPEG: zero size (DNL)");
    if (nc != 1 && nc != 3) fail("unsupported JPEG: " + std::to_string(nc) + " components");
    if (sl < size_t(6 + 3 * nc)) fail("corrupt JPEG: bad frame header");
    img.comps.clear();
    for (int i = 0; i < nc; i++) {
      Component c;
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG: bad component");
      img.comps.push_back(c);
    }
    frame = true;
  }

  void read_dht(const uint8_t* s, size_t sl) {
    size_t p = 0;
    while (p < sl) {
      if (p + 17 > sl) fail("corrupt JPEG: bad DHT");
      int tc = s[p] >> 4, th = s[p] & 15;
      int total = 0;
      for (int i = 1; i <= 16; i++) total += s[p + i];
      if (tc > 1 || th > 3 || total > 256 || p + 17 + total > sl) fail("corrupt JPEG: bad DHT");
      build_decoder(tc ? ac[th] : dc[th], s + p + 1, s + p + 17, total);
      p += 17 + total;
    }
  }

  void read_dqt(const uint8_t* s, size_t sl) {
    size_t p = 0;
    while (p < sl) {
      int pq = s[p] >> 4, tq = s[p] & 15;
      size_t need = 1 + 64 * (pq ? 2 : 1);
      if (pq > 1 || tq > 3 || p + need > sl) fail("corrupt JPEG: bad DQT");
      for (int k = 0; k < 64; k++)
        qt[tq][kZigzag[k]] = pq ? be16(s + p + 1 + 2 * k) : s[p + 1 + k];
      qt_defined[tq] = true;
      p += need;
    }
  }

  size_t read_scan(const uint8_t* s, size_t sl, size_t data_pos) {
    int ns = s[0];
    if (sl < size_t(4 + 2 * ns)) fail("corrupt JPEG: bad scan header");
    if (ns != int(img.comps.size()))
      fail("unsupported JPEG: a scan without every component");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int id = s[1 + 2 * i];
      Component* c = nullptr;
      for (auto& cc : img.comps)
        if (cc.id == id) c = &cc;
      if (!c) fail("corrupt JPEG: scan names an unknown component");
      c->td = s[2 + 2 * i] >> 4;
      c->ta = s[2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
        fail("corrupt JPEG: undefined Huffman table");
      if (!qt_defined[c->tq]) fail("corrupt JPEG: undefined quantization table");
      sc.push_back(c);
    }
    if (s[1 + 2 * ns] != 0 || s[2 + 2 * ns] != 63 || s[3 + 2 * ns] != 0)
      fail("unsupported JPEG: not a sequential scan");

    int hmax = 1, vmax = 1;
    for (auto& c : img.comps) hmax = std::max(hmax, c.h), vmax = std::max(vmax, c.v);
    const int W = img.width, H = img.height;
    const bool interleaved = ns > 1;
    int mcux, mcuy;
    for (auto& c : img.comps) {
      c.dsw = (W * c.h + hmax - 1) / hmax;
      c.dsh = (H * c.v + vmax - 1) / vmax;
    }
    if (interleaved) {
      mcux = (W + 8 * hmax - 1) / (8 * hmax);
      mcuy = (H + 8 * vmax - 1) / (8 * vmax);
      for (auto& c : img.comps) {
        c.stride = mcux * c.h * 8;
        c.rows = mcuy * c.v * 8;
      }
    } else {
      Component& c = *sc[0];
      mcux = (c.dsw + 7) / 8;
      mcuy = (c.dsh + 7) / 8;
      c.stride = mcux * 8;
      c.rows = mcuy * 8;
      c.h = c.v = 1;  // one block an MCU; only the grayscale case gets here
    }
    for (size_t k = 0; k < img.comps.size(); k++) {
      Component& c = img.comps[k];
      c.plane = kept_buffer(int(k), size_t(c.stride) * c.rows);
    }

    BitReader br(d, n, data_pos);
    int pred[4] = {0, 0, 0, 0};
    int16_t coef[64];
    int todo = restart_interval, next_rst = 0;
    for (int my = 0; my < mcuy; my++) {
      for (int mx = 0; mx < mcux; mx++) {
        if (restart_interval) {
          if (todo == 0) {
            br.restart(next_rst);
            next_rst = (next_rst + 1) & 7;
            todo = restart_interval;
            std::fill(pred, pred + 4, 0);
          }
          todo--;
        }
        for (int ci = 0; ci < ns; ci++) {
          Component& c = *sc[ci];
          const HuffDecoder& hd = dc[c.td];
          const HuffDecoder& ha = ac[c.ta];
          for (int by = 0; by < c.v; by++) {
            for (int bx = 0; bx < c.h; bx++) {
              std::memset(coef, 0, sizeof(coef));
              int t = br.decode(hd);
              if (t > 11) fail("corrupt JPEG: bad DC magnitude");
              int diff = t ? extend(br.get(t), t) : 0;
              pred[ci] += diff;
              coef[0] = int16_t(pred[ci]);
              for (int k = 1; k < 64;) {
                int rs = br.decode(ha);
                int r = rs >> 4, sz = rs & 15;
                if (sz) {
                  k += r;
                  if (k > 63) fail("corrupt JPEG: coefficient index past 63");
                  coef[kZigzag[k]] = int16_t(extend(br.get(sz), sz));
                  k++;
                } else if (r == 15) {
                  k += 16;
                } else {
                  break;
                }
              }
              int row = (my * c.v + by) * 8, col = (mx * c.h + bx) * 8;
              idct_islow(coef, qt[c.tq], c.plane + size_t(row) * c.stride + col, c.stride);
            }
          }
        }
      }
    }
    // past the entropy data: the next marker
    size_t p = data_pos;
    while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0 && !(d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7)
                          && d[p + 1] != 0xFF))
      p++;
    return p;
  }
};

// jdcolor.c's fixed-point YCbCr -> RGB
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

void decode(const uint8_t* data, size_t size, uint8_t* out, int out_h, int out_w, int out_c) {
  Decoder dec(data, size);
  dec.run(false);
  Image& img = dec.img;
  const int W = img.width, H = img.height, nc = int(img.comps.size());
  if (W != out_w || H != out_h || nc != out_c) fail("JPEG size differs from its header");
  int hmax = 1, vmax = 1;
  for (auto& c : img.comps) hmax = std::max(hmax, c.h), vmax = std::max(vmax, c.v);
  if (nc == 1) {
    const Component& c = img.comps[0];
    for (int y = 0; y < H; y++) std::memcpy(out + size_t(y) * W, c.plane + size_t(y) * c.stride, W);
    return;
  }
  static const YccTables t;
  uint8_t* rows = kept_buffer(4, size_t(3) * W);
  std::vector<int> sum(size_t(W) + 2);
  for (int y = 0; y < H; y++) {
    for (int k = 0; k < 3; k++)
      upsample_row(img.comps[k], hmax, vmax, y, W, rows + size_t(k) * W, sum.data());
    uint8_t* o = out + size_t(y) * W * 3;
    const uint8_t *py = rows, *pb = rows + W, *pr = rows + 2 * W;
    if (img.adobe_transform == 0) {  // stored as RGB
      for (int x = 0; x < W; x++) o[3 * x] = py[x], o[3 * x + 1] = pb[x], o[3 * x + 2] = pr[x];
      continue;
    }
    for (int x = 0; x < W; x++) {
      int yy = py[x], cb = pb[x], cr = pr[x];
      o[3 * x] = clamp255(yy + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
    }
  }
}

// ------------------------------------------------------------- encoder

const uint8_t kLumQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                           14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                           18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                           49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChromQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                             24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                             99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                             99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// The standard Huffman tables (ITU T.81 Annex K.3): bits[16] then values.
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEncoder {
  uint16_t code[256];
  uint8_t size[256];
  HuffEncoder(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, p = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l - 1]; i++, p++, c++) {
        code[vals[p]] = uint16_t(c);
        size[vals[p]] = uint8_t(l);
      }
      c <<= 1;
    }
  }
};

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  void put(uint32_t bits, int n) {
    acc_ = (acc_ << n) | (bits & ((1u << n) - 1));
    cnt_ += n;
    while (cnt_ >= 8) {
      uint8_t b = uint8_t(acc_ >> (cnt_ - 8));
      out_.push_back(b);
      if (b == 0xFF) out_.push_back(0);
      cnt_ -= 8;
    }
  }
  void flush() {  // pad the last byte with 1-bits, as libjpeg does
    put(0x7F, 7);
    cnt_ = 0;
  }

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int cnt_ = 0;
};

inline int bit_length(int v) {
  int n = 0;
  while (v) n++, v >>= 1;
  return n;
}

// libjpeg-turbo's compute_reciprocal (jcdctmgr.c) with a 16-bit DCTELEM
struct Divisor {
  uint16_t recip, corr;
  int shift;
};

Divisor reciprocal(uint16_t divisor) {
  if (divisor == 1) return {1, 0, -16};
  int b = bit_length(divisor) - 1;
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  return {uint16_t(fq), uint16_t(c), r - 16};
}

struct QuantTable {
  uint8_t q[64];  // natural order
  Divisor div[64];
  QuantTable(const uint8_t* base, int quality) {
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; i++) {
      long t = (long(base[i]) * scale + 50) / 100;
      t = std::min(std::max(t, 1L), 255L);
      q[i] = uint8_t(t);
      div[i] = reciprocal(uint16_t(t << 3));
    }
  }
};

struct BlockCoder {
  const HuffEncoder& dc;
  const HuffEncoder& ac;
  int pred = 0;
};

void encode_block(BitWriter& bw, BlockCoder& bc, const int16_t* coef) {
  int diff = coef[0] - bc.pred;
  bc.pred = coef[0];
  int t = diff, t2 = diff;
  if (t < 0) t = -t, t2--;
  int nb = bit_length(t);
  bw.put(bc.dc.code[nb], bc.dc.size[nb]);
  if (nb) bw.put(uint32_t(t2), nb);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    int v = coef[kZigzag[k]];
    if (v == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      bw.put(bc.ac.code[0xF0], bc.ac.size[0xF0]);
      r -= 16;
    }
    t = v;
    t2 = v;
    if (t < 0) t = -t, t2--;
    nb = bit_length(t);
    int sym = (r << 4) + nb;
    bw.put(bc.ac.code[sym], bc.ac.size[sym]);
    bw.put(uint32_t(t2), nb);
    r = 0;
  }
  if (r > 0) bw.put(bc.ac.code[0], bc.ac.size[0]);
}

// forward DCT + quantize of the 8x8 block at (row, col) of a plane
void fdct_block(const uint8_t* plane, int stride, int row, int col,
                const QuantTable& qt, int16_t* coef) {
  int64_t ws[64];
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++) ws[8 * r + c] = int64_t(plane[size_t(row + r) * stride + col + c]) - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    const Divisor& dv = qt.div[i];
    int64_t t = ws[i];
    bool neg = t < 0;
    uint32_t a = uint32_t(neg ? -t : t);
    uint32_t product = (a + dv.corr) * uint32_t(dv.recip);
    product >>= dv.shift + 16;
    int16_t v = int16_t(product);
    coef[i] = neg ? int16_t(-v) : v;
  }
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v));
}

void put_dht(std::vector<uint8_t>& o, int tc_th, const uint8_t* bits, const uint8_t* vals) {
  int total = 0;
  for (int i = 0; i < 16; i++) total += bits[i];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + total);
  o.push_back(uint8_t(tc_th));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + total);
}

// RGB (H, W, 3) -> baseline 4:2:0 JFIF, as libjpeg's single-pass compressor
// writes it with the standard tables.
const std::vector<uint8_t>& encode(const uint8_t* rgb, int H, int W, int quality) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535) fail("JPEG size out of range");
  if (quality < 1 || quality > 100) fail("JPEG quality must be in 1..100");
  const QuantTable ql(kLumQ, quality), qc(kChromQ, quality);

  // jccolor.c: tables in 16-bit fixed point; Cb and Cr round with 0.5 - epsilon
  auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
  const int64_t half = int64_t(1) << 15, cbcr_off = int64_t(128) << 16;
  const size_t npix = size_t(H) * W;
  uint8_t* Y = kept_buffer(8, npix);
  uint8_t* Cb = kept_buffer(9, npix);
  uint8_t* Cr = kept_buffer(10, npix);
  for (size_t i = 0; i < npix; i++) {
    int64_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    Y[i] = uint8_t((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16);
    Cb[i] = uint8_t((-fix(0.16874) * r - fix(0.33126) * g + fix(0.50000) * b + cbcr_off + half - 1) >> 16);
    Cr[i] = uint8_t((fix(0.50000) * r - fix(0.41869) * g - fix(0.08131) * b + cbcr_off + half - 1) >> 16);
  }
  const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
  const int lbw = (W + 7) / 8, lbh = (H + 7) / 8;  // luma blocks with image data
  // luma plane over its real blocks, edges replicated
  const int ls = lbw * 8;
  uint8_t* lum = kept_buffer(11, size_t(ls) * lbh * 8);
  for (int y = 0; y < lbh * 8; y++)
    for (int x = 0; x < ls; x++)
      lum[size_t(y) * ls + x] = Y[size_t(std::min(y, H - 1)) * W + std::min(x, W - 1)];
  // chroma: 2x2 means with the 1,2,1,2 bias over the edge-replicated frame;
  // rows past ceil(H/2) repeat the last one
  const int cs = mcux * 8, crows = mcuy * 8, creal = (H + 1) / 2;
  uint8_t* cpl[2] = {kept_buffer(12, size_t(cs) * crows), kept_buffer(13, size_t(cs) * crows)};
  const uint8_t* full[2] = {Cb, Cr};
  for (int k = 0; k < 2; k++) {
    const uint8_t* f = full[k];
    auto at = [&](int y, int x) { return int(f[size_t(std::min(y, H - 1)) * W + std::min(x, W - 1)]); };
    for (int i = 0; i < crows; i++) {
      int si = std::min(i, creal - 1);
      for (int j = 0; j < cs; j++) {
        int bias = (j & 1) ? 2 : 1;
        cpl[k][size_t(i) * cs + j] = uint8_t(
            (at(2 * si, 2 * j) + at(2 * si, 2 * j + 1) + at(2 * si + 1, 2 * j) +
             at(2 * si + 1, 2 * j + 1) + bias) >> 2);
      }
    }
  }

  thread_local std::vector<uint8_t> o;  // keeps its capacity between calls
  o.clear();
  o.reserve(size_t(H) * W / 2 + 1024);
  const uint8_t jfif[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), jfif, jfif + sizeof(jfif));
  for (int t = 0; t < 2; t++) {
    const QuantTable& q = t ? qc : ql;
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(uint8_t(t));
    for (int k = 0; k < 64; k++) o.push_back(q.q[kZigzag[k]]);
  }
  const uint8_t sof[] = {0xFF, 0xC0, 0x00, 0x11, 0x08};
  o.insert(o.end(), sof, sof + sizeof(sof));
  put16(o, H);
  put16(o, W);
  const uint8_t comps[] = {3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), comps, comps + sizeof(comps));
  put_dht(o, 0x00, kDcLumBits, kDcVals);
  put_dht(o, 0x10, kAcLumBits, kAcLumVals);
  put_dht(o, 0x01, kDcChromBits, kDcVals);
  put_dht(o, 0x11, kAcChromBits, kAcChromVals);
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  o.insert(o.end(), sos, sos + sizeof(sos));

  static const HuffEncoder dcl(kDcLumBits, kDcVals), acl(kAcLumBits, kAcLumVals);
  static const HuffEncoder dcc(kDcChromBits, kDcVals), acc(kAcChromBits, kAcChromVals);
  BlockCoder coders[3] = {{dcl, acl}, {dcc, acc}, {dcc, acc}};
  BitWriter bw(o);
  const int last_col_width = lbw % 2 ? 1 : 2, last_row_height = lbh % 2 ? 1 : 2;
  int16_t blocks[4][64];
  int16_t coef[64];
  for (int my = 0; my < mcuy; my++) {
    for (int mx = 0; mx < mcux; mx++) {
      // luma: 2x2 blocks; jccoefct.c's dummy blocks past the image's blocks
      // carry zero AC and the DC of the block before them
      const int blockcnt = mx < mcux - 1 ? 2 : last_col_width;
      for (int yi = 0; yi < 2; yi++) {
        int16_t* row = blocks[2 * yi];
        if (my < mcuy - 1 || yi < last_row_height) {
          for (int bi = 0; bi < blockcnt; bi++)
            fdct_block(lum, ls, (2 * my + yi) * 8, (2 * mx + bi) * 8, ql, row + 64 * bi);
          for (int bi = blockcnt; bi < 2; bi++) {
            std::memset(row + 64 * bi, 0, 64 * sizeof(int16_t));
            row[64 * bi] = row[64 * (bi - 1)];
          }
        } else {
          for (int bi = 0; bi < 2; bi++) {
            std::memset(row + 64 * bi, 0, 64 * sizeof(int16_t));
            row[64 * bi] = blocks[2 * yi - 1][0];
          }
        }
      }
      for (int b = 0; b < 4; b++) encode_block(bw, coders[0], blocks[b]);
      for (int k = 0; k < 2; k++) {
        fdct_block(cpl[k], cs, my * 8, mx * 8, qc, coef);
        encode_block(bw, coders[1 + k], coef);
      }
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

int record(const std::exception& e) {
  g_error = e.what();
  return -1;
}

}  // namespace

extern "C" {

const char* floodseg_codec_error() { return g_error.c_str(); }

// Header of a JPEG in memory: height, width and components (1 or 3).
int floodseg_jpeg_info(const uint8_t* data, size_t size, int* h, int* w, int* c) {
  try {
    Decoder dec(data, size);
    dec.run(true);
    if (!dec.frame) fail("corrupt JPEG: no frame header");
    *h = dec.img.height;
    *w = dec.img.width;
    *c = int(dec.img.comps.size());
    return 0;
  } catch (const std::exception& e) {
    return record(e);
  }
}

// Decode into out (h, w, c) uint8, c = 3 (RGB) or 1 (grayscale).
int floodseg_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int h, int w, int c) {
  try {
    decode(data, size, out, h, w, c);
    return 0;
  } catch (const std::exception& e) {
    return record(e);
  }
}

// Encode rgb (h, w, 3) uint8 into out; returns the byte count, or -2 when
// it needs more than cap bytes, or -1 on failure.
long floodseg_jpeg_encode(const uint8_t* rgb, int h, int w, int quality, uint8_t* out,
                          size_t cap) {
  try {
    const std::vector<uint8_t>& o = encode(rgb, h, w, quality);
    if (o.size() > cap) return -2;
    std::memcpy(out, o.data(), o.size());
    return long(o.size());
  } catch (const std::exception& e) {
    return record(e);
  }
}

// PNG row filters 0-4 (PNG spec section 9) undone: data holds h rows of a
// filter-type byte and rowbytes filtered bytes; bpp is bytes a pixel.
int floodseg_png_unfilter(const uint8_t* data, int h, int rowbytes, int bpp, uint8_t* out) {
  try {
    for (int y = 0; y < h; y++) {
      const uint8_t* src = data + size_t(y) * (rowbytes + 1);
      uint8_t* cur = out + size_t(y) * rowbytes;
      const uint8_t* up = y ? cur - rowbytes : nullptr;
      int ft = src[0];
      src++;
      for (int i = 0; i < rowbytes; i++) {
        int a = i >= bpp ? cur[i - bpp] : 0;
        int b = up ? up[i] : 0;
        int c = (up && i >= bpp) ? up[i - bpp] : 0;
        int pred;
        switch (ft) {
          case 0: pred = 0; break;
          case 1: pred = a; break;
          case 2: pred = b; break;
          case 3: pred = (a + b) >> 1; break;
          case 4: {
            int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
            pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
            break;
          }
          default: fail("corrupt PNG: filter type " + std::to_string(ft));
        }
        cur[i] = uint8_t(src[i] + pred);
      }
    }
    return 0;
  } catch (const std::exception& e) {
    return record(e);
  }
}

}  // extern "C"
