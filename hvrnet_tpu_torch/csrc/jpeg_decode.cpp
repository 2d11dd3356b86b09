// jpeg_decode — baseline JPEG decoder with the arithmetic of libjpeg-turbo's
// default decompression path, so that its BGR output is bit for bit what
// cv2.imread(path, IMREAD_COLOR) gives (OpenCV decodes through libjpeg-turbo
// with JCS_EXT_BGR output and the library's defaults: the islow IDCT, fancy
// upsampling, no merged upsampler).
//
// Read: sequential 8-bit Huffman JPEG (SOF0 / SOF1); DQT with 8- and 16-bit
// tables; DHT (the standard tables stand in for missing ones, as in
// libjpeg-turbo's jinit_huff_decoder); DRI with RSTn; byte stuffing and fill
// bytes; one or several scans; one component (grey) or three (YCbCr, or RGB
// under an Adobe APP14 marker with transform 0); any integral sampling
// factors (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1).
//
// Arithmetic, after libjpeg-turbo:
// - jidctint.c's jpeg_idct_islow (two passes, CONST_BITS 13, PASS1_BITS 2)
//   as its x86-64 SIMD version computes it, in 16-bit lanes (see
//   idct_islow);
// - jdsample.c: h2v1 and h2v2 fancy upsampling where the component is more
//   than 2 samples wide (triangle filter, biases 1/2 and 8/7), h1v2 fancy
//   upsampling (biases 1 above, 2 below), plain replication otherwise; the
//   row above the first and below the last real row is that row itself;
// - jdcolor.c's fixed-point YCbCr->RGB tables (SCALEBITS 16).
//
// Refused, with the reason: progressive, lossless, hierarchical and
// arithmetic-coded files; sample precision other than 8 bits; four
// components (CMYK, YCCK) or any count but 1 and 3; fractional sampling;
// corrupt or truncated entropy data (a code that is no Huffman code, data
// that run out before the last block, bytes between the data and a marker,
// a wrong restart marker) and bad headers.  libjpeg-turbo decodes some of
// these with a warning and fills the rest with grey; this decoder stops.
//
// The EXIF orientation (tag 0x0112 of the first APP1 segment, as OpenCV's
// ExifReader reads it) is returned, not applied.
//
// C interface (ctypes):
//   jpeg_info(data, size, info[3], err, errlen) -> 0, or -1 with err set;
//       info = {height, width, EXIF orientation (0 when absent)}
//   jpeg_decode(data, size, out, height, width, err, errlen) -> 0 or -1;
//       out: height * width * 3 bytes, BGR, rows top to bottom.
// Both are reentrant: no state outside the call.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Refusal : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void refuse(const std::string& why) { throw Refusal(why); }

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------- Huffman
// The standard tables of ITU T.81 K.3, which libjpeg-turbo installs in any
// of slots 0 and 1 that a file leaves undefined (Motion-JPEG frames).
const uint8_t kStdCounts[4][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},      // DC luminance
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},      // DC chrominance
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},   // AC luminance
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};  // AC chrominance
const uint8_t kStdDcValues[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLuma[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChroma[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// A DHT table as the file gives it.
struct HuffSpec {
  bool defined = false;
  uint8_t counts[16] = {};
  uint8_t values[256] = {};
};

constexpr int kLook = 9;  // bits decoded by one table lookup

// A table ready for decoding (jdhuff.c's jpeg_make_d_derived_tbl).
struct Huffman {
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[17];  // value index = code + valoffset[length]
  uint8_t values[256];
  uint16_t fast[1 << kLook];  // (length << 8) | value, 0: longer code
};

void derive(const HuffSpec& spec, bool dc, Huffman& h) {
  int total = 0;
  for (int l = 0; l < 16; l++) total += spec.counts[l];
  if (total > 256) refuse("bad Huffman table (more than 256 codes)");
  std::memcpy(h.values, spec.values, sizeof h.values);
  std::memset(h.fast, 0, sizeof h.fast);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; l++) {
    int n = spec.counts[l - 1];
    if (n) {
      h.valoffset[l] = k - code;
      h.maxcode[l] = code + n - 1;
    } else {
      h.maxcode[l] = -1;
    }
    // no code may be all ones
    if (code + n >= (1 << l))
      refuse("bad Huffman table (code space overflow)");
    for (int i = 0; i < n; i++, code++, k++) {
      if (l <= kLook) {
        int shift = kLook - l;
        uint16_t entry = static_cast<uint16_t>((l << 8) | spec.values[k]);
        for (int j = 0; j < (1 << shift); j++)
          h.fast[(code << shift) | j] = entry;
      }
    }
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  if (dc)
    for (int i = 0; i < total; i++)
      if (h.values[i] > 15) refuse("bad Huffman table (DC value above 15)");
}

// -------------------------------------------------------------- bit reader
// Entropy-coded data: 0xFF 0x00 is a data byte 0xFF, 0xFF followed by
// 0xFF fill bytes and then any other byte is a marker, where the data end.
struct Bits {
  const uint8_t* d;
  size_t n;
  size_t pos;          // next byte to read; at a marker, its first 0xFF
  uint64_t acc = 0;    // bits, most significant first
  int count = 0;       // real bits in acc
  bool at_marker = false;

  void fill() {
    while (count <= 56 && !at_marker) {
      if (pos >= n) {
        at_marker = true;
        break;
      }
      uint8_t b = d[pos];
      if (b == 0xFF) {
        size_t q = pos + 1;
        while (q < n && d[q] == 0xFF) q++;
        if (q < n && d[q] == 0x00) {
          pos = q + 1;
        } else {
          at_marker = true;
          break;
        }
      } else {
        pos++;
      }
      acc |= static_cast<uint64_t>(b) << (56 - count);
      count += 8;
    }
  }

  int get(int s) {  // s in 1..16
    if (count < s) fill();
    if (count < s) refuse("truncated or corrupt entropy data (the data end "
                          "before the last block)");
    int v = static_cast<int>(acc >> (64 - s));
    acc <<= s;
    count -= s;
    return v;
  }

  int decode(const Huffman& h) {
    if (count < 16) fill();
    const uint16_t f = h.fast[acc >> (64 - kLook)];
    int len;
    int value;
    if (f) {
      len = f >> 8;
      value = f & 0xFF;
    } else {
      const int code16 = static_cast<int>(acc >> 48);
      len = kLook + 1;
      while (len <= 16 && (code16 >> (16 - len)) > h.maxcode[len]) len++;
      if (len > 16)
        refuse("truncated or corrupt entropy data (not a Huffman code)");
      value = h.values[(code16 >> (16 - len)) + h.valoffset[len]];
    }
    if (len > count)
      refuse("truncated or corrupt entropy data (the data end before the "
             "last block)");
    acc <<= len;
    count -= len;
    return value;
  }

  // The end of an interval or scan: what is left in the buffer is the
  // last byte's padding, and a marker follows.
  void align_to_marker() {
    if (count >= 8)
      refuse("corrupt entropy data (bytes left before a marker)");
    acc = 0;
    count = 0;
    if (pos >= n) refuse("truncated file (the data end without EOI)");
    if (d[pos] != 0xFF)
      refuse("corrupt entropy data (bytes left before a marker)");
  }

  void restart(int expected) {
    align_to_marker();
    size_t q = pos;
    while (q < n && d[q] == 0xFF) q++;
    if (q >= n) refuse("truncated file (the data end without EOI)");
    if (d[q] != 0xD0 + expected)
      refuse("corrupt entropy data (missing or wrong restart marker)");
    pos = q + 1;
    at_marker = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// --------------------------------------------------------------- the file
struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0;   // downsampled size in samples
  int wib = 0, hib = 0;        // blocks holding samples
  int bw = 0, bh = 0;          // blocks allocated (whole MCUs)
  bool scanned = false;
  uint16_t quant[64] = {};     // natural order, latched at the first scan
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // (bh * 8) rows of (bw * 8) samples
};

struct Image {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false;
  bool scanned = false;  // past the first SOS: later APPn are not read
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool seen_app1 = false;
  int orientation = 0;
  int restart_interval = 0;
  bool quant_defined[4] = {};
  uint16_t quant[4][64] = {};
  HuffSpec dc_spec[4], ac_spec[4];
  bool std_tables_installed = false;
  Component comp[3];
};

int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// Read a marker segment's length and check it fits; returns its payload.
const uint8_t* segment(Image& im, size_t& len) {
  if (im.pos + 2 > im.n) refuse("truncated file (inside a marker segment)");
  int l = u16(im.d + im.pos);
  if (l < 2 || im.pos + l > im.n)
    refuse("truncated file (inside a marker segment)");
  const uint8_t* p = im.d + im.pos + 2;
  len = static_cast<size_t>(l - 2);
  im.pos += l;
  return p;
}

// OpenCV's ExifReader: the TIFF header 6 bytes into the first APP1, IFD0's
// entries read in order until one does not fit; the orientation's value is
// the 16-bit word 8 bytes into its entry.
int exif_orientation(const uint8_t* p, size_t len) {
  if (len <= 6) return 0;
  const uint8_t* t = p + 6;
  const size_t n = len - 6;
  if (n < 2) return 0;
  bool little;
  if (t[0] == 'I' && t[1] == 'I') little = true;
  else if (t[0] == 'M' && t[1] == 'M') little = false;
  else return 0;
  auto r16 = [&](size_t o, bool& ok) -> int {
    if (o + 1 >= n) { ok = false; return 0; }
    return little ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
  };
  auto r32 = [&](size_t o, bool& ok) -> uint32_t {
    if (o + 3 >= n) { ok = false; return 0; }
    return little ? (uint32_t(t[o]) | (uint32_t(t[o + 1]) << 8) |
                     (uint32_t(t[o + 2]) << 16) | (uint32_t(t[o + 3]) << 24))
                  : ((uint32_t(t[o]) << 24) | (uint32_t(t[o + 1]) << 16) |
                     (uint32_t(t[o + 2]) << 8) | uint32_t(t[o + 3]));
  };
  bool ok = true;
  if (r16(2, ok) != 0x2A || !ok) return 0;
  size_t off = r32(4, ok);
  if (!ok) return 0;
  int entries = r16(off, ok);
  if (!ok) return 0;
  off += 2;
  for (int i = 0; i < entries; i++, off += 12) {
    int tag = r16(off, ok);
    if (!ok) return 0;
    if (tag == 0x0112) {
      int value = r16(off + 8, ok);
      return ok ? value : 0;
    }
  }
  return 0;
}

void read_app(Image& im, int marker) {
  size_t len;
  const uint8_t* p = segment(im, len);
  if (im.scanned) return;
  if (marker == 0xE0 && len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0)
    im.jfif = true;
  if (marker == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
    im.adobe = true;
    im.adobe_transform = p[11];
  }
  if (marker == 0xE1 && !im.seen_app1) {
    im.seen_app1 = true;
    im.orientation = exif_orientation(p, len);
  }
}

void read_dqt(Image& im) {
  size_t len;
  const uint8_t* p = segment(im, len);
  size_t i = 0;
  while (i < len) {
    int pq = p[i] >> 4, tq = p[i] & 15;
    i++;
    if (tq > 3) refuse("bad DQT (table id above 3)");
    if (pq > 1) refuse("bad DQT (precision)");
    size_t need = pq ? 128 : 64;
    if (i + need > len) refuse("bad DQT (short segment)");
    for (int k = 0; k < 64; k++)
      im.quant[tq][kNatural[k]] = static_cast<uint16_t>(
          pq ? u16(p + i + 2 * k) : p[i + k]);
    im.quant_defined[tq] = true;
    i += need;
  }
}

void read_dht(Image& im) {
  size_t len;
  const uint8_t* p = segment(im, len);
  size_t i = 0;
  while (i < len) {
    if (i + 17 > len) refuse("bad DHT (short segment)");
    int tc = p[i] >> 4, th = p[i] & 15;
    if (tc > 1 || th > 3) refuse("bad DHT (table class or id)");
    HuffSpec& spec = tc ? im.ac_spec[th] : im.dc_spec[th];
    int total = 0;
    for (int l = 0; l < 16; l++) {
      spec.counts[l] = p[i + 1 + l];
      total += spec.counts[l];
    }
    i += 17;
    if (total > 256 || i + total > len) refuse("bad DHT (code count)");
    std::memset(spec.values, 0, sizeof spec.values);
    std::memcpy(spec.values, p + i, total);
    spec.defined = true;
    i += total;
  }
}

void read_sof(Image& im, int marker) {
  size_t len;
  const uint8_t* p = segment(im, len);
  if (im.frame) refuse("bad file (a second frame header)");
  if (len < 6) refuse("bad SOF (short segment)");
  if (p[0] != 8)
    refuse(std::to_string(p[0]) + "-bit samples are not supported (8-bit "
                                  "baseline JPEG only)");
  im.height = u16(p + 1);
  im.width = u16(p + 3);
  im.ncomp = p[5];
  if (im.height == 0)
    refuse("a height defined by a DNL marker is not supported");
  if (im.width == 0) refuse("bad SOF (width 0)");
  // libjpeg-turbo's JPEG_MAX_DIMENSION, and cv2's limit on the pixels of
  // an image it decodes (CV_IO_MAX_IMAGE_PIXELS)
  if (im.width > 65500 || im.height > 65500)
    refuse("image larger than 65500 pixels on a side");
  if (int64_t(im.width) * im.height > (int64_t(1) << 30))
    refuse("image of more than 2^30 pixels");
  if (im.ncomp == 4)
    refuse("CMYK or YCCK JPEG (4 components) is not supported");
  if (im.ncomp != 1 && im.ncomp != 3)
    refuse(std::to_string(im.ncomp) + "-component JPEG is not supported");
  if (len < 6 + 3 * static_cast<size_t>(im.ncomp))
    refuse("bad SOF (short segment)");
  (void)marker;
  for (int c = 0; c < im.ncomp; c++) {
    Component& k = im.comp[c];
    k.id = p[6 + 3 * c];
    k.h = p[7 + 3 * c] >> 4;
    k.v = p[7 + 3 * c] & 15;
    k.tq = p[8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4)
      refuse("bad SOF (sampling factors)");
    if (k.tq > 3) refuse("bad SOF (quantisation table id)");
    im.hmax = std::max(im.hmax, k.h);
    im.vmax = std::max(im.vmax, k.v);
  }
  im.mcux = (im.width + 8 * im.hmax - 1) / (8 * im.hmax);
  im.mcuy = (im.height + 8 * im.vmax - 1) / (8 * im.vmax);
  for (int c = 0; c < im.ncomp; c++) {
    Component& k = im.comp[c];
    if (im.hmax % k.h || im.vmax % k.v)
      refuse("fractional sampling factors are not supported");
    k.width = static_cast<int>((int64_t(im.width) * k.h + im.hmax - 1) /
                               im.hmax);
    k.height = static_cast<int>((int64_t(im.height) * k.v + im.vmax - 1) /
                                im.vmax);
    k.wib = (k.width + 7) / 8;
    k.hib = (k.height + 7) / 8;
    k.bw = im.mcux * k.h;
    k.bh = im.mcuy * k.v;
  }
  im.frame = true;
}

void install_std_tables(Image& im) {
  if (im.std_tables_installed) return;
  im.std_tables_installed = true;
  for (int t = 0; t < 2; t++) {
    if (!im.dc_spec[t].defined) {
      std::memcpy(im.dc_spec[t].counts, kStdCounts[t], 16);
      std::memcpy(im.dc_spec[t].values, kStdDcValues, 12);
      im.dc_spec[t].defined = true;
    }
    if (!im.ac_spec[t].defined) {
      std::memcpy(im.ac_spec[t].counts, kStdCounts[2 + t], 16);
      std::memcpy(im.ac_spec[t].values, t ? kStdAcChroma : kStdAcLuma, 162);
      im.ac_spec[t].defined = true;
    }
  }
}

inline void decode_block(Bits& b, const Huffman& dc, const Huffman& ac,
                         int& pred, int16_t* blk) {
  int s = b.decode(dc);
  if (s) pred += extend(b.get(s), s);
  blk[0] = static_cast<int16_t>(pred);
  for (int k = 1; k < 64; k++) {
    int rs = b.decode(ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if (k > 63)
        refuse("corrupt entropy data (coefficient index beyond 63)");
      blk[kNatural[k]] = static_cast<int16_t>(extend(b.get(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// One scan: its header, then its entropy-coded data into the coefficients.
void read_scan(Image& im) {
  size_t len;
  const uint8_t* p = segment(im, len);
  if (!im.frame) refuse("bad file (SOS before SOF)");
  if (len < 1) refuse("bad SOS (short segment)");
  int ns = p[0];
  if (ns < 1 || ns > im.ncomp || len != 4 + 2 * static_cast<size_t>(ns))
    refuse("bad SOS (component count)");
  int which[3], td[3], ta[3];
  for (int i = 0; i < ns; i++) {
    int id = p[1 + 2 * i];
    which[i] = -1;
    for (int c = 0; c < im.ncomp; c++)
      if (im.comp[c].id == id) which[i] = c;
    if (which[i] < 0) refuse("bad SOS (unknown component)");
    for (int j = 0; j < i; j++)
      if (which[j] == which[i]) refuse("bad SOS (repeated component)");
    td[i] = p[2 + 2 * i] >> 4;
    ta[i] = p[2 + 2 * i] & 15;
    if (td[i] > 3 || ta[i] > 3) refuse("bad SOS (table id)");
  }
  const uint8_t* q = p + 1 + 2 * ns;
  if (q[0] != 0 || q[1] != 63 || q[2] != 0)
    refuse("bad SOS (not a sequential scan)");
  install_std_tables(im);
  Huffman dc[3], ac[3];
  int blocks_per_mcu = 0;
  for (int i = 0; i < ns; i++) {
    Component& k = im.comp[which[i]];
    if (!im.dc_spec[td[i]].defined || !im.ac_spec[ta[i]].defined)
      refuse("a scan uses an undefined Huffman table");
    derive(im.dc_spec[td[i]], true, dc[i]);
    derive(im.ac_spec[ta[i]], false, ac[i]);
    if (!k.scanned) {
      if (!im.quant_defined[k.tq])
        refuse("a component uses an undefined quantisation table");
      std::memcpy(k.quant, im.quant[k.tq], sizeof k.quant);
      k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
      k.scanned = true;
    }
    blocks_per_mcu += k.h * k.v;
  }
  if (ns > 1 && blocks_per_mcu > 10)
    refuse("sampling factors too large for an interleaved scan");

  im.scanned = true;
  Bits b{im.d, im.n, im.pos};
  int pred[3] = {0, 0, 0};
  const int ri = im.restart_interval;
  int next_rst = 0;
  long done = 0;
  auto maybe_restart = [&]() {
    if (ri && done > 0 && done % ri == 0) {
      b.restart(next_rst);
      next_rst = (next_rst + 1) & 7;
      pred[0] = pred[1] = pred[2] = 0;
    }
  };
  if (ns == 1) {
    Component& k = im.comp[which[0]];
    for (int by = 0; by < k.hib; by++)
      for (int bx = 0; bx < k.wib; bx++, done++) {
        maybe_restart();
        decode_block(b, dc[0], ac[0], pred[0],
                     &k.coef[(static_cast<size_t>(by) * k.bw + bx) * 64]);
      }
  } else {
    for (int my = 0; my < im.mcuy; my++)
      for (int mx = 0; mx < im.mcux; mx++, done++) {
        maybe_restart();
        for (int i = 0; i < ns; i++) {
          Component& k = im.comp[which[i]];
          for (int y = 0; y < k.v; y++)
            for (int x = 0; x < k.h; x++) {
              size_t by = static_cast<size_t>(my) * k.v + y;
              size_t bx = static_cast<size_t>(mx) * k.h + x;
              decode_block(b, dc[i], ac[i], pred[i],
                           &k.coef[(by * k.bw + bx) * 64]);
            }
        }
      }
  }
  b.align_to_marker();
  im.pos = b.pos;
}

// Markers up to the first SOS (header_only) or through EOI.
void parse(Image& im, bool header_only) {
  if (im.n < 2 || im.d[0] != 0xFF || im.d[1] != 0xD8)
    refuse("not a JPEG file (no SOI marker)");
  im.pos = 2;
  for (;;) {
    if (im.pos >= im.n) refuse("truncated file (the data end without EOI)");
    if (im.d[im.pos] != 0xFF)
      refuse("corrupt file (bytes between marker segments)");
    while (im.pos < im.n && im.d[im.pos] == 0xFF) im.pos++;
    if (im.pos >= im.n) refuse("truncated file (the data end without EOI)");
    int m = im.d[im.pos++];
    switch (m) {
      case 0xC0:
      case 0xC1:
        read_sof(im, m);
        break;
      case 0xC2:
        refuse("progressive JPEG (SOF2) is not supported");
      case 0xC3:
        refuse("lossless JPEG (SOF3) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        refuse("hierarchical JPEG is not supported");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCC:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        refuse("arithmetic-coded JPEG is not supported");
      case 0xC4:
        read_dht(im);
        break;
      case 0xDB:
        read_dqt(im);
        break;
      case 0xDD: {
        size_t len;
        const uint8_t* p = segment(im, len);
        if (len != 2) refuse("bad DRI segment");
        im.restart_interval = u16(p);
        break;
      }
      case 0xDA:
        if (header_only) {
          if (!im.frame) refuse("bad file (SOS before SOF)");
          return;
        }
        read_scan(im);
        break;
      case 0xD9:
        if (!im.frame) refuse("bad file (EOI before any frame)");
        return;
      case 0xFE: {
        size_t len;
        segment(im, len);
        break;
      }
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          read_app(im, m);
          break;
        }
        if (m == 0xDC) refuse("DNL markers are not supported");
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) break;  // no parameters
        {
          char buf[64];
          std::snprintf(buf, sizeof buf, "unsupported marker 0x%02X", m);
          refuse(buf);
        }
    }
  }
}

// -------------------------------------------------------------- the IDCT
// jidctint.c, jpeg_idct_islow, with 32-bit intermediates.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

// libjpeg-turbo runs jidctint.c's arithmetic in 16-bit SIMD lanes
// (jidctint-sse2.asm / -avx2.asm, the x86-64 build cv2 ships), and the lanes
// decide what happens where a value leaves 16 bits:
// - a coefficient times its quantiser keeps its low 16 bits (pmullw; the
//   quantiser is read as a signed 16-bit value);
// - the sums in0 + in4, in0 - in4, in7 + in3 and in5 + in1 wrap to 16 bits
//   (paddw); every product and every later sum is 32-bit (pmaddwd, paddd);
// - pass 1's outputs saturate to 16 bits, pass 2's to [-128, 127] before
//   the +128 level shift (packssdw, packsswb);
// - when rows 1-7 of the whole block are zero, pass 1 is the DC alone,
//   shifted in 16 bits (psllw, which wraps).
// Where no lane overflows this is exactly jidctint.c with its range-limit
// table (the same integer identities: z1 = (z2 + z3) * c folded into each
// pair's two constants); the two part only for coefficients that no
// encoder of real pixels writes, and there this follows cv2.
inline int16_t wrap16(int32_t v) {
  return static_cast<int16_t>(static_cast<uint16_t>(v));
}
inline int16_t sat16(int32_t v) {
  return static_cast<int16_t>(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}
inline int32_t add32(int32_t a, int32_t b) {  // paddd: wraps
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
inline int32_t madd(int16_t a, int32_t ca, int16_t b, int32_t cb) {
  return add32(int32_t(a) * ca, int32_t(b) * cb);  // pmaddwd
}
inline int32_t descale(int32_t x, int n) {
  return add32(x, int32_t(1) << (n - 1)) >> n;
}

// One 1-D IDCT of x[0], x[step], ..., x[7 * step] into o[0..7], before
// the descale.
inline void idct_1d(const int16_t* x, int step, int32_t* o) {
  const int16_t i0 = x[0], i1 = x[step], i2 = x[2 * step], i3 = x[3 * step];
  const int16_t i4 = x[4 * step], i5 = x[5 * step], i6 = x[6 * step];
  const int16_t i7 = x[7 * step];
  // even part
  const int32_t tmp2 = madd(i2, FIX_0_541196100, i6,
                            FIX_0_541196100 - FIX_1_847759065);
  const int32_t tmp3 = madd(i2, FIX_0_541196100 + FIX_0_765366865, i6,
                            FIX_0_541196100);
  const int32_t tmp0 = int32_t(wrap16(int32_t(i0) + i4)) * (1 << kConstBits);
  const int32_t tmp1 = int32_t(wrap16(int32_t(i0) - i4)) * (1 << kConstBits);
  const int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  const int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
  // odd part: i7, i5, i3, i1 are jidctint.c's tmp0..tmp3
  const int16_t z3 = wrap16(int32_t(i7) + i3), z4 = wrap16(int32_t(i5) + i1);
  const int32_t z3s = madd(z3, FIX_1_175875602 - FIX_1_961570560, z4,
                           FIX_1_175875602);
  const int32_t z4s = madd(z3, FIX_1_175875602, z4,
                           FIX_1_175875602 - FIX_0_390180644);
  const int32_t o0 = add32(madd(i7, FIX_0_298631336 - FIX_0_899976223, i1,
                                -FIX_0_899976223), z3s);
  const int32_t o3 = add32(madd(i7, -FIX_0_899976223, i1,
                                FIX_1_501321110 - FIX_0_899976223), z4s);
  const int32_t o1 = add32(madd(i5, FIX_2_053119869 - FIX_2_562915447, i3,
                                -FIX_2_562915447), z4s);
  const int32_t o2 = add32(madd(i5, -FIX_2_562915447, i3,
                                FIX_3_072711026 - FIX_2_562915447), z3s);
  o[0] = add32(tmp10, o3);
  o[7] = sub32(tmp10, o3);
  o[1] = add32(tmp11, o2);
  o[6] = sub32(tmp11, o2);
  o[2] = add32(tmp12, o1);
  o[5] = sub32(tmp12, o1);
  o[3] = add32(tmp13, o0);
  o[4] = sub32(tmp13, o0);
}

inline uint8_t level_shift(int32_t v) {  // packssdw, packsswb, + 128
  return static_cast<uint8_t>(v < -128 ? 0 : v > 127 ? 255 : v + 128);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                size_t stride) {
  int16_t x[64], ws[64];
  bool ac_zero = true;
  for (int i = 8; i < 64 && ac_zero; i++) ac_zero = in[i] == 0;
  for (int i = 0; i < 64; i++)
    x[i] = wrap16(int32_t(in[i]) * static_cast<int16_t>(q[i]));
  // pass 1: columns into the 16-bit workspace
  for (int c = 0; c < 8; c++) {
    if (ac_zero) {
      const int16_t v = wrap16(int32_t(x[c]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) ws[8 * r + c] = v;
      continue;
    }
    if (!x[8 + c] && !x[16 + c] && !x[24 + c] && !x[32 + c] && !x[40 + c] &&
        !x[48 + c] && !x[56 + c]) {  // what the full pass gives
      const int16_t v = sat16(int32_t(x[c]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) ws[8 * r + c] = v;
      continue;
    }
    int32_t o[8];
    idct_1d(x + c, 8, o);
    for (int r = 0; r < 8; r++)
      ws[8 * r + c] = sat16(descale(o[r], kConstBits - kPass1Bits));
  }
  // pass 2: rows into samples
  for (int r = 0; r < 8; r++) {
    const int16_t* w = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      std::memset(op, level_shift(descale(w[0], kPass1Bits + 3)), 8);
      continue;  // what the full pass gives
    }
    int32_t o[8];
    idct_1d(w, 1, o);
    for (int k = 0; k < 8; k++)
      op[k] = level_shift(descale(o[k], kConstBits + kPass1Bits + 3));
  }
}

// ------------------------------------------------------ colour conversion
// jdcolor.c's build_ycc_rgb_table.
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int32_t half = int32_t(1) << (kScale - 1);
    auto fix = [](double x) {
      return static_cast<int32_t>(x * (1 << 16) + 0.5);
    };
    for (int i = 0; i < 256; i++) {
      int32_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// One output row of a component at full resolution (jdsample.c).
void upsample_row(const Image& im, const Component& k, int y, uint8_t* out,
                  std::vector<int>& colsum) {
  const size_t stride = static_cast<size_t>(k.bw) * 8;
  const uint8_t* plane = k.plane.data();
  const int hx = im.hmax / k.h, vy = im.vmax / k.v;
  const int w = k.width;
  if (hx == 1 && vy == 1) {
    std::memcpy(out, plane + y * stride, im.width);
    return;
  }
  if (hx == 2 && vy == 1 && w > 2) {  // h2v1 fancy
    const uint8_t* in = plane + y * stride;
    out[0] = in[0];
    out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
    for (int x = 1; x < w - 1; x++) {
      const int c3 = in[x] * 3;
      out[2 * x] = static_cast<uint8_t>((c3 + in[x - 1] + 1) >> 2);
      out[2 * x + 1] = static_cast<uint8_t>((c3 + in[x + 1] + 2) >> 2);
    }
    out[2 * w - 2] =
        static_cast<uint8_t>((in[w - 1] * 3 + in[w - 2] + 1) >> 2);
    out[2 * w - 1] = in[w - 1];
    return;
  }
  if (vy == 2 && (hx == 1 || (hx == 2 && w > 2))) {  // h1v2, h2v2 fancy
    const int i = y >> 1;
    const int nb = (y & 1) ? (i + 1 < k.height ? i + 1 : k.height - 1)
                           : (i > 0 ? i - 1 : 0);
    const uint8_t* near = plane + i * stride;
    const uint8_t* far = plane + nb * stride;
    if (hx == 1) {
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < w; x++)
        out[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      return;
    }
    // column sums with the edge columns repeated: cs[-1] = cs[0],
    // cs[w] = cs[w - 1]
    int* cs = colsum.data() + 1;
    for (int x = 0; x < w; x++) cs[x] = near[x] * 3 + far[x];
    cs[-1] = cs[0];
    cs[w] = cs[w - 1];
    for (int x = 0; x < w; x++) {
      const int c3 = cs[x] * 3;
      out[2 * x] = static_cast<uint8_t>((c3 + cs[x - 1] + 8) >> 4);
      out[2 * x + 1] = static_cast<uint8_t>((c3 + cs[x + 1] + 7) >> 4);
    }
    return;
  }
  // replication: int_upsample, h2v1_upsample, h2v2_upsample
  const uint8_t* in = plane + (y / vy) * stride;
  for (int x = 0; x < im.width; x++) out[x] = in[x / hx];
}

void render(const Image& im, uint8_t* out) {
  // the color space: jdapimin.c's default_decompress_parms
  bool rgb = false;
  if (im.ncomp == 3 && !im.jfif && im.adobe) {
    rgb = im.adobe_transform == 0;
  } else if (im.ncomp == 3 && !im.jfif && !im.adobe) {
    rgb = im.comp[0].id == 'R' && im.comp[1].id == 'G' &&
          im.comp[2].id == 'B';
  }
  const size_t row_len = static_cast<size_t>(im.width) + 16;
  std::vector<uint8_t> rows(row_len * im.ncomp);
  std::vector<int> colsum(static_cast<size_t>(im.width) + 16);
  for (int y = 0; y < im.height; y++) {
    uint8_t* r[3];
    for (int c = 0; c < im.ncomp; c++) {
      r[c] = rows.data() + c * row_len;
      upsample_row(im, im.comp[c], y, r[c], colsum);
    }
    uint8_t* o = out + static_cast<size_t>(y) * im.width * 3;
    if (im.ncomp == 1) {
      for (int x = 0; x < im.width; x++)
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r[0][x];
    } else if (rgb) {
      for (int x = 0; x < im.width; x++) {
        o[3 * x] = r[2][x];
        o[3 * x + 1] = r[1][x];
        o[3 * x + 2] = r[0][x];
      }
    } else {
      for (int x = 0; x < im.width; x++) {
        int yy = r[0][x], cb = r[1][x], cr = r[2][x];
        o[3 * x] = clamp255(yy + kYcc.cb_b[cb]);
        o[3 * x + 1] =
            clamp255(yy + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + kYcc.cr_r[cr]);
      }
    }
  }
}

void decode_all(Image& im, uint8_t* out, int height, int width) {
  parse(im, false);
  if (im.height != height || im.width != width)
    refuse("the output size differs from the file's");
  for (int c = 0; c < im.ncomp; c++) {
    Component& k = im.comp[c];
    if (!k.scanned) refuse("a component has no scan");
    const size_t stride = static_cast<size_t>(k.bw) * 8;
    k.plane.assign(stride * k.bh * 8, 0);
    for (int by = 0; by < k.hib; by++)
      for (int bx = 0; bx < k.wib; bx++)
        idct_islow(&k.coef[(static_cast<size_t>(by) * k.bw + bx) * 64],
                   k.quant, &k.plane[by * 8 * stride + bx * 8], stride);
    std::vector<int16_t>().swap(k.coef);
  }
  render(im, out);
}

void set_error(char* err, int errlen, const char* what) {
  if (err && errlen > 0) {
    std::strncpy(err, what, errlen - 1);
    err[errlen - 1] = '\0';
  }
}

}  // namespace

extern "C" {

int jpeg_info(const uint8_t* data, size_t size, int* info, char* err,
              int errlen) {
  try {
    Image im;
    im.d = data;
    im.n = size;
    parse(im, true);
    info[0] = im.height;
    info[1] = im.width;
    info[2] = im.orientation;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int height,
                int width, char* err, int errlen) {
  try {
    Image im;
    im.d = data;
    im.n = size;
    decode_all(im, out, height, width);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
