// Native host-IO runtime of the port: MJPEG-AVI demux and decode, and
// batch PNG decode, straight into one preallocated [N, H, W, 3] uint8 BGR
// buffer, with every frame or file of a batch decoded on its own thread.
//
// It needs no codec library: the JPEG decoder, the inflate and the
// PNG decoder below use the C++ standard library and POSIX only, so the
// file builds with a bare g++ (io/fastio.py compiles it at first use with
// g++ -O3 -shared -fPIC -std=c++17 -pthread).
//
// The JPEG decoder reproduces, integer for integer, libjpeg-turbo 2.1.5 with
// out_color_space = JCS_EXT_BGR, do_fancy_upsampling = FALSE and the
// default ISLOW IDCT (the JAX package's native/fastio.cpp), damaged frames
// included:
//   * markers as jdmarker.c reads them from a memory source, which feeds
//     fake EOI markers (FF D9 FF D9 ...) past the end of the data; a DQT
//     table always takes 64 entries, and a DAC sets the arithmetic
//     conditioning (L, U, K) of its tables;
//   * Huffman decode as jdhuff.c, with the standard tables of ITU-T T.81
//     Annex K.3 where a sequential frame carries no DHT (jstdhuff.c: MJPEG
//     omits them; the progressive decoder fills none);
//     a segment that runs out of data decodes as zero bits, and its later
//     MCUs as zero blocks, until the next restart marker;
//   * arithmetic decode as jdarith.c, with jaricom.c's probability table:
//     past a marker the decoder reads zero bytes and goes on decoding, and
//     after a bad code (a magnitude or a run past the band) it skips the
//     MCUs left in the segment;
//   * the ISLOW IDCT as the library runs it on x86 (idct_islow below);
//   * chroma replicated to full size (int_upsample, and the merged
//     upsampler, which gives the same values);
//   * YCbCr -> BGR with jdcolor.c's fixed-point tables (SCALEBITS 16);
//   * the colour space guessed as jdapimin.c does (JFIF, Adobe transform,
//     component ids); greyscale replicated to BGR.
//   * progressive frames (SOF2, SOF10), and sequential ones of several
//     scans, decoded into a whole frame of coefficients (jdcoefct.c's
//     buffered mode): for progressive ones the DC and AC first scans and
//     their successive-approximation refinements (jdphuff.c: EOB runs), the
//     scan header's checks, then, before the IDCT, jdcoefct.c's block
//     smoothing (on by default in libjpeg), which predicts the low
//     coefficients that the frame's scans have not yet given in full (a
//     frame cut short).
// It takes 8-bit frames, Huffman (SOF0, SOF1, SOF2) and arithmetic (SOF9,
// SOF10): those libjpeg-turbo 2.1.5 decodes. Any other frame returns
// kErrSof minus (precision << 8 | SOF marker), so that the caller can name
// it.
//
// The PNG decoder reproduces libpng with the transforms the JAX decoder
// asks for: strip_16, palette_to_rgb, expand_gray_1_2_4_to_8,
// tRNS_to_alpha, gray_to_rgb, strip_alpha and bgr. tRNS only adds an alpha
// channel that strip_alpha drops again, so it never changes a pixel and is
// skipped like any other ancillary chunk.

#include <sys/stat.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrShape = -3;
constexpr int kErrSof = -0x10000;

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(n > 0 ? static_cast<size_t>(n) : 0);
  bool ok = n >= 0 &&
            std::fread(out->data(), 1, out->size(), f) == out->size();
  std::fclose(f);
  return ok;
}

// --------------------------------------------------------------- JPEG ----

// Zigzag index -> natural (row-major) index, with 16 extra entries so that
// a corrupt run past coefficient 63 lands on 63 (libjpeg's
// jpeg_natural_order).
constexpr uint8_t kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ITU-T T.81 Annex K.3: code counts per length 1..16, then the symbols.
constexpr uint8_t kStdDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1,
                                        1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kStdDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                          1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                        5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kStdAcLumaVals[162] = {
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
constexpr uint8_t kStdAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                          7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kStdAcChromaVals[162] = {
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

// A DHT table as the file gives it: bits[l] codes of length l (1..16).
struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

void set_spec(HuffSpec* s, const uint8_t* bits, const uint8_t* vals) {
  s->defined = true;
  int n = 0;
  for (int l = 1; l <= 16; ++l) n += s->bits[l] = bits[l - 1];
  std::memset(s->vals, 0, sizeof s->vals);
  std::memcpy(s->vals, vals, n);
}

constexpr int kLook = 9;  // bits of the one-step lookup

// Decoding tables (jdhuff.c jpeg_make_d_derived_tbl).
struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t fast[1 << kLook];  // (length << 8) | symbol, 0: longer code
  // An AC code and its extra bits within kLook bits, resolved at once:
  // (coefficient << 16) | (run << 8) | bits consumed; 0: take `fast`.
  int32_t fast_ac[1 << kLook];
  uint8_t vals[256];
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

bool build_table(const HuffSpec& s, bool dc, HuffTable* t) {
  int size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (p + s.bits[l] > 256) return false;
    for (int i = 0; i < s.bits[l]; ++i) size[p++] = l;
  }
  size[p] = 0;
  const int n = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    // no code may be all ones
    if (c >= (1u << si)) return false;
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (s.bits[l]) {
      t->valoffset[l] = p - static_cast<int32_t>(code[p]);
      p += s.bits[l];
      t->maxcode[l] = static_cast<int32_t>(code[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;  // ends the search of a bad code at 17 bits
  std::memcpy(t->vals, s.vals, sizeof t->vals);
  std::memset(t->fast, 0, sizeof t->fast);
  p = 0;
  for (int l = 1; l <= kLook; ++l) {
    for (int i = 0; i < s.bits[l]; ++i, ++p) {
      uint32_t first = code[p] << (kLook - l);
      for (uint32_t k = 0; k < (1u << (kLook - l)); ++k)
        t->fast[first + k] = static_cast<uint16_t>((l << 8) | s.vals[p]);
    }
  }
  for (uint32_t i = 0; i < (1u << kLook); ++i) {
    const int len = t->fast[i] >> 8, rs = t->fast[i] & 0xFF, run = rs >> 4, size = rs & 15;
    t->fast_ac[i] = 0;
    if (len && size && len + size <= kLook) {
      const int v = extend(static_cast<int>((i >> (kLook - len - size)) & ((1u << size) - 1)), size);
      t->fast_ac[i] = static_cast<int32_t>(static_cast<uint32_t>(v) << 16) | (run << 8) | (len + size);
    }
  }
  if (dc)
    for (int i = 0; i < n; ++i)
      if (s.vals[i] > 15) return false;
  return true;
}

// The byte at `pos` of a frame of `size` bytes. Past the end, libjpeg's
// memory source feeds fake EOI markers, FF D9 FF D9 ...
inline int frame_byte(const uint8_t* data, size_t size, size_t pos) {
  return pos < size ? data[pos] : (pos - size) & 1 ? 0xD9 : 0xFF;
}

// The next byte of a scan's entropy-coded data, as both of libjpeg's
// entropy decoders read it: 0xFF00 is a 0xFF byte, fill 0xFFs are skipped,
// and a marker stops the data: it is kept in *marker (libjpeg's
// unread_marker), and from there on every byte reads as 0.
inline int scan_byte(const uint8_t* data, size_t size, size_t* pos, int* marker) {
  if (*marker) return 0;
  int c = frame_byte(data, size, (*pos)++);
  if (c != 0xFF) return c;
  do c = frame_byte(data, size, (*pos)++);
  while (c == 0xFF);
  if (c == 0) return 0xFF;
  *marker = c;
  return 0;
}

// The entropy-coded bits of one scan, MSB first, as jdhuff.c's bit buffer
// sees them (scan_byte's bytes).
struct Bits {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t acc = 0;  // the next n bits, left-aligned
  int n = 0;
  int pad = 0;     // how many of those n are zeros given past a marker
  int marker = 0;  // libjpeg's unread_marker: the marker that stopped us
  // a zero bit past a marker was consumed: the MCUs that follow stay zero
  // until the next restart (libjpeg's insufficient_data)
  bool insufficient = false;

  int byte() {
    const int c = scan_byte(data, size, &pos, &marker);
    if (marker) pad += 8;
    return c;
  }

  void fill() {
    while (n <= 56) {
      acc |= static_cast<uint64_t>(byte()) << (56 - n);
      n += 8;
    }
  }

  uint32_t peek(int k) const { return static_cast<uint32_t>(acc >> (64 - k)); }

  void skip(int k) {
    acc <<= k;
    n -= k;
    if (pad > n) {
      insufficient = true;
      pad = n;
    }
  }

  int get(int k) {
    int v = static_cast<int>(peek(k));
    skip(k);
    return v;
  }

  int bit() {
    if (n < 32) fill();
    return get(1);
  }

  // Forget the bits left in the buffer (at a restart or the end of a scan).
  void discard() {
    acc = 0;
    n = 0;
    pad = 0;
  }

  // Past a restart marker the data goes on, unless a marker still stands.
  void restarted() {
    if (marker == 0) insufficient = false;
  }
};

inline int huff_decode(Bits& b, const HuffTable& t) {
  if (b.n < 32) b.fill();
  int e = t.fast[b.peek(kLook)];
  if (e) {
    b.skip(e >> 8);
    return e & 0xFF;
  }
  int l = kLook + 1;
  int32_t code = static_cast<int32_t>(b.peek(l));
  while (code > t.maxcode[l]) code = static_cast<int32_t>(b.peek(++l));
  b.skip(l);
  if (l > 16) return 0;  // a bad code decodes as 0, as in libjpeg
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

// One block's coefficients, in natural order, into blk (zeroed by the
// caller). huff_decode leaves at least 15 bits in the buffer, enough for
// any symbol's extra bits.
void decode_block(Bits& b, const HuffTable& dc, const HuffTable& ac,
                  int* pred, int16_t* blk) {
  int s = huff_decode(b, dc);
  if (s) *pred = static_cast<int>(static_cast<uint32_t>(*pred) +
                                  static_cast<uint32_t>(extend(b.get(s), s)));
  blk[0] = static_cast<int16_t>(*pred);
  for (int k = 1; k < 64; ++k) {
    if (b.n < 32) b.fill();
    const int32_t f = ac.fast_ac[b.peek(kLook)];
    if (f) {
      b.skip(f & 0xFF);
      k += (f >> 8) & 0xFF;
      blk[kNatural[k]] = static_cast<int16_t>(f >> 16);
      continue;
    }
    int rs = huff_decode(b, ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = static_cast<int16_t>(extend(b.get(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// jaricom.c's jpeg_aritab, ITU-T T.81 Table D.2: per state, Qe in bits
// 16..31, the next state after an MPS in bits 8..15, the switch-MPS flag in
// bit 7 and the next state after an LPS in bits 0..6. State 113 is a fixed
// probability of one half (ITU-T T.851).
#define OFC_QE(qe, lps, mps, swap) ((static_cast<int32_t>(qe) << 16) | ((mps) << 8) | ((swap) << 7) | (lps))
constexpr int32_t kAritab[113 + 1] = {
    OFC_QE(0x5a1d, 1, 1, 1),     OFC_QE(0x2586, 14, 2, 0),    OFC_QE(0x1114, 16, 3, 0),
    OFC_QE(0x080b, 18, 4, 0),    OFC_QE(0x03d8, 20, 5, 0),    OFC_QE(0x01da, 23, 6, 0),
    OFC_QE(0x00e5, 25, 7, 0),    OFC_QE(0x006f, 28, 8, 0),    OFC_QE(0x0036, 30, 9, 0),
    OFC_QE(0x001a, 33, 10, 0),   OFC_QE(0x000d, 35, 11, 0),   OFC_QE(0x0006, 9, 12, 0),
    OFC_QE(0x0003, 10, 13, 0),   OFC_QE(0x0001, 12, 13, 0),   OFC_QE(0x5a7f, 15, 15, 1),
    OFC_QE(0x3f25, 36, 16, 0),   OFC_QE(0x2cf2, 38, 17, 0),   OFC_QE(0x207c, 39, 18, 0),
    OFC_QE(0x17b9, 40, 19, 0),   OFC_QE(0x1182, 42, 20, 0),   OFC_QE(0x0cef, 43, 21, 0),
    OFC_QE(0x09a1, 45, 22, 0),   OFC_QE(0x072f, 46, 23, 0),   OFC_QE(0x055c, 48, 24, 0),
    OFC_QE(0x0406, 49, 25, 0),   OFC_QE(0x0303, 51, 26, 0),   OFC_QE(0x0240, 52, 27, 0),
    OFC_QE(0x01b1, 54, 28, 0),   OFC_QE(0x0144, 56, 29, 0),   OFC_QE(0x00f5, 57, 30, 0),
    OFC_QE(0x00b7, 59, 31, 0),   OFC_QE(0x008a, 60, 32, 0),   OFC_QE(0x0068, 62, 33, 0),
    OFC_QE(0x004e, 63, 34, 0),   OFC_QE(0x003b, 32, 35, 0),   OFC_QE(0x002c, 33, 9, 0),
    OFC_QE(0x5ae1, 37, 37, 1),   OFC_QE(0x484c, 64, 38, 0),   OFC_QE(0x3a0d, 65, 39, 0),
    OFC_QE(0x2ef1, 67, 40, 0),   OFC_QE(0x261f, 68, 41, 0),   OFC_QE(0x1f33, 69, 42, 0),
    OFC_QE(0x19a8, 70, 43, 0),   OFC_QE(0x1518, 72, 44, 0),   OFC_QE(0x1177, 73, 45, 0),
    OFC_QE(0x0e74, 74, 46, 0),   OFC_QE(0x0bfb, 75, 47, 0),   OFC_QE(0x09f8, 77, 48, 0),
    OFC_QE(0x0861, 78, 49, 0),   OFC_QE(0x0706, 79, 50, 0),   OFC_QE(0x05cd, 48, 51, 0),
    OFC_QE(0x04de, 50, 52, 0),   OFC_QE(0x040f, 50, 53, 0),   OFC_QE(0x0363, 51, 54, 0),
    OFC_QE(0x02d4, 52, 55, 0),   OFC_QE(0x025c, 53, 56, 0),   OFC_QE(0x01f8, 54, 57, 0),
    OFC_QE(0x01a4, 55, 58, 0),   OFC_QE(0x0160, 56, 59, 0),   OFC_QE(0x0125, 57, 60, 0),
    OFC_QE(0x00f6, 58, 61, 0),   OFC_QE(0x00cb, 59, 62, 0),   OFC_QE(0x00ab, 61, 63, 0),
    OFC_QE(0x008f, 61, 32, 0),   OFC_QE(0x5b12, 65, 65, 1),   OFC_QE(0x4d04, 80, 66, 0),
    OFC_QE(0x412c, 81, 67, 0),   OFC_QE(0x37d8, 82, 68, 0),   OFC_QE(0x2fe8, 83, 69, 0),
    OFC_QE(0x293c, 84, 70, 0),   OFC_QE(0x2379, 86, 71, 0),   OFC_QE(0x1edf, 87, 72, 0),
    OFC_QE(0x1aa9, 87, 73, 0),   OFC_QE(0x174e, 72, 74, 0),   OFC_QE(0x1424, 72, 75, 0),
    OFC_QE(0x119c, 74, 76, 0),   OFC_QE(0x0f6b, 74, 77, 0),   OFC_QE(0x0d51, 75, 78, 0),
    OFC_QE(0x0bb6, 77, 79, 0),   OFC_QE(0x0a40, 77, 48, 0),   OFC_QE(0x5832, 80, 81, 1),
    OFC_QE(0x4d1c, 88, 82, 0),   OFC_QE(0x438e, 89, 83, 0),   OFC_QE(0x3bdd, 90, 84, 0),
    OFC_QE(0x34ee, 91, 85, 0),   OFC_QE(0x2eae, 92, 86, 0),   OFC_QE(0x299a, 93, 87, 0),
    OFC_QE(0x2516, 86, 71, 0),   OFC_QE(0x5570, 88, 89, 1),   OFC_QE(0x4ca9, 95, 90, 0),
    OFC_QE(0x44d9, 96, 91, 0),   OFC_QE(0x3e22, 97, 92, 0),   OFC_QE(0x3824, 99, 93, 0),
    OFC_QE(0x32b4, 99, 94, 0),   OFC_QE(0x2e17, 93, 86, 0),   OFC_QE(0x56a8, 95, 96, 1),
    OFC_QE(0x4f46, 101, 97, 0),  OFC_QE(0x47e5, 102, 98, 0),  OFC_QE(0x41cf, 103, 99, 0),
    OFC_QE(0x3c3d, 104, 100, 0), OFC_QE(0x375e, 99, 93, 0),   OFC_QE(0x5231, 105, 102, 0),
    OFC_QE(0x4c0f, 106, 103, 0), OFC_QE(0x4639, 107, 104, 0), OFC_QE(0x415e, 103, 99, 0),
    OFC_QE(0x5627, 105, 106, 1), OFC_QE(0x50e7, 108, 107, 0), OFC_QE(0x4b85, 109, 103, 0),
    OFC_QE(0x5597, 110, 109, 0), OFC_QE(0x504f, 111, 107, 0), OFC_QE(0x5a10, 110, 111, 1),
    OFC_QE(0x5522, 112, 109, 0), OFC_QE(0x59eb, 112, 111, 1), OFC_QE(0x5a1d, 113, 113, 0)};
#undef OFC_QE

// jdarith.c's QM decoder over one scan's bytes (scan_byte's, one at a
// time: where it stops is where libjpeg's marker reader goes on). A bin is
// a state index with the MPS in bit 7.
struct Arith {
  const uint8_t* data;
  size_t size;
  size_t pos;
  int marker = 0;  // libjpeg's unread_marker
  int64_t c = 0;   // the C register: the interval's base and the bit buffer
  int64_t a = 0;   // the A register: the interval's size
  int ct = -16;    // bits left in C's buffer; -16: two bytes to read; -1: a bad code
  uint8_t fixed = 113;  // the bin of probability one half

  // A restart or a new scan: read two bytes afresh.
  void discard() {
    c = 0;
    a = 0;
    ct = -16;
  }

  void restarted() {}

  // One decision in bin *st (T.81 D.2.4 to D.2.6), and the bin's update.
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | scan_byte(data, size, &pos, &marker);
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the first two bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAritab[sv & 0x7F];
    const int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
    qe >>= 16;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // The search of a magnitude category (T.81 F.23) from bin *st on, with
  // *m its first bound; *st is left at the bin that ended it. False where
  // the category overflows (libjpeg's JWRN_ARITH_BAD_CODE): then ct = -1,
  // and the rest of the segment is skipped.
  bool category(uint8_t** st, int* m) {
    while (decode(*st)) {
      if ((*m <<= 1) == 0x8000) {
        ct = -1;
        return false;
      }
      ++*st;
    }
    return true;
  }

  // A value of category m from its bits (F.24), 14 bins past st, signed.
  int value(uint8_t* st, int m, int sign) {
    int x = m;
    st += 14;
    while (m >>= 1)
      if (decode(st)) x |= m;
    x += 1;
    return sign ? -x : x;
  }

  // A DC difference (F.19) in the bins dc[64] of one conditioning table,
  // with *context the component's conditioning from its last difference
  // (F.1.4.4.1.2, bounds L and U).
  bool dc_diff(uint8_t* dc, int* context, int L, int U, int* v) {
    uint8_t* st = dc + *context;
    if (!decode(st)) {
      *context = 0;
      *v = 0;
      return true;
    }
    const int sign = decode(st + 1);
    st += 2 + sign;
    int m = decode(st);
    if (m) {
      st = dc + 20;  // X1
      if (!category(&st, &m)) return false;
    }
    *context = m < (1 << L) >> 1 ? 0 : m > (1 << U) >> 1 ? 12 + sign * 4 : 4 + sign * 4;
    *v = value(st, m, sign);
    return true;
  }

  // The AC coefficients ss..se of one block (F.20) in the bins ac[256] of
  // one conditioning table (split at K), shifted left by al, into blk.
  bool ac_first(uint8_t* ac, int K, int ss, int se, int al, int16_t* blk) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac + 3 * (k - 1);
      if (decode(st)) break;  // end of block
      while (!decode(st + 1)) {
        st += 3;
        if (++k > se) {
          ct = -1;  // past the band
          return false;
        }
      }
      const int sign = decode(&fixed);
      st += 2;
      int m = decode(st);
      if (m && decode(st)) {
        m = 2;
        st = ac + (k <= K ? 189 : 217);  // X2 of the lower or the upper bins
        if (!category(&st, &m)) return false;
      }
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(value(st, m, sign)) << al);
    }
    return true;
  }

  // A refinement of the AC coefficients ss..se (jdarith.c
  // decode_mcu_AC_refine): a correction bit for each already nonzero one,
  // and the newly nonzero ones, +-1 << al.
  bool ac_refine(uint8_t* ac, int ss, int se, int al, int16_t* blk) {
    const int p1 = 1 << al, m1 = -p1;
    int kex = se;  // the band's last nonzero coefficient before this scan
    while (kex > 0 && !blk[kNatural[kex]]) --kex;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac + 3 * (k - 1);
      if (k > kex && decode(st)) break;  // end of block
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (decode(st + 1)) {
          *coef = static_cast<int16_t>(decode(&fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ct = -1;
          return false;
        }
      }
    }
    return true;
  }
};

// The ISLOW inverse DCT as libjpeg-turbo runs it on x86 (its SIMD
// jsimd_idct_islow, which the JAX decoder's library takes): jidctint.c's
// arithmetic (CONST_BITS 13, PASS1_BITS 2) with its multiplications folded
// into pairs of 16-bit products, the coefficients dequantized and four sums
// formed in 16-bit lanes, 32-bit accumulators, the first pass's outputs
// saturated to 16 bits and the samples clamped to 0..255. On every frame an
// encoder writes this equals jidctint.c bit for bit; on corrupt data it is
// what the library gives, where jidctint.c's RANGE_MASK table would wrap.
inline int32_t wrap16(uint32_t v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }

inline int32_t descale(uint32_t x, int n) {
  return static_cast<int32_t>(x + (1u << (n - 1))) >> n;
}

inline uint8_t clamp_sample(int32_t v) {
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// Vector code, built twice, for AVX2 and for any x86-64, and picked when
// the library loads. Both are the same integer arithmetic, so the bytes do
// not depend on the host.
#if defined(__x86_64__) && defined(__GNUC__)
#define OFC_VECTOR __attribute__((target_clones("avx2", "default")))
#else
#define OFC_VECTOR
#endif

// GCC vector types: eight 32-bit lanes (one AVX2 register, two SSE2 ones).
// They pass by value only between internal functions of this file (g++'s
// note on the 32-byte vector ABI concerns no caller outside it).
typedef int32_t v8i __attribute__((vector_size(32)));
typedef uint32_t v8u __attribute__((vector_size(32)));
typedef int16_t v8s __attribute__((vector_size(16)));
typedef uint8_t v8b __attribute__((vector_size(8)));

inline v8i wrap16v(v8u v) { return (v8i)(v << 16) >> 16; }

// Eight 8-point passes at once: lane l of in[k] is input k of pass l; out[k]
// gets the 32-bit sums that jidctint.c descales into output k.
inline void idct_pass(const v8i in[8], v8u out[8]) {
  const v8u d0 = (v8u)(in[0]), d1 = (v8u)(in[1]), d2 = (v8u)(in[2]),
            d3 = (v8u)(in[3]), d4 = (v8u)(in[4]), d5 = (v8u)(in[5]),
            d6 = (v8u)(in[6]), d7 = (v8u)(in[7]);
  constexpr uint32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                     F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                     F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  const v8u tmp2 = d2 * F0541 + d6 * (F0541 - F1847);
  const v8u tmp3 = d2 * (F0541 + F0765) + d6 * F0541;
  const v8u tmp0 = (v8u)(wrap16v(d0 + d4)) << 13;
  const v8u tmp1 = (v8u)(wrap16v(d0 - d4)) << 13;
  const v8u tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const v8u z3 = (v8u)(wrap16v(d7 + d3)), z4 = (v8u)(wrap16v(d5 + d1));
  const v8u zz3 = z3 * (F1175 - F1961) + z4 * F1175, zz4 = z3 * F1175 + z4 * (F1175 - F0390);
  const v8u o0 = d7 * (F0298 - F0899) - d1 * F0899 + zz3, o1 = d5 * (F2053 - F2562) - d3 * F2562 + zz4;
  const v8u o2 = d3 * (F3072 - F2562) - d5 * F2562 + zz3, o3 = d1 * (F1501 - F0899) - d7 * F0899 + zz4;
  out[0] = tmp10 + o3; out[7] = tmp10 - o3; out[1] = tmp11 + o2; out[6] = tmp11 - o2;
  out[2] = tmp12 + o1; out[5] = tmp12 - o1; out[3] = tmp13 + o0; out[4] = tmp13 - o0;
}

// 8x8 transpose of rows r[0..7] (unpack 32, unpack 64, swap 128-bit halves).
inline void transpose8(v8i r[8]) {
  v8i t[8], u[8];
  for (int i = 0; i < 8; i += 2) {
    t[i] = __builtin_shuffle(r[i], r[i + 1], v8i{0, 8, 1, 9, 4, 12, 5, 13});
    t[i + 1] = __builtin_shuffle(r[i], r[i + 1], v8i{2, 10, 3, 11, 6, 14, 7, 15});
  }
  for (int i = 0; i < 8; i += 4) {
    u[i] = __builtin_shuffle(t[i], t[i + 2], v8i{0, 1, 8, 9, 4, 5, 12, 13});
    u[i + 1] = __builtin_shuffle(t[i], t[i + 2], v8i{2, 3, 10, 11, 6, 7, 14, 15});
    u[i + 2] = __builtin_shuffle(t[i + 1], t[i + 3], v8i{0, 1, 8, 9, 4, 5, 12, 13});
    u[i + 3] = __builtin_shuffle(t[i + 1], t[i + 3], v8i{2, 3, 10, 11, 6, 7, 14, 15});
  }
  for (int i = 0; i < 4; ++i) {
    r[i] = __builtin_shuffle(u[i], u[i + 4], v8i{0, 1, 2, 3, 8, 9, 10, 11});
    r[i + 4] = __builtin_shuffle(u[i], u[i + 4], v8i{4, 5, 6, 7, 12, 13, 14, 15});
  }
}

inline v8i descale_v(v8u x, int n) { return (v8i)(x + (1u << (n - 1))) >> n; }

// Dequantize one block, inverse-DCT it, level-shift and clamp it into 8
// rows of `out`, `stride` bytes apart: the columns' pass with lanes for
// columns, a transpose, the rows' pass with lanes for rows, a transpose.
OFC_VECTOR void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  v8i rows[8];
  v8s ac = {};
  for (int k = 0; k < 8; ++k) {
    v8s c, m;
    std::memcpy(&c, in + 8 * k, 16);
    std::memcpy(&m, q + 8 * k, 16);
    if (k) ac |= c;
    rows[k] = wrap16v((v8u)(__builtin_convertvector(c, v8i) * __builtin_convertvector(m, v8i)));
  }
  v8i ws[8];
  bool acz = true;
  for (int l = 0; l < 8; ++l) acz &= ac[l] == 0;
  bool dc_only = acz;
  for (int l = 1; l < 8; ++l) dc_only &= in[l] == 0;
  if (dc_only) {
    // every pass gives the DC alone: one value fills the block
    const int32_t w = wrap16(static_cast<uint32_t>(rows[0][0]) << 2);
    const uint8_t v = clamp_sample(descale(static_cast<uint32_t>(w), 5));
    for (int r = 0; r < 8; ++r) std::memset(out + static_cast<size_t>(r) * stride, v, 8);
    return;
  }
  if (acz) {
    // no column has an AC term: the library shifts its 16-bit lanes
    const v8i dc = wrap16v((v8u)(rows[0]) << 2);
    for (int r = 0; r < 8; ++r) ws[r] = dc;
  } else {
    v8u t[8];
    idct_pass(rows, t);
    for (int r = 0; r < 8; ++r) {
      const v8i v = descale_v(t[r], 11);
      ws[r] = v < -32768 ? -32768 : v > 32767 ? 32767 : v;
    }
  }
  transpose8(ws);
  v8u t[8];
  idct_pass(ws, t);
  v8i o[8];
  for (int k = 0; k < 8; ++k) {
    const v8i v = descale_v(t[k], 18) + 128;
    o[k] = v < 0 ? 0 : v > 255 ? 255 : v;
  }
  transpose8(o);
  for (int r = 0; r < 8; ++r) {
    const v8b b = __builtin_convertvector(o[r], v8b);
    std::memcpy(out + static_cast<size_t>(r) * stride, &b, 8);
  }
}

// jdcolor.c's YCbCr -> BGR (SCALEBITS 16), one row: its tables' entries
// computed in place (Cr_r, Cb_b round; Cb_g carries ONE_HALF).
OFC_VECTOR void ycc_row(const uint8_t* yr, const uint8_t* cbr, const uint8_t* crr,
                        uint8_t* o, int width) {
  constexpr int32_t kHalf = 1 << 15;
  constexpr int32_t kCrR = static_cast<int32_t>(1.40200 * 65536 + 0.5);
  constexpr int32_t kCbB = static_cast<int32_t>(1.77200 * 65536 + 0.5);
  constexpr int32_t kCrG = static_cast<int32_t>(0.71414 * 65536 + 0.5);
  constexpr int32_t kCbG = static_cast<int32_t>(0.34414 * 65536 + 0.5);
  // the arithmetic on planar spans (vectorized), then the BGR interleave
  constexpr int kSpan = 256;
  uint8_t bgr[3][kSpan];
  for (int x0 = 0; x0 < width; x0 += kSpan) {
    const int n = width - x0 < kSpan ? width - x0 : kSpan;
    for (int x = 0; x < n; ++x) {
      const int32_t y = yr[x0 + x], cb = cbr[x0 + x] - 128, cr = crr[x0 + x] - 128;
      const int32_t b = y + ((kCbB * cb + kHalf) >> 16);
      const int32_t g = y + ((-kCbG * cb + kHalf - kCrG * cr) >> 16);
      const int32_t r = y + ((kCrR * cr + kHalf) >> 16);
      bgr[0][x] = static_cast<uint8_t>(b < 0 ? 0 : b > 255 ? 255 : b);
      bgr[1][x] = static_cast<uint8_t>(g < 0 ? 0 : g > 255 ? 255 : g);
      bgr[2][x] = static_cast<uint8_t>(r < 0 ? 0 : r > 255 ? 255 : r);
    }
    uint8_t* p = o + 3 * static_cast<size_t>(x0);
    for (int x = 0; x < n; ++x) {
      p[3 * x] = bgr[0][x];
      p[3 * x + 1] = bgr[1][x];
      p[3 * x + 2] = bgr[2][x];
    }
  }
}

typedef uint8_t v16b __attribute__((vector_size(16)));

// Each sample of `src` twice, into `width` bytes of `out`.
OFC_VECTOR void upsample2(const uint8_t* src, uint8_t* out, int width) {
  int x = 0;
  for (; x + 32 <= width; x += 32) {
    v16b s;
    std::memcpy(&s, src + x / 2, 16);
    const v16b lo = __builtin_shuffle(s, v16b{0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7});
    const v16b hi = __builtin_shuffle(s, v16b{8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15});
    std::memcpy(out + x, &lo, 16);
    std::memcpy(out + x + 16, &hi, 16);
  }
  for (; x < width; ++x) out[x] = src[x >> 1];
}

struct Component {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  bool latched = false;  // its quant table, copied at its first scan
  int16_t qt[64] = {};
  int stride = 0;  // plane width, a whole number of MCUs
  std::vector<uint8_t> plane;
};

enum class Space { kGray, kYcc, kRgb };

// One JPEG frame, parsed marker by marker as jdmarker.c reads it.
struct Jpeg {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {};
  HuffSpec dc[4], ac[4];
  int restart_interval = 0;
  // The arithmetic conditioning of each of the 16 tables (DAC), as SOI
  // sets them: DC bounds L and U, AC split K.
  uint8_t dc_l[16] = {}, dc_u[16], ac_k[16];
  int sof = 0;        // the SOF marker, 0 before it
  int precision = 8;
  int width = 0, height = 0;
  std::vector<Component> comps;
  int hmax = 1, vmax = 1;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int scans = 0;
  bool progressive = false;  // SOF2, SOF10
  // The scans go into a whole frame of coefficients (coefs), output after
  // the last one: a progressive frame, or a sequential one whose first
  // scan does not hold every component (jdinput.c has_multiple_scans).
  bool buffered = false;
  bool sequential_once = false;  // the first scan held every component
  int pending = 0;  // a marker the entropy decoder stopped at
  int scan_comps[4];
  int ns = 0;
  int ss = 0, se = 63, ah = 0, al = 0;  // the scan's band and approximation
  // A buffered frame's coefficients: per component, blocks of 64 in
  // natural order over its whole-MCU block grid (the stride of its plane
  // over 8). coef_bits is jdphuff.c's: per coefficient, the Al of the last
  // scan that gave it, -1 before any; prev_bits, its values when the
  // component's last scan began.
  std::vector<std::vector<int16_t>> coefs;
  int coef_bits[10][64], prev_bits[10][64];  // a frame has at most 10 components
  int last_good_row = 0;  // jdcoefct.c's last_good_iMCU_row

  Jpeg(const uint8_t* d, size_t n) : data(d), size(n) {
    std::memset(dc_u, 1, sizeof dc_u);
    std::memset(ac_k, 5, sizeof ac_k);
  }

  int u8() { return frame_byte(data, size, pos++); }
  int u16() {
    const int hi = u8();
    return (hi << 8) | u8();
  }

  // jdmarker.c next_marker: skip to the next 0xFF, then past fill 0xFFs and
  // stuffed 0xFF00s.
  int next_marker() {
    if (pending) {
      int m = pending;
      pending = 0;
      return m;
    }
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();
      do c = u8();
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void skip(int n) { pos += n; }

  // APPn, of which libjpeg reads APP0 (JFIF) and APP14 (Adobe).
  void read_app(int m) {
    const int n = u16() - 2;
    uint8_t d[14];
    const size_t at = pos;
    for (int i = 0; i < 14; ++i) d[i] = static_cast<uint8_t>(u8());
    pos = at;
    if (m == 0xE0 && n >= 14 && std::memcmp(d, "JFIF\0", 5) == 0) saw_jfif = true;
    if (m == 0xEE && n >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[11];
    }
    skip(n > 0 ? n : 0);
  }

  // jdmarker.c get_dqt: every table takes its 64 entries, whatever the
  // length says, so a length that is no whole number of tables fails.
  bool read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      const int t = u8();
      const int idx = t & 15, prec = t >> 4;
      if (idx >= 4) return false;
      for (int i = 0; i < 64; ++i) qt[idx][kNatural[i]] = static_cast<uint16_t>(prec ? u16() : u8());
      len -= prec ? 129 : 65;
      qt_defined[idx] = true;
    }
    return len == 0;
  }

  bool read_dht() {
    int len = u16() - 2;
    while (len > 16) {
      const int index = u8();
      uint8_t bits[16], vals[256];
      int count = 0;
      for (auto& b : bits) count += b = static_cast<uint8_t>(u8());
      len -= 17;
      if (count > 256 || count > len) return false;
      for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(u8());
      const int slot = index & 0x0F;
      if ((index & ~0x10) >= 4) return false;
      set_spec(index & 0x10 ? &ac[slot] : &dc[slot], bits, vals);
      len -= count;
    }
    return len == 0;
  }

  // jdmarker.c get_dac. Any K is taken (K = 0 puts every coefficient in
  // the upper bins, K > 63 every one in the lower).
  bool read_dac() {
    int len = u16() - 2;
    while (len > 0) {
      const int index = u8(), val = u8();
      len -= 2;
      if (index >= 32) return false;
      if (index >= 16) {
        ac_k[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_l[index] = static_cast<uint8_t>(val & 15);
        dc_u[index] = static_cast<uint8_t>(val >> 4);
        if (dc_l[index] > dc_u[index]) return false;
      }
    }
    return len == 0;
  }

  bool read_sof(int m) {
    const int len = u16(), p = u8(), hh = u16(), ww = u16(), nc = u8();
    if (sof || hh <= 0 || ww <= 0 || nc <= 0 || len - 8 != nc * 3) return false;
    sof = m;
    precision = p;
    height = hh;
    width = ww;
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
    }
    return true;
  }

  bool read_sos() {
    const int len = u16(), n = u8();
    if (!sof || len != n * 2 + 6 || n < 1 || n > 4) return false;
    ns = n;
    bool used[4] = {};
    const int limit = comps.size() < 4 ? static_cast<int>(comps.size()) : 4;
    for (int i = 0; i < n; ++i) {
      const int cc = u8(), t = u8();
      int ci = 0;
      while (ci < limit && !(comps[ci].id == cc && !used[ci])) ++ci;
      if (ci == limit) return false;
      used[ci] = true;
      scan_comps[i] = ci;
      comps[ci].dc_tbl = t >> 4;
      comps[ci].ac_tbl = t & 15;
    }
    // a sequential decoder only warns on odd ones; a progressive one
    // checks them (start_progressive_scan)
    ss = u8();
    se = u8();
    const int a = u8();
    ah = a >> 4;
    al = a & 15;
    return true;
  }

  // jdinput.c initial_setup, at the first SOS: the frame's limits.
  bool setup_frame() {
    if (width > 65500 || height > 65500 || comps.size() > 10) return false;
    for (const auto& c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return false;
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    return true;
  }

  // Markers up to and through the next SOS header: kOk, or 1 at EOI.
  int read_markers() {
    for (;;) {
      int m = next_marker();
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6:
        case 0xC7: case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE:
        case 0xCF:
          if (!read_sof(m)) return kErrFormat;
          break;
        case 0xDA:
          if (!read_sos()) return kErrFormat;
          if (scans == 0 && !setup_frame()) return kErrFormat;
          return kOk;
        case 0xD9:
          return scans ? 1 : kErrFormat;
        case 0xC4:
          if (!read_dht()) return kErrFormat;
          break;
        case 0xDB:
          if (!read_dqt()) return kErrFormat;
          break;
        case 0xDD:
          if (u16() != 4) return kErrFormat;
          restart_interval = u16();
          break;
        case 0xCC:
          if (!read_dac()) return kErrFormat;
          break;
        case 0xDC:  // DNL
        case 0xFE: {  // COM
          const int n = u16() - 2;
          skip(n > 0 ? n : 0);
          break;
        }
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5:
        case 0xD6: case 0xD7: case 0x01:  // RSTn, TEM: no payload
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
            break;
          }
          return kErrFormat;  // SOI again, JPG, JPGn or an unknown marker
      }
    }
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart, for the
  // reader of either entropy decoder (Bits or Arith).
  template <typename Reader>
  void restart(Reader& b, int* next_rst) {
    b.discard();
    int m = b.marker ? b.marker : next_marker_from(b);
    const int want = 0xD0 + *next_rst;
    if (m == want) {
      b.marker = 0;
    } else {
      for (;;) {
        int action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((*next_rst + 1) & 7) ||
                   m == 0xD0 + ((*next_rst + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((*next_rst - 1) & 7) ||
                   m == 0xD0 + ((*next_rst - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          b.marker = 0;
          break;
        }
        if (action == 3) {
          b.marker = m;
          break;
        }
        b.marker = 0;
        m = next_marker_from(b);
      }
    }
    *next_rst = (*next_rst + 1) & 7;
    b.restarted();
  }

  template <typename Reader>
  int next_marker_from(Reader& b) {
    pos = b.pos;
    int m = next_marker();
    b.pos = pos;
    b.marker = m;
    return m;
  }

  // A component's own extent in blocks (jdinput.c width_in_blocks,
  // height_in_blocks): its MCU padding excluded.
  int blocks_wide(const Component& c) const { return (width * c.h + 8 * hmax - 1) / (8 * hmax); }
  int blocks_high(const Component& c) const { return (height * c.v + 8 * vmax - 1) / (8 * vmax); }

  // The MCU grid of the scan just read (jdinput.c per_scan_setup): a
  // non-interleaved scan's MCU is one block, over its component's own
  // extent; an interleaved scan's is the frame's, of at most 10 blocks.
  bool scan_grid(int* mcus_x, int* mcus_y) const {
    if (ns == 1) {
      *mcus_x = blocks_wide(comps[scan_comps[0]]);
      *mcus_y = blocks_high(comps[scan_comps[0]]);
      return true;
    }
    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += comps[scan_comps[i]].h * comps[scan_comps[i]].v;
    *mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    *mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    return blocks <= 10;
  }

  // A sequential scan's MCU (my, mx): fn(index in the scan, block) decodes
  // each block, which then goes through the IDCT into its plane from blk
  // (zeroed first, as jdcoefct.c decompress_onepass does), or, in a
  // buffered frame, is decoded in place: there a block that a scan gives
  // nothing keeps what it had (jdcoefct.c consume_data).
  template <typename Fn>
  void sequential_blocks(int my, int mx, int16_t* blk, Fn fn) {
    for (int i = 0; i < ns; ++i) {
      Component& c = comps[scan_comps[i]];
      const int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
      for (int yy = 0; yy < bh; ++yy) {
        for (int xx = 0; xx < bw; ++xx) {
          const int by = my * bh + yy, bx = mx * bw + xx;
          if (buffered) {
            fn(i, block(scan_comps[i], by, bx));
            continue;
          }
          std::memset(blk, 0, 64 * sizeof *blk);
          fn(i, blk);
          idct_islow(blk, c.qt, c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8, c.stride);
        }
      }
    }
  }

  // Decode the entropy-coded data of a sequential scan just read, block by
  // block (sequential_blocks).
  int decode_scan(const HuffTable* dct, const HuffTable* act) {
    int mcus_x, mcus_y;
    if (!scan_grid(&mcus_x, &mcus_y)) return kErrFormat;
    Bits b{data, size, pos};
    int preds[4] = {};
    int restarts_to_go = restart_interval, next_rst = 0;
    alignas(16) int16_t blk[64];
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        if (restart_interval) {
          if (restarts_to_go == 0) {
            restart(b, &next_rst);
            for (int& p : preds) p = 0;
            restarts_to_go = restart_interval;
          }
          --restarts_to_go;
        }
        const bool zero = b.insufficient;
        sequential_blocks(my, mx, blk, [&](int i, int16_t* dst) {
          const Component& c = comps[scan_comps[i]];
          if (!zero) decode_block(b, dct[c.dc_tbl], act[c.ac_tbl], &preds[i], dst);
        });
      }
    }
    b.discard();
    pos = b.pos;
    pending = b.marker;
    return kOk;
  }

  // ---- progressive frames (jdphuff.c, jdcoefct.c) ----

  int16_t* block(int ci, int by, int bx) {
    const Component& c = comps[ci];
    return coefs[ci].data() + (static_cast<size_t>(by) * (c.stride / 8) + bx) * 64;
  }

  // jdphuff.c start_pass_phuff_decoder (and jdarith.c start_pass): check
  // the scan's band and approximation, record what it gives in coef_bits
  // (a scan out of order is only a warning there), and build the one table
  // kind it reads, where it reads Huffman tables (tbls not null).
  bool start_progressive_scan(HuffTable* tbls) {
    const bool dc_band = ss == 0;
    bool bad = dc_band ? se != 0 : ss > se || se > 63 || ns != 1;
    if (ah != 0 && al != ah - 1) bad = true;
    if (bad || al > 13) return false;
    for (int i = 0; i < ns; ++i) {
      const int ci = scan_comps[i];
      for (int k = ss < 1 ? ss : 1; k <= (se > 9 ? se : 9); ++k)
        prev_bits[ci][k] = scans > 0 ? coef_bits[ci][k] : 0;
      for (int k = ss; k <= se; ++k) coef_bits[ci][k] = al;
    }
    if (!tbls || (dc_band && ah != 0)) return true;  // a DC refinement reads no table
    for (int i = 0; i < ns; ++i) {
      const Component& c = comps[scan_comps[i]];
      const int t = dc_band ? c.dc_tbl : c.ac_tbl;
      if (t >= 4) return false;
      const HuffSpec& spec = dc_band ? dc[t] : ac[t];
      if (!spec.defined || !build_table(spec, dc_band, &tbls[t])) return false;
    }
    return true;
  }

  // One MCU's blocks: fn(index in the scan, block).
  template <typename Fn>
  void mcu_blocks(int my, int mx, Fn fn) {
    if (ns == 1) {
      fn(0, block(scan_comps[0], my, mx));
      return;
    }
    for (int i = 0; i < ns; ++i) {
      const Component& c = comps[scan_comps[i]];
      for (int yy = 0; yy < c.v; ++yy)
        for (int xx = 0; xx < c.h; ++xx) fn(i, block(scan_comps[i], my * c.v + yy, mx * c.h + xx));
    }
  }

  // The scan just read into the coefficients, MCU by MCU as jdphuff.c's
  // decode_mcu_DC_first, _AC_first, _DC_refine and _AC_refine.
  int decode_progressive_scan(const HuffTable* tbls) {
    int mcus_x, mcus_y;
    if (!scan_grid(&mcus_x, &mcus_y)) return kErrFormat;
    Bits b{data, size, pos};
    int preds[4] = {};
    uint32_t eobrun = 0;
    int restarts_to_go = restart_interval, next_rst = 0;
    // a non-interleaved scan's iMCU row is v_samp_factor block rows
    const int mcu_rows = ns == 1 ? comps[scan_comps[0]].v : 1;
    const int p1 = 1 << al, m1 = -p1;
    int16_t* blk = nullptr;
    // Refinement bits for the nonzero coefficients at the zigzag positions
    // in `mask`, one bit each in ascending order, read up to 16 at a time.
    auto correct = [&](uint64_t mask) {
      while (mask) {
        int m = __builtin_popcountll(mask);
        if (m > 16) m = 16;
        if (b.n < 32) b.fill();
        const uint32_t v = static_cast<uint32_t>(b.get(m));
        for (int i = m - 1; i >= 0; --i) {
          int16_t* coef = blk + kNatural[__builtin_ctzll(mask)];
          mask &= mask - 1;
          if ((v >> i & 1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
        }
      }
    };
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        if (!b.insufficient) last_good_row = my / mcu_rows;
        if (restart_interval) {
          if (restarts_to_go == 0) {
            restart(b, &next_rst);
            for (int& p : preds) p = 0;
            eobrun = 0;
            restarts_to_go = restart_interval;
          }
          --restarts_to_go;
        }
        if (ss == 0 && ah != 0) {
          // the next bit of each DC; past the data they are zeros, which
          // change nothing, so the library does not test for it
          mcu_blocks(my, mx, [&](int, int16_t* dst) {
            if (b.bit()) dst[0] = static_cast<int16_t>(dst[0] | p1);
          });
          continue;
        }
        if (b.insufficient) continue;  // the rest of the segment stays as it is
        if (ss == 0) {
          mcu_blocks(my, mx, [&](int i, int16_t* dst) {
            const Component& c = comps[scan_comps[i]];
            int s = huff_decode(b, tbls[c.dc_tbl]);
            if (s) s = extend(b.get(s), s);
            preds[i] = static_cast<int>(static_cast<uint32_t>(preds[i]) + static_cast<uint32_t>(s));
            dst[0] = static_cast<int16_t>(static_cast<uint32_t>(preds[i]) << al);
          });
          continue;
        }
        blk = block(scan_comps[0], my, mx);
        const HuffTable& t = tbls[comps[scan_comps[0]].ac_tbl];
        if (ah == 0) {
          if (eobrun) {
            --eobrun;
            continue;
          }
          for (int k = ss; k <= se; ++k) {
            if (b.n < 32) b.fill();
            const int32_t f = t.fast_ac[b.peek(kLook)];
            if (f) {  // a code and its value's bits, resolved at once
              b.skip(f & 0xFF);
              k += (f >> 8) & 0xFF;
              blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(f >> 16) << al);
              continue;
            }
            const int rs = huff_decode(b, t), r = rs >> 4, s = rs & 15;
            if (s) {
              k += r;
              blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(extend(b.get(s), s)) << al);
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = (1u << r) + (r ? b.get(r) : 0) - 1;
              break;
            }
          }
          continue;
        }
        // nz: the band's nonzero coefficients, by zigzag position; those
        // at or past k are as they were when the block began
        auto band = [](int lo, int hi) {  // zigzag positions lo..hi
          return lo > hi ? 0 : (hi == 63 ? ~0ull : (2ull << hi) - 1) & ~((1ull << lo) - 1);
        };
        uint64_t nz = 0;
        for (int k = ss; k <= se; ++k) nz |= static_cast<uint64_t>(blk[kNatural[k]] != 0) << k;
        int k = ss;
        if (eobrun == 0) {
          for (; k <= se; ++k) {
            const int rs = huff_decode(b, t);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              // a newly nonzero coefficient (its size should be 1)
              s = b.bit() ? p1 : m1;
            } else if (r != 15) {
              eobrun = (1u << r) + (r ? b.get(r) : 0);
              break;
            }
            // pass r zero coefficients and stop at the next, refining the
            // nonzero ones on the way; past the band if it has too few
            uint64_t zeros = ~nz & band(k, se);
            for (; r > 0 && zeros; --r) zeros &= zeros - 1;
            const int stop = zeros ? __builtin_ctzll(zeros) : se + 1;
            correct(nz & band(k, stop - 1));
            k = stop;
            if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
          }
        }
        if (eobrun > 0) {
          correct(nz & band(k, se));
          --eobrun;
        }
      }
    }
    b.discard();
    pos = b.pos;
    pending = b.marker;
    return kOk;
  }

  // The scan just read of an arithmetic-coded frame, MCU by MCU as
  // jdarith.c's decode_mcu (sequential: sequential_blocks, as decode_scan)
  // or its decode_mcu_DC_first, _AC_first, _DC_refine and _AC_refine
  // (progressive: into the coefficients). Past a marker it reads zero bytes
  // and goes on decoding. After a bad code (Arith::ct = -1) it skips the
  // MCUs left in the segment: their blocks keep what they had (zero in a
  // sequential frame's one scan).
  int decode_arith_scan() {
    int mcus_x, mcus_y;
    if (!scan_grid(&mcus_x, &mcus_y)) return kErrFormat;
    Arith e{data, size, pos};
    uint8_t dc_stats[16][64], ac_stats[16][256];  // per conditioning table
    int last_dc[4], context[4];
    const bool dc_first = !progressive || (ss == 0 && ah == 0), has_ac = !progressive || ss != 0;
    // at the scan's start and at each restart: the statistics the scan
    // reads, its DC predictions and the decoder's registers
    auto reset = [&] {
      for (int i = 0; i < ns; ++i) {
        const Component& c = comps[scan_comps[i]];
        if (dc_first) {
          std::memset(dc_stats[c.dc_tbl], 0, sizeof dc_stats[0]);
          last_dc[i] = context[i] = 0;
        }
        if (has_ac) std::memset(ac_stats[c.ac_tbl], 0, sizeof ac_stats[0]);
      }
      e.discard();
    };
    reset();
    // the next DC of the scan's component i, false at a bad code
    auto next_dc = [&](int i, int* dc) {
      const int t = comps[scan_comps[i]].dc_tbl;
      int v;
      if (e.ct == -1 || !e.dc_diff(dc_stats[t], &context[i], dc_l[t], dc_u[t], &v)) return false;
      last_dc[i] = (last_dc[i] + v) & 0xFFFF;
      *dc = last_dc[i];
      return true;
    };
    int restarts_to_go = restart_interval, next_rst = 0;
    const int mcu_rows = ns == 1 ? comps[scan_comps[0]].v : 1;
    const int p1 = 1 << al;
    alignas(16) int16_t blk[64];
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        // jdarith.c never sets insufficient_data: every row counts as good
        last_good_row = my / mcu_rows;
        if (restart_interval) {
          if (restarts_to_go == 0) {
            restart(e, &next_rst);
            reset();
            restarts_to_go = restart_interval;
          }
          --restarts_to_go;
        }
        if (progressive && ss == 0 && ah != 0) {
          // the next bit of each DC, at probability one half; this decoder
          // has no bad-code test
          mcu_blocks(my, mx, [&](int, int16_t* dst) {
            if (e.decode(&e.fixed)) dst[0] = static_cast<int16_t>(dst[0] | p1);
          });
          continue;
        }
        if (e.ct == -1) continue;
        if (!progressive) {
          sequential_blocks(my, mx, blk, [&](int i, int16_t* dst) {
            const int t = comps[scan_comps[i]].ac_tbl;
            int dc;
            if (!next_dc(i, &dc)) return;
            dst[0] = static_cast<int16_t>(dc);
            e.ac_first(ac_stats[t], ac_k[t], 1, 63, 0, dst);
          });
          continue;
        }
        if (ss == 0) {
          mcu_blocks(my, mx, [&](int i, int16_t* dst) {
            int dc;
            if (next_dc(i, &dc)) dst[0] = static_cast<int16_t>(static_cast<uint32_t>(dc) << al);
          });
          continue;
        }
        const int t = comps[scan_comps[0]].ac_tbl;
        int16_t* dst = block(scan_comps[0], my, mx);
        if (ah == 0) {
          e.ac_first(ac_stats[t], ac_k[t], ss, se, al, dst);
        } else {
          e.ac_refine(ac_stats[t], ss, se, al, dst);
        }
      }
    }
    pos = e.pos;
    pending = e.marker;
    return kOk;
  }

  // jdcoefct.c smoothing_ok, after the last scan: smoothing runs when every
  // component has its quantization table, nonzero at the DC and the nine
  // lowest AC coefficients, has had its DC, and some of those nine are not
  // yet known in full. It latches their coef_bits (now and at the start of
  // the component's last scan) into bits[ci] and prev[ci].
  bool smoothing_ok(int bits[][10], int prev[][10]) const {
    if (!progressive) return false;
    bool useful = false;
    for (size_t ci = 0; ci < comps.size(); ++ci) {
      const Component& c = comps[ci];
      if (!c.latched) return false;
      for (int k = 0; k < 10; ++k)
        if (c.qt[kNatural[k]] == 0) return false;
      if (coef_bits[ci][0] < 0) return false;
      for (int k = 1; k < 10; ++k) {
        prev[ci][k] = scans > 1 ? prev_bits[ci][k] : -1;
        bits[ci][k] = coef_bits[ci][k];
        if (coef_bits[ci][k] != 0) useful = true;
      }
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data's estimate of one coefficient from
  // the DC values around its block: num / (q << 8) rounded, and kept below
  // 1 << al, the first bit the scans have not given yet.
  static int16_t predict(int64_t num, int64_t q, int al) {
    const bool neg = num < 0;
    int pred = static_cast<int>(((q << 7) + (neg ? -num : num)) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    return static_cast<int16_t>(neg ? -pred : pred);
  }

  // The output pass of a buffered frame (jdcoefct.c decompress_data, or
  // decompress_smooth_data when smoothing_ok): each component's own blocks
  // through the IDCT into its plane, the smoothed ones from a copy.
  void output_coefficients() {
    int latch[10][10], prev_latch[10][10];
    const bool smooth = smoothing_ok(latch, prev_latch);
    const int last_row = (height + 8 * vmax - 1) / (8 * vmax) - 1;  // iMCU rows
    for (size_t ci = 0; ci < comps.size(); ++ci) {
      Component& c = comps[ci];
      const int bw = blocks_wide(c), bh = blocks_high(c);
      auto out = [&](int by, int bx) {
        return c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8;
      };
      if (!smooth) {
        for (int by = 0; by < bh; ++by)
          for (int bx = 0; bx < bw; ++bx) idct_islow(block(ci, by, bx), c.qt, out(by, bx), c.stride);
        continue;
      }
      int64_t q[10];  // the quantization of zigzag coefficients 0..9
      for (int k = 0; k < 10; ++k) q[k] = static_cast<uint16_t>(c.qt[kNatural[k]]);
      alignas(16) int16_t ws[64];
      for (int row = 0; row <= last_row; ++row) {
        // an iMCU row past the last one the last scan reached with data
        // takes the coefficient bits from before that scan
        const int* cb = row > last_good_row ? prev_latch[ci] : latch[ci];
        bool change_dc = true;
        for (int k = 1; k < 10; ++k) change_dc &= cb[k] == -1;
        int block_rows = c.v;
        if (row == last_row) {
          block_rows = bh % c.v;
          if (block_rows == 0) block_rows = c.v;
        }
        for (int br = 0; br < block_rows; ++br) {
          // the block rows two above to two below, as the library picks them
          const int cur = row * c.v + br;
          const int up = br > 0 || row > 0 ? cur - 1 : cur;
          const int up2 = br > 1 || row > 1 ? cur - 2 : up;
          const int down = br < block_rows - 1 || row < last_row ? cur + 1 : cur;
          const int down2 = br < block_rows - 2 || row + 1 < last_row ? cur + 2 : down;
          const int16_t* rows[5] = {block(ci, up2, 0), block(ci, up, 0), block(ci, cur, 0), block(ci, down, 0),
                                    block(ci, down2, 0)};
          // dc[r][x]: the DC of the block r - 2 rows down and x - 2 columns
          // right, the nearest one inside the component where that is out
          int dc[5][5];
          for (int r = 0; r < 5; ++r)
            for (int x = 0; x < 5; ++x) dc[r][x] = rows[r][0];
          for (int bx = 0; bx < bw; ++bx) {
            std::memcpy(ws, rows[2] + static_cast<size_t>(bx) * 64, sizeof ws);
            if (bx == 0 && bx < bw - 1)
              for (int r = 0; r < 5; ++r) dc[r][3] = rows[r][64];
            if (bx + 1 < bw - 1)
              for (int r = 0; r < 5; ++r) dc[r][4] = rows[r][static_cast<size_t>(bx + 2) * 64];
            // the library's DC01..DC25, row by row
            auto D = [&](int n) { return static_cast<int64_t>(dc[(n - 1) / 5][(n - 1) % 5]); };
            // AC01, AC10, AC20, AC11, AC02 (and with change_dc AC03, AC12,
            // AC21, AC30): estimated where the coefficient is still zero and
            // not known in full
            auto estimate = [&](int k, int pos, int64_t sum) {
              if (cb[k] != 0 && ws[pos] == 0) ws[pos] = predict(q[0] * sum, q[k], cb[k]);
            };
            estimate(1, 1, change_dc ? -D(1) - D(2) + D(4) + D(5) - 3 * D(6) + 13 * D(7) - 13 * D(9) + 3 * D(10) -
                                           3 * D(11) + 38 * D(12) - 38 * D(14) + 3 * D(15) - 3 * D(16) +
                                           13 * D(17) - 13 * D(19) + 3 * D(20) - D(21) - D(22) + D(24) + D(25)
                                     : -7 * D(11) + 50 * D(12) - 50 * D(14) + 7 * D(15));
            estimate(2, 8, change_dc ? -D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) - D(6) + 13 * D(7) +
                                           38 * D(8) + 13 * D(9) - D(10) + D(16) - 13 * D(17) - 38 * D(18) -
                                           13 * D(19) + D(20) + D(21) + 3 * D(22) + 3 * D(23) + 3 * D(24) + D(25)
                                     : -7 * D(3) + 50 * D(8) - 50 * D(18) + 7 * D(23));
            estimate(3, 16, change_dc ? D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) - 5 * D(12) - 14 * D(13) -
                                            5 * D(14) + 2 * D(17) + 7 * D(18) + 2 * D(19) + D(23)
                                      : -D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) - D(23));
            estimate(4, 9, change_dc ? -D(1) + D(5) + 9 * D(7) - 9 * D(9) - 9 * D(17) + 9 * D(19) + D(21) - D(25)
                                     : D(10) + D(16) - 10 * D(17) + 10 * D(19) - D(2) - D(20) + D(22) - D(24) +
                                           D(4) - D(6) + 10 * D(7) - 10 * D(9));
            estimate(5, 2, change_dc ? 2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) + 7 * D(12) - 14 * D(13) +
                                           7 * D(14) + D(15) + 2 * D(17) - 5 * D(18) + 2 * D(19)
                                     : -D(11) + 13 * D(12) - 24 * D(13) + 13 * D(14) - D(15));
            if (change_dc) {
              estimate(6, 3, D(7) - D(9) + 2 * D(12) - 2 * D(14) + D(17) - D(19));
              estimate(7, 10, D(7) - 3 * D(8) + D(9) - D(17) + 3 * D(18) - D(19));
              estimate(8, 17, D(7) - D(9) - 3 * D(12) + 3 * D(14) + D(17) - D(19));
              estimate(9, 24, D(7) + 2 * D(8) + D(9) - D(17) - 2 * D(18) - D(19));
              // no AC has arrived: the DC itself from its 5x5 neighbourhood
              ws[0] = predict(q[0] * (-2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) - 2 * D(5) - 6 * D(6) +
                                      6 * D(7) + 42 * D(8) + 6 * D(9) - 6 * D(10) - 8 * D(11) + 42 * D(12) +
                                      152 * D(13) + 42 * D(14) - 8 * D(15) - 6 * D(16) + 6 * D(17) +
                                      42 * D(18) + 6 * D(19) - 6 * D(20) - 2 * D(21) - 6 * D(22) - 8 * D(23) -
                                      6 * D(24) - 2 * D(25)),
                              q[0], 0);
            }
            idct_islow(ws, c.qt, out(cur, bx), c.stride);
            for (int r = 0; r < 5; ++r)
              for (int x = 0; x < 4; ++x) dc[r][x] = dc[r][x + 1];
          }
        }
      }
    }
  }

  // Every scan, then the planes upsampled and colour-converted into out.
  int decode(uint8_t* out, int h, int w) {
    if (read_markers() != kOk) return kErrFormat;
    if (sof != 0xC0 && sof != 0xC1 && sof != 0xC2 && sof != 0xC9 && sof != 0xCA)
      return kErrSof - (precision << 8 | sof);
    if (precision != 8) return kErrSof - (precision << 8 | sof);
    progressive = sof == 0xC2 || sof == 0xCA;
    // an arithmetic-coded frame reads no Huffman table: a DHT in it is
    // parsed and left unused
    const bool arith = sof == 0xC9 || sof == 0xCA;
    const int nc = static_cast<int>(comps.size());
    // libjpeg reads a buffered frame's every scan before it can tell the
    // caller its size, so a fault in a scan comes first there
    buffered = progressive || ns != nc;
    if (!buffered && (width != w || height != h)) return kErrShape;
    if (nc != 1 && nc != 3) return kErrFormat;  // libjpeg has no conversion of these to BGR
    // jdapimin.c's guess: JFIF means YCbCr, else Adobe's transform 0 or
    // component ids 'R', 'G', 'B' mean RGB
    const bool rgb_ids = nc == 3 && comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
    const Space space = nc == 1 ? Space::kGray
                        : !saw_jfif && (saw_adobe ? adobe_transform == 0 : rgb_ids) ? Space::kRgb
                                                                                     : Space::kYcc;
    for (const auto& c : comps)
      if (hmax % c.h || vmax % c.v) return kErrFormat;
    const int nmcu_x = (width + 8 * hmax - 1) / (8 * hmax);
    const int nmcu_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.stride = nmcu_x * c.h * 8;
      // 128, an IDCT of zero coefficients: what libjpeg gives a component
      // that no scan reached
      c.plane.assign(static_cast<size_t>(c.stride) * nmcu_y * c.v * 8, 128);
    }
    if (buffered) {
      coefs.resize(nc);
      for (int ci = 0; ci < nc; ++ci)
        coefs[ci].assign(static_cast<size_t>(nmcu_x) * comps[ci].h * nmcu_y * comps[ci].v * 64, 0);
      for (int ci = 0; ci < nc; ++ci)
        for (int k = 0; k < 64; ++k) {
          coef_bits[ci][k] = -1;
          prev_bits[ci][k] = 0;
        }
    }
    if (!progressive && !arith) {
      // libjpeg-turbo fills absent tables 0 and 1 with the standard ones
      // when its sequential Huffman decoder starts, after the first SOS
      // (MJPEG frames omit them).
      if (!dc[0].defined) set_spec(&dc[0], kStdDcLumaBits, kStdDcVals);
      if (!ac[0].defined) set_spec(&ac[0], kStdAcLumaBits, kStdAcLumaVals);
      if (!dc[1].defined) set_spec(&dc[1], kStdDcChromaBits, kStdDcVals);
      if (!ac[1].defined) set_spec(&ac[1], kStdAcChromaBits, kStdAcChromaVals);
    }
    std::vector<HuffTable> tables(8);
    HuffTable* dct = tables.data();
    HuffTable* act = tables.data() + 4;
    for (;;) {
      if (!progressive && scans == 1 && sequential_once) return kErrFormat;
      for (int i = 0; i < ns; ++i) {
        Component& c = comps[scan_comps[i]];
        if (!progressive && !arith) {
          if (c.dc_tbl >= 4 || !dc[c.dc_tbl].defined ||
              !build_table(dc[c.dc_tbl], true, &dct[c.dc_tbl]))
            return kErrFormat;
          if (c.ac_tbl >= 4 || !ac[c.ac_tbl].defined ||
              !build_table(ac[c.ac_tbl], false, &act[c.ac_tbl]))
            return kErrFormat;
        }
        if (!c.latched) {
          if (c.tq >= 4 || !qt_defined[c.tq]) return kErrFormat;
          for (int k = 0; k < 64; ++k)
            c.qt[k] = static_cast<int16_t>(qt[c.tq][k]);
          c.latched = true;
        }
      }
      if (progressive && !start_progressive_scan(arith ? nullptr : dct)) return kErrFormat;
      if (!progressive && scans == 0) sequential_once = ns == nc;
      int rc;
      if (arith) {
        rc = decode_arith_scan();
      } else if (progressive) {
        rc = decode_progressive_scan(dct);
      } else {
        rc = decode_scan(dct, act);
      }
      if (rc != kOk) return rc;
      ++scans;
      rc = read_markers();
      if (rc == 1) break;
      if (rc != kOk) return rc;
    }
    if (buffered) {
      if (width != w || height != h) return kErrShape;
      output_coefficients();
    }
    convert(out, space);
    return kOk;
  }

  // Replicate each component to full size and convert it into out.
  void convert(uint8_t* out, Space space) const {
    const int nc = static_cast<int>(comps.size());
    std::vector<uint8_t> up(static_cast<size_t>(nc) * width);
    for (int y = 0; y < height; ++y) {
      const uint8_t* row[3];
      for (int i = 0; i < nc; ++i) {
        const Component& c = comps[i];
        const uint8_t* src = c.plane.data() + static_cast<size_t>(y / (vmax / c.v)) * c.stride;
        const int e = hmax / c.h;
        if (e == 1) {
          row[i] = src;
          continue;
        }
        uint8_t* u = up.data() + static_cast<size_t>(i) * width;
        if (e == 2) {
          upsample2(src, u, width);
        } else {
          for (int x = 0, k = 0; x < width; ++k)
            for (int r = 0; r < e && x < width; ++r) u[x++] = src[k];
        }
        row[i] = u;
      }
      uint8_t* o = out + static_cast<size_t>(y) * width * 3;
      if (space == Space::kYcc) {
        ycc_row(row[0], row[1], row[2], o, width);
      } else if (space == Space::kRgb) {
        for (int x = 0; x < width; ++x) {
          o[3 * x] = row[2][x];
          o[3 * x + 1] = row[1][x];
          o[3 * x + 2] = row[0][x];
        }
      } else {
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[0][x];
      }
    }
  }
};

bool is_soi(const uint8_t* bytes, size_t size) {
  return size >= 2 && bytes[0] == 0xFF && bytes[1] == 0xD8;
}

int decode_jpeg_one(const uint8_t* bytes, size_t size, uint8_t* out, int h,
                    int w) {
  if (!is_soi(bytes, size)) return kErrFormat;
  Jpeg j(bytes, size);
  j.pos = 2;
  return j.decode(out, h, w);
}

// The frame's size from its markers through the first SOS (what
// jpeg_read_header reads). A frame of a kind the decoder refuses still
// probes, so that decoding it names its SOF.
bool jpeg_probe(const uint8_t* bytes, size_t size, int* h, int* w) {
  if (!is_soi(bytes, size)) return false;
  Jpeg j(bytes, size);
  j.pos = 2;
  if (j.read_markers() != kOk) return false;
  *h = j.height;
  *w = j.width;
  return true;
}

// ---------------------------------------------------------------- PNG ----

uint32_t rd32be(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

uint32_t crc32(const uint8_t* p, size_t n) {
  static const std::vector<uint32_t> table = [] {
    std::vector<uint32_t> t(256);
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// A canonical Huffman code of inflate: count[l] codes of length l, and the
// symbols in code order.
struct InfHuff {
  int16_t count[16];
  int16_t symbol[288];
};

// RFC 1950/1951 inflate of a zlib stream, as libpng reads IDAT: to the end
// of the stream and its Adler-32. A fault (a bad code, distance or
// checksum) fails the image while its `rows` bytes are not all out and
// right after the last of them; once a byte more is out, libpng only checks
// the rest of the stream, and a fault there is a warning. Running out of
// data always fails. Output past `rows` is only checksummed, behind a
// 32 KiB window, so memory stays bounded.
struct Inflate {
  const uint8_t* in;
  size_t n;
  size_t pos = 0;
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  bool ok = true;
  bool exhausted = false;
  bool too_far = false;  // a distance past the output
  std::vector<uint8_t> out;
  size_t rows;
  size_t total = 0;  // bytes out, the trimmed ones included
  uint32_t s1 = 1, s2 = 0;  // Adler-32 of out[0, summed)
  size_t summed = 0;

  Inflate(const uint8_t* d, size_t size, size_t need) : in(d), n(size), rows(need) {
    out.reserve(need);
  }

  void adler(size_t end) {
    while (summed < end) {
      const size_t stop = end - summed > 5552 ? summed + 5552 : end;
      for (; summed < stop; ++summed) {
        s1 += out[summed];
        s2 += s1;
      }
      s1 %= 65521;
      s2 %= 65521;
    }
  }

  void push(uint8_t v) {
    out.push_back(v);
    ++total;
    constexpr size_t kWindow = 32768;
    if (out.size() >= rows + 3 * kWindow) {
      const size_t cut = out.size() - kWindow;
      adler(cut);
      out.erase(out.begin() + static_cast<std::ptrdiff_t>(rows), out.begin() + static_cast<std::ptrdiff_t>(cut));
      summed = rows;
    }
  }

  int bits(int need) {
    while (bitcnt < need) {
      if (pos >= n) {
        ok = false;
        exhausted = true;
        return 0;
      }
      bitbuf |= static_cast<uint64_t>(in[pos++]) << bitcnt;
      bitcnt += 8;
    }
    int v = static_cast<int>(bitbuf & ((1u << need) - 1));
    bitbuf >>= need;
    bitcnt -= need;
    return v;
  }

  // 0: complete code, > 0: incomplete, < 0: over-subscribed.
  static int construct(InfHuff* h, const int16_t* length, int count) {
    for (int l = 0; l < 16; ++l) h->count[l] = 0;
    for (int s = 0; s < count; ++s) h->count[length[s]]++;
    if (h->count[0] == count) return 0;
    int left = 1;
    for (int l = 1; l < 16; ++l) {
      left <<= 1;
      left -= h->count[l];
      if (left < 0) return left;
    }
    int16_t offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + h->count[l];
    for (int s = 0; s < count; ++s)
      if (length[s]) h->symbol[offs[length[s]]++] = static_cast<int16_t>(s);
    return left;
  }

  int decode(const InfHuff& h) {
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      code |= bits(1);
      if (!ok) return -1;
      int count = h.count[l];
      if (code - count < first) return h.symbol[index + (code - first)];
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    ok = false;
    return -1;
  }

  bool codes(const InfHuff& lencode, const InfHuff& distcode) {
    static const int16_t kLBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                                       15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                       67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const int16_t kLExt[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                      2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const int16_t kDBase[30] = {
        1,   2,   3,   4,   5,   7,    9,    13,   17,   25,   33,   49,   65,    97,    129,
        193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
    static const int16_t kDExt[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                      6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    for (;;) {
      int sym = decode(lencode);
      if (!ok) return false;
      if (sym < 256) {
        push(static_cast<uint8_t>(sym));
      } else if (sym == 256) {
        return true;
      } else {
        sym -= 257;
        if (sym >= 29) return false;
        int len = kLBase[sym] + bits(kLExt[sym]);
        int ds = decode(distcode);
        if (!ok || ds < 0 || ds >= 30) return false;
        size_t dist = kDBase[ds] + bits(kDExt[ds]);
        if (!ok) return false;
        if (dist > out.size()) {
          too_far = true;
          return false;
        }
        for (int i = 0; i < len; ++i) push(out[out.size() - dist]);
      }
    }
  }

  bool stored() {
    bitbuf = 0;
    bitcnt = 0;
    if (pos + 4 > n) {
      exhausted = true;
      return false;
    }
    unsigned len = in[pos] | (in[pos + 1] << 8);
    unsigned nlen = in[pos + 2] | (in[pos + 3] << 8);
    pos += 4;
    if (len != (~nlen & 0xFFFF)) return false;
    if (pos + len > n) {
      exhausted = true;
      return false;
    }
    for (unsigned i = 0; i < len; ++i) push(in[pos + i]);
    pos += len;
    return true;
  }

  bool fixed() {
    InfHuff lencode, distcode;
    int16_t lengths[288];
    int s = 0;
    for (; s < 144; ++s) lengths[s] = 8;
    for (; s < 256; ++s) lengths[s] = 9;
    for (; s < 280; ++s) lengths[s] = 7;
    for (; s < 288; ++s) lengths[s] = 8;
    construct(&lencode, lengths, 288);
    for (s = 0; s < 30; ++s) lengths[s] = 5;
    construct(&distcode, lengths, 30);
    return codes(lencode, distcode);
  }

  bool dynamic() {
    static const int16_t kOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                       11, 4,  12, 3, 13, 2, 14, 1, 15};
    int16_t lengths[320];
    int nlen = bits(5) + 257, ndist = bits(5) + 1, ncode = bits(4) + 4;
    if (!ok || nlen > 286 || ndist > 30) return false;
    int idx = 0;
    for (; idx < ncode; ++idx) lengths[kOrder[idx]] = static_cast<int16_t>(bits(3));
    for (; idx < 19; ++idx) lengths[kOrder[idx]] = 0;
    InfHuff lencode, distcode;
    if (!ok || construct(&lencode, lengths, 19) != 0) return false;
    idx = 0;
    while (idx < nlen + ndist) {
      int sym = decode(lencode);
      if (!ok) return false;
      if (sym < 16) {
        lengths[idx++] = static_cast<int16_t>(sym);
        continue;
      }
      int16_t len = 0;
      int rep;
      if (sym == 16) {
        if (idx == 0) return false;
        len = lengths[idx - 1];
        rep = 3 + bits(2);
      } else if (sym == 17) {
        rep = 3 + bits(3);
      } else {
        rep = 11 + bits(7);
      }
      if (!ok || idx + rep > nlen + ndist) return false;
      while (rep--) lengths[idx++] = len;
    }
    if (lengths[256] == 0) return false;
    int err = construct(&lencode, lengths, nlen);
    if (err && (err < 0 || nlen != lencode.count[0] + lencode.count[1])) return false;
    err = construct(&distcode, lengths + nlen, ndist);
    if (err && (err < 0 || ndist != distcode.count[0] + distcode.count[1])) return false;
    return codes(lencode, distcode);
  }

  // Whether the image's rows decode, by libpng's rule above. zlib checks a
  // match's distance only when it has room to copy, so a distance past the
  // output right after the last row byte is also only a warning.
  bool run() {
    const bool stream_ok = stream();
    return stream_ok || (!exhausted && (total > rows || (too_far && total == rows)));
  }

  bool stream() {
    if (n < 2) return false;
    const int cmf = in[0], flg = in[1];
    if ((cmf & 15) != 8 || (cmf >> 4) > 7 || (cmf * 256 + flg) % 31 || (flg & 0x20))
      return false;
    pos = 2;
    for (;;) {
      int last = bits(1), type = bits(2);
      if (!ok) return false;
      bool good = type == 0 ? stored() : type == 1 ? fixed() : type == 2 ? dynamic() : false;
      if (!good) return false;
      if (last) break;
    }
    // the Adler-32, big-endian, after the last block's partial byte
    if (pos + 4 > n) {
      exhausted = true;
      return false;
    }
    adler(out.size());
    const uint32_t want = (static_cast<uint32_t>(in[pos]) << 24) | (in[pos + 1] << 16) | (in[pos + 2] << 8) | in[pos + 3];
    return want == ((s2 << 16) | s1);
  }
};

// Decode one PNG to BGR at [h, w, 3] into `out`; returns kOk or an error.
int decode_png_one(const uint8_t* bytes, size_t size, uint8_t* out, int h, int w) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (size < 8 || std::memcmp(bytes, kSig, 8) != 0) return kErrFormat;
  size_t pos = 8;
  uint32_t width = 0, height = 0;
  int depth = 0, color = 0, interlace = 0;
  uint8_t palette[256][3] = {};
  bool have_ihdr = false, have_plte = false;
  std::vector<uint8_t> idat;
  bool in_idat = false;
  for (;;) {
    if (pos + 12 > size) return kErrFormat;
    const uint32_t len = rd32be(bytes + pos);
    const uint8_t* type = bytes + pos + 4;
    if (len > 0x7FFFFFFFu || pos + 12 + len > size) return kErrFormat;
    const uint8_t* d = type + 4;
    const bool critical = !(type[0] & 0x20);
    if (critical && crc32(type, 4 + len) != rd32be(d + len)) return kErrFormat;
    const bool is_idat = std::memcmp(type, "IDAT", 4) == 0;
    if (in_idat && !is_idat) break;  // libpng reads no further for the rows
    if (!have_ihdr && std::memcmp(type, "IHDR", 4) != 0) return kErrFormat;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (have_ihdr || len != 13) return kErrFormat;
      width = rd32be(d);
      height = rd32be(d + 4);
      depth = d[8];
      color = d[9];
      interlace = d[12];
      if (width == 0 || height == 0 || width > 1000000 || height > 1000000 ||
          d[10] != 0 || d[11] != 0 || interlace > 1)
        return kErrFormat;
      const bool depth_ok =
          color == 0   ? (depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16)
          : color == 3 ? (depth == 1 || depth == 2 || depth == 4 || depth == 8)
          : (color == 2 || color == 4 || color == 6) ? (depth == 8 || depth == 16)
                                                     : false;
      if (!depth_ok) return kErrFormat;
      have_ihdr = true;
      // libpng checks the size as soon as png_read_info has the header
      if (static_cast<int>(width) != w || static_cast<int>(height) != h) return kErrShape;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (color == 3) {
        if (len % 3 || len > 768 || len == 0) return kErrFormat;
        for (uint32_t i = 0; i < len / 3; ++i)
          for (int k = 0; k < 3; ++k) palette[i][k] = d[3 * i + k];
        have_plte = true;
      }
    } else if (is_idat) {
      if (color == 3 && !have_plte) return kErrFormat;
      idat.insert(idat.end(), d, d + len);
      in_idat = true;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    } else if (critical) {
      return kErrFormat;  // an unknown critical chunk
    }
    pos += 12 + len;
  }
  if (!in_idat) return kErrFormat;

  const int channels = color == 0 ? 1 : color == 2 ? 3 : color == 3 ? 1 : color == 4 ? 2 : 4;
  const int bpp_bits = channels * depth;
  const int bpp = bpp_bits < 8 ? 1 : bpp_bits / 8;
  struct Pass {
    int x0, y0, dx, dy;
  };
  static const Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                 {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const Pass kWhole = {0, 0, 1, 1};
  const Pass* passes = interlace ? kAdam7 : &kWhole;
  const int npass = interlace ? 7 : 1;
  size_t need = 0;
  for (int i = 0; i < npass; ++i) {
    const Pass& p = passes[i];
    const size_t pw = (width - p.x0 + p.dx - 1) / p.dx;
    const size_t ph = (height - p.y0 + p.dy - 1) / p.dy;
    if (width > static_cast<uint32_t>(p.x0) && height > static_cast<uint32_t>(p.y0))
      need += ph * (1 + (pw * bpp_bits + 7) / 8);
  }
  Inflate inf(idat.data(), idat.size(), need);
  if (!inf.run() || inf.out.size() < need) return kErrFormat;

  const uint8_t* src = inf.out.data();
  const int maxv = (1 << depth) - 1;
  const int scale = depth < 8 ? 255 / maxv : 1;
  std::vector<uint8_t> prev, cur;
  for (int i = 0; i < npass; ++i) {
    const Pass& p = passes[i];
    if (width <= static_cast<uint32_t>(p.x0) || height <= static_cast<uint32_t>(p.y0)) continue;
    const int pw = static_cast<int>((width - p.x0 + p.dx - 1) / p.dx);
    const int ph = static_cast<int>((height - p.y0 + p.dy - 1) / p.dy);
    const size_t rowbytes = (static_cast<size_t>(pw) * bpp_bits + 7) / 8;
    prev.assign(rowbytes, 0);
    cur.resize(rowbytes);
    for (int r = 0; r < ph; ++r) {
      const int filter = *src++;
      for (size_t k = 0; k < rowbytes; ++k) {
        const int x = src[k];
        const int a = k >= static_cast<size_t>(bpp) ? cur[k - bpp] : 0;
        const int b = prev[k];
        const int c = k >= static_cast<size_t>(bpp) ? prev[k - bpp] : 0;
        int v;
        switch (filter) {
          case 0: v = x; break;
          case 1: v = x + a; break;
          case 2: v = x + b; break;
          case 3: v = x + ((a + b) >> 1); break;
          case 4: {
            const int pp = a + b - c;
            const int pa = pp > a ? pp - a : a - pp;
            const int pb = pp > b ? pp - b : b - pp;
            const int pc = pp > c ? pp - c : c - pp;
            v = x + (pa <= pb && pa <= pc ? a : pb <= pc ? b : c);
            break;
          }
          default: return kErrFormat;
        }
        cur[k] = static_cast<uint8_t>(v);
      }
      src += rowbytes;
      const int y = p.y0 + r * p.dy;
      for (int q = 0; q < pw; ++q) {
        uint8_t* o = out + (static_cast<size_t>(y) * w + p.x0 + q * p.dx) * 3;
        // each channel's sample as 8 bits: the high byte of a 16-bit one
        // (strip_16), a 1/2/4-bit one unpacked MSB first
        auto sample = [&](int ch) -> int {
          if (depth == 16) return cur[(static_cast<size_t>(q) * channels + ch) * 2];
          if (depth == 8) return cur[static_cast<size_t>(q) * channels + ch];
          const size_t bit = static_cast<size_t>(q) * depth;
          return (cur[bit >> 3] >> (8 - depth - (bit & 7))) & maxv;
        };
        if (color == 3) {
          const uint8_t* rgb = palette[sample(0)];  // past the palette: black
          o[0] = rgb[2];
          o[1] = rgb[1];
          o[2] = rgb[0];
        } else if (color == 0 || color == 4) {
          o[0] = o[1] = o[2] = static_cast<uint8_t>(sample(0) * scale);
        } else {
          o[0] = static_cast<uint8_t>(sample(2));
          o[1] = static_cast<uint8_t>(sample(1));
          o[2] = static_cast<uint8_t>(sample(0));
        }
      }
      std::swap(prev, cur);
    }
  }
  return kOk;
}

// ----------------------------------------------------------- AVI RIFF ----

uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

bool tag_is(const uint8_t* p, const char* t) {
  return std::memcmp(p, t, 4) == 0;
}

// Seek-based index pass: walk the RIFF tree reading only chunk headers and
// seeking past payloads, so memory is O(n_frames) at any file size. Takes
// the '00dc'/'00db' video chunks of each movi LIST. Files past ~1 GB are
// OpenDML: `RIFF....AVIX` segments follow the primary `RIFF....AVI ` one,
// each with its own movi LIST, and every segment is indexed.
bool index_avi_file(const char* path,
                    std::vector<std::pair<size_t, size_t>>* chunks) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  long rpos = 0;
  bool first = true;
  while (rpos + 12 <= fsize) {
    uint8_t hdr[12];
    std::fseek(f, rpos, SEEK_SET);
    if (std::fread(hdr, 1, 12, f) != 12 || !tag_is(hdr, "RIFF")) break;
    bool form_ok = first ? tag_is(hdr + 8, "AVI ")
                         : (tag_is(hdr + 8, "AVIX") || tag_is(hdr + 8, "AVI "));
    if (!form_ok) break;
    first = false;
    uint32_t rsz = rd32(hdr + 4);
    long rend = rpos + 8 + static_cast<long>(rsz);
    if (rend > fsize) rend = fsize;
    long pos = rpos + 12;
    while (pos + 8 <= rend) {
      uint8_t bh[12];
      std::fseek(f, pos, SEEK_SET);
      size_t got = std::fread(bh, 1, 12, f);
      if (got < 8) break;
      uint32_t sz = rd32(bh + 4);
      if (tag_is(bh, "LIST") && got == 12) {
        if (tag_is(bh + 8, "movi")) {
          long mp = pos + 12;
          long mend = pos + 8 + static_cast<long>(sz);
          if (mend > rend) mend = rend;
          while (mp + 8 <= mend) {
            uint8_t ch[8];
            std::fseek(f, mp, SEEK_SET);
            if (std::fread(ch, 1, 8, f) != 8) break;
            uint32_t csz = rd32(ch + 4);
            if ((ch[2] == 'd' && (ch[3] == 'c' || ch[3] == 'b')) &&
                mp + 8 + static_cast<long>(csz) <= fsize) {
              chunks->emplace_back(static_cast<size_t>(mp + 8),
                                   static_cast<size_t>(csz));
            }
            mp += 8 + static_cast<long>(csz) + (csz & 1);
          }
          break;  // one movi per RIFF segment; go to the next segment
        }
        pos += 12;  // descend into other LISTs (hdrl etc.)
        continue;
      }
      pos += 8 + static_cast<long>(sz) + (sz & 1);
    }
    rpos = rend + (rsz & 1);
  }
  std::fclose(f);
  return !chunks->empty();
}

// Per-path chunk-index cache, valid while the file's mtime and size hold,
// so a stream's windows do not parse the container again. Entries are
// copied out under the lock.
struct AviIndex {
  int64_t mtime;
  int64_t fsize;
  std::vector<std::pair<size_t, size_t>> chunks;
};
std::mutex g_avi_mu;
std::map<std::string, AviIndex>& avi_cache() {
  static std::map<std::string, AviIndex>* m = new std::map<std::string, AviIndex>();
  return *m;
}

bool avi_index_cached(const char* path,
                      std::vector<std::pair<size_t, size_t>>* chunks) {
  struct stat st;
  if (::stat(path, &st) != 0) return false;
  const int64_t mtime =
      static_cast<int64_t>(st.st_mtim.tv_sec) * 1000000000 + st.st_mtim.tv_nsec;
  {
    std::lock_guard<std::mutex> lk(g_avi_mu);
    auto it = avi_cache().find(path);
    if (it != avi_cache().end() && it->second.mtime == mtime &&
        it->second.fsize == static_cast<int64_t>(st.st_size)) {
      *chunks = it->second.chunks;
      return true;
    }
  }
  std::vector<std::pair<size_t, size_t>> fresh;
  if (!index_avi_file(path, &fresh)) return false;
  {
    std::lock_guard<std::mutex> lk(g_avi_mu);
    avi_cache()[path] = AviIndex{mtime, static_cast<int64_t>(st.st_size), fresh};
  }
  *chunks = std::move(fresh);
  return true;
}

// Read file bytes [lo, hi): the working set of one decode window.
bool read_span(const char* path, size_t lo, size_t hi,
               std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  out->resize(hi - lo);
  bool ok = std::fseek(f, static_cast<long>(lo), SEEK_SET) == 0 &&
            std::fread(out->data(), 1, out->size(), f) == out->size();
  std::fclose(f);
  return ok;
}

template <typename Fn>
void parallel_for(int n, int threads, Fn fn) {
  if (threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  auto worker = [&] {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
  };
  std::vector<std::thread> pool;
  int nt = threads < n ? threads : n;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Decode n same-size PNGs into out[n, h, w, 3] BGR. Returns 0 or the
// (negative) error code of a failing file; `errs[i]` gets each file's
// status when errs != nullptr.
int ofc_decode_png_batch(const char** paths, int n, uint8_t* out, int h,
                         int w, int threads, int* errs) {
  std::atomic<int> rc{kOk};
  parallel_for(n, threads, [&](int i) {
    std::vector<uint8_t> bytes;
    int st = kErrOpen;
    if (read_file(paths[i], &bytes)) {
      st = decode_png_one(bytes.data(), bytes.size(),
                          out + static_cast<size_t>(i) * h * w * 3, h, w);
    }
    if (errs) errs[i] = st;
    int expect = kOk;
    if (st != kOk) rc.compare_exchange_strong(expect, st);
  });
  return rc.load();
}

// Probe an MJPEG AVI: frame count and the first frame's size, from the
// cached index and that frame's bytes alone.
int ofc_mjpeg_avi_probe(const char* path, int* n, int* h, int* w) {
  std::vector<std::pair<size_t, size_t>> chunks;
  if (!avi_index_cached(path, &chunks)) return kErrFormat;
  std::vector<uint8_t> first;
  if (!read_span(path, chunks[0].first, chunks[0].first + chunks[0].second,
                 &first))
    return kErrOpen;
  if (!jpeg_probe(first.data(), first.size(), h, w)) return kErrFormat;
  *n = static_cast<int>(chunks.size());
  return kOk;
}

int ofc_mjpeg_avi_decode_flags(const char* path, uint8_t* out, int start,
                               int count, int h, int w, int threads,
                               uint8_t* done);

// Decode the first `max_frames` (> 0) frames of an MJPEG AVI into
// out[n, h, w, 3] BGR. Returns the number of frames decoded, or a negative
// error code.
int ofc_mjpeg_avi_decode(const char* path, uint8_t* out, int max_frames,
                         int h, int w, int threads) {
  return ofc_mjpeg_avi_decode_flags(path, out, 0, max_frames, h, w, threads,
                                    nullptr);
}

// Streaming decode: frames [start, start + count) (count > 0) into out,
// publishing each frame's completion into done[i] (0 -> 1, after a release
// fence that orders it behind the frame's pixels), so that a consumer can
// work on the contiguous done prefix while later frames still decode. A
// frame that fails keeps its flag at 0. Returns frames decoded or a
// negative error code.
int ofc_mjpeg_avi_decode_flags(const char* path, uint8_t* out, int start,
                               int count, int h, int w, int threads,
                               uint8_t* done) {
  std::vector<std::pair<size_t, size_t>> chunks;
  if (!avi_index_cached(path, &chunks)) return kErrFormat;
  int total = static_cast<int>(chunks.size());
  if (start < 0 || start >= total || count <= 0) return kErrShape;
  int n = total - start;
  if (count < n) n = count;
  // Read only this window's byte span: memory is O(window), not O(file).
  size_t lo = chunks[start].first;
  size_t hi = lo;
  for (int i = 0; i < n; ++i) {
    size_t c0 = chunks[start + i].first;
    size_t c1 = c0 + chunks[start + i].second;
    if (c0 < lo) lo = c0;
    if (c1 > hi) hi = c1;
  }
  std::vector<uint8_t> buf;
  if (!read_span(path, lo, hi, &buf)) return kErrOpen;
  std::atomic<int> rc{kOk};
  parallel_for(n, threads, [&](int i) {
    int st = decode_jpeg_one(buf.data() + (chunks[start + i].first - lo),
                             chunks[start + i].second,
                             out + static_cast<size_t>(i) * h * w * 3, h, w);
    int expect = kOk;
    if (st != kOk) rc.compare_exchange_strong(expect, st);
    if (done && st == kOk) {
      std::atomic_thread_fence(std::memory_order_release);
      reinterpret_cast<std::atomic<uint8_t>*>(done)[i].store(
          1, std::memory_order_relaxed);
    }
  });
  return rc.load() == kOk ? n : rc.load();
}

// The acquire side of the done flags: the Python consumer reads them with
// plain loads, which pair with the release fence on x86 but not on weakly
// ordered CPUs, so it calls this after it sees new flags and before it
// reads their pixels.
void ofc_acquire_fence() {
  std::atomic_thread_fence(std::memory_order_acquire);
}

}  // extern "C"
