// Entropy decoding of one JPEG scan into coefficient planes.
//
// Huffman decoding is bit-serial, so it is done here and not in numpy:
// yart_tpu_torch/io/jpeg.py parses the markers and tables, calls
// yart_jpeg_scan once per scan with the scan's entropy-coded segment, and
// then dequantises and inverse-transforms the planes in numpy. The four
// procedures are those of ITU T.81 (F.2.2 sequential, G.1.2 progressive)
// as libjpeg-turbo's jdhuff.c and jdphuff.c run them: DC predictors and
// the EOB run reset at each restart marker, a progressive AC refinement
// walks the coefficients already nonzero as G.1.2.3 says, and every
// coefficient is stored as a 16-bit integer (JCOEF). Where libjpeg warns
// and goes on (a bad Huffman code, a run past the band, a marker inside
// the data, a wrong restart marker), this decoder stops with an error.
//
// Each plane is int16 [rows][stride][64]: a component's blocks in raster
// order, each block's 64 coefficients in natural (row-major) order.
// Built with g++ by yart_tpu_torch/kernels/build.py (HOST_LIBRARIES).

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// Zigzag index -> natural index (T.81 figure A.6).
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Canonical Huffman table (T.81 C and F.2.2.3): per code length l, the
// largest code, and the index into vals of the smallest code.
struct Huff {
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  const uint8_t* vals;
};

void make_huff(const uint8_t* counts, const uint8_t* vals, Huff* h) {
  int32_t code = 0, k = 0;
  for (int l = 1; l <= 16; l++) {
    h->valptr[l] = k;
    h->mincode[l] = code;
    code += counts[l - 1];
    k += counts[l - 1];
    h->maxcode[l] = counts[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;
  h->vals = vals;
}

struct Error {};

struct Reader {
  const uint8_t* d;
  int64_t n;
  int64_t pos;
  uint32_t byte;
  int bits;
  char* msg;
  int msglen;

  [[noreturn]] void fail(const char* what) {
    std::snprintf(msg, msglen, "%s", what);
    throw Error();
  }

  int bit() {
    if (bits == 0) {
      if (pos >= n) fail("entropy-coded data ends inside the scan (truncated file)");
      uint32_t b = d[pos];
      if (b == 0xFF) {
        if (pos + 1 >= n) fail("entropy-coded data ends inside the scan (truncated file)");
        uint32_t next = d[pos + 1];
        if (next != 0) {
          std::snprintf(msg, msglen,
                        "marker 0xFF%02X at byte %lld inside the scan's data (truncated or corrupt scan)",
                        next, (long long)pos);
          throw Error();
        }
        pos += 2;
      } else {
        pos += 1;
      }
      byte = b;
      bits = 8;
    }
    bits--;
    return (byte >> bits) & 1;
  }

  int get(int s) {
    int v = 0;
    for (int i = 0; i < s; i++) v = (v << 1) | bit();
    return v;
  }

  int decode(const Huff& h) {
    int32_t code = bit();
    int l = 1;
    while (code > h.maxcode[l]) {
      if (l == 16) fail("bad Huffman code (corrupt scan)");
      code = (code << 1) | bit();
      l++;
    }
    return h.vals[h.valptr[l] + code - h.mincode[l]];
  }

  // Drop the bits left in the current byte and read marker RSTm.
  void restart(int m) {
    bits = 0;
    int64_t p = pos;
    while (p < n && d[p] == 0xFF && p + 1 < n && d[p + 1] == 0xFF) p++;  // fill bytes
    if (p + 1 >= n || d[p] != 0xFF || d[p + 1] != 0xD0 + m) {
      std::snprintf(msg, msglen, "expected restart marker RST%d at byte %lld (corrupt scan)", m,
                    (long long)pos);
      throw Error();
    }
    pos = p + 2;
  }
};

inline int extend(int v, int s) { return s && v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

}  // namespace

extern "C" {

// Decodes one scan. data[pos:] is the entropy-coded segment (just past the
// SOS header). The scan has n_comp components; for component c,
// planes[c] is its coefficient plane with `stride[c]` blocks per row,
// (bh[c], bw[c]) its blocks per MCU, and dc_tab[c] / ac_tab[c] index the
// tables in counts (17 bytes each, count of codes of lengths 1..16) and
// vals (256 bytes each). The scan covers mcus_y x mcus_x MCUs;
// `restart` is the restart interval in MCUs (0: none). progressive: 0
// sequential (Ss = 0, Se = 63), 1 progressive with spectral band
// [ss, se] and successive approximation ah / al. On success writes the
// offset of the first marker after the scan's data into *end and
// returns 0; on a fault writes a message into msg and returns 1.
int yart_jpeg_scan(const uint8_t* data, int64_t len, int64_t pos, int n_comp, int16_t** planes,
                   const int32_t* stride, const int32_t* bh, const int32_t* bw,
                   const int32_t* dc_tab, const int32_t* ac_tab, const uint8_t* counts,
                   const uint8_t* vals, int mcus_y, int mcus_x, int restart, int progressive,
                   int ss, int se, int ah, int al, int64_t* end, char* msg, int msglen) {
  Huff tabs[8];
  for (int t = 0; t < 8; t++) make_huff(counts + 17 * t, vals + 256 * t, &tabs[t]);
  Reader r{data, len, pos, 0, 0, msg, msglen};
  int pred[4] = {0, 0, 0, 0};
  int eobrun = 0;
  const int p1 = 1 << al;
  const int m1 = -1 * (1 << al);
  int64_t n_mcu = (int64_t)mcus_y * mcus_x;
  int next_rst = 0;
  try {
    for (int64_t mcu = 0; mcu < n_mcu; mcu++) {
      if (restart && mcu && mcu % restart == 0) {
        r.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        for (int c = 0; c < 4; c++) pred[c] = 0;
        eobrun = 0;
      }
      int64_t my = mcu / mcus_x, mx = mcu % mcus_x;
      for (int c = 0; c < n_comp; c++) {
        const Huff& dc = tabs[dc_tab[c]];
        const Huff& ac = tabs[4 + ac_tab[c]];
        for (int y = 0; y < bh[c]; y++) {
          for (int x = 0; x < bw[c]; x++) {
            int16_t* blk = planes[c] + ((my * bh[c] + y) * (int64_t)stride[c] + mx * bw[c] + x) * 64;
            if (!progressive) {
              int s = r.decode(dc);
              pred[c] += extend(r.get(s), s);
              blk[0] = (int16_t)pred[c];
              for (int k = 1; k < 64; k++) {
                int rs = r.decode(ac);
                int run = rs >> 4;
                s = rs & 15;
                if (s) {
                  k += run;
                  if (k > 63) r.fail("AC run past coefficient 63 (corrupt scan)");
                  blk[kNatural[k]] = (int16_t)extend(r.get(s), s);
                } else if (run == 15) {
                  k += 15;
                } else {
                  break;
                }
              }
            } else if (ss == 0) {  // DC first or refine
              if (ah == 0) {
                int s = r.decode(dc);
                pred[c] += extend(r.get(s), s);
                blk[0] = (int16_t)(int32_t)((uint32_t)pred[c] << al);
              } else if (r.bit()) {
                blk[0] = (int16_t)(blk[0] | p1);
              }
            } else if (ah == 0) {  // AC first
              if (eobrun > 0) {
                eobrun--;
                continue;
              }
              for (int k = ss; k <= se; k++) {
                int rs = r.decode(ac);
                int run = rs >> 4;
                int s = rs & 15;
                if (s) {
                  k += run;
                  if (k > se) r.fail("AC run past the end of the scan's spectral band (corrupt scan)");
                  blk[kNatural[k]] = (int16_t)(int32_t)((uint32_t)extend(r.get(s), s) << al);
                } else if (run == 15) {
                  k += 15;
                } else {
                  eobrun = 1 << run;
                  if (run) eobrun += r.get(run);
                  eobrun--;
                  break;
                }
              }
            } else {  // AC refine
              int k = ss;
              if (eobrun == 0) {
                for (; k <= se; k++) {
                  int rs = r.decode(ac);
                  int run = rs >> 4;
                  int s = rs & 15;
                  if (s) {
                    if (s != 1) r.fail("AC refinement coefficient of size other than 1 (corrupt scan)");
                    s = r.bit() ? p1 : m1;
                  } else if (run != 15) {
                    eobrun = 1 << run;
                    if (run) eobrun += r.get(run);
                    break;
                  }
                  do {
                    int16_t* co = blk + kNatural[k];
                    if (*co != 0) {
                      if (r.bit() && (*co & p1) == 0) *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
                    } else if (--run < 0) {
                      break;
                    }
                    k++;
                  } while (k <= se);
                  if (s) {
                    if (k > se) r.fail("AC refinement run past the end of the spectral band (corrupt scan)");
                    blk[kNatural[k]] = (int16_t)s;
                  }
                }
              }
              if (eobrun > 0) {
                for (; k <= se; k++) {
                  int16_t* co = blk + kNatural[k];
                  if (*co != 0 && r.bit() && (*co & p1) == 0)
                    *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
                }
                eobrun--;
              }
            }
          }
        }
      }
    }
  } catch (const Error&) {
    return 1;
  }
  // The next marker: skip what is left of the data, stuffed bytes and
  // restart markers (libjpeg's next_marker does the same).
  int64_t p = r.pos;
  while (p + 1 < len) {
    if (data[p] == 0xFF) {
      uint8_t m = data[p + 1];
      if (m != 0 && m != 0xFF && !(m >= 0xD0 && m <= 0xD7)) break;
    }
    p++;
  }
  *end = p + 1 < len ? p : len;
  return 0;
}

}  // extern "C"
