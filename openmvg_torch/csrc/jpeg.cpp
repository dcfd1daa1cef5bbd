// JPEG decoder and encoder of the port, equal to libjpeg-turbo's defaults
// (the library PIL decodes and encodes JPEG with), so that the port reads
// and writes photographs without PIL and sees the same pixels.
//
// Decoder (omt_jpeg_decode):
//   - SOF0, SOF1 (8-bit) and SOF2 (progressive: spectral selection and
//     successive approximation), DRI/RSTn restart intervals, 1 or 3
//     components, any integer sampling ratios (4:4:4, 4:2:2, 4:2:0, 4:4:0);
//   - every scan is decoded into whole-image coefficient planes, then each
//     component goes through the integer "islow" IDCT (jidctint.c:
//     CONST_BITS 13, PASS1_BITS 2, the post-IDCT range-limit table of
//     jdmaster.c), fancy upsampling at its own downsampled size with the
//     last real row and column replicated (jdsample.c h2v1 biases 1/2,
//     h2v2 8/7, h1v2 1/2; plain replication where libjpeg-turbo uses it:
//     downsampled width <= 2, other ratios), and the fixed-point
//     YCbCr->RGB tables of jdcolor.c;
//   - libjpeg's colour-space guess (JFIF, Adobe APP14 transform, component
//     ids 'R','G','B');
//   - a segment that runs out of data leaves its remaining MCUs as they
//     are, as libjpeg does after it hits a marker early.
//   Raised as "unsupported" (the Python wrapper raises NotImplementedError):
//   arithmetic coding (SOF9-SOF15, DAC), lossless and hierarchical frames
//   (SOF3, SOF5-SOF7), samples other than 8 bits, 2 or 4 components
//   (CMYK/YCCK), fractional sampling ratios, and progressive files whose
//   scans leave AC coefficients 1..9 of a component unrefined (libjpeg-turbo
//   then smooths blocks, jdcoefct.c::smoothing_ok).  The EXIF orientation
//   is not applied.
//
// Encoder (omt_jpeg_encode), equal to PIL's default save of a .jpg through
// libjpeg-turbo: quality 75 (jpeg_set_quality's scaling of the Annex K
// tables, clamped to 255 for baseline), RGB as YCbCr 4:2:0 (jccolor.c's
// fixed-point conversion, jcsample.c::h2v2_downsample's alternating bias,
// jcprepct.c's edge expansion, dummy blocks carrying the previous DC as in
// jccoefct.c), gray as one component, the islow forward DCT (jfdctint.c)
// and jcdctmgr.c's reciprocal quantisation, the standard Huffman tables,
// and a JFIF 1.01 APP0 (density 1:1, unit 0).  The marker order is
// jcmarker.c's, so the file is byte-equal to PIL's.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (openmvg_torch/utils/build.py::
// codec_library, at first use, into openmvg_torch/_build/), loaded with
// ctypes by openmvg_torch/io/jpeg.py.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace omt_jpeg {

// Zigzag position -> natural (row-major) position, with libjpeg's 16 extra
// entries so that a corrupt run length stays inside the block.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Failure {
  int code;  // -1 malformed, -2 unsupported
  std::string msg;
};

[[noreturn]] void malformed(const std::string& m) { throw Failure{-1, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Failure{-2, m}; }

// ---------------------------------------------------------------- decoder

struct HuffDecode {
  bool defined = false;
  int max_val = 0;     // a DC table's values are bit counts, at most 15
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[256];  // (code length << 8) | value, 0 when longer than 8 bits

  void build(const uint8_t bits[17], const uint8_t* v, int nv) {
    std::memcpy(vals, v, nv);
    max_val = 0;
    for (int i = 0; i < nv; ++i) max_val = std::max(max_val, (int)v[i]);
    int huffsize[257], huffcode[257], p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) malformed("bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 8; ++l)
      for (int i = 0; i < bits[l]; ++i, ++p) {
        const int lookbits = huffcode[p] << (8 - l);
        for (int ctr = 1 << (8 - l); ctr > 0; --ctr)
          look[lookbits + ctr - 1] = (uint16_t)((l << 8) | vals[p]);
      }
    defined = true;
  }
};

// MSB-first entropy-coded bits; at a marker it supplies zeros, and a
// consumer that needs more bits than the segment holds sets `insufficient`.
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0, real = 0;
  bool marker = false, insufficient = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t c = 0;
      if (!marker && pos < n) {
        c = d[pos];
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          if (q < n && d[q] == 0) {
            pos = q + 1;
          } else {
            marker = true;  // pos stays on the marker's first 0xFF
            c = 0;
          }
        } else {
          ++pos;
        }
        if (!marker) real += 8;
      }
      buf |= (uint64_t)c << (56 - cnt);
      cnt += 8;
    }
  }
  void consume(int k) {
    if (k > real) { insufficient = true; real = 0; } else { real -= k; }
    buf <<= k;
    cnt -= k;
  }
  int bits(int k) {  // 1 <= k <= 16
    if (cnt < k) fill();
    const int v = (int)(buf >> (64 - k));
    consume(k);
    return v;
  }
  int bit() { return bits(1); }
  int decode(const HuffDecode& t) {
    if (cnt < 16) fill();
    const uint16_t e = t.look[buf >> 56];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int code = (int)(buf >> 56), l = 8;
    uint64_t b = buf << 8;
    while (code > t.maxcode[l]) {
      code = (code << 1) | (int)(b >> 63);
      b <<= 1;
      if (++l > 16) {  // corrupt data: libjpeg fakes a zero
        consume(16);
        return 0;
      }
    }
    consume(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  void reset() { buf = 0; cnt = 0; real = 0; }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;          // downsampled size in samples
  int bw = 0, bh = 0;          // blocks holding real samples
  int bw_pad = 0, bh_pad = 0;  // blocks of the interleaved MCU grid
  std::vector<int16_t> coef;   // bh_pad * bw_pad blocks of 64, natural order
  uint16_t qt[64];
  bool latched = false;
  int dc_pred = 0;
  int coef_bits[64];
  int16_t* block(int by, int bx) { return &coef[((size_t)by * bw_pad + bx) * 64]; }
};

struct Decoder {
  const uint8_t* d;
  size_t n, pos = 0;
  uint16_t qtab[4][64];
  bool qdef[4] = {false, false, false, false};
  HuffDecode dc[4], ac[4];
  int W = 0, H = 0, nc = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  bool sof = false, progressive = false, jfif = false, adobe = false;
  int adobe_transform = -1, restart_interval = 0;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) malformed("truncated JPEG file");
    return d[pos++];
  }
  int u16() {
    const int a = u8();
    return (a << 8) | u8();
  }
  int next_marker() {  // skips bytes up to 0xFF, then fill bytes
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) malformed("truncated JPEG file: no EOI marker");
    return d[pos++];
  }

  void read_sof(int marker) {
    const size_t len = u16();  // before `pos` is read
    const size_t end = pos + len - 2;
    const int P = u8();
    H = u16();
    W = u16();
    nc = u8();
    if (sof) malformed("more than one SOF marker");
    sof = true;
    progressive = marker == 0xC2;
    if (P != 8)
      unsupported("SOF" + std::to_string(marker - 0xC0) + " with " + std::to_string(P) +
                  "-bit samples (only 8-bit samples are decoded)");
    if (H == 0) unsupported("image height defined by a DNL marker");
    if (W == 0) malformed("image width 0");
    if (nc == 4) unsupported("4 components (CMYK/YCCK)");
    if (nc != 1 && nc != 3)
      unsupported(std::to_string(nc) + " components (only 1 and 3 are decoded)");
    for (int i = 0; i < nc; ++i) {
      comp[i].id = u8();
      const int hv = u8();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = u8();
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4 || comp[i].tq > 3)
        malformed("bad sampling factors or table number in SOF");
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < nc; ++i) {
      Component& c = comp[i];
      c.dw = (int)(((int64_t)W * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)H * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.bw_pad = mcux * c.h;
      c.bh_pad = mcuy * c.v;
      c.coef.assign((size_t)c.bw_pad * c.bh_pad * 64, 0);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    pos = end;
  }

  void read_dht() {
    const size_t len = u16();  // before `pos` is read
    const size_t end = pos + len - 2;
    while (pos < end) {
      const int tc_th = u8();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += bits[l] = (uint8_t)u8();
      if (count > 256 || (tc_th & 15) > 3) malformed("bad DHT marker");
      uint8_t vals[256];
      for (int i = 0; i < count; ++i) vals[i] = (uint8_t)u8();
      (tc_th & 0x10 ? ac : dc)[tc_th & 15].build(bits, vals, count);
    }
    pos = end;
  }

  void read_dqt() {
    const size_t len = u16();  // before `pos` is read
    const size_t end = pos + len - 2;
    while (pos < end) {
      const int pq_tq = u8();
      if ((pq_tq & 15) > 3) malformed("bad DQT marker");
      uint16_t* q = qtab[pq_tq & 15];
      for (int i = 0; i < 64; ++i) q[kNatural[i]] = (uint16_t)(pq_tq >> 4 ? u16() : u8());
      qdef[pq_tq & 15] = true;
    }
    pos = end;
  }

  void read_app(int marker) {
    const int len = u16();
    const size_t end = pos + len - 2;
    if (end > n) malformed("truncated marker segment");
    if (marker == 0xE0 && len >= 16 && std::memcmp(d + pos, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && len >= 14 && std::memcmp(d + pos, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[pos + 11];
    }
    pos = end;
  }

  // ------------------------------------------------------------ one scan
  Component* sc[4];
  int ns = 0, Ss = 0, Se = 63, Ah = 0, Al = 0;
  int td[4], ta[4];
  int eobrun = 0;

  void decode_baseline(BitReader& br, int ci, int16_t* blk) {
    Component& c = *sc[ci];
    int s = br.decode(dc[td[ci]]);
    if (s) s = extend(br.bits(s), s);
    c.dc_pred = (int)((unsigned)c.dc_pred + (unsigned)s);
    blk[0] = (int16_t)c.dc_pred;
    const HuffDecode& t = ac[ta[ci]];
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(t);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(br.bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(BitReader& br, int ci, int16_t* blk) {
    Component& c = *sc[ci];
    int s = br.decode(dc[td[ci]]);
    if (s) s = extend(br.bits(s), s);
    c.dc_pred = (int)((unsigned)c.dc_pred + (unsigned)s);
    blk[0] = (int16_t)((unsigned)c.dc_pred << Al);
  }

  void decode_dc_refine(BitReader& br, int16_t* blk) {
    if (br.bit()) blk[0] = (int16_t)(blk[0] | (1 << Al));
  }

  void decode_ac_first(BitReader& br, int ci, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const HuffDecode& t = ac[ta[ci]];
    for (int k = Ss; k <= Se; ++k) {
      const int rs = br.decode(t);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)((unsigned)extend(br.bits(s), s) << Al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        --eobrun;
        break;
      }
    }
  }

  void decode_ac_refine(BitReader& br, int ci, int16_t* blk) {
    const int p1 = 1 << Al, m1 = -1 * (1 << Al);
    int k = Ss;
    if (eobrun == 0) {
      const HuffDecode& t = ac[ta[ci]];
      for (; k <= Se; ++k) {
        const int rs = br.decode(t);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.bit() && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.bit() && (*coef & p1) == 0)
          *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun;
    }
  }

  void decode_block(BitReader& br, int ci, int16_t* blk) {
    if (!progressive) decode_baseline(br, ci, blk);
    else if (Ss == 0) { if (Ah == 0) decode_dc_first(br, ci, blk); else decode_dc_refine(br, blk); }
    else if (Ah == 0) decode_ac_first(br, ci, blk);
    else decode_ac_refine(br, ci, blk);
  }

  void restart(BitReader& br, int& expected) {
    br.reset();
    size_t p = br.pos;
    while (p < n && d[p] != 0xFF) ++p;
    size_t q = p;
    while (q < n && d[q] == 0xFF) ++q;
    if (q < n && d[q] >= 0xD0 && d[q] <= 0xD7) {  // RSTn: consume it
      br.pos = q + 1;
      br.marker = false;
      br.insufficient = false;
    } else {  // not a restart marker: the rest of the scan has no data
      br.pos = p;
      br.marker = true;
    }
    expected = (expected + 1) & 7;
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    eobrun = 0;
  }

  void read_sos() {
    if (!sof) malformed("SOS before SOF");
    const size_t len = u16();  // before `pos` is read
    const size_t end = pos + len - 2;
    ns = u8();
    if (ns < 1 || ns > 4) malformed("bad SOS component count");
    for (int i = 0; i < ns; ++i) {
      const int id = u8(), t = u8();
      int ci = -1;
      for (int j = 0; j < nc; ++j)
        if (comp[j].id == id) ci = j;
      if (ci < 0) malformed("SOS names an unknown component");
      sc[i] = &comp[ci];
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3) malformed("bad Huffman table number in SOS");
    }
    Ss = u8();
    Se = u8();
    const int a = u8();
    Ah = a >> 4;
    Al = a & 15;
    pos = end;
    if (!progressive) {
      Ss = 0; Se = 63; Ah = 0; Al = 0;
    } else {
      if (Ss > Se || Se > 63 || Al > 13 || (Ss == 0 && Se != 0) || (Ss > 0 && ns != 1))
        malformed("bad progressive scan parameters");
      for (int i = 0; i < ns; ++i)
        for (int k = Ss; k <= Se; ++k) sc[i]->coef_bits[k] = Al;
    }
    for (int i = 0; i < ns; ++i) {  // latch each component's table at its first scan
      Component& c = *sc[i];
      if (c.latched) continue;
      if (!qdef[c.tq]) malformed("component refers to an undefined quantisation table");
      std::memcpy(c.qt, qtab[c.tq], sizeof(c.qt));
      c.latched = true;
    }
    const bool need_dc = !progressive || (Ss == 0 && Ah == 0);
    const bool need_ac = !progressive || Ss > 0;
    for (int i = 0; i < ns; ++i) {
      if (need_dc && !dc[td[i]].defined) malformed("scan uses an undefined DC Huffman table");
      if (need_dc && dc[td[i]].max_val > 15) malformed("bad Huffman table");  // as jdhuff.c
      if (need_ac && !ac[ta[i]].defined) malformed("scan uses an undefined AC Huffman table");
      sc[i]->dc_pred = 0;
    }
    eobrun = 0;

    BitReader br{d, n, pos};
    int to_go = restart_interval, expected = 0;
    auto mcu_start = [&]() {
      if (restart_interval) {
        if (to_go == 0) {
          restart(br, expected);
          to_go = restart_interval;
        }
        --to_go;
      }
    };
    if (ns == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx) {
          mcu_start();
          if (!br.insufficient) decode_block(br, 0, c.block(by, bx));
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          mcu_start();
          if (br.insufficient) continue;
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int yy = 0; yy < c.v; ++yy)
              for (int xx = 0; xx < c.h; ++xx)
                decode_block(br, i, c.block(my * c.v + yy, mx * c.h + xx));
          }
        }
    }
    pos = br.pos;  // at the next marker, or at padding bits before it
  }

  void parse() {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8) malformed("not a JPEG file (no SOI marker)");
    pos = 2;
    bool scanned = false;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m);
      } else if (m == 0xC3) {
        unsupported("SOF3 (lossless JPEG)");
      } else if (m >= 0xC5 && m <= 0xC7) {
        unsupported("SOF" + std::to_string(m - 0xC0) + " (hierarchical JPEG)");
      } else if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF)) {
        unsupported("SOF" + std::to_string(m - 0xC0) + " (arithmetic coding)");
      } else if (m == 0xCC) {
        unsupported("DAC (arithmetic coding)");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        u16();
        restart_interval = u16();
      } else if (m == 0xDA) {
        read_sos();
        scanned = true;
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // a stray RSTn or TEM carries no segment
      } else if (m == 0xD8) {
        malformed("SOI marker inside the file");
      } else {
        read_app(m);
      }
    }
    if (!scanned) malformed("JPEG file without a scan");
    if (progressive) check_smoothing();
  }

  // libjpeg-turbo smooths blocks (jdcoefct.c::smoothing_ok) when every
  // component's DC is known and some AC coefficient 1..9 is not final.
  void check_smoothing() {
    static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < nc; ++i) {
      const Component& c = comp[i];
      if (!c.latched) return;
      for (int k = 0; k < 10; ++k)
        if (c.qt[kQ[k]] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful)
      unsupported("progressive JPEG whose scans leave AC coefficients 1..9 unrefined "
                  "(libjpeg's block smoothing)");
  }

  // ------------------------------------------------------ pixel pipeline
  struct LimitTable {
    uint8_t v[1024];
    LimitTable() {
      for (int i = 0; i < 1024; ++i)
        v[i] = (uint8_t)(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
    }
  };
  static const uint8_t* idct_limit() {  // jdmaster.c prepare_range_limit_table
    static const LimitTable table;  // initialised once, thread-safe
    return table.v;
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    const uint8_t* lim = idct_limit();
    int ws[64];
    for (int col = 0; col < 8; ++col) {
      const int16_t* ip = in + col;
      const uint16_t* qp = q + col;
      int* wp = ws + col;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        const int dcval = (ip[0] * qp[0]) * 4;
        for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
        continue;
      }
      int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
      const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298; tmp1 *= F2053; tmp2 *= F3072; tmp3 *= F1501;
      z1 *= -F0899; z2 *= -F2562; z3 *= -F1961; z4 *= -F0390;
      z3 += z5; z4 += z5;
      tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
      const int64_t rnd = 1 << 10;  // DESCALE by CONST_BITS - PASS1_BITS = 11
      wp[0] = (int)((t10 + tmp3 + rnd) >> 11);
      wp[56] = (int)((t10 - tmp3 + rnd) >> 11);
      wp[8] = (int)((t11 + tmp2 + rnd) >> 11);
      wp[48] = (int)((t11 - tmp2 + rnd) >> 11);
      wp[16] = (int)((t12 + tmp1 + rnd) >> 11);
      wp[40] = (int)((t12 - tmp1 + rnd) >> 11);
      wp[24] = (int)((t13 + tmp0 + rnd) >> 11);
      wp[32] = (int)((t13 - tmp0 + rnd) >> 11);
    }
    for (int row = 0; row < 8; ++row) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + (size_t)row * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        const uint8_t v = lim[((wp[0] + 16) >> 5) & 1023];
        for (int c = 0; c < 8; ++c) op[c] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * 8192, tmp1 = ((int64_t)wp[0] - wp[4]) * 8192;
      const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = wp[7]; tmp1 = wp[5]; tmp2 = wp[3]; tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298; tmp1 *= F2053; tmp2 *= F3072; tmp3 *= F1501;
      z1 *= -F0899; z2 *= -F2562; z3 *= -F1961; z4 *= -F0390;
      z3 += z5; z4 += z5;
      tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
      const int64_t rnd = (int64_t)1 << 17;  // DESCALE by CONST_BITS + PASS1_BITS + 3 = 18
      op[0] = lim[(int)((t10 + tmp3 + rnd) >> 18) & 1023];
      op[7] = lim[(int)((t10 - tmp3 + rnd) >> 18) & 1023];
      op[1] = lim[(int)((t11 + tmp2 + rnd) >> 18) & 1023];
      op[6] = lim[(int)((t11 - tmp2 + rnd) >> 18) & 1023];
      op[2] = lim[(int)((t12 + tmp1 + rnd) >> 18) & 1023];
      op[5] = lim[(int)((t12 - tmp1 + rnd) >> 18) & 1023];
      op[3] = lim[(int)((t13 + tmp0 + rnd) >> 18) & 1023];
      op[4] = lim[(int)((t13 - tmp0 + rnd) >> 18) & 1023];
    }
  }

  // The component's samples (dw x dh of a plane of bw*8 columns), upsampled
  // to (dw * hr) x (dh * vr).
  std::vector<uint8_t> component_plane(Component& c, int& ow, int& oh) {
    const int stride = c.bw * 8;
    std::vector<uint8_t> plane((size_t)stride * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.block(by, bx), c.qt, &plane[(size_t)by * 8 * stride + bx * 8], stride);
    if (hmax % c.h || vmax % c.v) unsupported("fractional sampling ratios");
    const int hr = hmax / c.h, vr = vmax / c.v, dw = c.dw, dh = c.dh;
    ow = dw * hr;
    oh = dh * vr;
    if (hr == 1 && vr == 1) {
      std::vector<uint8_t> out((size_t)ow * oh);
      for (int r = 0; r < dh; ++r) std::memcpy(&out[(size_t)r * ow], &plane[(size_t)r * stride], dw);
      return out;
    }
    std::vector<uint8_t> out((size_t)ow * oh);
    auto row = [&](int r) { return &plane[(size_t)std::min(std::max(r, 0), dh - 1) * stride]; };
    if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      for (int r = 0; r < dh; ++r) {
        const uint8_t* in = row(r);
        uint8_t* o = &out[(size_t)r * ow];
        o[0] = in[0];
        o[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
        for (int i = 1; i < dw - 1; ++i) {
          o[2 * i] = (uint8_t)((in[i] * 3 + in[i - 1] + 1) >> 2);
          o[2 * i + 1] = (uint8_t)((in[i] * 3 + in[i + 1] + 2) >> 2);
        }
        o[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        o[2 * dw - 1] = in[dw - 1];
      }
    } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      for (int r = 0; r < dh; ++r)
        for (int half = 0; half < 2; ++half) {
          const uint8_t* in0 = row(r);
          const uint8_t* in1 = row(half ? r + 1 : r - 1);
          const int bias = half ? 2 : 1;
          uint8_t* o = &out[(size_t)(2 * r + half) * ow];
          for (int i = 0; i < dw; ++i) o[i] = (uint8_t)((in0[i] * 3 + in1[i] + bias) >> 2);
        }
    } else if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      std::vector<int> cs(dw);
      for (int r = 0; r < dh; ++r)
        for (int half = 0; half < 2; ++half) {
          const uint8_t* in0 = row(r);
          const uint8_t* in1 = row(half ? r + 1 : r - 1);
          for (int i = 0; i < dw; ++i) cs[i] = in0[i] * 3 + in1[i];
          uint8_t* o = &out[(size_t)(2 * r + half) * ow];
          o[0] = (uint8_t)((cs[0] * 4 + 8) >> 4);
          o[1] = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
          for (int i = 1; i < dw - 1; ++i) {
            o[2 * i] = (uint8_t)((cs[i] * 3 + cs[i - 1] + 8) >> 4);
            o[2 * i + 1] = (uint8_t)((cs[i] * 3 + cs[i + 1] + 7) >> 4);
          }
          o[2 * dw - 2] = (uint8_t)((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
          o[2 * dw - 1] = (uint8_t)((cs[dw - 1] * 4 + 7) >> 4);
        }
    } else {  // replication (int_upsample, h2v1_upsample, h2v2_upsample)
      for (int r = 0; r < oh; ++r) {
        const uint8_t* in = row(r / vr);
        uint8_t* o = &out[(size_t)r * ow];
        for (int i = 0; i < ow; ++i) o[i] = in[i / hr];
      }
    }
    return out;
  }

  struct YccTables {  // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    YccTables() {
      for (int i = 0; i < 256; ++i) {
        const int64_t x = i - 128;
        cr_r[i] = (int)((91881 * x + 32768) >> 16);
        cb_b[i] = (int)((116130 * x + 32768) >> 16);
        cr_g[i] = (int)(-46802 * x);
        cb_g[i] = (int)(-22554 * x + 32768);
      }
    }
  };

  void pixels(uint8_t* out) {
    if (nc == 1) {
      int ow, oh;
      std::vector<uint8_t> y = component_plane(comp[0], ow, oh);
      for (int r = 0; r < H; ++r) std::memcpy(out + (size_t)r * W, &y[(size_t)r * ow], W);
      return;
    }
    int ow[3], oh[3];
    std::vector<uint8_t> p[3];
    for (int i = 0; i < 3; ++i) p[i] = component_plane(comp[i], ow[i], oh[i]);
    bool rgb = false;  // jdapimin.c default_decompress_parms
    if (jfif) rgb = false;
    else if (adobe) rgb = adobe_transform == 0;
    else rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    if (rgb) {
      for (int r = 0; r < H; ++r)
        for (int x = 0; x < W; ++x)
          for (int i = 0; i < 3; ++i) out[((size_t)r * W + x) * 3 + i] = p[i][(size_t)r * ow[i] + x];
      return;
    }
    static const YccTables t;
    const int *cr_r = t.cr_r, *cb_b = t.cb_b, *cr_g = t.cr_g, *cb_g = t.cb_g;
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int r = 0; r < H; ++r) {
      const uint8_t* yy = &p[0][(size_t)r * ow[0]];
      const uint8_t* cb = &p[1][(size_t)r * ow[1]];
      const uint8_t* cr = &p[2][(size_t)r * ow[2]];
      uint8_t* o = out + (size_t)r * W * 3;
      for (int x = 0; x < W; ++x) {
        const int y = yy[x];
        o[3 * x] = clamp(y + cr_r[cr[x]]);
        o[3 * x + 1] = clamp(y + ((cb_g[cb[x]] + cr_g[cr[x]]) >> 16));
        o[3 * x + 2] = clamp(y + cb_b[cb[x]]);
      }
    }
  }
};

// ---------------------------------------------------------------- encoder

const uint8_t kLumQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                           14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                           18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                           49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChrQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                           24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                           99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                           99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
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
const uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
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

struct HuffEncode {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t bits[17], const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        code[vals[p]] = (uint16_t)c++;
        size[vals[p]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

// jcdctmgr.c compute_reciprocal with 16-bit DCTELEM (libjpeg-turbo's SIMD
// build): divisor d = 8 q; returns reciprocal, correction and shift.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1ull << r) / divisor);
  const uint32_t fr = (uint32_t)((1ull << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return Divisor{fq & 0xFFFF, c & 0xFFFF, r};
}

void fdct_islow(int* data) {  // jfdctint.c, in place on centred samples
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    const int sh = pass ? 15 : 11;  // CONST_BITS + PASS1_BITS, CONST_BITS - PASS1_BITS
    for (int ctr = 0; ctr < 8; ++ctr) {
      int* p = data + ctr * next;
      const int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      const int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      const int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      const int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0] = (int)((t10 + t11) * 4);
        p[4 * step] = (int)((t10 - t11) * 4);
      } else {
        p[0] = (int)((t10 + t11 + 2) >> 2);
        p[4 * step] = (int)((t10 - t11 + 2) >> 2);
      }
      const int64_t rnd = (int64_t)1 << (sh - 1);
      int64_t z1 = (t12 + t13) * F0541;
      p[2 * step] = (int)((z1 + t13 * F0765 + rnd) >> sh);
      p[6 * step] = (int)((z1 + t12 * -F1847 + rnd) >> sh);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int64_t z5 = (z3 + z4) * F1175;
      const int64_t a4 = tmp4 * F0298, a5 = tmp5 * F2053, a6 = tmp6 * F3072, a7 = tmp7 * F1501;
      z1 *= -F0899; z2 *= -F2562; z3 *= -F1961; z4 *= -F0390;
      z3 += z5; z4 += z5;
      p[7 * step] = (int)((a4 + z1 + z3 + rnd) >> sh);
      p[5 * step] = (int)((a5 + z2 + z4 + rnd) >> sh);
      p[3 * step] = (int)((a6 + z2 + z3 + rnd) >> sh);
      p[step] = (int)((a7 + z1 + z4 + rnd) >> sh);
    }
  }
}

struct Writer {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int nbits = 0;
  void byte(int b) { out.push_back((uint8_t)b); }
  void u16(int v) { byte(v >> 8); byte(v & 0xFF); }
  void marker(int m) { byte(0xFF); byte(m); }
  void put(uint32_t code, int size) {
    if (!size) return;
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      const int c = (acc >> (nbits - 8)) & 0xFF;
      byte(c);
      if (c == 0xFF) byte(0);
      nbits -= 8;
    }
  }
  void flush() { put(0x7F, 7); nbits = 0; acc = 0; }
};

struct Encoder {
  Writer w;
  HuffEncode dch[2], ach[2];
  Divisor div[2][64];
  uint8_t qt[2][64];

  Encoder() {
    for (int i = 0; i < 64; ++i) {  // jpeg_set_quality(75, TRUE): scale 50
      qt[0][i] = (uint8_t)std::min<long>(255, std::max<long>(1, (kLumQ[i] * 50L + 50) / 100));
      qt[1][i] = (uint8_t)std::min<long>(255, std::max<long>(1, (kChrQ[i] * 50L + 50) / 100));
      div[0][i] = reciprocal(qt[0][i] * 8u);
      div[1][i] = reciprocal(qt[1][i] * 8u);
    }
    dch[0].build(kDcLumBits, kDcVals);
    dch[1].build(kDcChrBits, kDcVals);
    ach[0].build(kAcLumBits, kAcLumVals);
    ach[1].build(kAcChrBits, kAcChrVals);
  }

  // One block of samples (8 rows of `stride`) -> quantised coefficients.
  void forward(const uint8_t* s, int stride, int t, int16_t* coef) {
    int data[64];
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) data[r * 8 + c] = s[(size_t)r * stride + c] - 128;
    fdct_islow(data);
    for (int i = 0; i < 64; ++i) {
      const Divisor& dv = div[t][i];
      const int v = data[i];
      const uint32_t a = (uint32_t)(v < 0 ? -v : v);
      const uint32_t q = (uint32_t)((((a + dv.corr) & 0xFFFF) * (uint64_t)dv.recip) >> dv.shift);
      coef[i] = (int16_t)(v < 0 ? -(int)q : (int)q);
    }
  }

  void encode_block(const int16_t* coef, int& last_dc, int t) {
    int temp = coef[0] - last_dc, temp2 = temp;
    last_dc = coef[0];
    if (temp < 0) { temp = -temp; --temp2; }
    int nb = 0;
    while (temp) { ++nb; temp >>= 1; }
    w.put(dch[t].code[nb], dch[t].size[nb]);
    w.put((uint32_t)temp2, nb);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      temp = coef[kNatural[k]];
      if (temp == 0) { ++r; continue; }
      while (r > 15) { w.put(ach[t].code[0xF0], ach[t].size[0xF0]); r -= 16; }
      temp2 = temp;
      if (temp < 0) { temp = -temp; --temp2; }
      nb = 0;
      while (temp) { ++nb; temp >>= 1; }
      const int i = (r << 4) + nb;
      w.put(ach[t].code[i], ach[t].size[i]);
      w.put((uint32_t)temp2, nb);
      r = 0;
    }
    if (r > 0) w.put(ach[t].code[0], ach[t].size[0]);
  }

  void dqt(int t) {
    w.marker(0xDB);
    w.u16(67);
    w.byte(t);
    for (int i = 0; i < 64; ++i) w.byte(qt[t][kNatural[i]]);
  }
  void dht(int cls, int t, const uint8_t bits[17], const uint8_t* vals) {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    w.marker(0xC4);
    w.u16(2 + 1 + 16 + count);
    w.byte(t + (cls ? 0x10 : 0));
    for (int l = 1; l <= 16; ++l) w.byte(bits[l]);
    for (int i = 0; i < count; ++i) w.byte(vals[i]);
  }

  void headers(int W, int H, int nc) {
    w.marker(0xD8);
    w.marker(0xE0);  // JFIF 1.01 APP0, density 1:1, unit 0, no thumbnail
    w.u16(16);
    const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    for (uint8_t b : jfif) w.byte(b);
    dqt(0);
    if (nc == 3) dqt(1);
    w.marker(0xC0);
    w.u16(8 + 3 * nc);
    w.byte(8);
    w.u16(H);
    w.u16(W);
    w.byte(nc);
    for (int i = 0; i < nc; ++i) {
      w.byte(i + 1);
      w.byte(nc == 3 && i == 0 ? 0x22 : 0x11);
      w.byte(i ? 1 : 0);
    }
    dht(0, 0, kDcLumBits, kDcVals);
    dht(1, 0, kAcLumBits, kAcLumVals);
    if (nc == 3) {
      dht(0, 1, kDcChrBits, kDcVals);
      dht(1, 1, kAcChrBits, kAcChrVals);
    }
    w.marker(0xDA);
    w.u16(6 + 2 * nc);
    w.byte(nc);
    for (int i = 0; i < nc; ++i) {
      w.byte(i + 1);
      w.byte(i ? 0x11 : 0x00);
    }
    w.byte(0);
    w.byte(63);
    w.byte(0);
  }

  void encode_gray(const uint8_t* img, int W, int H) {
    headers(W, H, 1);
    const int bw = (W + 7) / 8, bh = (H + 7) / 8, pw = bw * 8;
    std::vector<uint8_t> strip((size_t)pw * 8);
    int16_t coef[64];
    int last = 0;
    for (int by = 0; by < bh; ++by) {
      for (int r = 0; r < 8; ++r) {  // jcprepct.c / expand_right_edge
        const uint8_t* src = img + (size_t)std::min(by * 8 + r, H - 1) * W;
        uint8_t* dst = &strip[(size_t)r * pw];
        std::memcpy(dst, src, W);
        std::memset(dst + W, src[W - 1], pw - W);
      }
      for (int bx = 0; bx < bw; ++bx) {
        forward(&strip[bx * 8], pw, 0, coef);
        encode_block(coef, last, 0);
      }
    }
    w.flush();
    w.marker(0xD9);
  }

  void encode_rgb(const uint8_t* img, int W, int H) {
    headers(W, H, 3);
    // jccolor.c rgb_ycc_convert (SCALEBITS 16)
    auto fix = [](double x) { return (int32_t)(x * 65536 + 0.5); };
    const int32_t ry = fix(0.299), gy = fix(0.587), by_ = fix(0.114), rcb = fix(0.16874),
                  gcb = fix(0.33126), half = fix(0.5), gcr = fix(0.41869), bcr = fix(0.08131);
    const int32_t cbcr_off = 128 << 16, one_half = 1 << 15;
    const size_t npx = (size_t)W * H;
    std::vector<uint8_t> Y(npx), Cb(npx), Cr(npx);
    for (size_t i = 0; i < npx; ++i) {
      const int r = img[3 * i], g = img[3 * i + 1], b = img[3 * i + 2];
      Y[i] = (uint8_t)((ry * r + gy * g + by_ * b + one_half) >> 16);
      Cb[i] = (uint8_t)((-rcb * r - gcb * g + half * b + cbcr_off + one_half - 1) >> 16);
      Cr[i] = (uint8_t)((half * r - gcr * g - bcr * b + cbcr_off + one_half - 1) >> 16);
    }
    const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
    const int ybw = (W + 7) / 8, ybh = (H + 7) / 8;
    const int ypw = mcux * 16, cpw = mcux * 8;
    const int ch_real = (H + 1) / 2;  // chroma rows from the colour rows
    std::vector<uint8_t> ys((size_t)ypw * 16), cbs((size_t)cpw * 8), crs((size_t)cpw * 8);
    int16_t coef[64];
    int last[3] = {0, 0, 0};
    for (int my = 0; my < mcuy; ++my) {
      for (int r = 0; r < 16; ++r) {  // Y samples, edges replicated
        const uint8_t* src = &Y[(size_t)std::min(my * 16 + r, H - 1) * W];
        uint8_t* dst = &ys[(size_t)r * ypw];
        std::memcpy(dst, src, W);
        std::memset(dst + W, src[W - 1], ypw - W);
      }
      for (int r = 0; r < 8; ++r) {  // jcsample.c h2v2_downsample, bias 1,2,1,2,...
        const int j = std::min(my * 8 + r, ch_real - 1);
        const int r0 = 2 * j, r1 = std::min(2 * j + 1, H - 1);
        for (int p = 0; p < 2; ++p) {
          const uint8_t* pl = p ? Cr.data() : Cb.data();
          const uint8_t* a = pl + (size_t)r0 * W;
          const uint8_t* b = pl + (size_t)r1 * W;
          uint8_t* dst = &(p ? crs : cbs)[(size_t)r * cpw];
          for (int i = 0; i < cpw; ++i) {
            const int c0 = std::min(2 * i, W - 1), c1 = std::min(2 * i + 1, W - 1);
            dst[i] = (uint8_t)((a[c0] + a[c1] + b[c0] + b[c1] + 1 + (i & 1)) >> 2);
          }
        }
      }
      for (int mx = 0; mx < mcux; ++mx) {
        // jccoefct.c compress_data: real blocks, then dummy blocks with the previous DC
        int16_t blocks[4][64];
        const int last_col = ybw % 2 ? ybw % 2 : 2, last_row = ybh % 2 ? ybh % 2 : 2;
        const int blockcnt = mx < mcux - 1 ? 2 : last_col;
        for (int yi = 0; yi < 2; ++yi) {
          int16_t* row = blocks[2 * yi];
          if (my < mcuy - 1 || yi < last_row) {
            for (int bi = 0; bi < blockcnt; ++bi)
              forward(&ys[(size_t)yi * 8 * ypw + mx * 16 + bi * 8], ypw, 0, row + 64 * bi);
            for (int bi = blockcnt; bi < 2; ++bi) {
              std::memset(row + 64 * bi, 0, 64 * sizeof(int16_t));
              row[64 * bi] = row[64 * (bi - 1)];
            }
          } else {
            const int16_t dc = row[-64];
            std::memset(row, 0, 128 * sizeof(int16_t));
            row[0] = row[64] = dc;
          }
        }
        for (int b = 0; b < 4; ++b) encode_block(blocks[b], last[0], 0);
        forward(&cbs[mx * 8], cpw, 1, coef);
        encode_block(coef, last[1], 1);
        forward(&crs[mx * 8], cpw, 1, coef);
        encode_block(coef, last[2], 1);
      }
    }
    w.flush();
    w.marker(0xD9);
  }
};

void set_error(const Failure& f, char* err, int64_t errlen) {
  if (err && errlen > 0) {
    const size_t k = std::min<size_t>(f.msg.size(), (size_t)errlen - 1);
    std::memcpy(err, f.msg.data(), k);
    err[k] = 0;
  }
}

}  // namespace omt_jpeg

extern "C" {

// Decodes `n` bytes of a JPEG file.  On success returns 0, writes
// (width, height, components) to dims and a malloc'ed H*W*components
// buffer (free it with omt_jpeg_free) to *pixels.  Returns -1 for a
// malformed file, -2 for an unsupported kind; `err` then holds the reason.
int64_t omt_jpeg_decode(const uint8_t* data, int64_t n, int32_t* dims, uint8_t** pixels,
                        char* err, int64_t errlen) {
  using namespace omt_jpeg;
  *pixels = nullptr;
  try {
    Decoder dec(data, (size_t)n);
    dec.parse();
    uint8_t* out = (uint8_t*)std::malloc((size_t)dec.W * dec.H * dec.nc);
    if (!out) throw Failure{-1, "out of memory"};
    try {
      dec.pixels(out);
    } catch (...) {
      std::free(out);
      throw;
    }
    dims[0] = dec.W;
    dims[1] = dec.H;
    dims[2] = dec.nc;
    *pixels = out;
    return 0;
  } catch (const Failure& f) {
    set_error(f, err, errlen);
    return f.code;
  } catch (const std::bad_alloc&) {
    set_error(Failure{-1, "out of memory"}, err, errlen);
    return -1;
  }
}

// Encodes an H x W x components (1 gray or 3 RGB) uint8 image as PIL's
// default save of a .jpg does.  Returns the file's length and a malloc'ed
// buffer in *file (free it with omt_jpeg_free), or -1.
int64_t omt_jpeg_encode(const uint8_t* pixels, int64_t width, int64_t height, int32_t comps,
                        uint8_t** file) {
  using namespace omt_jpeg;
  *file = nullptr;
  if (width < 1 || height < 1 || width > 65535 || height > 65535 || (comps != 1 && comps != 3))
    return -1;
  try {
    Encoder enc;
    if (comps == 1) enc.encode_gray(pixels, (int)width, (int)height);
    else enc.encode_rgb(pixels, (int)width, (int)height);
    uint8_t* out = (uint8_t*)std::malloc(enc.w.out.size());
    if (!out) return -1;
    std::memcpy(out, enc.w.out.data(), enc.w.out.size());
    *file = out;
    return (int64_t)enc.w.out.size();
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

void omt_jpeg_free(void* p) { std::free(p); }

}  // extern "C"
