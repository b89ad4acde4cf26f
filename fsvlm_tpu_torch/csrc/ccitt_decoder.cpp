// The port's CCITT fax decoder for TIFF: Modified Huffman RLE (compression
// 2), T.4 one- and two-dimensional (3, T4Options bit 0), T.6 (4) and
// word-aligned RLE (32771), as libtiff 4.7's tif_fax3.c decodes a strip or
// tile, which is how Pillow 12.1 reads them.
//
// libtiff decodes with a bit accumulator filled a byte at a time (its
// NeedBits8 / NeedBits16, zeros padded at the end of the data once any bit
// is left) and state tables looked up 7, 12 or 13 bits at a time
// (mkg3states.c): the mode codes, the white and black run codes and
// eleven zeros for an EOL; a pattern no code covers consumes nothing.
// Runs alternate white and black from white; each row is cleaned up to end
// exactly at its width (CLEANUP_RUNS), then filled, white as 0 bits and
// black as 1 bits (_TIFFFax3fillruns, which also clips the runs it fills:
// the clipped runs are the next row's reference).  A code that does not fit
// ends the row (libtiff's warning), the data running out mid-row fails the
// strip, but for T.6, whose decode of a strip with a row decoded succeeds
// (its other rows stay 0).  T.4's search for a row's EOL running out of
// data switches libtiff 4.7 to decoding without EOLs ("Try to decode (read)
// fax Group 3 data without EOL"): from then on, for this and every later
// strip, rows are decoded with no EOL search, starting over at the first
// byte of the strip, the rows already decoded kept.  FillOrder 2 reads each
// byte's bits from the least significant.

#include <cstdint>
#include <cstring>
#include <vector>

#include "host_common.h"

namespace {

using namespace fsvlm;

enum State : uint8_t {
  kNull, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW, kTermB, kMakeUpW, kMakeUpB, kMakeUp, kEol
};

struct Ent {
  uint8_t state = kNull, width = 0;
  int32_t param = 0;
};

// ITU-T T.4 codes, as "bits" strings, of the run lengths 0..63, the make-up
// lengths 64..1728 and the extended make-up lengths 1792..2560
const char* const kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100"};
const char* const kWhiteMakeUp[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011"};
const char* const kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kBlackMakeUp[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
const char* const kExtMakeUp[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111"};

// mkg3states.c's tables: indexed by the next `bits` bits of the stream, the
// first bit in the least significant place, as libtiff's accumulator holds
// them.
struct Tables {
  Ent white[1 << 12], black[1 << 13], main[1 << 7];
  static void fill(Ent* t, int bits, const char* code, State s, int32_t param) {
    const int n = static_cast<int>(std::strlen(code));
    int base = 0;
    for (int i = 0; i < n; ++i) base |= (code[i] - '0') << i;
    for (int rest = 0; rest < (1 << (bits - n)); ++rest) {
      Ent& e = t[base | rest << n];
      e.state = s;
      e.width = static_cast<uint8_t>(n);
      e.param = param;
    }
  }
  Tables() {
    for (int i = 0; i < 64; ++i) {
      fill(white, 12, kWhiteTerm[i], kTermW, i);
      fill(black, 13, kBlackTerm[i], kTermB, i);
    }
    for (int i = 0; i < 27; ++i) {
      fill(white, 12, kWhiteMakeUp[i], kMakeUpW, 64 * (i + 1));
      fill(black, 13, kBlackMakeUp[i], kMakeUpB, 64 * (i + 1));
    }
    for (int i = 0; i < 13; ++i) {
      fill(white, 12, kExtMakeUp[i], kMakeUp, 1792 + 64 * i);
      fill(black, 13, kExtMakeUp[i], kMakeUp, 1792 + 64 * i);
    }
    fill(white, 12, "00000000000", kEol, 0);
    fill(black, 13, "00000000000", kEol, 0);
    fill(main, 7, "1", kV0, 0);
    fill(main, 7, "011", kVR, 1);
    fill(main, 7, "000011", kVR, 2);
    fill(main, 7, "0000011", kVR, 3);
    fill(main, 7, "010", kVL, 1);
    fill(main, 7, "000010", kVL, 2);
    fill(main, 7, "0000010", kVL, 3);
    fill(main, 7, "001", kHoriz, 0);
    fill(main, 7, "0001", kPass, 0);
    fill(main, 7, "0000001", kExt, 0);
    fill(main, 7, "0000000", kEol, 0);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

uint8_t rev8(uint8_t b) {
  b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

struct Eof {};   // the data ran out with no bit left (libtiff's eof labels)
struct NoEol {}; // an EOL search ran out of data (SYNC_EOL's noEOLFound)
struct Fail {};  // a run array overflowed: libtiff fails the strip

class Fax {
 public:
  bool noeol = false;  // FAXMODE_NOEOL, set by a failed EOL search

  // Fax3SetupState's run arrays: two rounded up to 32 for a reference line
  Fax(const uint8_t* data, size_t n, bool msb_first, int64_t width, bool needs_ref)
      : cp_(data), ep_(data + n), start_(data), msb_(msb_first), lastx_(width) {
    nruns_ = (needs_ref ? 2 * ((width + 31) / 32 * 32) : width) + 3;
    runs_.assign(static_cast<size_t>(2 * nruns_), 0);
    cur_ = runs_.data();
    ref_ = runs_.data() + nruns_;
    ref_[0] = static_cast<uint32_t>(width);
    ref_[1] = 0;
  }

  // compression 2 / 32771: one row, then the byte / word alignment (of the
  // file's bytes: libtiff reads the strip in place from the mapped file)
  void rle_row(uint8_t* row, bool word, uint64_t offset) {
    begin_row();
    expand1d();
    fillruns(row);
    if (!word) {
      clr(avail_ - (avail_ & ~7));
    } else {
      clr(avail_ - (avail_ & ~15));
      if (avail_ == 0 && ((offset + static_cast<uint64_t>(cp_ - start_)) & 1)) ++cp_;
    }
  }

  // compression 3, one-dimensional rows
  void g3_1d_row(uint8_t* row) {
    begin_row();
    sync_or_restart();
    expand1d();
    fillruns(row);
  }

  // compression 3 with T4Options 2D: the tag bit after the EOL picks 1D or 2D
  void g3_2d_row(uint8_t* row) {
    begin_row();
    sync_or_restart();
    need8(1);
    const bool is1d = bits(1);
    clr(1);
    pb_ = ref_;
    b1_ = *pb_++;
    if (is1d)
      expand1d();
    else
      expand2d();
    fillruns(row);
    if (pa_ < cur_ + nruns_) setvalue(0);  // the imaginary change of the reference
    std::swap(cur_, ref_);
  }

  // compression 4: false at the end of the data (EOFB, or an EOL)
  bool g4_row(uint8_t* row) {
    begin_row();
    pb_ = ref_;
    b1_ = *pb_++;
    bool eof = false;
    try {
      expand2d();
    } catch (const Eof&) {
      eof = true;
    }
    if (eof || eol_) {
      fillruns(row);
      return false;
    }
    fillruns(row);
    setvalue(0);
    std::swap(cur_, ref_);
    return true;
  }

 private:
  const uint8_t *cp_, *ep_, *start_;
  bool msb_;
  int64_t lastx_, nruns_;
  uint32_t acc_ = 0;
  int avail_ = 0;
  bool eol_ = false;  // EOLcnt
  std::vector<uint32_t> runs_;
  uint32_t *cur_, *ref_, *pa_ = nullptr, *pb_ = nullptr;
  int64_t a0_ = 0, run_ = 0, b1_ = 0;

  uint32_t next_byte() { return msb_ ? rev8(*cp_++) : *cp_++; }
  void need8(int n) {
    if (avail_ < n) {
      if (cp_ >= ep_) {
        if (avail_ == 0) throw Eof{};
        avail_ = n;
      } else {
        acc_ |= next_byte() << avail_;
        avail_ += 8;
      }
    }
  }
  void need16(int n) {
    if (avail_ < n) {
      if (cp_ >= ep_) {
        if (avail_ == 0) throw Eof{};
        avail_ = n;
      } else {
        acc_ |= next_byte() << avail_;
        if ((avail_ += 8) < n) {
          if (cp_ >= ep_) {
            avail_ = n;
          } else {
            acc_ |= next_byte() << avail_;
            avail_ += 8;
          }
        }
      }
    }
  }
  uint32_t bits(int n) const { return acc_ & ((1u << n) - 1); }
  void clr(int n) {
    avail_ -= n;
    acc_ >>= n;
  }
  const Ent& lookup8(const Ent* t, int w) {
    need8(w);
    const Ent& e = t[bits(w)];
    clr(e.width);
    return e;
  }
  const Ent& lookup16(const Ent* t, int w) {
    need16(w);
    const Ent& e = t[bits(w)];
    clr(e.width);
    return e;
  }

  void begin_row() {
    a0_ = 0;
    run_ = 0;
    pa_ = cur_;
  }
  void setvalue(int64_t x) {
    if (pa_ >= cur_ + nruns_) throw Fail{};
    *pa_++ = static_cast<uint32_t>(run_ + x);
    a0_ += x;
    run_ = 0;
  }
  void cleanup() {  // CLEANUP_RUNS
    if (run_) setvalue(0);
    if (a0_ != lastx_) {
      while (a0_ > lastx_ && pa_ > cur_) a0_ -= *--pa_;
      if (a0_ < lastx_) {
        if (a0_ < 0) a0_ = 0;
        if ((pa_ - cur_) & 1) setvalue(0);
        setvalue(lastx_ - a0_);
      } else if (a0_ > lastx_) {
        setvalue(lastx_);
        setvalue(0);
      }
    }
  }
  // SYNC_EOL, unless the strip is decoded without EOLs; its search running
  // out of data starts that mode, over from the strip's first byte
  void sync_or_restart() {
    if (noeol) return;
    try {
      sync_eol();
    } catch (const NoEol&) {
      noeol = true;
      cp_ = start_;
      acc_ = 0;
      avail_ = 0;
    }
  }
  // NeedBits16 / NeedBits8, the end of the data with no bit left an NoEol
  void need_sync(int n, bool sixteen) {
    if (avail_ < n && cp_ >= ep_ && avail_ == 0) throw NoEol{};
    if (sixteen) need16(n);
    else need8(n);
  }
  void sync_eol() {  // SYNC_EOL
    if (!eol_) {
      for (;;) {
        need_sync(11, true);
        if (bits(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      need_sync(8, false);
      if (bits(8)) break;
      clr(8);
    }
    while (bits(1) == 0) clr(1);
    clr(1);
    eol_ = false;
  }

  // EXPAND1D: white and black runs to the row's end, or an EOL
  void expand1d() {
    const Tables& t = tables();
    try {
      for (;;) {
        for (;;) {
          const Ent& e = lookup16(t.white, 12);
          if (e.state == kEol) {
            eol_ = true;
            cleanup();
            return;
          }
          if (e.state == kTermW) {
            setvalue(e.param);
            break;
          }
          if (e.state == kMakeUpW || e.state == kMakeUp) {
            a0_ += e.param;
            run_ += e.param;
            continue;
          }
          cleanup();  // unexpected("WhiteTable")
          return;
        }
        if (a0_ >= lastx_) break;
        for (;;) {
          const Ent& e = lookup16(t.black, 13);
          if (e.state == kEol) {
            eol_ = true;
            cleanup();
            return;
          }
          if (e.state == kTermB) {
            setvalue(e.param);
            break;
          }
          if (e.state == kMakeUpB || e.state == kMakeUp) {
            a0_ += e.param;
            run_ += e.param;
            continue;
          }
          cleanup();  // unexpected("BlackTable")
          return;
        }
        if (a0_ >= lastx_) break;
        if (pa_[-1] == 0 && pa_[-2] == 0) pa_ -= 2;
      }
    } catch (const Eof&) {
      cleanup();  // prematureEOF
      throw;
    }
    cleanup();
  }

  void check_b1() {
    if (pa_ != cur_)
      while (b1_ <= a0_ && b1_ < lastx_) {
        if (pb_ + 1 >= ref_ + nruns_) throw Fail{};
        b1_ += pb_[0] + pb_[1];
        pb_ += 2;
      }
  }
  // one run of `white` (true) or black in horizontal mode; false: a bad code
  bool horiz_run(bool white) {
    const Tables& t = tables();
    for (;;) {
      const Ent& e = white ? lookup16(t.white, 12) : lookup16(t.black, 13);
      if (e.state == (white ? kTermW : kTermB)) {
        setvalue(e.param);
        return true;
      }
      if (e.state == (white ? kMakeUpW : kMakeUpB) || e.state == kMakeUp) {
        a0_ += e.param;
        run_ += e.param;
        continue;
      }
      return false;
    }
  }

  // EXPAND2D: the modes against the reference line to the row's end
  void expand2d() {
    const Tables& t = tables();
    try {
      while (a0_ < lastx_) {
        if (pa_ >= cur_ + nruns_) throw Fail{};
        const Ent& e = lookup8(t.main, 7);
        switch (e.state) {
          case kPass:
            check_b1();
            if (pb_ + 1 >= ref_ + nruns_) throw Fail{};
            b1_ += *pb_++;
            run_ += b1_ - a0_;
            a0_ = b1_;
            b1_ += *pb_++;
            break;
          case kHoriz: {
            const bool black_first = (pa_ - cur_) & 1;
            if (!horiz_run(!black_first) || !horiz_run(black_first)) {
              cleanup();  // unexpected
              return;
            }
            check_b1();
            break;
          }
          case kV0:
          case kVR:
            check_b1();
            setvalue(b1_ - a0_ + (e.state == kVR ? e.param : 0));
            if (pb_ >= ref_ + nruns_) throw Fail{};
            b1_ += *pb_++;
            break;
          case kVL:
            check_b1();
            if (b1_ < a0_ + e.param) {
              cleanup();  // unexpected("VL")
              return;
            }
            setvalue(b1_ - a0_ - e.param);
            b1_ -= *--pb_;
            break;
          case kExt:
            *pa_++ = static_cast<uint32_t>(lastx_ - a0_);
            cleanup();  // uncompressed data: not supported
            return;
          case kEol:
            *pa_++ = static_cast<uint32_t>(lastx_ - a0_);
            need8(4);
            clr(4);
            eol_ = true;
            cleanup();
            return;
          default:
            cleanup();
            return;
        }
      }
      if (run_) {
        if (run_ + a0_ < lastx_) {  // expect a final V0
          need8(1);
          if (!bits(1)) {
            cleanup();
            return;
          }
          clr(1);
        }
        setvalue(0);
      }
    } catch (const Eof&) {
      cleanup();  // prematureEOF
      throw;
    }
    cleanup();
  }

  // _TIFFFax3fillruns: white runs as 0 bits, black as 1, each run clipped to
  // the row (in place: the clipped runs are the next row's reference)
  void fillruns(uint8_t* row) {
    uint32_t* runs = cur_;
    uint32_t* erun = pa_;
    if ((erun - runs) & 1) *erun++ = 0;
    int64_t x = 0;
    for (; runs < erun; runs += 2) {
      for (int c = 0; c < 2; ++c) {
        int64_t run = runs[c];
        if (x + run > lastx_ || run > lastx_) run = runs[c] = static_cast<uint32_t>(lastx_ - x);
        for (int64_t i = x; i < x + run; ++i) {
          const uint8_t bit = static_cast<uint8_t>(0x80 >> (i & 7));
          if (c)
            row[i >> 3] |= bit;
          else
            row[i >> 3] &= static_cast<uint8_t>(~bit);
        }
        x += run;
      }
    }
  }
};

}  // namespace

namespace fsvlm {

int ccitt_decode(const uint8_t* data, size_t n, uint64_t offset, int compression, bool two_d,
                 bool lsb_first, int64_t width, int64_t rows, uint8_t* out, bool* noeol) {
  if (width <= 0 || width > (int64_t(1) << 24)) return kCorrupt;
  const int64_t row_bytes = (width + 7) / 8;
  std::memset(out, 0, static_cast<size_t>(row_bytes * rows));
  Fax fax(data, n, !lsb_first, width, compression == 4 || (compression == 3 && two_d));
  fax.noeol = *noeol;
  struct Keep {  // the mode outlives the strip, as libtiff's codec state
    Fax& f;
    bool* to;
    ~Keep() { *to = f.noeol; }
  } keep{fax, noeol};
  int64_t y = 0;
  try {
    for (; y < rows; ++y) {
      uint8_t* row = out + y * row_bytes;
      switch (compression) {
        case 2: fax.rle_row(row, false, offset); break;
        case 32771: fax.rle_row(row, true, offset); break;
        case 3:
          if (two_d) fax.g3_2d_row(row);
          else fax.g3_1d_row(row);
          break;
        default:
          // the end of the data: libtiff's T.6 decode succeeds once a row is done
          if (!fax.g4_row(row)) return y > 0 ? kOk : kCorrupt;
          break;
      }
    }
  } catch (const Eof&) {
    return kCorrupt;
  } catch (const Fail&) {
    return kCorrupt;
  }
  return kOk;
}

}  // namespace fsvlm
