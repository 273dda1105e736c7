// Native LAS/LAZ point-cloud reader + writer (no external dependencies).
//
// The aiMotive dataset ships its lidar as LASzip-compressed .laz frames,
// which the reference reads through laspy (dataset/src/loaders/
// lidar_loader.py:86-91). laspy is not part of the TPU image, so this
// module implements the format natively: the LAS 1.2-1.4 container and
// the LASzip "pointwise chunked" codec (compressor 2, arithmetic coder 0,
// item versions 2) for POINT10 + GPSTIME11 + BYTE items — i.e. point
// formats 0 and 1 (+ extra bytes), which covers x/y/z/intensity/gps_time
// lidar. Uncompressed LAS point formats 0-3 and 6/7 are read directly.
//
// The entropy-coding layer follows the published LASzip design (Isenburg,
// "LASzip: lossless compression of LiDAR data", PE&RS 2013; the FastAC
// arithmetic coder of Said, 2004): adaptive binary/symbol models with
// periodic halving updates, a 32-bit range coder with carry propagation,
// and the IntegerCompressor k-bit corrector scheme. A writer is included
// so the codec is validated by exhaustive roundtrips (tests/test_data/
// test_lasio.py) — no LAZ tooling exists in this environment to cross
// check against, so byte-level interop with external laszip encoders is
// asserted by construction, not by fixture.
//
// The PyTorch port's copy of mm_training_tpu/data/csrc/lasio.cpp. One
// difference: the reader also takes a stream-written LAZ file, whose
// chunk-table offset field holds -1 and whose last 8 bytes hold the
// table's offset (the JAX package's copy refuses it as corrupt).
//
// Compiled with g++ -O3 -shared -fPIC at first use (ops/build.py::load_host);
// loaded via ctypes (data/lasio.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <vector>

namespace {

typedef uint8_t U8;
typedef uint16_t U16;
typedef uint32_t U32;
typedef uint64_t U64;
typedef int8_t I8;
typedef int16_t I16;
typedef int32_t I32;
typedef int64_t I64;
typedef float F32;
typedef double F64;

// ------------------------------------------------------------------ errors
enum {
  LASIO_EOPEN = -1,     // cannot open / read file
  LASIO_EHEADER = -2,   // bad magic or truncated header
  LASIO_EFORMAT = -3,   // unsupported point data format
  LASIO_ELAZ = -4,      // unsupported laszip variant (compressor/coder/item)
  LASIO_ECORRUPT = -5,  // truncated stream / bad chunk table
  LASIO_ECAP = -6,      // caller buffer too small
  LASIO_EWRITE = -7,    // write failed
  LASIO_ERANGE = -8,    // coordinates out of i32 range for chosen scale
};

// ================================================================== coder
// Adaptive arithmetic coder (Said's FastAC as adopted by LASzip).

constexpr U32 AC_MinLength = 0x01000000u;
constexpr U32 AC_MaxLength = 0xFFFFFFFFu;
constexpr U32 BM_LengthShift = 13;  // binary models
constexpr U32 BM_MaxCount = 1u << BM_LengthShift;
constexpr U32 DM_LengthShift = 15;  // symbol models
constexpr U32 DM_MaxCount = 1u << DM_LengthShift;

struct BitModel {
  U32 bit_0_count = 1, bit_count = 2;
  U32 bit_0_prob = 1u << (BM_LengthShift - 1);
  U32 update_cycle = 4, bits_until_update = 4;

  void init() { *this = BitModel(); }

  void update() {
    if ((bit_count += update_cycle) > BM_MaxCount) {
      bit_count = (bit_count + 1) >> 1;
      bit_0_count = (bit_0_count + 1) >> 1;
      if (bit_0_count == bit_count) ++bit_count;
    }
    bit_0_prob = (bit_0_count << BM_LengthShift) / bit_count;
    update_cycle = (5 * update_cycle) >> 2;
    if (update_cycle > 64) update_cycle = 64;
    bits_until_update = update_cycle;
  }
};

struct SymbolModel {
  U32 symbols = 0, last_symbol = 0;
  U32 total_count = 0, update_cycle = 0, symbols_until_update = 0;
  U32 table_shift = 0;  // 0 == no decoder table (small models)
  std::vector<U32> distribution, symbol_count;
  std::vector<U32> table;  // decode acceleration only; no effect on coding

  explicit SymbolModel(U32 n = 0) { if (n) reset(n); }

  void reset(U32 n) {
    symbols = n;
    last_symbol = n - 1;
    distribution.assign(n, 0);
    symbol_count.assign(n, 1);
    if (n > 16) {  // FastAC init-decoder-table rule
      U32 table_bits = 3;
      while (n > (1u << (table_bits + 2))) ++table_bits;
      table_shift = DM_LengthShift - table_bits;
      table.assign((1u << table_bits) + 2, 0);
    } else {
      table_shift = 0;
      table.clear();
    }
    total_count = 0;
    update_cycle = n;
    update();
    symbols_until_update = update_cycle = (n + 6) >> 1;
  }

  void init() { reset(symbols); }

  void update() {
    if ((total_count += update_cycle) > DM_MaxCount) {
      total_count = 0;
      for (U32 k = 0; k < symbols; ++k)
        total_count += (symbol_count[k] = (symbol_count[k] + 1) >> 1);
    }
    U32 sum = 0;
    const U32 scale = 0x80000000u / total_count;
    if (table.empty()) {
      for (U32 k = 0; k < symbols; ++k) {
        distribution[k] = (scale * sum) >> (31 - DM_LengthShift);
        sum += symbol_count[k];
      }
    } else {
      U32 s = 0;
      for (U32 k = 0; k < symbols; ++k) {
        distribution[k] = (scale * sum) >> (31 - DM_LengthShift);
        sum += symbol_count[k];
        const U32 w = distribution[k] >> table_shift;
        while (s < w) table[++s] = k - 1;
      }
      table[0] = 0;
      const U32 table_size = static_cast<U32>(table.size()) - 2;
      while (s <= table_size) table[++s] = symbols - 1;
    }
    update_cycle = (5 * update_cycle) >> 2;
    const U32 max_cycle = (symbols + 6) << 3;
    if (update_cycle > max_cycle) update_cycle = max_cycle;
    symbols_until_update = update_cycle;
  }
};

struct Encoder {
  std::vector<U8>* out = nullptr;
  size_t start = 0;  // first byte of this coding session inside *out
  U32 base = 0, length = AC_MaxLength;

  void init(std::vector<U8>* o) {
    out = o;
    start = o->size();
    base = 0;
    length = AC_MaxLength;
  }

  void propagate_carry() {
    // increment the last non-0xFF byte written during this session
    for (size_t i = out->size(); i-- > start;) {
      if ((*out)[i] == 0xFF) {
        (*out)[i] = 0;
      } else {
        ++(*out)[i];
        return;
      }
    }
    // carry out of the first byte cannot occur: base+length <= 2^32
  }

  void renorm() {
    do {
      out->push_back(static_cast<U8>(base >> 24));
      base <<= 8;
    } while ((length <<= 8) < AC_MinLength);
  }

  void encode_bit(BitModel& m, U32 bit) {
    const U32 x = m.bit_0_prob * (length >> BM_LengthShift);
    if (bit == 0) {
      length = x;
      ++m.bit_0_count;
    } else {
      const U32 init_base = base;
      base += x;
      length -= x;
      if (init_base > base) propagate_carry();
    }
    if (length < AC_MinLength) renorm();
    if (--m.bits_until_update == 0) m.update();
  }

  void encode_symbol(SymbolModel& m, U32 sym) {
    U32 x;
    const U32 init_base = base;
    if (sym == m.last_symbol) {
      x = m.distribution[sym] * (length >> DM_LengthShift);
      base += x;
      length -= x;
    } else {
      x = m.distribution[sym] * (length >>= DM_LengthShift);
      base += x;
      length = m.distribution[sym + 1] * length - x;
    }
    if (init_base > base) propagate_carry();
    if (length < AC_MinLength) renorm();
    ++m.symbol_count[sym];
    if (--m.symbols_until_update == 0) m.update();
  }

  void write_bits(U32 bits, U32 sym) {
    if (bits > 19) {
      write_short(sym & 0xFFFFu);
      sym >>= 16;
      bits -= 16;
    }
    const U32 init_base = base;
    base += sym * (length >>= bits);
    if (init_base > base) propagate_carry();
    if (length < AC_MinLength) renorm();
  }

  void write_short(U32 sym) {
    const U32 init_base = base;
    base += sym * (length >>= 16);
    if (init_base > base) propagate_carry();
    if (length < AC_MinLength) renorm();
  }

  void write_int(U32 v) {
    write_short(v & 0xFFFFu);  // lower 16 first (LASzip order)
    write_short(v >> 16);
  }

  void done() {
    const U32 init_base = base;
    if (length > 2 * AC_MinLength) {
      base += AC_MinLength;
      length = AC_MinLength >> 1;
    } else {
      base += AC_MinLength >> 1;
      length = AC_MinLength >> 9;
    }
    if (init_base > base) propagate_carry();
    renorm();
  }
};

struct Decoder {
  const U8* buf = nullptr;
  size_t pos = 0, size = 0;
  U32 value = 0, length = 0;

  // the coder may read a few bytes past the semantically needed end (it
  // holds 4 bytes of lookahead); inside a file those land in the next
  // chunk / the chunk table, at EOF we zero-fill
  U8 get_byte() { return pos < size ? buf[pos++] : 0; }

  void init(const U8* b, size_t n) {
    buf = b;
    size = n;
    pos = 0;
    value = (U32(get_byte()) << 24) | (U32(get_byte()) << 16) |
            (U32(get_byte()) << 8) | U32(get_byte());
    length = AC_MaxLength;
  }

  void renorm() {
    do {
      value = (value << 8) | get_byte();
    } while ((length <<= 8) < AC_MinLength);
  }

  U32 decode_bit(BitModel& m) {
    const U32 x = m.bit_0_prob * (length >> BM_LengthShift);
    const U32 sym = (value >= x);
    if (sym == 0) {
      length = x;
      ++m.bit_0_count;
    } else {
      value -= x;
      length -= x;
    }
    if (length < AC_MinLength) renorm();
    if (--m.bits_until_update == 0) m.update();
    return sym;
  }

  U32 decode_symbol(SymbolModel& m) {
    U32 s, x, y = length;
    if (!m.table.empty()) {  // table-assisted search (same result, fewer steps)
      const U32 dv = value / (length >>= DM_LengthShift);
      const U32 t = dv >> m.table_shift;
      s = m.table[t];
      U32 n = m.table[t + 1] + 1;
      while (n > s + 1) {
        const U32 mid = (s + n) >> 1;
        if (m.distribution[mid] > dv) n = mid;
        else s = mid;
      }
      x = m.distribution[s] * length;
      if (s != m.last_symbol) y = m.distribution[s + 1] * length;
    } else {
      U32 n = m.symbols;
      s = 0;
      x = 0;
      length >>= DM_LengthShift;
      U32 mid = n >> 1;
      do {  // bisection over the cumulative distribution
        const U32 z = length * m.distribution[mid];
        if (z > value) {
          n = mid;
          y = z;
        } else {
          s = mid;
          x = z;
        }
      } while ((mid = (s + n) >> 1) != s);
    }
    value -= x;
    length = y - x;
    if (length < AC_MinLength) renorm();
    ++m.symbol_count[s];
    if (--m.symbols_until_update == 0) m.update();
    return s;
  }

  U32 read_bits(U32 bits) {
    if (bits > 19) {
      const U32 lo = read_short();
      return (read_bits(bits - 16) << 16) | lo;
    }
    const U32 sym = value / (length >>= bits);
    value -= length * sym;
    if (length < AC_MinLength) renorm();
    return sym;
  }

  U32 read_short() {
    const U32 sym = value / (length >>= 16);
    value -= length * sym;
    if (length < AC_MinLength) renorm();
    return sym;
  }

  U32 read_int() {
    const U32 lo = read_short();
    return (read_short() << 16) | lo;
  }
};

// ----------------------------------------------- integer corrector scheme
struct IntCompressor {
  U32 bits, contexts, bits_high;
  U32 corr_bits, corr_range;
  I32 corr_min, corr_max;
  U32 k = 0;  // interval index of the last (de)compressed corrector
  std::vector<SymbolModel> m_bits;        // [contexts](corr_bits+1)
  BitModel m_corr0;
  std::vector<SymbolModel> m_corr;        // [corr_bits+1] (index 0 unused)

  IntCompressor(U32 bits_, U32 contexts_, U32 bits_high_ = 8)
      : bits(bits_), contexts(contexts_), bits_high(bits_high_) {
    if (bits && bits < 32) {
      corr_bits = bits;
      corr_range = 1u << bits;
      corr_min = -static_cast<I32>(corr_range / 2);
      corr_max = corr_min + static_cast<I32>(corr_range) - 1;
    } else {
      corr_bits = 32;
      corr_range = 0;
      corr_min = INT32_MIN;
      corr_max = INT32_MAX;
    }
    m_bits.assign(contexts, SymbolModel(corr_bits + 1));
    m_corr.reserve(corr_bits + 1);
    m_corr.emplace_back(2);  // placeholder at index 0 (bit model used)
    for (U32 i = 1; i <= corr_bits; ++i)
      m_corr.emplace_back(i <= bits_high ? (1u << i) : (1u << bits_high));
  }

  void init() {
    for (auto& m : m_bits) m.init();
    m_corr0.init();
    for (U32 i = 1; i <= corr_bits; ++i) m_corr[i].init();
    k = 0;
  }

  void compress(Encoder& enc, I32 pred, I32 real, U32 context = 0) {
    I32 corr = real - pred;
    if (corr_range) {  // wrap the corrector into the closed range
      if (corr < corr_min) corr += static_cast<I32>(corr_range);
      else if (corr > corr_max) corr -= static_cast<I32>(corr_range);
    }
    write_corrector(enc, corr, m_bits[context]);
  }

  I32 decompress(Decoder& dec, I32 pred, U32 context = 0) {
    I32 real = pred + read_corrector(dec, m_bits[context]);
    if (corr_range) {
      if (real < 0) real += static_cast<I32>(corr_range);
      else if (static_cast<U32>(real) >= corr_range)
        real -= static_cast<I32>(corr_range);
    }
    return real;
  }

  void write_corrector(Encoder& enc, I32 c, SymbolModel& mb) {
    // tightest interval [-(2^k - 1), -2^(k-1)] u [2^(k-1)+1, 2^k]
    U32 c1 = (c <= 0) ? static_cast<U32>(-static_cast<I64>(c))
                      : static_cast<U32>(c) - 1;
    k = 0;
    while (c1) {
      c1 >>= 1;
      ++k;
    }
    enc.encode_symbol(mb, k);
    if (k) {
      if (k < 32) {
        // translate into [0, 2^k - 1]: negatives below positives
        U32 raw = (c > 0) ? static_cast<U32>(c) - 1
                          : static_cast<U32>(c + ((1 << k) - 1));
        if (k <= bits_high) {
          enc.encode_symbol(m_corr[k], raw);
        } else {
          const U32 k1 = k - bits_high;
          enc.encode_symbol(m_corr[k], raw >> k1);
          enc.write_bits(k1, raw & ((1u << k1) - 1));
        }
      }
      // k == 32: c == corr_min, nothing more to send
    } else {
      enc.encode_bit(m_corr0, static_cast<U32>(c));  // c in {0, 1}
    }
  }

  I32 read_corrector(Decoder& dec, SymbolModel& mb) {
    I32 c;
    k = dec.decode_symbol(mb);
    if (k) {
      if (k < 32) {
        U32 raw;
        if (k <= bits_high) {
          raw = dec.decode_symbol(m_corr[k]);
        } else {
          const U32 k1 = k - bits_high;
          raw = dec.decode_symbol(m_corr[k]);
          raw = (raw << k1) | dec.read_bits(k1);
        }
        if (raw >= (1u << (k - 1)))
          c = static_cast<I32>(raw) + 1;  // positive branch
        else
          c = static_cast<I32>(raw) - ((1 << k) - 1);  // negative branch
      } else {
        c = corr_min;
      }
    } else {
      c = static_cast<I32>(dec.decode_bit(m_corr0));
    }
    return c;
  }
};

// ======================================================== POINT10 item v2

struct StreamingMedian5 {
  I32 values[5];
  bool high;

  void init() {
    values[0] = values[1] = values[2] = values[3] = values[4] = 0;
    high = true;
  }

  void add(I32 v) {
    if (high) {
      if (v < values[2]) {
        values[4] = values[3];
        values[3] = values[2];
        if (v < values[0]) {
          values[2] = values[1];
          values[1] = values[0];
          values[0] = v;
        } else if (v < values[1]) {
          values[2] = values[1];
          values[1] = v;
        } else {
          values[2] = v;
        }
      } else {
        if (v < values[3]) {
          values[4] = values[3];
          values[3] = v;
        } else {
          values[4] = v;
        }
        high = false;
      }
    } else {
      if (values[2] < v) {
        values[0] = values[1];
        values[1] = values[2];
        if (values[4] < v) {
          values[2] = values[3];
          values[3] = values[4];
          values[4] = v;
        } else if (values[3] < v) {
          values[2] = values[3];
          values[3] = v;
        } else {
          values[2] = v;
        }
      } else {
        if (values[1] < v) {
          values[0] = values[1];
          values[1] = v;
        } else {
          values[0] = v;
        }
        high = true;
      }
    }
  }

  I32 get() const { return values[2]; }
};

// context tables keyed by (number_of_returns, return_number)
const U8 kNumberReturnMap[8][8] = {
    {15, 14, 13, 12, 11, 10, 9, 8},  {14, 0, 1, 3, 6, 10, 10, 9},
    {13, 1, 2, 4, 7, 11, 11, 10},    {12, 3, 4, 5, 8, 12, 12, 11},
    {11, 6, 7, 8, 9, 13, 13, 12},    {10, 10, 11, 12, 13, 14, 14, 13},
    {9, 10, 11, 12, 13, 14, 15, 14}, {8, 9, 10, 11, 12, 13, 14, 15}};

const U8 kNumberReturnLevel[8][8] = {
    {0, 1, 2, 3, 4, 5, 6, 7}, {1, 0, 1, 2, 3, 4, 5, 6},
    {2, 1, 0, 1, 2, 3, 4, 5}, {3, 2, 1, 0, 1, 2, 3, 4},
    {4, 3, 2, 1, 0, 1, 2, 3}, {5, 4, 3, 2, 1, 0, 1, 2},
    {6, 5, 4, 3, 2, 1, 0, 1}, {7, 6, 5, 4, 3, 2, 1, 0}};

#pragma pack(push, 1)
struct P10 {  // the 20-byte LAS point-format-0 record
  I32 x, y, z;
  U16 intensity;
  U8 flags;  // return(3) | num_returns(3) | scan_dir(1) | edge(1)
  U8 classification;
  U8 scan_angle_rank;  // raw byte of the i8 field
  U8 user_data;
  U16 point_source;
};
#pragma pack(pop)
static_assert(sizeof(P10) == 20, "LAS point10 record must pack to 20 bytes");

struct Point10V2 {
  P10 last;
  U16 last_intensity[16];
  StreamingMedian5 med_x[16], med_y[16];
  I32 last_height[8];
  SymbolModel m_changed{64};
  SymbolModel m_sar0{256}, m_sar1{256};
  std::unique_ptr<SymbolModel> m_bit_byte[256], m_class[256], m_user[256];
  IntCompressor ic_intensity{16, 4};
  IntCompressor ic_psid{16, 1};
  IntCompressor ic_dx{32, 2};
  IntCompressor ic_dy{32, 22};
  IntCompressor ic_z{32, 20};

  void init(const U8* first_raw) {
    for (int i = 0; i < 16; ++i) {
      last_intensity[i] = 0;
      med_x[i].init();
      med_y[i].init();
    }
    for (int i = 0; i < 8; ++i) last_height[i] = 0;
    m_changed.init();
    m_sar0.init();
    m_sar1.init();
    for (int i = 0; i < 256; ++i) {  // lazily created models survive chunks
      if (m_bit_byte[i]) m_bit_byte[i]->init();
      if (m_class[i]) m_class[i]->init();
      if (m_user[i]) m_user[i]->init();
    }
    ic_intensity.init();
    ic_psid.init();
    ic_dx.init();
    ic_dy.init();
    ic_z.init();
    std::memcpy(&last, first_raw, 20);
    // zero the first point's intensity in the *codec state* (the output
    // keeps the raw value): the changed-bit for intensity is computed
    // against last_intensity[m] (all zero at init), and a changed_values
    // of 0 makes the decoder keep last.intensity — the invariant
    // last.intensity == last_intensity[m] must therefore hold from the
    // start (LASzip v2 does the same in its item init)
    last.intensity = 0;
  }

  static SymbolModel& lazy(std::unique_ptr<SymbolModel>& slot) {
    if (!slot) slot = std::make_unique<SymbolModel>(256);
    return *slot;
  }

  void write(Encoder& enc, const U8* raw) {
    P10 cur;
    std::memcpy(&cur, raw, 20);
    const U32 r = cur.flags & 7u, n = (cur.flags >> 3) & 7u;
    const U32 m = kNumberReturnMap[n][r], l = kNumberReturnLevel[n][r];

    U32 changed = 0;
    if (cur.flags != last.flags) changed |= 32;
    if (cur.intensity != last_intensity[m]) changed |= 16;
    if (cur.classification != last.classification) changed |= 8;
    if (cur.scan_angle_rank != last.scan_angle_rank) changed |= 4;
    if (cur.user_data != last.user_data) changed |= 2;
    if (cur.point_source != last.point_source) changed |= 1;
    enc.encode_symbol(m_changed, changed);

    if (changed & 32) enc.encode_symbol(lazy(m_bit_byte[last.flags]), cur.flags);
    if (changed & 16) {
      ic_intensity.compress(enc, last_intensity[m], cur.intensity,
                            m < 3 ? m : 3u);
      last_intensity[m] = cur.intensity;
    }
    if (changed & 8)
      enc.encode_symbol(lazy(m_class[last.classification]), cur.classification);
    if (changed & 4) {
      const U8 diff = static_cast<U8>(cur.scan_angle_rank - last.scan_angle_rank);
      enc.encode_symbol(((cur.flags >> 6) & 1u) ? m_sar1 : m_sar0, diff);
    }
    if (changed & 2)
      enc.encode_symbol(lazy(m_user[last.user_data]), cur.user_data);
    if (changed & 1)
      ic_psid.compress(enc, last.point_source, cur.point_source, 0);

    const I32 dx = cur.x - last.x;
    ic_dx.compress(enc, med_x[m].get(), dx, n == 1 ? 1u : 0u);
    med_x[m].add(dx);
    U32 k_bits = ic_dx.k;
    const I32 dy = cur.y - last.y;
    ic_dy.compress(enc, med_y[m].get(), dy,
                   (n == 1 ? 1u : 0u) + (k_bits < 20 ? (k_bits & ~1u) : 20u));
    med_y[m].add(dy);
    k_bits = (ic_dx.k + ic_dy.k) / 2;
    ic_z.compress(enc, last_height[l], cur.z,
                  (n == 1 ? 1u : 0u) + (k_bits < 18 ? (k_bits & ~1u) : 18u));
    last_height[l] = cur.z;

    last = cur;
  }

  void read(Decoder& dec, U8* raw_out) {
    const U32 changed = dec.decode_symbol(m_changed);
    if (changed & 32)
      last.flags = static_cast<U8>(dec.decode_symbol(lazy(m_bit_byte[last.flags])));
    const U32 r = last.flags & 7u, n = (last.flags >> 3) & 7u;
    const U32 m = kNumberReturnMap[n][r], l = kNumberReturnLevel[n][r];
    if (changed) {
      if (changed & 16) {
        last.intensity = static_cast<U16>(
            ic_intensity.decompress(dec, last_intensity[m], m < 3 ? m : 3u));
        last_intensity[m] = last.intensity;
      } else {
        last.intensity = last_intensity[m];
      }
      if (changed & 8)
        last.classification =
            static_cast<U8>(dec.decode_symbol(lazy(m_class[last.classification])));
      if (changed & 4) {
        const U32 diff =
            dec.decode_symbol(((last.flags >> 6) & 1u) ? m_sar1 : m_sar0);
        last.scan_angle_rank = static_cast<U8>(diff + last.scan_angle_rank);
      }
      if (changed & 2)
        last.user_data =
            static_cast<U8>(dec.decode_symbol(lazy(m_user[last.user_data])));
      if (changed & 1)
        last.point_source =
            static_cast<U16>(ic_psid.decompress(dec, last.point_source, 0));
    }

    I32 diff = ic_dx.decompress(dec, med_x[m].get(), n == 1 ? 1u : 0u);
    last.x += diff;
    med_x[m].add(diff);
    U32 k_bits = ic_dx.k;
    diff = ic_dy.decompress(
        dec, med_y[m].get(),
        (n == 1 ? 1u : 0u) + (k_bits < 20 ? (k_bits & ~1u) : 20u));
    last.y += diff;
    med_y[m].add(diff);
    k_bits = (ic_dx.k + ic_dy.k) / 2;
    last.z = ic_z.decompress(
        dec, last_height[l],
        (n == 1 ? 1u : 0u) + (k_bits < 18 ? (k_bits & ~1u) : 18u));
    last_height[l] = last.z;

    std::memcpy(raw_out, &last, 20);
  }
};

// ====================================================== GPSTIME11 item v2

union GpsValue {
  U64 u64;
  I64 i64;
  F64 f64;
};

// multiplier alphabet: 0..500 positive, 501..510 negative(-1..-10),
// 511 unchanged, 512 full 64-bit, 513..515 switch sequence (+1..+3)
constexpr U32 kGpsMulti = 500;
constexpr I32 kGpsMultiMinus = -10;
constexpr U32 kGpsMultiUnchanged = 511;
constexpr U32 kGpsMultiCodeFull = 512;
constexpr U32 kGpsMultiTotal = 516;

struct GpsTime11V2 {
  U32 last_idx = 0, next_idx = 0;
  GpsValue last_gpstime[4];
  I32 last_gpstime_diff[4];
  I32 multi_extreme_counter[4];
  SymbolModel m_multi{kGpsMultiTotal};
  SymbolModel m_0diff{6};
  IntCompressor ic_gps{32, 9};

  void init(const U8* first_raw) {
    last_idx = next_idx = 0;
    for (int i = 0; i < 4; ++i) {
      last_gpstime[i].u64 = 0;
      last_gpstime_diff[i] = 0;
      multi_extreme_counter[i] = 0;
    }
    std::memcpy(&last_gpstime[0].u64, first_raw, 8);
    m_multi.init();
    m_0diff.init();
    ic_gps.init();
  }

  void bump_extreme(I32 diff) {
    if (++multi_extreme_counter[last_idx] > 3) {
      last_gpstime_diff[last_idx] = diff;
      multi_extreme_counter[last_idx] = 0;
    }
  }

  void write(Encoder& enc, const U8* raw) {
    GpsValue cur;
    std::memcpy(&cur.u64, raw, 8);
    if (last_gpstime_diff[last_idx] == 0) {  // no fitted 32-bit diff yet
      if (cur.i64 == last_gpstime[last_idx].i64) {
        enc.encode_symbol(m_0diff, 0);
        return;
      }
      const I64 d64 = cur.i64 - last_gpstime[last_idx].i64;
      const I32 d32 = static_cast<I32>(d64);
      if (d64 == static_cast<I64>(d32)) {
        enc.encode_symbol(m_0diff, 1);
        ic_gps.compress(enc, 0, d32, 0);
        last_gpstime_diff[last_idx] = d32;
        multi_extreme_counter[last_idx] = 0;
        last_gpstime[last_idx].i64 = cur.i64;
      } else {
        for (U32 i = 1; i < 4; ++i) {  // another active time sequence?
          const U32 other = (last_idx + i) & 3u;
          const I64 od = cur.i64 - last_gpstime[other].i64;
          if (od == static_cast<I64>(static_cast<I32>(od))) {
            enc.encode_symbol(m_0diff, i + 2);
            last_idx = other;
            write(enc, raw);
            return;
          }
        }
        enc.encode_symbol(m_0diff, 2);  // full 64-bit value
        ic_gps.compress(enc, static_cast<I32>(last_gpstime[last_idx].u64 >> 32),
                        static_cast<I32>(cur.u64 >> 32), 8);
        enc.write_int(static_cast<U32>(cur.u64));
        next_idx = (next_idx + 1) & 3u;
        last_idx = next_idx;
        last_gpstime[last_idx].u64 = cur.u64;
        last_gpstime_diff[last_idx] = 0;
        multi_extreme_counter[last_idx] = 0;
      }
    } else {
      if (cur.i64 == last_gpstime[last_idx].i64) {
        enc.encode_symbol(m_multi, kGpsMultiUnchanged);
        return;
      }
      const I64 d64 = cur.i64 - last_gpstime[last_idx].i64;
      const I32 d32 = static_cast<I32>(d64);
      if (d64 == static_cast<I64>(d32)) {
        const F32 multi_f =
            static_cast<F32>(d32) / static_cast<F32>(last_gpstime_diff[last_idx]);
        const I32 multi = multi_f >= 0 ? static_cast<I32>(multi_f + 0.5f)
                                       : static_cast<I32>(multi_f - 0.5f);
        if (multi == 1) {
          enc.encode_symbol(m_multi, 1);
          ic_gps.compress(enc, last_gpstime_diff[last_idx], d32, 1);
          last_gpstime_diff[last_idx] = d32;
          multi_extreme_counter[last_idx] = 0;
        } else if (multi > 0) {
          if (multi < static_cast<I32>(kGpsMulti)) {
            enc.encode_symbol(m_multi, static_cast<U32>(multi));
            ic_gps.compress(enc, multi * last_gpstime_diff[last_idx], d32,
                            multi < 10 ? 2 : 3);
          } else {
            enc.encode_symbol(m_multi, kGpsMulti);
            ic_gps.compress(enc,
                            static_cast<I32>(kGpsMulti) * last_gpstime_diff[last_idx],
                            d32, 4);
            bump_extreme(d32);
          }
        } else if (multi < 0) {
          if (multi > kGpsMultiMinus) {  // -1 .. -9
            enc.encode_symbol(m_multi, static_cast<U32>(kGpsMulti - multi));
            ic_gps.compress(enc, multi * last_gpstime_diff[last_idx], d32, 5);
          } else {
            enc.encode_symbol(m_multi,
                              static_cast<U32>(kGpsMulti - kGpsMultiMinus));
            ic_gps.compress(enc, kGpsMultiMinus * last_gpstime_diff[last_idx],
                            d32, 6);
            bump_extreme(d32);
          }
        } else {  // multi == 0
          enc.encode_symbol(m_multi, 0);
          ic_gps.compress(enc, 0, d32, 7);
          bump_extreme(d32);
        }
        last_gpstime[last_idx].i64 = cur.i64;
      } else {
        for (U32 i = 1; i < 4; ++i) {
          const U32 other = (last_idx + i) & 3u;
          const I64 od = cur.i64 - last_gpstime[other].i64;
          if (od == static_cast<I64>(static_cast<I32>(od))) {
            enc.encode_symbol(m_multi, kGpsMultiCodeFull + i);
            last_idx = other;
            write(enc, raw);
            return;
          }
        }
        enc.encode_symbol(m_multi, kGpsMultiCodeFull);
        ic_gps.compress(enc, static_cast<I32>(last_gpstime[last_idx].u64 >> 32),
                        static_cast<I32>(cur.u64 >> 32), 8);
        enc.write_int(static_cast<U32>(cur.u64));
        next_idx = (next_idx + 1) & 3u;
        last_idx = next_idx;
        last_gpstime[last_idx].u64 = cur.u64;
        last_gpstime_diff[last_idx] = 0;
        multi_extreme_counter[last_idx] = 0;
      }
    }
  }

  void read(Decoder& dec, U8* raw_out) {
    if (last_gpstime_diff[last_idx] == 0) {
      const U32 multi = dec.decode_symbol(m_0diff);
      if (multi == 1) {
        last_gpstime_diff[last_idx] = ic_gps.decompress(dec, 0, 0);
        last_gpstime[last_idx].i64 += last_gpstime_diff[last_idx];
        multi_extreme_counter[last_idx] = 0;
      } else if (multi == 2) {
        next_idx = (next_idx + 1) & 3u;
        U64 hi = static_cast<U32>(ic_gps.decompress(
            dec, static_cast<I32>(last_gpstime[last_idx].u64 >> 32), 8));
        last_gpstime[next_idx].u64 = (hi << 32) | dec.read_int();
        last_idx = next_idx;
        last_gpstime_diff[last_idx] = 0;
        multi_extreme_counter[last_idx] = 0;
      } else if (multi > 2) {  // switch to another sequence
        last_idx = (last_idx + multi - 2) & 3u;
        read(dec, raw_out);
        return;
      }
      // multi == 0: unchanged
    } else {
      const U32 multi = dec.decode_symbol(m_multi);
      if (multi == 1) {
        const I32 d = ic_gps.decompress(dec, last_gpstime_diff[last_idx], 1);
        last_gpstime[last_idx].i64 += d;
        last_gpstime_diff[last_idx] = d;
        multi_extreme_counter[last_idx] = 0;
      } else if (multi < kGpsMultiUnchanged) {
        I32 d;
        if (multi == 0) {
          d = ic_gps.decompress(dec, 0, 7);
          bump_extreme(d);
        } else if (multi < kGpsMulti) {
          d = ic_gps.decompress(
              dec, static_cast<I32>(multi) * last_gpstime_diff[last_idx],
              multi < 10 ? 2 : 3);
        } else if (multi == kGpsMulti) {
          d = ic_gps.decompress(
              dec, static_cast<I32>(kGpsMulti) * last_gpstime_diff[last_idx], 4);
          bump_extreme(d);
        } else {  // 501..510 -> negative multipliers
          const I32 smulti = static_cast<I32>(kGpsMulti) - static_cast<I32>(multi);
          if (smulti > kGpsMultiMinus) {
            d = ic_gps.decompress(dec, smulti * last_gpstime_diff[last_idx], 5);
          } else {
            d = ic_gps.decompress(dec, kGpsMultiMinus * last_gpstime_diff[last_idx],
                                  6);
            bump_extreme(d);
          }
        }
        last_gpstime[last_idx].i64 += d;
      } else if (multi == kGpsMultiUnchanged) {
        // value repeats
      } else if (multi == kGpsMultiCodeFull) {
        next_idx = (next_idx + 1) & 3u;
        U64 hi = static_cast<U32>(ic_gps.decompress(
            dec, static_cast<I32>(last_gpstime[last_idx].u64 >> 32), 8));
        last_gpstime[next_idx].u64 = (hi << 32) | dec.read_int();
        last_idx = next_idx;
        last_gpstime_diff[last_idx] = 0;
        multi_extreme_counter[last_idx] = 0;
      } else {  // 513..515: switch sequence
        last_idx = (last_idx + multi - kGpsMultiCodeFull) & 3u;
        read(dec, raw_out);
        return;
      }
    }
    std::memcpy(raw_out, &last_gpstime[last_idx].u64, 8);
  }
};

// =========================================================== BYTE item v2

struct ByteV2 {
  U32 n;
  std::vector<U8> last;
  std::vector<SymbolModel> models;

  explicit ByteV2(U32 n_) : n(n_), last(n_, 0) {
    models.reserve(n);
    for (U32 i = 0; i < n; ++i) models.emplace_back(256);
  }

  void init(const U8* first_raw) {
    for (auto& m : models) m.init();
    std::memcpy(last.data(), first_raw, n);
  }

  void write(Encoder& enc, const U8* raw) {
    for (U32 i = 0; i < n; ++i)
      enc.encode_symbol(models[i], static_cast<U8>(raw[i] - last[i]));
    std::memcpy(last.data(), raw, n);
  }

  void read(Decoder& dec, U8* raw_out) {
    for (U32 i = 0; i < n; ++i)
      last[i] = static_cast<U8>(last[i] + dec.decode_symbol(models[i]));
    std::memcpy(raw_out, last.data(), n);
  }
};

// ============================================================= LAS header

template <typename T>
T rd(const U8* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

template <typename T>
void wr(std::vector<U8>& out, T v) {
  const size_t n = out.size();
  out.resize(n + sizeof(T));
  std::memcpy(out.data() + n, &v, sizeof(T));
}

struct LasHeader {
  U8 version_major = 1, version_minor = 2;
  U16 header_size = 227;
  U32 offset_to_points = 0;
  U32 num_vlrs = 0;
  U8 point_format = 0;  // bit 7 stripped
  bool compressed = false;
  U16 record_length = 0;
  U64 npoints = 0;
  F64 scale[3] = {1, 1, 1}, offset[3] = {0, 0, 0};
};

struct LazVlrInfo {
  bool present = false;
  U16 compressor = 0, coder = 0;
  U32 chunk_size = 0;
  struct Item {
    U16 type, size, version;
  };
  std::vector<Item> items;
};

int parse_header(const std::vector<U8>& f, LasHeader* h, LazVlrInfo* laz) {
  if (f.size() < 227 || std::memcmp(f.data(), "LASF", 4) != 0)
    return LASIO_EHEADER;
  h->version_major = f[24];
  h->version_minor = f[25];
  h->header_size = rd<U16>(&f[94]);
  h->offset_to_points = rd<U32>(&f[96]);
  h->num_vlrs = rd<U32>(&f[100]);
  const U8 fmt = f[104];
  h->compressed = (fmt & 0x80u) != 0;
  h->point_format = fmt & 0x7Fu;
  h->record_length = rd<U16>(&f[105]);
  h->npoints = rd<U32>(&f[107]);
  for (int i = 0; i < 3; ++i) {
    h->scale[i] = rd<F64>(&f[131 + 8 * i]);
    h->offset[i] = rd<F64>(&f[155 + 8 * i]);
  }
  if (h->npoints == 0 && h->version_major == 1 && h->version_minor >= 4 &&
      f.size() >= 375 && h->header_size >= 375)
    h->npoints = rd<U64>(&f[247]);
  if (h->header_size > f.size() || h->offset_to_points > f.size())
    return LASIO_EHEADER;

  // walk the VLRs for the laszip record (user "laszip encoded", id 22204)
  size_t p = h->header_size;
  for (U32 i = 0; i < h->num_vlrs && p + 54 <= f.size(); ++i) {
    char user_id[17] = {0};
    std::memcpy(user_id, &f[p + 2], 16);
    const U16 record_id = rd<U16>(&f[p + 18]);
    const U16 len = rd<U16>(&f[p + 20]);
    const size_t payload = p + 54;
    if (payload + len > f.size()) break;
    if (std::strncmp(user_id, "laszip encoded", 16) == 0 && record_id == 22204 &&
        len >= 34) {
      laz->present = true;
      laz->compressor = rd<U16>(&f[payload]);
      laz->coder = rd<U16>(&f[payload + 2]);
      // payload layout: compressor u16, coder u16, version u8+u8+u16,
      // options u32, chunk_size u32 -> chunk_size at offset 12
      laz->chunk_size = rd<U32>(&f[payload + 12]);
      const U16 num_items = rd<U16>(&f[payload + 32]);
      for (U16 j = 0; j < num_items && payload + 34 + 6 * (j + 1) <= p + 54 + len;
           ++j) {
        LazVlrInfo::Item it;
        it.type = rd<U16>(&f[payload + 34 + 6 * j]);
        it.size = rd<U16>(&f[payload + 36 + 6 * j]);
        it.version = rd<U16>(&f[payload + 38 + 6 * j]);
        laz->items.push_back(it);
      }
    }
    p = payload + len;
  }
  return 0;
}

int read_file(const char* path, std::vector<U8>* out, long max_bytes = -1) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return LASIO_EOPEN;
  std::fseek(fp, 0, SEEK_END);
  long n = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(fp);
    return LASIO_EOPEN;
  }
  if (max_bytes >= 0 && n > max_bytes) n = max_bytes;
  out->resize(static_cast<size_t>(n));
  const size_t got = n ? std::fread(out->data(), 1, out->size(), fp) : 0;
  std::fclose(fp);
  return got == out->size() ? 0 : LASIO_EOPEN;
}

// per-format byte offsets of (gps_time, flags are at 14 for 0-5)
int gps_offset_for_format(U8 fmt) {
  switch (fmt) {
    case 1:
    case 3:
    case 4:
    case 5:
      return 20;
    case 6:
    case 7:
    case 8:
    case 9:
    case 10:
      return 22;
    default:
      return -1;  // format 0 / 2: no gps time
  }
}

// ============================================================ read points

// fills rows [x, y, z, intensity, gps]; returns rows or negative error
long long read_points_impl(const std::vector<U8>& f, const LasHeader& h,
                           const LazVlrInfo& laz, F64* out, long long cap) {
  if (static_cast<long long>(h.npoints) > cap) return LASIO_ECAP;
  const F64 sx = h.scale[0], sy = h.scale[1], sz = h.scale[2];
  const F64 ox = h.offset[0], oy = h.offset[1], oz = h.offset[2];

  if (!h.compressed) {
    const int gps_off = gps_offset_for_format(h.point_format);
    if (h.point_format > 10 || (h.point_format > 3 && h.point_format < 6))
      return LASIO_EFORMAT;
    const size_t stride = h.record_length;
    if (h.offset_to_points + h.npoints * stride > f.size())
      return LASIO_ECORRUPT;
    const U8* p = f.data() + h.offset_to_points;
    for (U64 i = 0; i < h.npoints; ++i, p += stride) {
      F64* row = out + 5 * i;
      row[0] = rd<I32>(p) * sx + ox;
      row[1] = rd<I32>(p + 4) * sy + oy;
      row[2] = rd<I32>(p + 8) * sz + oz;
      row[3] = rd<U16>(p + 12);
      row[4] = gps_off > 0 && stride >= static_cast<size_t>(gps_off) + 8
                   ? rd<F64>(p + gps_off)
                   : 0.0;
    }
    return static_cast<long long>(h.npoints);
  }

  // ---- LASzip chunked point stream
  if (!laz.present || laz.coder != 0 || laz.compressor != 2) return LASIO_ELAZ;
  bool have_p10 = false, have_gps = false;
  U32 extra = 0;
  for (const auto& it : laz.items) {
    if (it.type == 6 && it.version == 2 && it.size == 20) {
      have_p10 = true;
    } else if (it.type == 7 && it.version == 2 && it.size == 8) {
      have_gps = true;
    } else if (it.type == 9 && it.version == 2) {
      extra = it.size;
    } else {
      return LASIO_ELAZ;  // RGB / POINT14 / v1 items: not needed for lidar
    }
  }
  if (!have_p10) return LASIO_ELAZ;
  const U32 chunk_size = laz.chunk_size ? laz.chunk_size : 50000;
  if (chunk_size == 0xFFFFFFFFu) return LASIO_ELAZ;  // variable-size chunking

  if (h.offset_to_points + 8 > f.size()) return LASIO_ECORRUPT;
  I64 table_off = rd<I64>(&f[h.offset_to_points]);
  if (table_off == -1) {
    // written to a stream the writer could not seek back in: LASzip then
    // appends the table's offset as the file's last 8 bytes
    if (f.size() < h.offset_to_points + 16) return LASIO_ECORRUPT;
    table_off = rd<I64>(&f[f.size() - 8]);
  }
  const U64 first_chunk = h.offset_to_points + 8;
  const U64 num_chunks = (h.npoints + chunk_size - 1) / chunk_size;

  // chunk table: u32 version, u32 count, arithmetic-coded byte sizes
  std::vector<U64> chunk_start(num_chunks, 0);
  if (table_off < 0 || static_cast<U64>(table_off) + 8 > f.size())
    return LASIO_ECORRUPT;
  {
    const U8* t = f.data() + table_off;
    if (rd<U32>(t) != 0) return LASIO_ECORRUPT;
    const U32 count = rd<U32>(t + 4);
    if (count < num_chunks) return LASIO_ECORRUPT;
    Decoder dec;
    dec.init(t + 8, f.size() - static_cast<size_t>(table_off) - 8);
    IntCompressor ic(32, 2);
    ic.init();
    U64 pos = first_chunk;
    I32 prev = 0;
    for (U32 i = 0; i < count; ++i) {
      const I32 sz = ic.decompress(dec, prev, 1);
      if (i < num_chunks) chunk_start[i] = pos;
      prev = sz;
      pos += static_cast<U32>(sz);
    }
  }

  Point10V2 p10;
  GpsTime11V2 gps;
  std::unique_ptr<ByteV2> bytes(extra ? new ByteV2(extra) : nullptr);
  const U32 first_len = 20 + (have_gps ? 8 : 0) + extra;

  U64 done = 0;
  std::vector<U8> raw(first_len);
  for (U64 c = 0; c < num_chunks; ++c) {
    const U64 in_chunk =
        std::min<U64>(chunk_size, h.npoints - done);
    const U64 pos = chunk_start[c];
    if (pos + first_len > f.size()) return LASIO_ECORRUPT;
    // the first point of every chunk is stored raw
    std::memcpy(raw.data(), &f[pos], first_len);
    p10.init(raw.data());
    if (have_gps) gps.init(raw.data() + 20);
    if (bytes) bytes->init(raw.data() + 20 + (have_gps ? 8 : 0));
    Decoder dec;
    dec.init(f.data() + pos + first_len, f.size() - pos - first_len);
    for (U64 j = 0; j < in_chunk; ++j) {
      if (j > 0) {
        p10.read(dec, raw.data());
        if (have_gps) gps.read(dec, raw.data() + 20);
        if (bytes) bytes->read(dec, raw.data() + 20 + (have_gps ? 8 : 0));
      }
      P10 pt;
      std::memcpy(&pt, raw.data(), 20);
      F64* row = out + 5 * (done + j);
      row[0] = pt.x * sx + ox;
      row[1] = pt.y * sy + oy;
      row[2] = pt.z * sz + oz;
      row[3] = pt.intensity;
      row[4] = have_gps ? rd<F64>(raw.data() + 20) : 0.0;
    }
    done += in_chunk;
  }
  return static_cast<long long>(done);
}

// =========================================================== write points

long long write_points_impl(const char* path, const F64* pts, long long n,
                            F64 sx, F64 sy, F64 sz, F64 ox, F64 oy, F64 oz,
                            int compress, U32 chunk_size) {
  if (chunk_size == 0) chunk_size = 50000;
  // quantize to i32 grid; reject out-of-range coordinates
  std::vector<P10> recs(static_cast<size_t>(n));
  F64 bbox[6] = {0, 0, 0, 0, 0, 0};  // max/min interleaved per LAS layout
  for (long long i = 0; i < n; ++i) {
    const F64* row = pts + 5 * i;
    F64 q[3] = {std::nearbyint((row[0] - ox) / sx),
                std::nearbyint((row[1] - oy) / sy),
                std::nearbyint((row[2] - oz) / sz)};
    for (int a = 0; a < 3; ++a)
      if (q[a] < -2147483648.0 || q[a] > 2147483647.0) return LASIO_ERANGE;
    P10& r = recs[i];
    r.x = static_cast<I32>(q[0]);
    r.y = static_cast<I32>(q[1]);
    r.z = static_cast<I32>(q[2]);
    const F64 in = std::nearbyint(row[3]);  // round-half-even, like numpy
    r.intensity = static_cast<U16>(in < 0 ? 0 : (in > 65535 ? 65535 : in));
    r.flags = 0x09;  // return 1 of 1
    r.classification = 0;
    r.scan_angle_rank = 0;
    r.user_data = 0;
    r.point_source = 0;
    const F64 wx = r.x * sx + ox, wy = r.y * sy + oy, wz = r.z * sz + oz;
    if (i == 0) {
      bbox[0] = bbox[1] = wx;
      bbox[2] = bbox[3] = wy;
      bbox[4] = bbox[5] = wz;
    } else {
      bbox[0] = std::max(bbox[0], wx);
      bbox[1] = std::min(bbox[1], wx);
      bbox[2] = std::max(bbox[2], wy);
      bbox[3] = std::min(bbox[3], wy);
      bbox[4] = std::max(bbox[4], wz);
      bbox[5] = std::min(bbox[5], wz);
    }
  }

  std::vector<U8> out;
  out.reserve(static_cast<size_t>(n) * 28 / (compress ? 4 : 1) + 512);

  // ---- LAS 1.2 header (227 bytes) + optional laszip VLR
  const U16 vlr_payload = 34 + 6 * 2;
  const U32 offset_to_points = 227 + (compress ? 54 + vlr_payload : 0);
  out.insert(out.end(), {'L', 'A', 'S', 'F'});
  wr<U16>(out, 0);                       // file source id
  wr<U16>(out, 0);                       // global encoding
  for (int i = 0; i < 16; ++i) out.push_back(0);  // guid
  out.push_back(1);                      // version 1.2
  out.push_back(2);
  char sysid[32] = "mm_training_tpu";
  char gensw[32] = "lasio native codec";
  out.insert(out.end(), sysid, sysid + 32);
  out.insert(out.end(), gensw, gensw + 32);
  wr<U16>(out, 1);                       // creation day
  wr<U16>(out, 2026);                    // creation year
  wr<U16>(out, 227);                     // header size
  wr<U32>(out, offset_to_points);
  wr<U32>(out, compress ? 1 : 0);        // number of VLRs
  out.push_back(compress ? (1 | 0x80) : 1);  // point format 1 (+laz bit)
  wr<U16>(out, 28);                      // record length
  wr<U32>(out, static_cast<U32>(n));     // legacy point count
  wr<U32>(out, static_cast<U32>(n));     // points by return[0]
  for (int i = 0; i < 4; ++i) wr<U32>(out, 0);
  wr<F64>(out, sx);
  wr<F64>(out, sy);
  wr<F64>(out, sz);
  wr<F64>(out, ox);
  wr<F64>(out, oy);
  wr<F64>(out, oz);
  for (int i = 0; i < 6; ++i) wr<F64>(out, bbox[i]);

  if (compress) {
    // laszip VLR
    wr<U16>(out, 0);  // reserved
    char user[16] = "laszip encoded";
    out.insert(out.end(), user, user + 16);
    wr<U16>(out, 22204);
    wr<U16>(out, vlr_payload);
    char desc[32] = "lasio (chunked, coder 0)";
    out.insert(out.end(), desc, desc + 32);
    wr<U16>(out, 2);   // compressor: pointwise chunked
    wr<U16>(out, 0);   // coder: arithmetic
    out.push_back(2);  // version 2.2.0
    out.push_back(2);
    wr<U16>(out, 0);
    wr<U32>(out, 0);   // options
    wr<U32>(out, chunk_size);
    wr<I64>(out, -1);  // number of special evlrs
    wr<I64>(out, -1);  // offset to special evlrs
    wr<U16>(out, 2);   // num items
    wr<U16>(out, 6);   // POINT10
    wr<U16>(out, 20);
    wr<U16>(out, 2);
    wr<U16>(out, 7);   // GPSTIME11
    wr<U16>(out, 8);
    wr<U16>(out, 2);

    const size_t table_off_pos = out.size();
    wr<I64>(out, 0);  // chunk table offset placeholder

    Point10V2 p10;
    GpsTime11V2 gps;
    Encoder enc;
    std::vector<U32> chunk_bytes;
    U8 raw[28];
    size_t chunk_begin = 0;
    for (long long i = 0; i < n; ++i) {
      const U32 j = static_cast<U32>(i % chunk_size);
      std::memcpy(raw, &recs[i], 20);
      std::memcpy(raw + 20, pts + 5 * i + 4, 8);  // gps f64
      if (j == 0) {
        if (i > 0) {
          enc.done();
          chunk_bytes.push_back(static_cast<U32>(out.size() - chunk_begin));
        }
        chunk_begin = out.size();
        out.insert(out.end(), raw, raw + 28);  // raw first point
        p10.init(raw);
        gps.init(raw + 20);
        enc.init(&out);
      } else {
        p10.write(enc, raw);
        gps.write(enc, raw + 20);
      }
    }
    if (n > 0) {
      enc.done();
      chunk_bytes.push_back(static_cast<U32>(out.size() - chunk_begin));
    }

    const I64 table_off = static_cast<I64>(out.size());
    std::memcpy(out.data() + table_off_pos, &table_off, 8);
    wr<U32>(out, 0);  // chunk table version
    wr<U32>(out, static_cast<U32>(chunk_bytes.size()));
    if (!chunk_bytes.empty()) {
      Encoder tenc;
      tenc.init(&out);
      IntCompressor ic(32, 2);
      ic.init();
      I32 prev = 0;
      for (U32 sz_i : chunk_bytes) {
        ic.compress(tenc, prev, static_cast<I32>(sz_i), 1);
        prev = static_cast<I32>(sz_i);
      }
      tenc.done();
    }
  } else {
    for (long long i = 0; i < n; ++i) {
      const size_t at = out.size();
      out.resize(at + 28);
      std::memcpy(out.data() + at, &recs[i], 20);
      std::memcpy(out.data() + at + 20, pts + 5 * i + 4, 8);
    }
  }

  FILE* fp = std::fopen(path, "wb");
  if (!fp) return LASIO_EWRITE;
  const size_t put = std::fwrite(out.data(), 1, out.size(), fp);
  const int rc = std::fclose(fp);
  if (put != out.size() || rc != 0) return LASIO_EWRITE;
  return n;
}

}  // namespace

// ================================================================== C API

extern "C" {

// out[0]=npoints out[1]=format out[2]=compressed out[3..5]=scale
// out[6..8]=offset out[9]=has_gps out[10]=record_length
int las_info(const char* path, double* out) {
  std::vector<U8> f;
  // header + VLRs only: read up to offset_to_point_data, not the points
  int rc = read_file(path, &f, 512);
  if (rc) return rc;
  LasHeader h;
  LazVlrInfo laz;
  if (f.size() >= 100) {
    const U32 otp = rd<U32>(&f[96]);
    if (otp > f.size()) rc = read_file(path, &f, static_cast<long>(otp));
    if (rc) return rc;
  }
  rc = parse_header(f, &h, &laz);
  if (rc) return rc;
  out[0] = static_cast<double>(h.npoints);
  out[1] = h.point_format;
  out[2] = h.compressed ? 1 : 0;
  for (int i = 0; i < 3; ++i) {
    out[3 + i] = h.scale[i];
    out[6 + i] = h.offset[i];
  }
  out[9] = gps_offset_for_format(h.point_format) > 0 ? 1 : 0;
  out[10] = h.record_length;
  return 0;
}

long long las_read_points(const char* path, double* out, long long cap) {
  std::vector<U8> f;
  int rc = read_file(path, &f);
  if (rc) return rc;
  LasHeader h;
  LazVlrInfo laz;
  rc = parse_header(f, &h, &laz);
  if (rc) return rc;
  return read_points_impl(f, h, laz, out, cap);
}

long long las_write_points(const char* path, const double* pts, long long n,
                           double sx, double sy, double sz, double ox,
                           double oy, double oz, int compress,
                           unsigned chunk_size) {
  return write_points_impl(path, pts, n, sx, sy, sz, ox, oy, oz, compress,
                           chunk_size);
}

}  // extern "C"
