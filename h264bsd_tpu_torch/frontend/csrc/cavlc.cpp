#include "cavlc.h"

#include <array>

#include "cavlc_tables.h"

namespace h264tpu {

namespace {

// Flat decode LUTs, built once from the canonical code lists. An entry of 0
// means "no such codeword".
//
// coeff_token: indexed by the next 16 stream bits, value packs
// [total_coeff:5][trailing_ones:6][length:5] (mirrors the reference's info
// field layout, h264bsd_cavlc.c:56-67, so parity tests can compare directly).
struct CavlcLuts {
  // 5 nC classes: 0 (nC<2), 1 (2<=nC<4), 2 (4<=nC<8), 3 (nC>=8), 4 (nC==-1)
  std::array<std::array<u16, 1 << 16>, 5> coeff_token;
  // first-level 10-bit table (2KB/class, cache-resident): short codes
  // resolve here; 0xFFFF defers to the full 16-bit table. The flat 64K
  // tables replicate a short code over up to 2^12 consecutive entries,
  // so random lookups into them miss cache on nearly every call.
  std::array<std::array<u16, 1 << 10>, 5> ct_l1;
  // total_zeros: [tc-1][9 bits] for luma, [tc-1][9 bits] chroma DC
  std::array<std::array<u8, 1 << 9>, 15> total_zeros_luma;
  std::array<std::array<u8, 1 << 9>, 3> total_zeros_chroma;
  // run_before: [min(zeros_left,7)-1][11 bits]
  std::array<std::array<u8, 1 << 11>, 7> run_before;

  CavlcLuts() {
    auto fill_ct = [&](std::array<u16, 1 << 16>& lut, const CoeffTokenCode* codes,
                       size_t n) {
      lut.fill(0);
      for (size_t i = 0; i < n; ++i) {
        const auto& c = codes[i];
        u32 base = u32(c.code) << (16 - c.len);
        u32 count = 1u << (16 - c.len);
        u16 packed = u16((u32(c.total_coeff) << 11) | (u32(c.trailing_ones) << 5) |
                         c.len);
        for (u32 b = 0; b < count; ++b) lut[base + b] = packed;
      }
    };
    fill_ct(coeff_token[0], kCoeffToken0, std::size(kCoeffToken0));
    fill_ct(coeff_token[1], kCoeffToken2, std::size(kCoeffToken2));
    fill_ct(coeff_token[2], kCoeffToken4, std::size(kCoeffToken4));
    fill_ct(coeff_token[3], kCoeffToken8, std::size(kCoeffToken8));
    fill_ct(coeff_token[4], kCoeffTokenM1, std::size(kCoeffTokenM1));

    auto fill_l1 = [&](std::array<u16, 1 << 10>& lut,
                       const CoeffTokenCode* codes, size_t n) {
      lut.fill(0);
      for (size_t i = 0; i < n; ++i) {
        const auto& c = codes[i];
        if (c.len > 10) continue;
        u32 base = u32(c.code) << (10 - c.len);
        u32 count = 1u << (10 - c.len);
        u16 packed = u16((u32(c.total_coeff) << 11) |
                         (u32(c.trailing_ones) << 5) | c.len);
        for (u32 b = 0; b < count; ++b) lut[base + b] = packed;
      }
      for (size_t i = 0; i < n; ++i) {  // long codes: defer by 10-bit prefix
        const auto& c = codes[i];
        if (c.len <= 10) continue;
        lut[u32(c.code) >> (c.len - 10)] = 0xFFFF;
      }
    };
    fill_l1(ct_l1[0], kCoeffToken0, std::size(kCoeffToken0));
    fill_l1(ct_l1[1], kCoeffToken2, std::size(kCoeffToken2));
    fill_l1(ct_l1[2], kCoeffToken4, std::size(kCoeffToken4));
    fill_l1(ct_l1[3], kCoeffToken8, std::size(kCoeffToken8));
    fill_l1(ct_l1[4], kCoeffTokenM1, std::size(kCoeffTokenM1));

    auto fill_short = [&](u8* lut, u32 lut_bits, const ShortCode* codes,
                          size_t n) {
      std::memset(lut, 0, size_t(1) << lut_bits);
      for (size_t i = 0; i < n; ++i) {
        const auto& c = codes[i];
        u32 base = u32(c.code) << (lut_bits - c.len);
        u32 count = 1u << (lut_bits - c.len);
        u8 packed = u8((c.value << 4) | c.len);
        for (u32 b = 0; b < count; ++b) lut[base + b] = packed;
      }
    };
    const ShortCode* tz[15] = {
        kTotalZeros1,  kTotalZeros2,  kTotalZeros3,  kTotalZeros4,
        kTotalZeros5,  kTotalZeros6,  kTotalZeros7,  kTotalZeros8,
        kTotalZeros9,  kTotalZeros10, kTotalZeros11, kTotalZeros12,
        kTotalZeros13, kTotalZeros14, kTotalZeros15};
    const size_t tz_n[15] = {
        std::size(kTotalZeros1),  std::size(kTotalZeros2),
        std::size(kTotalZeros3),  std::size(kTotalZeros4),
        std::size(kTotalZeros5),  std::size(kTotalZeros6),
        std::size(kTotalZeros7),  std::size(kTotalZeros8),
        std::size(kTotalZeros9),  std::size(kTotalZeros10),
        std::size(kTotalZeros11), std::size(kTotalZeros12),
        std::size(kTotalZeros13), std::size(kTotalZeros14),
        std::size(kTotalZeros15)};
    for (int i = 0; i < 15; ++i)
      fill_short(total_zeros_luma[i].data(), 9, tz[i], tz_n[i]);
    fill_short(total_zeros_chroma[0].data(), 9, kTotalZerosChromaDc1,
               std::size(kTotalZerosChromaDc1));
    fill_short(total_zeros_chroma[1].data(), 9, kTotalZerosChromaDc2,
               std::size(kTotalZerosChromaDc2));
    fill_short(total_zeros_chroma[2].data(), 9, kTotalZerosChromaDc3,
               std::size(kTotalZerosChromaDc3));

    const ShortCode* rb[7] = {kRunBefore1, kRunBefore2, kRunBefore3,
                              kRunBefore4, kRunBefore5, kRunBefore6,
                              kRunBefore7Up};
    const size_t rb_n[7] = {std::size(kRunBefore1), std::size(kRunBefore2),
                            std::size(kRunBefore3), std::size(kRunBefore4),
                            std::size(kRunBefore5), std::size(kRunBefore6),
                            std::size(kRunBefore7Up)};
    for (int i = 0; i < 7; ++i)
      fill_short(run_before[i].data(), 11, rb[i], rb_n[i]);
  }
};

const CavlcLuts& luts() {
  static const CavlcLuts instance;
  return instance;
}

inline u32 nc_class(i32 nc) {
  if (nc < 0) return 4;
  if (nc < 2) return 0;
  if (nc < 4) return 1;
  if (nc < 8) return 2;
  return 3;
}

// 32-bit local bit cache over the BitReader, replicating the reference's
// BUFFER_* macros' refill-and-error semantics (h264bsd_cavlc.c:325-366):
// a refill first commits consumed bits via flush() which fails past stream end.
struct BitCache {
  BitReader& br;
  u32 value;
  u32 bits;

  explicit BitCache(BitReader& r) : br(r), value(r.show32()), bits(32) {}

  bool show(u32 n, u32* out) {
    if (bits < n) {
      if (!ok(br.flush(32 - bits))) return false;
      value = br.show32();
      bits = 32;
    }
    *out = value >> (32 - n);
    return true;
  }
  void drop(u32 n) {
    value <<= n;
    bits -= n;
  }
  bool get(u32 n, u32* out) {
    if (!show(n, out)) return false;
    drop(n);
    return true;
  }
  Status finish() { return br.flush(32 - bits); }
};

}  // namespace

u32 dev_coeff_token(u32 bits16, i32 nc) {
  return luts().coeff_token[nc_class(nc)][bits16 & 0xFFFF];
}

u32 dev_total_zeros(u32 bits9, u32 total_coeff, bool chroma_dc) {
  return chroma_dc ? luts().total_zeros_chroma[total_coeff - 1][bits9 & 0x1FF]
                   : luts().total_zeros_luma[total_coeff - 1][bits9 & 0x1FF];
}

u32 dev_run_before(u32 bits11, u32 zeros_left) {
  u32 idx = zeros_left < 7 ? zeros_left - 1 : 6;
  u32 v = luts().run_before[idx][bits11 & 0x7FF];
  if (zeros_left >= 7 && (v >> 4) > zeros_left) v = 0;
  return v;
}

Status decode_residual_block(BitReader& br, i32 nc, u32 max_num_coeff,
                             i16* coeff_level, CavlcResult* out) {
  const CavlcLuts& t = luts();
  BitCache cache(br);

  u32 bits = 0;
  if (!cache.show(16, &bits)) return Status::kError;
  u32 cls = nc_class(nc);
  u32 token = t.ct_l1[cls][bits >> 6];
  if (__builtin_expect(token == 0xFFFF, 0)) token = t.coeff_token[cls][bits];
  if (!token) return Status::kError;
  cache.drop(token & 0x1F);

  u32 total_coeff = (token >> 11) & 0x1F;
  if (total_coeff > max_num_coeff) return Status::kError;
  u32 trailing_ones = (token >> 5) & 0x3F;

  u16 coeff_map = 0;
  u32 abs_sum = 0;
  if (total_coeff != 0) {
    i32 level[16];
    u32 run[16];
    u32 i = 0;

    if (trailing_ones) {
      u32 signs = 0;
      if (!cache.get(trailing_ones, &signs)) return Status::kError;
      for (u32 mask = 1u << (trailing_ones - 1); mask; mask >>= 1, ++i)
        level[i] = (signs & mask) ? -1 : 1;
    }

    u32 suffix_length = (total_coeff > 10 && trailing_ones < 3) ? 1 : 0;

    for (; i < total_coeff; ++i) {
      if (!cache.show(16, &bits)) return Status::kError;
      if (bits == 0) return Status::kError;  // >15 zeros: invalid level_prefix
      u32 level_prefix = 15 - (31 - u32(__builtin_clz(bits)));
      cache.drop(level_prefix + 1);

      u32 suffix_bits;
      if (level_prefix < 14) {
        suffix_bits = suffix_length;
      } else if (level_prefix == 14) {
        suffix_bits = suffix_length ? suffix_length : 4;
      } else {
        // level_prefix 15 escape; suffix_length 0 behaves as 1 (adds 15)
        if (!suffix_length) suffix_length = 1;
        suffix_bits = 12;
      }

      u32 code = level_prefix;
      if (suffix_length) code <<= suffix_length;
      if (suffix_bits) {
        u32 suffix = 0;
        if (!cache.get(suffix_bits, &suffix)) return Status::kError;
        code += suffix;
      }
      if (i == trailing_ones && trailing_ones < 3) code += 2;

      level[i] = i32((code + 2) >> 1);
      if (suffix_length == 0) suffix_length = 1;
      if (level[i] > (3 << (suffix_length - 1)) && suffix_length < 6)
        suffix_length++;
      if (code & 1) level[i] = -level[i];
    }

    u32 zeros_left = 0;
    if (total_coeff < max_num_coeff) {
      if (!cache.show(9, &bits)) return Status::kError;
      u32 tz = max_num_coeff == 4
                   ? t.total_zeros_chroma[total_coeff - 1][bits]
                   : t.total_zeros_luma[total_coeff - 1][bits];
      if (!tz) return Status::kError;
      cache.drop(tz & 0xF);
      zeros_left = tz >> 4;
    }

    for (i = 0; i + 1 < total_coeff; ++i) {
      if (zeros_left > 0) {
        if (!cache.show(11, &bits)) return Status::kError;
        u32 rb = t.run_before[zeros_left < 7 ? zeros_left - 1 : 6][bits];
        if (zeros_left >= 7 && (rb >> 4) > zeros_left) rb = 0;
        if (!rb) return Status::kError;
        cache.drop(rb & 0xF);
        run[i] = rb >> 4;
        zeros_left -= run[i]++;
      } else {
        run[i] = 1;
      }
    }

    // scatter levels to zigzag positions, highest-frequency coefficient first
    u32 pos = zeros_left;
    coeff_level[pos] = i16(level[total_coeff - 1]);
    coeff_map = u16(1u << pos);
    abs_sum = u32(level[total_coeff - 1] < 0 ? -level[total_coeff - 1]
                                             : level[total_coeff - 1]);
    for (i = total_coeff - 1; i--;) {
      pos += run[i];
      coeff_map |= u16(1u << pos);
      coeff_level[pos] = i16(level[i]);
      abs_sum += u32(level[i] < 0 ? -level[i] : level[i]);
    }
  }

  if (!ok(cache.finish())) return Status::kError;
  out->total_coeff = total_coeff;
  out->coeff_map = coeff_map;
  out->abs_sum = abs_sum;
  return Status::kOk;
}

}  // namespace h264tpu
