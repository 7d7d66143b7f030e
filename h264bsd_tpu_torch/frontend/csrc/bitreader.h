// MSB-first bit reader over an EPB-stripped RBSP buffer, plus Exp-Golomb
// decoders. Semantics match the reference bit reader (h264bsd_stream.c) and
// VLC module (h264bsd_vlc.c): reads past the end return zero bits, a flush
// past the end is an error, and the 65-bit BIG_CODE_NUM edge cases of ue(v)
// are preserved.
#pragma once

#include <cstring>

#include "common.h"

namespace h264tpu {

constexpr u32 kEndOfStream = 0xFFFFFFFFu;
constexpr u32 kBigCodeNum = 0xFFFFFFFFu;

class BitReader {
 public:
  BitReader() = default;
  BitReader(const u8* data, u32 size_bytes) : buf_(data), size_(size_bytes) {}

  // 32-bit MSB-first peek; bits beyond the end read as zero
  // (reference h264bsd_stream.c:116-167).
  u32 show32() const {
    i64 bits_left = i64(size_) * 8 - i64(read_bits_);
    if (bits_left <= 0) return 0;
    const u8* p = buf_ + (read_bits_ >> 3);
    u32 bit_pos = read_bits_ & 7;
    if (bits_left >= 64) {  // fast path: one unaligned load + byte swap
      u64 w;
      std::memcpy(&w, p, 8);
      w = __builtin_bswap64(w);
      return u32(w >> (32 - bit_pos));
    }
    // tail: assemble byte by byte, zero-padded
    u64 w = 0;
    u32 avail_bytes = size_ - u32(read_bits_ >> 3);
    for (u32 i = 0; i < 8; ++i) w |= u64(i < avail_bytes ? p[i] : 0) << (56 - 8 * i);
    return u32(w >> (32 - bit_pos));
  }

  // Remove bits; error when flushing past the end (h264bsd_stream.c:189-209).
  Status flush(u32 num_bits) {
    read_bits_ += num_bits;
    return read_bits_ <= 8 * u64(size_) ? Status::kOk : Status::kError;
  }

  // Read up to 31 bits; kEndOfStream if not enough bits left.
  u32 get_bits(u32 num_bits) {
    if (num_bits == 0) return 0;
    u32 out = show32() >> (32 - num_bits);
    return ok(flush(num_bits)) ? out : kEndOfStream;
  }

  bool byte_aligned() const { return (read_bits_ & 7) == 0; }
  u64 bits_read() const { return read_bits_; }
  u32 size_bytes() const { return size_; }
  i64 bits_left() const { return i64(size_) * 8 - i64(read_bits_); }

  // ue(v). Mirrors the 2^32-1 / 2^32 special cases: both set *code_num to
  // kBigCodeNum; the former returns kOk, the latter kError
  // (reference h264bsd_vlc.c:105-201).
  Status ue(u32* code_num) {
    u32 bits = show32();
    if (bits & 0x80000000u) {
      flush(1);
      *code_num = 0;
      return Status::kOk;
    }
    u32 zeros = bits ? u32(__builtin_clz(bits)) : 32;
    if (zeros < 32) {
      if (!ok(flush(zeros + 1))) return Status::kError;
      u32 suffix = get_bits(zeros);
      if (suffix == kEndOfStream) return Status::kError;
      *code_num = (1u << zeros) - 1 + suffix;
      return Status::kOk;
    }
    // 32 leading zero bits: 65-bit codes
    *code_num = 0;
    flush(32);
    if (get_bits(1) == 1) {
      u32 tail = show32();
      if (!ok(flush(32))) return Status::kError;
      if (tail == 0) {  // codeNum 2^32 - 1
        *code_num = kBigCodeNum;
        return Status::kOk;
      }
      if (tail == 1) {  // codeNum 2^32 (used by se(v) for -2^31)
        *code_num = kBigCodeNum;
        return Status::kError;
      }
    }
    return Status::kError;
  }

  // se(v) (reference h264bsd_vlc.c:232-276).
  Status se(i32* value) {
    u32 code_num = 0;
    Status s = ue(&code_num);
    if (code_num == kBigCodeNum) {
      if (ok(s)) return Status::kError;  // would be +2^31, out of range
      *value = i32(0x80000000u);         // -2^31
      return Status::kOk;
    }
    if (!ok(s)) return Status::kError;
    *value = (code_num & 1) ? i32((code_num + 1) >> 1) : -i32((code_num + 1) >> 1);
    return Status::kOk;
  }

  // te(v) (reference h264bsd_vlc.c:365-392).
  Status te(u32* value, bool greater_than_one) {
    if (greater_than_one) return ue(value);
    u32 bit = get_bits(1);
    if (bit == kEndOfStream) return Status::kError;
    *value = bit ^ 1u;
    return Status::kOk;
  }

  // RBSP trailing-bits check (reference h264bsd_util.c:124-148).
  Status rbsp_trailing_bits() {
    u32 len = 8 - (read_bits_ & 7);
    u32 stuffing = get_bits(len);
    if (stuffing == kEndOfStream) return Status::kError;
    return stuffing == (1u << (len - 1)) ? Status::kOk : Status::kError;
  }

  // more_rbsp_data() (reference h264bsd_util.c:172-195).
  bool more_rbsp_data() const {
    i64 bits = bits_left();
    if (bits <= 0) return false;
    if (bits > 8) return true;
    return (show32() >> (32 - bits)) != (1u << (bits - 1));
  }

 private:
  const u8* buf_ = nullptr;
  u32 size_ = 0;
  u64 read_bits_ = 0;
};

// Coded-block-pattern me(v) mapping tables, spec Table 9-4
// (reference h264bsd_vlc.c:59-65).
Status decode_cbp(BitReader& br, bool is_intra, u32* cbp);

}  // namespace h264tpu
