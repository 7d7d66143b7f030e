// Common types, status codes, and constants for the host bitstream front-end.
//
// This library is the "L2a" half of the TPU-native decoder: everything that is
// inherently serial bit-twiddling (NAL extraction, Exp-Golomb, CAVLC, header
// parsing, DPB bookkeeping) runs here on the host CPU and emits dense
// per-frame macroblock tensors consumed by the JAX/Pallas reconstruction
// pipeline on TPU. Behavioral parity anchors are cited as reference file:line
// (reference tree: oneam/h264bsd).
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace h264tpu {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i8 = int8_t;
using i16 = int16_t;
using i32 = int32_t;
using i64 = int64_t;

enum class Status : u32 {
  kOk = 0,
  kError = 1,          // invalid stream data (reference HANTRO_NOK)
  kParamSetError = 2,  // invalid/unsupported parameter set
  kMemError = 3,
};

inline bool ok(Status s) { return s == Status::kOk; }

// Profile-independent limits (reference h264bsd_cfg.h:44-47).
constexpr u32 kMaxNumRefPics = 16;
constexpr u32 kMaxNumSps = 32;
constexpr u32 kMaxNumPps = 256;
constexpr u32 kMaxNumSliceGroups = 8;

// NAL unit types (subset handled; reference h264bsd_nal_unit.h).
enum NalType : u32 {
  kNalUnspecified = 0,
  kNalCodedSlice = 1,
  kNalCodedSliceIdr = 5,
  kNalSei = 6,
  kNalSps = 7,
  kNalPps = 8,
  kNalAccessUnitDelimiter = 9,
  kNalEndOfSequence = 10,
  kNalEndOfStream = 11,
  kNalFillerData = 12,
  kNalMaxType = 31,
};

struct NalUnit {
  NalType type = kNalUnspecified;
  u32 ref_idc = 0;
};

inline bool is_idr(const NalUnit& n) { return n.type == kNalCodedSliceIdr; }

// Macroblock types (decoded value space; reference h264bsd_macroblock_layer.h:51-84).
enum MbType : u32 {
  kPSkip = 0,
  kP16x16 = 1,
  kP16x8 = 2,
  kP8x16 = 3,
  kP8x8 = 4,
  kP8x8ref0 = 5,
  kI4x4 = 6,
  kI16x16Base = 7,   // 7..30: I_16x16 variants
  kIPcm = 31,
};

inline bool mb_is_intra(u32 t) { return t > kP8x8ref0; }
inline bool mb_is_i16(u32 t) { return t >= kI16x16Base && t < kIPcm; }

// Device-side mb_class of a concealed MB (renders nothing; deblock treats
// it as intra with qp 40 and zero filter offsets, ConcealMb
// conceal.c:384-392).
constexpr u8 kMbConcealed = 6;

// Chroma QP mapping table, spec Table 8-15 (reference h264bsd_util.c:53-55).
constexpr u8 kQpC[52] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 32, 33,
    34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};

}  // namespace h264tpu
