#include "nal.h"

namespace h264tpu {

Status NalExtractor::extract(const u8* data, u32 len, ExtractedNal* out) {
  u32 nal_start = 0;   // offset of first byte after the start-code prefix
  u32 nal_size = 0;    // bytes of the NAL unit (EPBs still present)
  u32 trailing = 0;    // trailing zero bytes consumed but not part of the NAL
  bool byte_stream = len > 3 && data[0] == 0x00 && data[1] == 0x00 &&
                     (data[2] & 0xFE) == 0x00;
  bool invalid = false;
  bool has_emulation = true;

  if (byte_stream) {
    // Scan for the first start code (00 00 01), tolerating extra zeros.
    u32 pos = 2, zeros = 2;
    for (;;) {
      u8 b = data[pos++];
      if (pos == len) {  // no start code found in the whole buffer
        out->read_bytes = len;
        return Status::kError;
      }
      if (b == 0) {
        zeros++;
      } else if (b == 0x01 && zeros >= 2) {
        break;
      } else {
        zeros = 0;
      }
    }
    nal_start = pos;

    // Find the next start code (or end of buffer) to bound the NAL; note
    // in-NAL 0x000003 marks emulation and >=3 zeros before a nonzero,
    // non-0x01 byte is an invalid sequence (h264bsd_byte_stream.c:133-169).
    zeros = 0;
    has_emulation = false;
    for (;;) {
      u8 b = data[pos++];
      if (b == 0) zeros++;
      if (b == 0x03 && zeros == 2) has_emulation = true;
      if (b == 0x01 && zeros >= 2) {
        nal_size = pos - nal_start - zeros - 1;
        trailing = zeros - (zeros < 3 ? zeros : 3);
        break;
      } else if (b != 0) {
        if (zeros >= 3) invalid = true;
        zeros = 0;
      }
      if (pos == len) {
        nal_size = pos - nal_start - zeros;
        trailing = zeros;
        break;
      }
    }
  } else {
    // bare single-NAL buffer
    nal_size = len;
  }

  out->read_bytes = nal_start + nal_size + trailing;
  if (invalid) return Status::kError;

  const u8* nal = data + nal_start;
  if (!has_emulation) {
    out->rbsp = nal;
    out->rbsp_size = nal_size;
    return Status::kOk;
  }

  // Strip emulation prevention bytes into scratch; enforce that 0x03 is
  // followed by 0x00-0x03 and that 0x000000/01/02 never appear in a NAL
  // (h264bsd_byte_stream.c:199-228).
  scratch_.resize(nal_size);
  u8* w = scratch_.data();
  u32 zeros = 0;
  for (u32 i = 0; i < nal_size; ++i) {
    u8 b = nal[i];
    if (zeros == 2 && b == 0x03) {
      if (i + 1 == nal_size || nal[i + 1] > 0x03) return Status::kError;
      zeros = 0;
      continue;  // drop the EPB
    }
    if (zeros == 2 && b <= 0x02) return Status::kError;
    zeros = (b == 0) ? zeros + 1 : 0;
    *w++ = b;
  }
  out->rbsp = scratch_.data();
  out->rbsp_size = u32(w - scratch_.data());
  return Status::kOk;
}

Status NalExtractor::decode_nal_header(BitReader& br, NalUnit* nal) {
  if (br.get_bits(1) == kEndOfStream) return Status::kError;  // forbidden bit
  nal->ref_idc = br.get_bits(2);
  u32 t = br.get_bits(5);
  nal->type = NalType(t);
  if (t >= 2 && t <= 4) return Status::kError;  // data partitioning unsupported
  bool must_ref = t == kNalSps || t == kNalPps || t == kNalCodedSliceIdr;
  bool must_nonref = t == kNalSei || t == kNalAccessUnitDelimiter ||
                     t == kNalEndOfSequence || t == kNalEndOfStream ||
                     t == kNalFillerData;
  if (must_ref && nal->ref_idc == 0) return Status::kError;
  if (must_nonref && nal->ref_idc != 0) return Status::kError;
  return Status::kOk;
}

// me(v) for coded_block_pattern, spec Table 9-4 (values are ITU constants;
// layout matches reference h264bsd_vlc.c:59-65 by necessity).
static const u8 kCbpIntra[48] = {
    47, 31, 15, 0,  23, 27, 29, 30, 7,  11, 13, 14, 39, 43, 45, 46,
    16, 3,  5,  10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1,  2,  4,
    8,  17, 18, 20, 24, 6,  9,  22, 25, 32, 33, 34, 36, 40, 38, 41};
static const u8 kCbpInter[48] = {
    0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15, 47, 7,  11, 13,
    14, 6,  9,  31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};

Status decode_cbp(BitReader& br, bool is_intra, u32* cbp) {
  u32 code_num = 0;
  if (!ok(br.ue(&code_num)) || code_num > 47) return Status::kError;
  *cbp = is_intra ? kCbpIntra[code_num] : kCbpInter[code_num];
  return Status::kOk;
}

}  // namespace h264tpu
