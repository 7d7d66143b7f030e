// Annex-B byte-stream handling: start-code scan, NAL size determination, and
// emulation-prevention-byte removal. Unlike the reference (which strips EPBs
// in place, mutating the caller's buffer — reference h264bsd_byte_stream.c:193-233,
// README.md:12), we strip into an internal scratch vector so user input is
// never modified. The consumed-bytes accounting matches the reference exactly
// so the per-NAL resume contract is preserved.
#pragma once

#include "bitreader.h"
#include "common.h"

namespace h264tpu {

struct ExtractedNal {
  // RBSP payload with start code + EPBs removed; points into scratch storage
  // owned by the Extractor, valid until the next extract() call.
  const u8* rbsp = nullptr;
  u32 rbsp_size = 0;
  u32 read_bytes = 0;  // bytes consumed from the input buffer
};

class NalExtractor {
 public:
  // Mirrors reference h264bsdExtractNalUnit (h264bsd_byte_stream.c:81-237):
  // detects byte-stream vs bare-NAL input from the leading bytes, rejects
  // in-NAL sequences 0x000000/01/02 and truncated EPBs.
  Status extract(const u8* data, u32 len, ExtractedNal* out);

  // Parse the NAL unit header and perform the reference's validity checks
  // (reference h264bsd_nal_unit.c:69-117): forbidden_zero_bit, rejection of
  // data partitioning NAL types 2-4, nal_ref_idc constraints for IDR/SPS/PPS
  // vs SEI. Advances the reader by one byte.
  static Status decode_nal_header(BitReader& br, NalUnit* nal);

 private:
  std::vector<u8> scratch_;
};

}  // namespace h264tpu
