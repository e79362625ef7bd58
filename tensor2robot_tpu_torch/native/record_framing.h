// Shared TFRecord framing: the ONE definition of the record header/
// footer contract (length cap, CRC checks, error classification) used
// by both native readers — tfrecord_io.cc's batched Reader and
// batch_stager.cc's per-file RecordReader. Before this header the two
// siblings each carried a copy of the framing sequence and the 2 GiB
// sanity cap; a policy change had to be replicated or the paths
// drifted silently (the fuzz-parity tests pin
// the error CLASSES, not which copy produced them).
//
// Record framing (public TFRecord format):
//   uint64 length | uint32 masked_crc(length) | data | uint32 masked_crc(data)

#ifndef TENSOR2ROBOT_TPU_NATIVE_RECORD_FRAMING_H_
#define TENSOR2ROBOT_TPU_NATIVE_RECORD_FRAMING_H_

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

// Defined in tfrecord_io.cc; every framing user links into the same
// shared library.
extern "C" uint32_t t2r_masked_crc32c(const uint8_t* data, int64_t n);

namespace t2r {

// Sanity cap: a corrupt length field must not drive a huge allocation.
// Mirrored by the Python fallback (`data/tfrecord.py` _MAX_RECORD_BYTES)
// so both paths raise the same error class on garbage lengths.
constexpr uint64_t kMaxRecordBytes = 1ull << 31;  // 2 GiB

// Reads the 12-byte record header. 1 = ok (*length set), 0 = clean
// EOF, -1 = corruption (*error set).
inline int ReadRecordHeader(std::FILE* file, bool verify_crc,
                            uint64_t* length, std::string* error) {
  uint8_t header[12];
  size_t got = std::fread(header, 1, 12, file);
  if (got == 0) return 0;
  if (got < 12) {
    *error = "truncated header";
    return -1;
  }
  std::memcpy(length, header, 8);
  if (*length > kMaxRecordBytes) {
    *error = "implausible record length (corrupt file?)";
    return -1;
  }
  if (verify_crc) {
    uint32_t expect;
    std::memcpy(&expect, header + 8, 4);
    if (t2r_masked_crc32c(header, 8) != expect) {
      *error = "length crc mismatch";
      return -1;
    }
  }
  return 1;
}

// Reads + checks the 4-byte data-CRC footer for a record body already
// in memory. 1 = ok, -1 = corruption (*error set).
inline int ReadRecordFooter(std::FILE* file, bool verify_crc,
                            const uint8_t* data, uint64_t length,
                            std::string* error) {
  uint8_t footer[4];
  if (std::fread(footer, 1, 4, file) < 4) {
    *error = "truncated footer";
    return -1;
  }
  if (verify_crc) {
    uint32_t expect;
    std::memcpy(&expect, footer, 4);
    if (t2r_masked_crc32c(data, static_cast<int64_t>(length)) != expect) {
      *error = "data crc mismatch";
      return -1;
    }
  }
  return 1;
}

}  // namespace t2r

#endif  // TENSOR2ROBOT_TPU_NATIVE_RECORD_FRAMING_H_
