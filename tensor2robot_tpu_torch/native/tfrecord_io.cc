// Native TFRecord IO: buffered record reader + CRC32C.
//
// The hot host-side loop of the data layer. The reference delegates this to the
// TensorFlow runtime's C++ record readers; this is our equivalent,
// exposed through a minimal C ABI consumed via ctypes
// (tensor2robot_tpu_torch/native/__init__.py). Python fallbacks exist for
// every entry point.
//
// Record framing lives in record_framing.h — the ONE definition of the
// header/footer contract shared with batch_stager.cc's RecordReader.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "record_framing.h"

namespace {

// CRC32C (Castagnoli), 8-slice table-driven.
uint32_t g_tables[8][256];
bool g_tables_ready = false;

void init_tables() {
  if (g_tables_ready) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int k = 0; k < 8; ++k)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    g_tables[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = g_tables[0][i];
    for (int t = 1; t < 8; ++t) {
      crc = g_tables[0][crc & 0xFF] ^ (crc >> 8);
      g_tables[t][i] = crc;
    }
  }
  g_tables_ready = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  init_tables();
  uint32_t crc = 0xFFFFFFFFu;
  while (n >= 8) {
    crc ^= static_cast<uint32_t>(data[0]) |
           (static_cast<uint32_t>(data[1]) << 8) |
           (static_cast<uint32_t>(data[2]) << 16) |
           (static_cast<uint32_t>(data[3]) << 24);
    crc = g_tables[7][crc & 0xFF] ^ g_tables[6][(crc >> 8) & 0xFF] ^
          g_tables[5][(crc >> 16) & 0xFF] ^ g_tables[4][(crc >> 24) & 0xFF] ^
          g_tables[3][data[4]] ^ g_tables[2][data[5]] ^
          g_tables[1][data[6]] ^ g_tables[0][data[7]];
    data += 8;
    n -= 8;
  }
  while (n--) crc = g_tables[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

struct Reader {
  FILE* file = nullptr;
  std::vector<uint8_t> arena;       // batch payload storage
  std::vector<int64_t> offsets;     // per-record offset into arena
  std::vector<int64_t> lengths;     // per-record length
  bool verify_crc = false;
  std::string error;
};

}  // namespace

extern "C" {

uint32_t t2r_crc32c(const uint8_t* data, int64_t n) {
  return crc32c(data, static_cast<size_t>(n));
}

uint32_t t2r_masked_crc32c(const uint8_t* data, int64_t n) {
  return masked_crc(data, static_cast<size_t>(n));
}

void* t2r_reader_open(const char* path, int verify_crc) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  Reader* r = new Reader();
  r->file = f;
  r->verify_crc = verify_crc != 0;
  return r;
}

void t2r_reader_close(void* handle) {
  if (!handle) return;
  Reader* r = static_cast<Reader*>(handle);
  if (r->file) std::fclose(r->file);
  delete r;
}

// Reads up to max_records records into the reader's arena.
// Returns: number of records read; 0 on clean EOF; -1 on corruption.
// After the call, t2r_reader_data/offsets/lengths expose the batch.
int64_t t2r_reader_next_batch(void* handle, int64_t max_records) try {
  Reader* r = static_cast<Reader*>(handle);
  r->arena.clear();
  r->offsets.clear();
  r->lengths.clear();
  for (int64_t i = 0; i < max_records; ++i) {
    uint64_t length;
    int status = t2r::ReadRecordHeader(r->file, r->verify_crc, &length,
                                       &r->error);
    if (status == 0) break;            // clean EOF
    if (status < 0) return -1;
    size_t offset = r->arena.size();
    r->arena.resize(offset + length);
    if (std::fread(r->arena.data() + offset, 1, length, r->file) < length) {
      r->error = "truncated body";
      return -1;
    }
    if (t2r::ReadRecordFooter(r->file, r->verify_crc,
                              r->arena.data() + offset, length,
                              &r->error) < 0)
      return -1;
    r->offsets.push_back(static_cast<int64_t>(offset));
    r->lengths.push_back(static_cast<int64_t>(length));
  }
  return static_cast<int64_t>(r->offsets.size());
} catch (const std::exception& e) {
  // Exceptions must not cross the C ABI: report as a corrupt-file error.
  static_cast<Reader*>(handle)->error = e.what();
  return -1;
}

const uint8_t* t2r_reader_data(void* handle) {
  return static_cast<Reader*>(handle)->arena.data();
}

const int64_t* t2r_reader_offsets(void* handle) {
  return static_cast<Reader*>(handle)->offsets.data();
}

const int64_t* t2r_reader_lengths(void* handle) {
  return static_cast<Reader*>(handle)->lengths.data();
}

const char* t2r_reader_error(void* handle) {
  return static_cast<Reader*>(handle)->error.c_str();
}

}  // extern "C"
