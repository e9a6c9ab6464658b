// Shared .rec framing walker of mxnet_tpu_torch's native input library (the
// one source of the on-disk format for recordio.cc and image_pipeline.cc).
//
// Reference: dmlc-core recordio — every record is
// [uint32 magic][uint32 lrec][payload][pad to 4B] where lrec's upper 3
// bits are the continuation flag: 0 = whole record, 1 = start, 2 =
// middle, 3 = end.  The writer splits a record at 4-aligned occurrences
// of the magic word inside the payload (the occurrence itself is
// dropped); the reader re-inserts the magic between re-joined parts.
#ifndef MXTT_RECORDIO_FORMAT_H_
#define MXTT_RECORDIO_FORMAT_H_

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace mxtt {

constexpr uint32_t kRecMagic = 0xced7230a;
constexpr uint32_t kRecLengthMask = (1u << 29) - 1;

inline uint32_t RecDecodeFlag(uint32_t lrec) { return lrec >> 29; }

// Reads one framed part; false at EOF or corrupt stream.
inline bool ReadRecPart(std::FILE* f, uint32_t* cflag,
                        std::vector<uint8_t>* part) {
  uint8_t header[8];
  if (std::fread(header, 1, 8, f) != 8) return false;
  uint32_t magic, lrec;
  std::memcpy(&magic, header, 4);
  std::memcpy(&lrec, header + 4, 4);
  if (magic != kRecMagic) return false;
  *cflag = RecDecodeFlag(lrec);
  uint32_t len = lrec & kRecLengthMask;
  part->resize(len);
  if (len && std::fread(part->data(), 1, len, f) != len) return false;
  uint32_t pad = (4 - (len % 4)) % 4;
  if (pad && std::fseek(f, pad, SEEK_CUR) != 0) return false;
  return true;
}

// Reads one LOGICAL record, re-joining continuation parts with the magic
// word re-inserted (dmlc RecordIOReader::NextRecord semantics).
// Returns false at EOF or on a framing error.
inline bool ReadRecRecord(std::FILE* f, std::vector<uint8_t>* out) {
  std::vector<uint8_t> part;
  uint32_t cflag = 0;
  if (!ReadRecPart(f, &cflag, &part)) return false;
  if (cflag == 0) {
    out->swap(part);
    return true;
  }
  if (cflag != 1) return false;  // middle/end with no start: corrupt
  out->swap(part);
  while (true) {
    if (!ReadRecPart(f, &cflag, &part)) return false;
    if (cflag != 2 && cflag != 3) return false;
    const uint8_t* m = reinterpret_cast<const uint8_t*>(&kRecMagic);
    out->insert(out->end(), m, m + 4);
    out->insert(out->end(), part.begin(), part.end());
    if (cflag == 3) return true;
  }
}

}  // namespace mxtt

#endif  // MXTT_RECORDIO_FORMAT_H_
