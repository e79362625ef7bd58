// Native batched tf.Example / tf.SequenceExample parser.
//
// Parses batches of serialized Example or SequenceExample protos directly
// (hand-rolled varint/wire walking, no protobuf runtime) into dense
// columnar buffers for the spec-driven data layer — the host-side hot
// path that keeps the accelerator fed. Scope: fixed-length
// float/int64 features (context or fixed-T feature lists) and bytes
// features with a static value capacity (single images, multi-image
// lists, image sequences); varlen/optional/dynamic-T specs take the
// Python path.
//
// Wire layout (proto3):
//   Example         { Features features = 1; }
//   SequenceExample { Features context = 1; FeatureLists feature_lists = 2; }
//   Features        { map<string, Feature> feature = 1; }
//   FeatureLists    { map<string, FeatureList> feature_list = 1; }
//   map entry       { string key = 1; Feature/FeatureList value = 2; }
//   FeatureList     { repeated Feature feature = 1; }
//   Feature         { oneof { BytesList=1; FloatList=2; Int64List=3 } }
//   BytesList       { repeated bytes value = 1; }
//   FloatList       { repeated float value = 1 [packed]; }
//   Int64List       { repeated int64 value = 1 [packed]; }
//
// Because Example.features and SequenceExample.context share field 1, one
// walk handles both message types: field 1 entries are context features,
// field 2 entries (if any) are feature lists.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Slice {
  const uint8_t* data;
  size_t size;
};

bool read_varint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t byte = *p++;
    result |= static_cast<uint64_t>(byte & 0x7F) << shift;
    if (!(byte & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

bool skip_field(const uint8_t*& p, const uint8_t* end, uint32_t wire_type) {
  uint64_t tmp;
  switch (wire_type) {
    case 0:  // varint
      return read_varint(p, end, &tmp);
    case 1:  // 64-bit
      if (end - p < 8) return false;
      p += 8;
      return true;
    case 2: {  // length-delimited
      if (!read_varint(p, end, &tmp) || static_cast<uint64_t>(end - p) < tmp)
        return false;
      p += tmp;
      return true;
    }
    case 5:  // 32-bit
      if (end - p < 4) return false;
      p += 4;
      return true;
    default:
      return false;
  }
}

bool get_subfield(Slice message, uint32_t want_field, Slice* out) {
  // Finds the first length-delimited occurrence of `want_field`.
  const uint8_t* p = message.data;
  const uint8_t* end = message.data + message.size;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    if (field == want_field && wire == 2) {
      uint64_t len;
      if (!read_varint(p, end, &len) ||
          static_cast<uint64_t>(end - p) < len)
        return false;
      out->data = p;
      out->size = len;
      return true;
    }
    if (!skip_field(p, end, wire)) return false;
  }
  return false;
}

// Feature kinds (must match the Python wrapper).
enum Kind { KIND_FLOAT = 0, KIND_INT64 = 1, KIND_BYTES = 2 };

struct Plan {
  std::vector<std::string> names;
  std::vector<int> kinds;
  std::vector<int64_t> sizes;     // element count per step (floats/ints)
  std::vector<int64_t> seq_lens;  // 0 = context feature; T = fixed-T list
  std::vector<int64_t> caps;      // bytes value capacity (>=1, bytes only)
  std::vector<int64_t> caps_offset;  // bytes slot offset per feature
  std::vector<int> seq_slot;      // per-feature index among seq features
  std::vector<int> bytes_slot;    // per-feature index among bytes features
  int64_t total_caps = 0;
  int num_seq = 0;
  int num_bytes = 0;
  std::unordered_map<std::string, int> index;
  std::string error;
  // per-parse outputs
  std::vector<const uint8_t*> bytes_ptrs;   // [batch * total_caps]
  std::vector<int64_t> bytes_lens;          // [batch * total_caps]
  std::vector<int64_t> bytes_counts;        // [batch * num_bytes]
  std::vector<int64_t> step_counts;         // [batch * num_seq]
};

bool parse_float_list(Slice feature_payload, float* out, int64_t expect,
                      Plan* plan) {
  // feature_payload is the FloatList message; field 1 packed (or
  // repeated unpacked 32-bit).
  const uint8_t* p = feature_payload.data;
  const uint8_t* end = p + feature_payload.size;
  int64_t count = 0;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    if (field == 1 && wire == 2) {  // packed
      uint64_t len;
      if (!read_varint(p, end, &len) || len % 4 ||
          static_cast<uint64_t>(end - p) < len)
        return false;
      int64_t n = static_cast<int64_t>(len / 4);
      if (count + n > expect) return false;
      std::memcpy(out + count, p, len);
      count += n;
      p += len;
    } else if (field == 1 && wire == 5) {  // unpacked
      if (end - p < 4 || count + 1 > expect) return false;
      std::memcpy(out + count, p, 4);
      ++count;
      p += 4;
    } else if (!skip_field(p, end, wire)) {
      return false;
    }
  }
  return count == expect;
}

bool parse_int64_list(Slice feature_payload, int64_t* out, int64_t expect) {
  const uint8_t* p = feature_payload.data;
  const uint8_t* end = p + feature_payload.size;
  int64_t count = 0;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    if (field == 1 && wire == 2) {  // packed varints
      uint64_t len;
      if (!read_varint(p, end, &len) ||
          static_cast<uint64_t>(end - p) < len)
        return false;
      const uint8_t* sub_end = p + len;
      while (p < sub_end) {
        uint64_t v;
        if (!read_varint(p, sub_end, &v) || count + 1 > expect) return false;
        out[count++] = static_cast<int64_t>(v);
      }
    } else if (field == 1 && wire == 0) {
      uint64_t v;
      if (!read_varint(p, end, &v) || count + 1 > expect) return false;
      out[count++] = static_cast<int64_t>(v);
    } else if (!skip_field(p, end, wire)) {
      return false;
    }
  }
  return count == expect;
}

// Walks a BytesList, storing up to `cap` (ptr, len) pairs; returns the
// full value count (values beyond cap are counted but not stored).
bool parse_bytes_list(Slice bytes_list, const uint8_t** out_ptrs,
                      int64_t* out_lens, int64_t cap, int64_t* out_count) {
  const uint8_t* p = bytes_list.data;
  const uint8_t* end = p + bytes_list.size;
  int64_t count = 0;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    if (field == 1 && wire == 2) {
      uint64_t len;
      if (!read_varint(p, end, &len) ||
          static_cast<uint64_t>(end - p) < len)
        return false;
      if (count < cap) {
        out_ptrs[count] = p;
        out_lens[count] = static_cast<int64_t>(len);
      }
      ++count;
      p += len;
    } else if (!skip_field(p, end, wire)) {
      return false;
    }
  }
  *out_count = count;
  return true;
}

// Parses one Feature message for plan entry i at step `t` of a record.
bool parse_one_feature(Plan* plan, int i, Slice feature_msg, int64_t r,
                       int64_t t, float** float_outs, int64_t** int_outs) {
  int kind = plan->kinds[i];
  int64_t steps = plan->seq_lens[i] > 0 ? plan->seq_lens[i] : 1;
  if (kind == KIND_FLOAT) {
    Slice payload;
    return get_subfield(feature_msg, 2, &payload) &&
           parse_float_list(
               payload,
               float_outs[i] + (r * steps + t) * plan->sizes[i],
               plan->sizes[i], plan);
  }
  if (kind == KIND_INT64) {
    Slice payload;
    return get_subfield(feature_msg, 3, &payload) &&
           parse_int64_list(
               payload,
               int_outs[i] + (r * steps + t) * plan->sizes[i],
               plan->sizes[i]);
  }
  // KIND_BYTES: for sequence bytes, step t occupies slot t; for context
  // bytes the whole capacity belongs to one BytesList.
  Slice payload;
  if (!get_subfield(feature_msg, 1, &payload)) {
    // Empty bytes list: leave null slots, count 0.
    return true;
  }
  int64_t base = r * plan->total_caps + plan->caps_offset[i];
  int64_t count = 0;
  if (plan->seq_lens[i] > 0) {
    if (t >= plan->caps[i]) return true;  // clipped step
    if (!parse_bytes_list(payload, plan->bytes_ptrs.data() + base + t,
                          plan->bytes_lens.data() + base + t, 1, &count))
      return false;
    return count <= 1;  // >1 image per step: loud error, never a clip
  }
  if (!parse_bytes_list(payload, plan->bytes_ptrs.data() + base,
                        plan->bytes_lens.data() + base, plan->caps[i],
                        &count))
    return false;
  plan->bytes_counts[r * plan->num_bytes + plan->bytes_slot[i]] = count;
  return true;
}

// Walks one FeatureList message (repeated Feature) for plan entry i.
bool parse_feature_list(Plan* plan, int i, Slice list_msg, int64_t r,
                        float** float_outs, int64_t** int_outs) {
  const uint8_t* p = list_msg.data;
  const uint8_t* end = list_msg.data + list_msg.size;
  int64_t t = 0;
  int64_t max_t = plan->seq_lens[i];
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    if (field == 1 && wire == 2) {
      uint64_t len;
      if (!read_varint(p, end, &len) ||
          static_cast<uint64_t>(end - p) < len)
        return false;
      Slice feature_msg{p, len};
      p += len;
      if (t < max_t &&
          !parse_one_feature(plan, i, feature_msg, r, t, float_outs,
                             int_outs))
        return false;
      ++t;  // steps beyond max_t are clipped but counted
    } else if (!skip_field(p, end, wire)) {
      return false;
    }
  }
  plan->step_counts[r * plan->num_seq + plan->seq_slot[i]] = t;
  if (plan->kinds[i] == KIND_BYTES)
    plan->bytes_counts[r * plan->num_bytes + plan->bytes_slot[i]] =
        std::min(t, plan->caps[i]);
  return true;
}

}  // namespace

extern "C" {

// seq_lens[i] == 0 -> context feature; T > 0 -> fixed-T feature list
// (steps beyond T are clipped; actual counts via t2r_parser_step_counts).
// caps[i]: for KIND_BYTES, the number of stored (ptr, len) value slots
// (1 for single images, N for multi-image lists, T for image sequences);
// ignored for float/int.
void* t2r_parser_create(const char** names, const int* kinds,
                        const int64_t* sizes, const int64_t* seq_lens,
                        const int64_t* caps, int n) {
  Plan* plan = new Plan();
  for (int i = 0; i < n; ++i) {
    plan->names.emplace_back(names[i]);
    plan->kinds.push_back(kinds[i]);
    plan->sizes.push_back(sizes[i]);
    plan->seq_lens.push_back(seq_lens[i]);
    plan->seq_slot.push_back(seq_lens[i] > 0 ? plan->num_seq : -1);
    if (seq_lens[i] > 0) ++plan->num_seq;
    if (kinds[i] == KIND_BYTES) {
      int64_t cap = std::max<int64_t>(1, caps[i]);
      plan->bytes_slot.push_back(plan->num_bytes++);
      plan->caps.push_back(cap);
      plan->caps_offset.push_back(plan->total_caps);
      plan->total_caps += cap;
    } else {
      plan->bytes_slot.push_back(-1);
      plan->caps.push_back(0);
      plan->caps_offset.push_back(-1);
    }
    plan->index[plan->names.back()] = i;
  }
  return plan;
}

void t2r_parser_destroy(void* handle) {
  delete static_cast<Plan*>(handle);
}

const char* t2r_parser_error(void* handle) {
  return static_cast<Plan*>(handle)->error.c_str();
}

const uint8_t** t2r_parser_bytes_ptrs(void* handle) {
  return static_cast<Plan*>(handle)->bytes_ptrs.data();
}

const int64_t* t2r_parser_bytes_lens(void* handle) {
  return static_cast<Plan*>(handle)->bytes_lens.data();
}

const int64_t* t2r_parser_bytes_counts(void* handle) {
  return static_cast<Plan*>(handle)->bytes_counts.data();
}

const int64_t* t2r_parser_step_counts(void* handle) {
  return static_cast<Plan*>(handle)->step_counts.data();
}

// Gathers plan entry `i`'s context-bytes raw plane from the LAST
// t2r_parser_parse_batch call into one contiguous [batch, size] buffer
// (`size` = the plan's declared byte size). Returns 1 when every record
// holds exactly one value of exactly `size` bytes (dest filled), 0 when
// any record deviates (caller falls back to the per-value path), -1 on
// a non-bytes/out-of-range entry. A null `dest` is a CHECK-ONLY probe
// (same return values, nothing copied) — the wrapper probes first so a
// stream that never qualifies pays no dest allocation per batch.
// Replaces the wrapper's per-record Python memmove loop with ctypes
// calls per feature per BATCH.
int t2r_parser_gather_plane(void* handle, int i, int64_t batch,
                            uint8_t* dest) {
  Plan* plan = static_cast<Plan*>(handle);
  if (i < 0 || i >= static_cast<int>(plan->names.size()) ||
      plan->kinds[i] != KIND_BYTES || plan->seq_lens[i] > 0)
    return -1;
  int64_t size = plan->sizes[i];
  if (size <= 0) return -1;
  int64_t offset = plan->caps_offset[i];
  int slot = plan->bytes_slot[i];
  for (int64_t r = 0; r < batch; ++r) {
    if (plan->bytes_counts[r * plan->num_bytes + slot] != 1 ||
        plan->bytes_lens[r * plan->total_caps + offset] != size)
      return 0;
  }
  if (dest == nullptr) return 1;  // check-only probe
  for (int64_t r = 0; r < batch; ++r)
    std::memcpy(dest + r * size,
                plan->bytes_ptrs[r * plan->total_caps + offset],
                static_cast<size_t>(size));
  return 1;
}

// Parses `batch` Example or SequenceExample records. float/int features
// land in dense zeroed buffers of shape [batch, max(1, seq_len), size]
// supplied per feature (float_outs[i] / int_outs[i], null for other
// kinds); short sequences stay zero-padded, long ones are clipped, and
// actual step counts are exposed via t2r_parser_step_counts as
// [batch * num_seq_features] (record-major, seq-plan-order). Bytes
// features are exposed via t2r_parser_bytes_ptrs/lens as capacity slots
// in (record-major, caps_offset) layout with value counts via
// t2r_parser_bytes_counts; pointers alias the input records.
// `missing_ok` features absent from a record leave zeros / null entries.
// Returns 0 on success, -1 on malformed input (error() says why).
int t2r_parser_parse_batch(void* handle,
                           const uint8_t** records, const int64_t* lens,
                           int64_t batch,
                           float** float_outs, int64_t** int_outs,
                           const uint8_t* missing_ok) try {
  Plan* plan = static_cast<Plan*>(handle);
  int num_features = static_cast<int>(plan->names.size());
  plan->bytes_ptrs.assign(static_cast<size_t>(batch) * plan->total_caps,
                          nullptr);
  plan->bytes_lens.assign(static_cast<size_t>(batch) * plan->total_caps, 0);
  plan->bytes_counts.assign(static_cast<size_t>(batch) * plan->num_bytes, 0);
  plan->step_counts.assign(static_cast<size_t>(batch) * plan->num_seq, 0);

  std::vector<uint8_t> seen(num_features);
  for (int64_t r = 0; r < batch; ++r) {
    Slice record{records[r], static_cast<size_t>(lens[r])};
    std::fill(seen.begin(), seen.end(), 0);
    // Walk the record's top-level fields: 1 = Features (Example.features
    // or SequenceExample.context), 2 = FeatureLists.
    const uint8_t* rp = record.data;
    const uint8_t* rend = record.data + record.size;
    bool any_features_msg = false;
    while (rp < rend) {
      uint64_t rtag;
      if (!read_varint(rp, rend, &rtag)) {
        plan->error = "bad record tag";
        return -1;
      }
      uint32_t rfield = static_cast<uint32_t>(rtag >> 3);
      uint32_t rwire = static_cast<uint32_t>(rtag & 7);
      if ((rfield != 1 && rfield != 2) || rwire != 2) {
        if (!skip_field(rp, rend, rwire)) {
          plan->error = "bad record field";
          return -1;
        }
        continue;
      }
      uint64_t msg_len;
      if (!read_varint(rp, rend, &msg_len) ||
          static_cast<uint64_t>(rend - rp) < msg_len) {
        plan->error = "bad features message";
        return -1;
      }
      Slice features_msg{rp, msg_len};
      rp += msg_len;
      any_features_msg = true;
      bool in_lists = (rfield == 2);
      // Walk the map entries (key -> Feature / FeatureList).
      const uint8_t* p = features_msg.data;
      const uint8_t* end = features_msg.data + features_msg.size;
      while (p < end) {
        uint64_t tag;
        if (!read_varint(p, end, &tag)) {
          plan->error = "bad tag";
          return -1;
        }
        uint32_t field = static_cast<uint32_t>(tag >> 3);
        uint32_t wire = static_cast<uint32_t>(tag & 7);
        if (field != 1 || wire != 2) {
          if (!skip_field(p, end, wire)) {
            plan->error = "bad skip";
            return -1;
          }
          continue;
        }
        uint64_t entry_len;
        if (!read_varint(p, end, &entry_len) ||
            static_cast<uint64_t>(end - p) < entry_len) {
          plan->error = "bad map entry";
          return -1;
        }
        Slice entry{p, entry_len};
        p += entry_len;
        Slice key_slice, value_msg;
        if (!get_subfield(entry, 1, &key_slice)) continue;
        std::string key(reinterpret_cast<const char*>(key_slice.data),
                        key_slice.size);
        auto it = plan->index.find(key);
        if (it == plan->index.end()) continue;  // feature not in plan
        int i = it->second;
        if (in_lists != (plan->seq_lens[i] > 0))
          continue;  // context/list mismatch: not this plan entry's slot
        if (!get_subfield(entry, 2, &value_msg)) continue;
        bool ok;
        if (in_lists) {
          ok = parse_feature_list(plan, i, value_msg, r, float_outs,
                                  int_outs);
        } else {
          ok = parse_one_feature(plan, i, value_msg, r, 0, float_outs,
                                 int_outs);
        }
        if (!ok) {
          plan->error = "malformed feature '" + key + "'";
          return -1;
        }
        seen[i] = 1;
      }
    }
    if (!any_features_msg) {
      plan->error = "record has no features message";
      return -1;
    }
    for (int i = 0; i < num_features; ++i) {
      if (!seen[i] && !missing_ok[i]) {
        plan->error = "missing required feature '" + plan->names[i] + "'";
        return -1;
      }
    }
  }
  return 0;
} catch (const std::exception& e) {
  static_cast<Plan*>(handle)->error = e.what();
  return -1;
}

}  // extern "C"
