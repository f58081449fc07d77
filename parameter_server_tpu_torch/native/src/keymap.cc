// Native persistent key->slot map: the Localizer hot path.
//
// The reference keeps the streaming-key vocabulary in the server's C++ hash
// map (``src/parameter/kv_map.h`` / ``src/util/localizer.h`` [U] —
// SURVEY.md #11/#20).  Here the map is host-side (the device table is a
// dense HBM array indexed by the slots this map hands out), and at Criteo
// rates (16k batch x 39 slots) a Python-level loop — or even vectorized
// numpy probing, which pays a full batch-sized temporary per probe round —
// is the bottleneck.  This is a flat open-addressing
// table (linear probing, power-of-two size, load factor <= 1/2) with the
// exact assign() semantics of utils.keys.Localizer:
//
//   PAD_KEY (2^64-1)        -> capacity  (the trash row)
//   known key               -> its stable slot
//   new key, vocab not full -> next sequential id (arrival order)
//   new key, vocab full     -> key % capacity  (feature-hash overflow,
//                              NOT cached; sets the overflow flag)
//
// ABI is plain C for ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr uint64_t kEmpty = 0xFFFFFFFFFFFFFFFFull;  // == PAD_KEY

inline uint64_t mix64(uint64_t x) {
  // splitmix64 avalanche — same constants as utils.keys.mix64(seed=0), so
  // probe distributions match the Python fallback (not semantically
  // required, but keeps perf characteristics identical).
  x *= 0xFF51AFD7ED558CCDull;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ull;
  x ^= x >> 33;
  return x;
}

struct KeyMap {
  int64_t capacity = 0;   // max vocab (slot ids are 0..capacity-1)
  int64_t n = 0;          // assigned vocab size
  uint64_t size = 0;      // table size, power of two
  uint64_t mask = 0;
  uint64_t* keys = nullptr;
  int32_t* vals = nullptr;
  bool overflowed = false;
  bool grow_failed = false;  // OOM latch: stop re-attempting huge mallocs

  bool alloc(uint64_t new_size) {
    uint64_t* new_keys =
        static_cast<uint64_t*>(malloc(new_size * sizeof(uint64_t)));
    int32_t* new_vals =
        static_cast<int32_t*>(malloc(new_size * sizeof(int32_t)));
    if (!new_keys || !new_vals) {  // OOM must not leave dangling pointers
      free(new_keys);
      free(new_vals);
      return false;
    }
    size = new_size;
    mask = new_size - 1;
    keys = new_keys;
    vals = new_vals;
    memset(keys, 0xFF, new_size * sizeof(uint64_t));  // all kEmpty
    return true;
  }

  bool grow() {
    uint64_t old_size = size;
    uint64_t* old_keys = keys;
    int32_t* old_vals = vals;
    if (!alloc(size * 2)) {
      // OOM: keep the old table intact.  The map still works — inserts
      // continue until the table is literally full; assign_one falls back
      // to feature hashing at capacity, so correctness is preserved.  The
      // latch stops every later insert from re-attempting the same
      // multi-hundred-MB malloc pair under memory pressure.
      keys = old_keys;
      vals = old_vals;
      size = old_size;
      mask = old_size - 1;
      grow_failed = true;
      return false;
    }
    for (uint64_t i = 0; i < old_size; ++i) {
      if (old_keys[i] == kEmpty) continue;
      uint64_t p = mix64(old_keys[i]) & mask;
      while (keys[p] != kEmpty) p = (p + 1) & mask;
      keys[p] = old_keys[i];
      vals[p] = old_vals[i];
    }
    free(old_keys);
    free(old_vals);
    return true;
  }

  // find-or-insert one key; returns its slot
  inline int32_t assign_one(uint64_t k) {
    uint64_t p = mix64(k) & mask;
    // Bounded probe: after grow()-OOM the load factor may exceed 1/2, and a
    // literally full table would otherwise spin forever on an absent key.
    for (uint64_t probes = 0; probes < size; ++probes) {
      uint64_t cur = keys[p];
      if (cur == k) return vals[p];
      if (cur == kEmpty) {
        if (n < capacity) {
          int32_t slot = static_cast<int32_t>(n++);
          keys[p] = k;
          vals[p] = slot;
          if (static_cast<uint64_t>(n) * 2 > size && !grow_failed) grow();
          return slot;
        }
        break;
      }
      p = (p + 1) & mask;
    }
    overflowed = true;
    return static_cast<int32_t>(k % static_cast<uint64_t>(capacity));
  }
};

}  // namespace

extern "C" {

void* ps_keymap_new(int64_t capacity) {
  if (capacity <= 0) return nullptr;
  auto* m = new KeyMap();
  m->capacity = capacity;
  if (!m->alloc(1 << 16)) {  // OOM -> nullptr; Python raises MemoryError
    delete m;
    return nullptr;
  }
  return m;
}

void ps_keymap_free(void* h) {
  auto* m = static_cast<KeyMap*>(h);
  if (!m) return;
  free(m->keys);
  free(m->vals);
  delete m;
}

int64_t ps_keymap_len(void* h) { return static_cast<KeyMap*>(h)->n; }

int ps_keymap_overflowed(void* h) {
  return static_cast<KeyMap*>(h)->overflowed ? 1 : 0;
}

// Assign slots for n keys (PAD -> capacity). Sequential; insertion order is
// the arrival order, matching the Python Localizer exactly.
void ps_keymap_assign(void* h, const uint64_t* in, int64_t n, int32_t* out) {
  auto* m = static_cast<KeyMap*>(h);
  const int32_t trash = static_cast<int32_t>(m->capacity);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t k = in[i];
    out[i] = (k == kEmpty) ? trash : m->assign_one(k);
  }
}

}  // extern "C"
