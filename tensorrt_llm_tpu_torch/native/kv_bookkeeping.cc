// Host-side paged-KV block bookkeeping (native backend of the port).
//
// A copy of the JAX package's native/kv_bookkeeping.cc, the counterpart of
// the reference's C++ BlockManager / KVCacheManager host logic
// (cpp/tensorrt_llm/batch_manager/kvCacheManager.{h,cpp}): a block pool with
// ref counts, a chain-hash prefix-reuse index (the radix-tree analog of
// BlockKey, kvCacheManager.h:148-195), eviction of unreferenced cached
// blocks by retention priority, LRU within a priority (evictionPolicy.h),
// and partial tail-block reuse.  The scheduler loop runs this bookkeeping
// on the host every iteration, so it is native code.  Exposed through a
// plain C ABI loaded with ctypes (tensorrt_llm_tpu_torch/native/__init__.py).
// Semantics are kept in lockstep with the Python backend in
// runtime/kv_cache_manager.py: tests/test_torch_native_kv.py drives both,
// and the JAX package's Python backend, with identical op sequences and
// requires identical block tables, free counts and evictions.
//
// Changes from the JAX package's copy: the beam-search fork
// (`tllm_kvbm_fork`) tells an unknown source (-2) and a pair buffer too
// small for the tail (-3) apart from an exhausted pool (-1), and never
// writes past `max_pairs`; `tllm_kvbm_drop_cached` forgets the reuse
// index after a weight swap.  The eviction list (`tllm_kvbm_drain_
// evictions`) feeds the KV manager's "removed" events; the host-memory
// tier that the JAX package also feeds from it is not in the port yet.  Device memory never appears here: the pools are
// torch tensors owned by the Python side; this module only decides *which*
// block ids hold which tokens.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <list>
#include <map>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 1469598103934665603ull;
constexpr uint64_t kFnvPrime = 1099511628211ull;

inline uint64_t fnv_mix(uint64_t h, uint64_t v) {
  h ^= v;
  h *= kFnvPrime;
  return h;
}

// Chain hash of (parent_hash, token block, salt). Mirrors the Python
// fallback's _chain_hash contract: any deterministic 64-bit mix works — only
// equality matters, and both sides always use their own hash space.
uint64_t chain_hash(uint64_t parent, const int32_t* toks, int64_t n,
                    uint64_t salt, int has_salt) {
  uint64_t h = fnv_mix(kFnvOffset, parent);
  for (int64_t i = 0; i < n; ++i) h = fnv_mix(h, (uint64_t)(uint32_t)toks[i]);
  h = fnv_mix(h, has_salt ? salt : 0x9e3779b97f4a7c15ull);
  h = fnv_mix(h, (uint64_t)has_salt);
  return h;
}

// Default retention priority (reference KvCacheRetentionConfig,
// executor.h:559).
constexpr int32_t kDefaultPriority = 35;

struct SeqInfo {
  std::vector<int32_t> block_ids;
  std::vector<uint64_t> block_hashes;
  int64_t num_tokens = 0;
  uint64_t salt = 0;
  int has_salt = 0;
  int32_t priority = kDefaultPriority;
};

struct Manager {
  int32_t num_blocks;
  int32_t block_size;
  bool enable_reuse;

  // free list: FIFO like the Python deque (popleft / append)
  std::deque<int32_t> free_blocks;
  std::vector<int32_t> ref_count;
  std::vector<uint64_t> block_hash;
  std::vector<uint8_t> has_hash;
  std::vector<int32_t> block_priority;  // set at seal (first-writer wins)
  std::unordered_map<uint64_t, int32_t> cached;  // full-block reuse index
  // Evictable cached blocks bucketed by retention priority: the lowest
  // priority evicts first, LRU (least-recently-inserted) within a bucket —
  // reference priority eviction (evictionPolicy.h:29,70).
  std::map<int32_t, std::list<int32_t>> evict_buckets;
  struct EvictPos {
    int32_t priority;
    std::list<int32_t>::iterator it;
  };
  std::unordered_map<int32_t, EvictPos> evict_pos;
  int64_t n_evictable = 0;
  std::unordered_map<int64_t, SeqInfo> sequences;

  // Partial-reuse side index (reference partial reuse /
  // copy_on_partial_reuse, BlockManager::loadOrAllocateBlocks): sealed
  // block token contents + children of each (parent_hash, salt) chain node
  // so the block following a full match can be probed for a shared prefix.
  std::unordered_map<int32_t, std::vector<int32_t>> block_tokens;
  std::unordered_map<uint64_t, std::list<int32_t>> children;
  struct ChildPos {
    uint64_t key;
    std::list<int32_t>::iterator it;
  };
  std::unordered_map<int32_t, ChildPos> child_pos;

  // stats (reference KvCacheStats, kvCacheManager.h:213-236)
  int64_t num_reused = 0;
  int64_t num_partial = 0;
  int64_t num_allocated = 0;
  int64_t num_evicted = 0;
  // block ids evicted from the reuse index since the last drain
  std::vector<int32_t> pending_evictions;

  explicit Manager(int32_t nb, int32_t bs, bool reuse)
      : num_blocks(nb), block_size(bs), enable_reuse(reuse),
        ref_count(nb, 0), block_hash(nb, 0), has_hash(nb, 0),
        block_priority(nb, kDefaultPriority) {
    // block 0 is the reserved null block (padding rows in block tables)
    for (int32_t i = 1; i < nb; ++i) free_blocks.push_back(i);
  }

  int64_t num_free() const {
    return (int64_t)free_blocks.size() + n_evictable;
  }

  static uint64_t child_key(uint64_t parent, uint64_t salt, int has_salt) {
    uint64_t h = fnv_mix(kFnvOffset, parent);
    h = fnv_mix(h, has_salt ? salt : 0x9e3779b97f4a7c15ull);
    return fnv_mix(h, (uint64_t)has_salt);
  }

  void forget_block(int32_t bid) {
    block_tokens.erase(bid);
    auto it = child_pos.find(bid);
    if (it != child_pos.end()) {
      auto cit = children.find(it->second.key);
      if (cit != children.end()) {
        cit->second.erase(it->second.it);
        if (cit->second.empty()) children.erase(cit);
      }
      child_pos.erase(it);
    }
  }

  // Longest shared token prefix of any cached child of `parent` with
  // toks[matched:]; at least one prompt token stays uncached. Returns the
  // match length and sets *out_bid.
  int64_t best_partial(uint64_t parent, uint64_t salt, int has_salt,
                       const int32_t* toks, int64_t n, int64_t matched,
                       int32_t* out_bid) const {
    *out_bid = -1;
    int64_t limit = n - 1 - matched;
    if (limit > block_size) limit = block_size;
    if (limit < 1) return 0;
    auto cit = children.find(child_key(parent, salt, has_salt));
    if (cit == children.end()) return 0;
    int64_t best_k = 0;
    for (int32_t bid : cit->second) {
      auto tit = block_tokens.find(bid);
      if (tit == block_tokens.end()) continue;
      const auto& bt = tit->second;
      int64_t k = 0;
      while (k < limit && k < (int64_t)bt.size() &&
             bt[k] == toks[matched + k])
        ++k;
      if (k > best_k) {
        best_k = k;
        *out_bid = bid;
      }
    }
    return best_k;
  }

  int32_t take_block() {
    int32_t bid;
    if (!free_blocks.empty()) {
      bid = free_blocks.front();
      free_blocks.pop_front();
    } else if (n_evictable > 0) {
      auto bit = evict_buckets.begin();  // lowest priority first
      bid = bit->second.front();
      bit->second.pop_front();
      if (bit->second.empty()) evict_buckets.erase(bit);
      evict_pos.erase(bid);
      --n_evictable;
      if (has_hash[bid]) {
        cached.erase(block_hash[bid]);
        has_hash[bid] = 0;
      }
      forget_block(bid);
      ++num_evicted;
      pending_evictions.push_back(bid);
    } else {
      return -1;  // out of blocks
    }
    ref_count[bid] = 1;
    ++num_allocated;
    return bid;
  }

  void ref_block(int32_t bid) {
    if (ref_count[bid] == 0) {
      auto it = evict_pos.find(bid);
      if (it != evict_pos.end()) {
        auto bit = evict_buckets.find(it->second.priority);
        bit->second.erase(it->second.it);
        if (bit->second.empty()) evict_buckets.erase(bit);
        evict_pos.erase(it);
        --n_evictable;
      }
    }
    ++ref_count[bid];
  }

  void unref_block(int32_t bid) {
    if (ref_count[bid] <= 0) {
      // double-unref (caller bug): the Python fallback raises here.  Fail
      // SAFE on the native path — leak the block rather than returning a
      // still-referenced page to the pool (cross-sequence corruption).
      std::fprintf(stderr,
                   "tllm kv bookkeeping: unref of unreferenced block %d\n",
                   bid);
      return;
    }
    --ref_count[bid];
    if (ref_count[bid] == 0) {
      if (has_hash[bid] && enable_reuse) {
        auto& bucket = evict_buckets[block_priority[bid]];
        bucket.push_back(bid);
        evict_pos[bid] = {block_priority[bid], std::prev(bucket.end())};
        ++n_evictable;
      } else {
        free_blocks.push_back(bid);
      }
    }
  }
};

}  // namespace

extern "C" {

void* tllm_kvbm_create(int32_t num_blocks, int32_t block_size,
                       int32_t enable_reuse) {
  return new Manager(num_blocks, block_size, enable_reuse != 0);
}

void tllm_kvbm_destroy(void* h) { delete static_cast<Manager*>(h); }

// Register a sequence and match reusable full prefix blocks. Returns the
// number of prefix TOKENS already cached (strictly < n: the last prompt
// token is always recomputed, same partial-reuse guard as the reference).
int64_t tllm_kvbm_add_sequence(void* h, int64_t seq, const int32_t* toks,
                               int64_t n, uint64_t salt, int32_t has_salt) {
  Manager& m = *static_cast<Manager*>(h);
  SeqInfo& info = m.sequences[seq];
  info.salt = salt;
  info.has_salt = has_salt;
  int64_t matched = 0;
  uint64_t parent = 0;
  if (m.enable_reuse) {
    int64_t n_full = (n - 1) / m.block_size;  // keep the last token
    for (int64_t b = 0; b < n_full; ++b) {
      uint64_t hh = chain_hash(parent, toks + b * m.block_size, m.block_size,
                               salt, has_salt);
      auto it = m.cached.find(hh);
      if (it == m.cached.end()) break;
      m.ref_block(it->second);
      info.block_ids.push_back(it->second);
      info.block_hashes.push_back(hh);
      matched += m.block_size;
      parent = hh;
    }
  }
  info.num_tokens = matched;
  if (matched) m.num_reused += (int64_t)info.block_ids.size();
  return matched;
}

// Ensure the sequence owns enough blocks for new_total tokens.
// Returns 0 on success, -1 when the pool is exhausted (no state rollback:
// callers gate with can-grow checks first, as the Python side does).
int32_t tllm_kvbm_grow(void* h, int64_t seq, int64_t new_total) {
  Manager& m = *static_cast<Manager*>(h);
  auto sit = m.sequences.find(seq);
  if (sit == m.sequences.end()) return -2;  // unknown id: surface, don't insert
  SeqInfo& info = sit->second;
  int64_t need = (new_total + m.block_size - 1) / m.block_size;
  while ((int64_t)info.block_ids.size() < need) {
    int32_t bid = m.take_block();
    if (bid < 0) return -1;
    info.block_ids.push_back(bid);
  }
  info.num_tokens = new_total;
  return 0;
}

int64_t tllm_kvbm_seq_num_blocks(void* h, int64_t seq) {
  Manager& m = *static_cast<Manager*>(h);
  auto it = m.sequences.find(seq);
  return it == m.sequences.end() ? -1 : (int64_t)it->second.block_ids.size();
}

// Publish completed full blocks into the reuse index (first writer wins).
void tllm_kvbm_seal(void* h, int64_t seq, const int32_t* toks, int64_t n) {
  Manager& m = *static_cast<Manager*>(h);
  if (!m.enable_reuse) return;
  auto sit = m.sequences.find(seq);
  if (sit == m.sequences.end()) return;  // unknown id: no phantom entry
  SeqInfo& info = sit->second;
  int64_t n_full = n / m.block_size;
  uint64_t parent = info.block_hashes.empty() ? 0 : info.block_hashes.back();
  for (int64_t b = (int64_t)info.block_hashes.size(); b < n_full; ++b) {
    int32_t bid = info.block_ids[b];
    uint64_t hh = chain_hash(parent, toks + b * m.block_size, m.block_size,
                             info.salt, info.has_salt);
    if (m.cached.find(hh) == m.cached.end()) {
      m.cached[hh] = bid;
      m.block_hash[bid] = hh;
      m.has_hash[bid] = 1;
      m.block_priority[bid] = info.priority;
      m.block_tokens[bid].assign(toks + b * m.block_size,
                                 toks + (b + 1) * m.block_size);
      uint64_t ck = Manager::child_key(parent, info.salt, info.has_salt);
      auto& lst = m.children[ck];
      lst.push_back(bid);
      m.child_pos[bid] = {ck, std::prev(lst.end())};
    }
    info.block_hashes.push_back(hh);
    parent = hh;
  }
}

// Set the retention priority used for blocks this sequence seals from now
// on (reference KvCacheRetentionConfig decode/context priorities).
void tllm_kvbm_set_priority(void* h, int64_t seq, int32_t priority) {
  Manager& m = *static_cast<Manager*>(h);
  auto it = m.sequences.find(seq);
  if (it != m.sequences.end()) it->second.priority = priority;
}

// Fork dst from src for beam search: blocks whose KV is fully written
// (indices < (num_tokens-1)/block_size) are shared by ref count; the
// remaining tail blocks are freshly allocated and must be device-copied.
// Writes the (src,dst) copy pairs and returns their count; -1 when the
// pool cannot hold the tail, -2 for an unknown src, -3 when the tail has
// more blocks than max_pairs (dst is left unregistered in each case).
int64_t tllm_kvbm_fork(void* h, int64_t src, int64_t dst, int32_t* out_src,
                       int32_t* out_dst, int64_t max_pairs) {
  Manager& m = *static_cast<Manager*>(h);
  auto it = m.sequences.find(src);
  if (it == m.sequences.end()) return -2;
  SeqInfo s = it->second;  // copy: sequences map may rehash on insert below
  int64_t shared = s.num_tokens > 0 ? (s.num_tokens - 1) / m.block_size : 0;
  if (shared > (int64_t)s.block_ids.size())
    shared = (int64_t)s.block_ids.size();
  int64_t tail = (int64_t)s.block_ids.size() - shared;
  if (tail > max_pairs) return -3;
  if (tail > m.num_free()) return -1;
  SeqInfo d;
  d.num_tokens = s.num_tokens;
  d.salt = s.salt;
  d.has_salt = s.has_salt;
  d.priority = s.priority;
  for (int64_t i = 0; i < shared; ++i) {
    m.ref_block(s.block_ids[i]);
    d.block_ids.push_back(s.block_ids[i]);
  }
  int64_t n_pairs = 0;
  for (int64_t i = shared; i < (int64_t)s.block_ids.size(); ++i) {
    int32_t bid = m.take_block();
    d.block_ids.push_back(bid);
    out_src[n_pairs] = s.block_ids[i];
    out_dst[n_pairs] = bid;
    ++n_pairs;
  }
  m.sequences[dst] = std::move(d);
  return n_pairs;
}

void tllm_kvbm_free_seq(void* h, int64_t seq) {
  Manager& m = *static_cast<Manager*>(h);
  auto it = m.sequences.find(seq);
  if (it == m.sequences.end()) return;
  for (int32_t bid : it->second.block_ids) m.unref_block(bid);
  m.sequences.erase(it);
}

// Fill out[0:max_blocks] with the sequence's block ids, 0-padded.
void tllm_kvbm_block_table(void* h, int64_t seq, int32_t* out,
                           int64_t max_blocks) {
  Manager& m = *static_cast<Manager*>(h);
  auto it = m.sequences.find(seq);
  if (it == m.sequences.end()) {  // unknown/freed: zero-fill, no phantom entry
    for (int64_t i = 0; i < max_blocks; ++i) out[i] = 0;
    return;
  }
  const auto& ids = it->second.block_ids;
  int64_t n = (int64_t)ids.size() < max_blocks ? (int64_t)ids.size()
                                               : max_blocks;
  for (int64_t i = 0; i < n; ++i) out[i] = ids[i];
  for (int64_t i = n; i < max_blocks; ++i) out[i] = 0;
}

// Flat slots (block_id*block_size + offset) for [start, start+n).
int32_t tllm_kvbm_slot_mapping(void* h, int64_t seq, int64_t start, int64_t n,
                               int32_t* out) {
  Manager& m = *static_cast<Manager*>(h);
  auto it = m.sequences.find(seq);
  if (it == m.sequences.end()) return -1;  // unknown id: surface, don't insert
  const auto& ids = it->second.block_ids;
  for (int64_t i = 0; i < n; ++i) {
    int64_t pos = start + i;
    int64_t b = pos / m.block_size;
    if (b >= (int64_t)ids.size()) return -1;
    out[i] = ids[b] * m.block_size + (int32_t)(pos % m.block_size);
  }
  return 0;
}

int64_t tllm_kvbm_num_free(void* h) {
  return static_cast<Manager*>(h)->num_free();
}

// Dry-run prefix lookup: how many prompt tokens' KV is cached right now,
// with no side effects (no refs taken).  Backs the KV-cache-aware router's
// per-server match scores (reference serve/router.py:76-139 keeps an
// event-fed radix mirror; a direct query is exact and needs no mirror).
int64_t tllm_kvbm_match(void* h, const int32_t* toks, int64_t n,
                        uint64_t salt, int32_t has_salt) {
  Manager& m = *static_cast<Manager*>(h);
  if (!m.enable_reuse) return 0;
  int64_t matched = 0;
  uint64_t parent = 0;
  int64_t n_full = (n - 1) / m.block_size;  // last token always recomputed
  for (int64_t b = 0; b < n_full; ++b) {
    uint64_t hh = chain_hash(parent, toks + b * m.block_size, m.block_size,
                             salt, has_salt);
    if (m.cached.find(hh) == m.cached.end()) break;
    matched += m.block_size;
    parent = hh;
  }
  return matched;
}

// Partial tail-block reuse (reference enable_partial_reuse /
// copy_on_partial_reuse): after full-block matching (the sequence's token
// count is block-aligned), probe the chain tail's cached children for the
// longest shared token prefix with toks[num_tokens:].  copy_on_partial != 0
// allocates a fresh block the caller must device-copy the source page into;
// otherwise the source block itself is adopted in place (only when
// unreferenced) and leaves the reuse index.  out[3] = {extra_tokens, src,
// dst}; extra_tokens == 0 means no match (out[1..2] = -1).
void tllm_kvbm_partial_match(void* h, int64_t seq, const int32_t* toks,
                             int64_t n, int32_t copy_on_partial,
                             int64_t* out) {
  Manager& m = *static_cast<Manager*>(h);
  out[0] = 0;
  out[1] = out[2] = -1;
  if (!m.enable_reuse) return;
  auto sit = m.sequences.find(seq);
  if (sit == m.sequences.end()) return;
  SeqInfo& info = sit->second;
  if (info.num_tokens % m.block_size ||
      info.num_tokens != (int64_t)info.block_ids.size() * m.block_size ||
      info.block_hashes.size() != info.block_ids.size())
    // every owned block must be a hash-chain match: host-onboarded blocks
    // carry no hashes, and probing children of an earlier chain node would
    // reuse a block at the wrong position
    return;
  uint64_t parent = info.block_hashes.empty() ? 0 : info.block_hashes.back();
  int32_t src = -1;
  int64_t k = m.best_partial(parent, info.salt, info.has_salt, toks, n,
                             info.num_tokens, &src);
  if (k < 1) return;
  int32_t dst;
  if (!copy_on_partial) {
    // in-place adoption: the page will be partially overwritten, so it
    // must be unshared and leave the reuse index
    if (m.ref_count[src] != 0) return;
    m.ref_block(src);
    if (m.has_hash[src]) {
      m.cached.erase(m.block_hash[src]);
      m.has_hash[src] = 0;
    }
    m.forget_block(src);
    ++m.num_allocated;
    dst = src;
  } else {
    m.ref_block(src);  // pin: take_block may otherwise evict it
    dst = m.take_block();
    m.unref_block(src);
    if (dst < 0) return;
  }
  info.block_ids.push_back(dst);
  info.num_tokens += k;
  ++m.num_partial;
  out[0] = k;
  out[1] = src;
  out[2] = dst;
}

// Dry-run variant of tllm_kvbm_match that extends the full-block match with
// the best partial tail-block overlap (no side effects).
int64_t tllm_kvbm_match_partial(void* h, const int32_t* toks, int64_t n,
                                uint64_t salt, int32_t has_salt) {
  Manager& m = *static_cast<Manager*>(h);
  if (!m.enable_reuse) return 0;
  int64_t matched = 0;
  uint64_t parent = 0;
  int64_t n_full = (n - 1) / m.block_size;
  for (int64_t b = 0; b < n_full; ++b) {
    uint64_t hh = chain_hash(parent, toks + b * m.block_size, m.block_size,
                             salt, has_salt);
    if (m.cached.find(hh) == m.cached.end()) break;
    matched += m.block_size;
    parent = hh;
  }
  int32_t bid;
  return matched + m.best_partial(parent, salt, has_salt, toks, n, matched,
                                  &bid);
}

// Forget the reuse index (the cached blocks hold KV of other weights after
// a weight swap): unreferenced cached blocks go back to the free list, in
// eviction order; blocks in use stay with their sequences and are freed,
// not cached, when released.
void tllm_kvbm_drop_cached(void* h) {
  Manager& m = *static_cast<Manager*>(h);
  for (auto& kv : m.evict_buckets)
    for (int32_t bid : kv.second) m.free_blocks.push_back(bid);
  m.evict_buckets.clear();
  m.evict_pos.clear();
  m.n_evictable = 0;
  m.cached.clear();
  std::fill(m.has_hash.begin(), m.has_hash.end(), 0);
  m.block_tokens.clear();
  m.children.clear();
  m.child_pos.clear();
}

// Drain block ids evicted from the reuse index since the last call.
// Writes up to max ids into out; returns the count (ids beyond max are
// kept for the next drain).
int64_t tllm_kvbm_drain_evictions(void* h, int32_t* out, int64_t max) {
  Manager& m = *static_cast<Manager*>(h);
  int64_t n = (int64_t)m.pending_evictions.size();
  if (n > max) n = max;
  std::memcpy(out, m.pending_evictions.data(), n * sizeof(int32_t));
  m.pending_evictions.erase(m.pending_evictions.begin(),
                            m.pending_evictions.begin() + n);
  return n;
}

// out[8] = {free, evictable, reused, allocated, evicted, active_seqs,
//           num_blocks, partial_reused}
void tllm_kvbm_stats(void* h, int64_t* out) {
  Manager& m = *static_cast<Manager*>(h);
  out[0] = (int64_t)m.free_blocks.size();
  out[1] = m.n_evictable;
  out[2] = m.num_reused;
  out[3] = m.num_allocated;
  out[4] = m.num_evicted;
  out[5] = (int64_t)m.sequences.size();
  out[6] = m.num_blocks;
  out[7] = m.num_partial;
}

}  // extern "C"
