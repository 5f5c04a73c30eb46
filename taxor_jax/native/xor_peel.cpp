// Native IXF construction core: probe hashing + round-synchronous batch
// peeling + reverse fingerprint assignment, threaded over bins.
//
// Implements EXACTLY the algorithm of ixf/xor_filter.py (_peel_bin +
// build_ixf inner loop) so the native and numpy paths produce
// byte-identical fingerprint tables: per round, every alive key claims
// its first probe slot whose alive-degree is 1 (degrees frozen at round
// start), then assignment replays the rounds in reverse.  The hash math
// mirrors utils/u64np.py, which in turn mirrors the reference
// (src/main/hashutil.hpp:50-61, src/main/xorfilter.hpp:22-45).
//
// The reference's equivalent loop is seqan3-fork ixf.add_bin_elements
// driven by construct_ixf.cpp (C++, -Ofast); this file is its
// counterpart in this framework for the build-time host path.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t murmur64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDULL;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ULL;
  h ^= h >> 33;
  return h;
}

inline uint64_t rotl64(uint64_t x, int c) {
  return (x << c) | (x >> (64 - c));
}

inline uint64_t reduce32(uint64_t r, uint64_t n) {
  return ((r & 0xFFFFFFFFULL) * n) >> 32;
}

// Build one bin; returns false if the 2-core is non-empty (peel failure).
bool build_bin(const uint64_t* keys, int64_t n, uint64_t seed, int64_t bl,
               uint8_t* fp, int64_t stride, int64_t bin,
               std::vector<int32_t>& counts) {
  if (n == 0) return true;
  std::vector<int64_t> pos(3 * n);
  std::vector<uint8_t> fpr(n);
  for (int64_t i = 0; i < n; i++) {
    uint64_t m = murmur64(keys[i] + seed);
    pos[3 * i + 0] = (int64_t)reduce32(m, (uint64_t)bl);
    pos[3 * i + 1] = (int64_t)reduce32(rotl64(m, 21), (uint64_t)bl) + bl;
    pos[3 * i + 2] =
        (int64_t)reduce32(rotl64(m, 42), (uint64_t)bl) + 2 * bl;
    fpr[i] = (uint8_t)(m ^ (m >> 32));
  }
  // Drop keys sharing all 3 probe slots, keeping the first occurrence in
  // original key order (matches np.unique(pos, axis=0, return_index=True)
  // + sort in xor_filter.build_ixf; divergence #2 in DIVERGENCES.md).
  std::vector<uint8_t> alive(n, 1);
  int64_t remaining = n;
  {
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; i++) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      if (pos[3 * a] != pos[3 * b]) return pos[3 * a] < pos[3 * b];
      if (pos[3 * a + 1] != pos[3 * b + 1])
        return pos[3 * a + 1] < pos[3 * b + 1];
      if (pos[3 * a + 2] != pos[3 * b + 2])
        return pos[3 * a + 2] < pos[3 * b + 2];
      return a < b;  // group leader = smallest original index
    });
    for (int64_t i = 1; i < n; i++) {
      int64_t a = order[i - 1], b = order[i];
      if (alive[a] && pos[3 * a] == pos[3 * b] &&
          pos[3 * a + 1] == pos[3 * b + 1] &&
          pos[3 * a + 2] == pos[3 * b + 2]) {
        alive[b] = 0;
        remaining--;
        // keep comparing later dups against the group leader
        std::swap(order[i], order[i - 1]);
      }
    }
  }
  // alive-degree per slot
  std::fill(counts.begin(), counts.end(), 0);
  for (int64_t i = 0; i < n; i++)
    if (alive[i])
      for (int j = 0; j < 3; j++) counts[pos[3 * i + j]]++;
  // round-synchronous peel: claims use the degrees frozen at round start
  std::vector<int64_t> rk, rs, round_start;
  rk.reserve(remaining);
  rs.reserve(remaining);
  while (remaining > 0) {
    size_t start = rk.size();
    round_start.push_back((int64_t)start);
    for (int64_t i = 0; i < n; i++) {
      if (!alive[i]) continue;
      for (int j = 0; j < 3; j++) {
        int64_t p = pos[3 * i + j];
        if (counts[p] == 1) {  // first degree-1 probe claims (argmax)
          rk.push_back(i);
          rs.push_back(p);
          break;
        }
      }
    }
    size_t claimed = rk.size() - start;
    if (claimed == 0) return false;  // non-empty 2-core
    for (size_t e = start; e < rk.size(); e++) {
      int64_t i = rk[e];
      alive[i] = 0;
      for (int j = 0; j < 3; j++) counts[pos[3 * i + j]]--;
    }
    remaining -= (int64_t)claimed;
  }
  // reverse assignment: within a round no key's unclaimed slot is another
  // key's claimed slot, so in-order writes match numpy's batched update
  for (int64_t r = (int64_t)round_start.size() - 1; r >= 0; r--) {
    int64_t lo = round_start[r];
    int64_t hi = (r + 1 < (int64_t)round_start.size())
                     ? round_start[r + 1]
                     : (int64_t)rk.size();
    for (int64_t e = lo; e < hi; e++) {
      int64_t i = rk[e];
      fp[rs[e] * stride + bin] =
          fpr[i] ^ fp[pos[3 * i + 0] * stride + bin] ^
          fp[pos[3 * i + 1] * stride + bin] ^
          fp[pos[3 * i + 2] * stride + bin];
    }
  }
  return true;
}

}  // namespace

extern "C" {

// keys: concatenated per-bin uint64 keys; offsets: int64 [n_bins+1].
// fp: zero-initialized uint8 [slots, n_bins] row-major (stride = n_bins).
// Returns -1 on success, else the lowest failing bin index.
long ixf_build_bins(const uint64_t* keys, const int64_t* offsets,
                    long n_bins, unsigned long long seed,
                    long block_length, uint8_t* fp, long stride,
                    int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<long> next(0);
  std::atomic<long> failed(-1);
  int64_t slots = 3 * (int64_t)block_length;
  auto worker = [&]() {
    std::vector<int32_t> counts((size_t)slots);
    for (;;) {
      long b = next.fetch_add(1);
      if (b >= n_bins || failed.load() >= 0) return;
      const uint64_t* k = keys + offsets[b];
      int64_t n = offsets[b + 1] - offsets[b];
      if (!build_bin(k, n, (uint64_t)seed, (int64_t)block_length, fp,
                     (int64_t)stride, (int64_t)b, counts)) {
        long expect = -1;
        while (!failed.compare_exchange_weak(expect, b) && expect >= 0 &&
               b < expect)
          expect = -1;  // keep the lowest failing bin for determinism
      }
    }
  };
  int nt = (int)std::min<long>(n_threads, n_bins > 0 ? n_bins : 1);
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int i = 0; i < nt; i++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  return failed.load();
}

}  // extern "C"
