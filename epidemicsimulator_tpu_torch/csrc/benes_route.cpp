// Beneš-network routing of a static permutation, on the host (C++).
//
// The router behind kernel B5 (csrc/benes.cu): the classic Waksman
// looping algorithm, O(n) per level, with the bit-packed control layout
// of the JAX package's router (attic/benes_route.cc.txt), so that one
// routed table drives both packages.  Built with the host compiler by
// epidemicsimulator_tpu_torch/runtime.py and loaded with ctypes.
//
// Network on n = 2^k elements: 2k-1 swap stages with XOR distances
// d_j = 2^(k-1-j) for j < k and 2^(j-k+1) for j >= k.  Stage j computes
// y[i] = bit_j(i) ? x[i ^ d_j] : x[i], and the router gives both members
// of a pair the same bit.  Applying the stages in order gives
// out[o] = in[src[o]]; applying them in reverse order applies the
// inverse permutation (every stage is an involution).
//
// Stage j's bit for element i is bit (j % 8) of ctrl[(j / 8) * n + i];
// the caller passes ceil((2k-1)/8) * n zeroed bytes.
#include <cstdint>
#include <vector>

namespace {

inline void set_bit(uint8_t* p, int shift, uint8_t v) {
  *p = uint8_t((*p & ~(uint8_t(1) << shift)) | (uint8_t(v) << shift));
}

}  // namespace

// Returns 0 on success, 1 if src is not a bijection on [0, 2^k).
extern "C" int es_benes_route(const int32_t* src, int32_t k, uint8_t* ctrl) {
  const int64_t n = int64_t(1) << k;
  const int32_t n_stages = 2 * k - 1;
  std::vector<int32_t> cur(src, src + n), nxt(n), dst(n);
  std::vector<uint8_t> routed(n, 0);
  for (int64_t i = 0; i < n; i++) {
    if (cur[i] < 0 || cur[i] >= n || routed[cur[i]]) return 1;
    routed[cur[i]] = 1;
  }
  for (int32_t lvl = 0; lvl < k - 1; lvl++) {
    const int64_t m = int64_t(1) << (k - lvl);  // block size at this level
    const int64_t h = m >> 1;                   // stage XOR distance
    uint8_t* first = ctrl + int64_t(lvl / 8) * n;
    const int fbit = lvl % 8;
    const int32_t lstage = n_stages - 1 - lvl;
    uint8_t* last = ctrl + int64_t(lstage / 8) * n;
    const int lbit = lstage % 8;
    for (int64_t p = 0; p < n; p += m) {
      const int32_t* s = cur.data() + p;  // out -> in, relative to block
      int32_t* d = dst.data();            // in -> out
      for (int64_t o = 0; o < m; o++) d[s[o]] = int32_t(o);
      uint8_t* r = routed.data() + p;     // per-output routed flags
      for (int64_t o = 0; o < m; o++) r[o] = 0;
      int32_t* sub_u = nxt.data() + p;      // upper subnetwork, 0..h
      int32_t* sub_l = nxt.data() + p + h;  // lower subnetwork, h..m
      // Sends output o (and its input) through the upper subnetwork if
      // via_u, else the lower one; returns the input.
      auto route = [&](int64_t o, bool via_u) {
        r[o] = 1;
        const int64_t po = o & (h - 1);
        const uint8_t lv = via_u ? uint8_t(o >= h) : uint8_t(o < h);
        set_bit(&last[p + po], lbit, lv);
        set_bit(&last[p + po + h], lbit, lv);
        const int64_t i = s[o];
        const int64_t pi = i & (h - 1);
        const uint8_t fv = via_u ? uint8_t(i >= h) : uint8_t(i < h);
        set_bit(&first[p + pi], fbit, fv);
        set_bit(&first[p + pi + h], fbit, fv);
        (via_u ? sub_u : sub_l)[po] = int32_t(pi);
        return i;
      };
      for (int64_t o0 = 0; o0 < m; o0++) {
        int64_t o = o0;
        while (!r[o]) {
          const int64_t i = route(o, true);
          // the partner input i^h must take the lower subnetwork; the
          // walk goes on at its output's pair partner
          const int64_t o2 = d[i ^ h];
          if (!r[o2]) route(o2, false);
          o = o2 ^ h;
        }
      }
    }
    cur.swap(nxt);
  }
  // blocks of size 2: the middle stage (level k-1, distance 1)
  uint8_t* mid = ctrl + int64_t((k - 1) / 8) * n;
  const int mbit = (k - 1) % 8;
  for (int64_t p = 0; p < n; p += 2) {
    const uint8_t mv = uint8_t(cur[p] == 1);
    set_bit(&mid[p], mbit, mv);
    set_bit(&mid[p + 1], mbit, mv);
  }
  return 0;
}
