// Run totals (B2) and the int8 cumsum (B3) of the fused step, and the
// two-phase cumsum's apply (B4), for Hopper.
//
// Replaces epidemicsimulator_tpu/ops/pallas_scans.py: run_totals_fused
// (_summary_kernel + _apply_kernel), cumsum_pallas (_cumsum_kernel) and
// _cumsum_pallas2 (_cumsum_apply_kernel).
// On the TPU the grid runs in order and cumsum_pallas carries its running
// total from block to block in SMEM.  Here blocks run in parallel.
//
// B2 is three passes over tiles of TILE elements:
//
//   summary  each block reduces its tile: the sum and, per boundary set,
//            the largest exclusive prefix at a run start and the smallest
//            inclusive prefix at a run end (tile-local values);
//   combine  one block scans the (n / TILE) summaries: each tile's
//            exclusive offset and, per set, the carries from the tiles
//            before (max) and after (min) it;
//   apply    each block rescans its tile and writes the totals.
//
// Bound: memory; B2 reads 1 + 2 * n_sets bytes and writes 4 * n_sets per
// element.  The tile is read twice (summary and apply); the summaries are
// a few KB.  Block-level scans are warp shuffles plus one shared-memory
// step.
//
// B3 is one pass with decoupled look-back (Merrill and Garland, "Single-
// pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016).  It
// is bound by memory: 1 byte read and 4 written per element, 0.094 ms at
// 63M on 3.35 TB/s.  What it does about that:
//
//   - every byte is read once, in 16-byte loads with neighbouring
//     threads on neighbouring addresses;
//   - the int32 results go through shared memory (16 KB, XOR-swizzled so
//     that neither side has bank conflicts) and out as 16-byte stores, so
//     one warp instruction writes 512 contiguous bytes;
//   - a block takes a tile of 16,384 elements as four sub-tiles of 4,096
//     (256 threads x 16), so each thread has four 16-byte loads in flight
//     and the look-back is short: 3,846 tiles at 63M, 212 at 3,457,142
//     (1.6 per SM, all in one wave).  Measured on the H100 against 4,096-
//     and 8,192-element tiles, it was the fastest at both sizes;
//   - the look-back reads a window of 128 descriptors per round, four
//     loads in flight per lane, so a tile far from the nearest finished
//     prefix walks back 128 tiles per L2 round trip;
//   - tiles are numbered by an atomic ticket, not blockIdx, so every tile
//     a block waits on belongs to a block that is already running: it
//     publishes its own sum before it looks back, so the wait ends;
//   - a tile publishes its state as one 64-bit word (flag in the high
//     half, the int32 value in the low), written and read with single
//     relaxed 64-bit accesses at GPU scope: a reader sees the flag and its
//     value together or neither, so no fence is needed between them;
//   - the descriptors and the ticket are zeroed in stream order by one
//     cudaMemsetAsync before each launch: two device operations per call,
//     no host sync, and nothing read from an earlier call.
//
// B4 keeps the JAX package's split: the caller computes each tile's sum
// and their exclusive cumsum (plain torch ops, as XLA did), and
// cumsum_apply rescans each tile from its base.  A tile (tile_elems, a
// runtime multiple of CHUNK) is one block, which walks it in chunks of
// CHUNK elements with the running carry in a register; each thread
// writes its four int32 results as one 16-byte store.  Bound: memory,
// 1 byte read and 4 written per element, plus one read for the sums.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr int NEG = -(1 << 30);  // below any prefix, even plus an offset
constexpr int POS = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

struct Add { __device__ int operator()(int a, int b) const { return a + b; } };
struct Max { __device__ int operator()(int a, int b) const { return a > b ? a : b; } };
struct Min { __device__ int operator()(int a, int b) const { return a < b ? a : b; } };

// Exclusive scan of one value per thread in thread order (identity for
// thread 0).  smem holds WARPS ints; every thread of the block must call.
template <class Op>
__device__ int block_scan_excl(int x, int identity, Op op, int* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl = op(y, incl);
  }
  if (lane == 31) smem[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? smem[lane] : identity;
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w = op(y, w);
    }
    if (lane < WARPS) smem[lane] = w;
  }
  __syncthreads();
  int before = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) before = identity;
  int result = op(warp > 0 ? smem[warp - 1] : identity, before);
  __syncthreads();
  return result;
}

// Exclusive scan in reverse thread order: thread t gets op over t+1..end.
template <class Op>
__device__ int block_rscan_excl(int x, int identity, Op op, int* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_down_sync(FULL, incl, d);
    if (lane + d < 32) incl = op(incl, y);
  }
  if (lane == 0) smem[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? smem[lane] : identity;
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_down_sync(FULL, w, d);
      if (lane + d < 32) w = op(w, y);
    }
    if (lane < WARPS) smem[lane] = w;
  }
  __syncthreads();
  int after = __shfl_down_sync(FULL, incl, 1);
  if (lane == 31) after = identity;
  int result = op(after, warp < WARPS - 1 ? smem[warp + 1] : identity);
  __syncthreads();
  return result;
}

template <class Op>
__device__ int block_reduce(int x, int identity, Op op, int* smem) {
  int excl = block_scan_excl(x, identity, op, smem);
  // the last thread holds the total after combining its own value
  __shared__ int total;
  if (threadIdx.x == THREADS - 1) total = op(excl, x);
  __syncthreads();
  int t = total;
  __syncthreads();
  return t;
}

struct Masks {
  const uint8_t* start[2];
  const uint8_t* end[2];
};

// Loads this thread's ITEMS values (0 past n) and returns the exclusive
// prefix of the thread's first element within the tile.
__device__ int load_tile(const int8_t* v, long long n, int* vals, int* smem) {
  const long long base = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
  int tsum = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    vals[i] = base + i < n ? (int)v[base + i] : 0;
    tsum += vals[i];
  }
  return block_scan_excl(tsum, 0, Add(), smem);
}

template <int NSETS>
__global__ void scan_summary(const int8_t* v, Masks m, long long n, int nb,
                             int* sums, int* mstart, int* mend) {
  __shared__ int smem[WARPS];
  int vals[ITEMS];
  const int excl = load_tile(v, n, vals, smem);
  int tsum = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) tsum += vals[i];
  const int total = block_reduce(tsum, 0, Add(), smem);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
  const long long base = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
#pragma unroll
  for (int k = 0; k < NSETS; ++k) {
    int mx = NEG, mn = POS, run = excl;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int cse = run;
      run += vals[i];
      if (base + i < n) {
        if (m.start[k][base + i]) mx = cse > mx ? cse : mx;
        if (m.end[k][base + i]) mn = run < mn ? run : mn;
      }
    }
    mx = block_reduce(mx, NEG, Max(), smem);
    mn = block_reduce(mn, POS, Min(), smem);
    if (threadIdx.x == 0) {
      mstart[k * nb + blockIdx.x] = mx;
      mend[k * nb + blockIdx.x] = mn;
    }
  }
}

// One block: tile offsets and, per set, the carries into each tile.
template <int NSETS>
__global__ void scan_combine(int nb, const int* sums, const int* mstart,
                             const int* mend, int* offs, int* carry_c,
                             int* carry_d) {
  __shared__ int smem[WARPS];
  const int per = (nb + THREADS - 1) / THREADS;
  const int t0 = min(nb, (int)threadIdx.x * per), t1 = min(nb, t0 + per);
  int local = 0;
  for (int b = t0; b < t1; ++b) local += sums[b];
  int run = block_scan_excl(local, 0, Add(), smem);
  for (int b = t0; b < t1; ++b) {
    offs[b] = run;
    run += sums[b];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NSETS; ++k) {
    const int* ms = mstart + k * nb;
    const int* me = mend + k * nb;
    int mx = NEG, mn = POS;
    for (int b = t0; b < t1; ++b) {
      mx = max(mx, ms[b] + offs[b]);
      mn = min(mn, me[b] + offs[b]);
    }
    int c = block_scan_excl(mx, NEG, Max(), smem);
    for (int b = t0; b < t1; ++b) {
      carry_c[k * nb + b] = c;
      c = max(c, ms[b] + offs[b]);
    }
    int d = block_rscan_excl(mn, POS, Min(), smem);
    for (int b = t1 - 1; b >= t0; --b) {
      carry_d[k * nb + b] = d;
      d = min(d, me[b] + offs[b]);
    }
  }
}

// out[k] receives set k's run totals.
template <int NSETS>
__global__ void scan_apply(const int8_t* v, Masks m, long long n, int nb,
                           const int* offs, const int* carry_c,
                           const int* carry_d, int* out0, int* out1) {
  __shared__ int smem[WARPS];
  int vals[ITEMS];
  const int excl = load_tile(v, n, vals, smem);
  const int s = offs[blockIdx.x];
  const long long base = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
#pragma unroll
  for (int k = 0; k < NSETS; ++k) {
    int* out = k == 0 ? out0 : out1;
    int sp[ITEMS], ep[ITEMS];
    // forward: largest tile-local exclusive prefix at a start at or before i
    int run = excl, mx = NEG;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (base + i < n && m.start[k][base + i]) mx = max(mx, run);
      run += vals[i];
      sp[i] = mx;
    }
    const int before = block_scan_excl(mx, NEG, Max(), smem);
    // reverse: smallest tile-local inclusive prefix at an end at or after i
    int mn = POS;
    run = excl;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) run += vals[i];
#pragma unroll
    for (int i = ITEMS - 1; i >= 0; --i) {
      if (base + i < n && m.end[k][base + i]) mn = min(mn, run);
      run -= vals[i];
      ep[i] = mn;
    }
    const int after = block_rscan_excl(mn, POS, Min(), smem);
    const int c = carry_c[k * nb + blockIdx.x];
    const int d = carry_d[k * nb + blockIdx.x];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int spi = max(max(before, sp[i]) + s, c);
      const int epi = min(min(after, ep[i]) + s, d);
      if (base + i < n) out[base + i] = epi - spi;
    }
  }
}

template <int NSETS>
int run_scans(const int8_t* v, Masks m, long long n, int* scratch, int* out0,
              int* out1, cudaStream_t stream) {
  const int nb = (int)((n + TILE - 1) / TILE);
  int* sums = scratch;
  int* offs = sums + nb;
  int* mstart = offs + nb;
  int* mend = mstart + NSETS * nb;
  int* carry_c = mend + NSETS * nb;
  int* carry_d = carry_c + NSETS * nb;
  scan_summary<NSETS><<<nb, THREADS, 0, stream>>>(v, m, n, nb, sums, mstart,
                                                 mend);
  scan_combine<NSETS><<<1, THREADS, 0, stream>>>(nb, sums, mstart, mend, offs,
                                                carry_c, carry_d);
  scan_apply<NSETS><<<nb, THREADS, 0, stream>>>(v, m, n, nb, offs, carry_c,
                                               carry_d, out0, out1);
  return (int)cudaGetLastError();
}

constexpr int APPLY_ITEMS = 4;
constexpr int CHUNK = THREADS * APPLY_ITEMS;

// One block per tile: out[i] = base[tile] + (inclusive cumsum of v over
// the tile up to i).  tile_elems is a multiple of CHUNK.
__global__ void cumsum_apply(const int8_t* v, const int* base, long long n,
                             long long tile_elems, int* out) {
  __shared__ int smem[WARPS];
  __shared__ int chunk_total;
  const long long t0 = (long long)blockIdx.x * tile_elems;
  const long long t1 = t0 + tile_elems < n ? t0 + tile_elems : n;
  int carry = base[blockIdx.x];
  for (long long c0 = t0; c0 < t1; c0 += CHUNK) {
    const long long i0 = c0 + threadIdx.x * APPLY_ITEMS;
    int vals[APPLY_ITEMS];
    int tsum = 0;
#pragma unroll
    for (int e = 0; e < APPLY_ITEMS; ++e) {
      vals[e] = i0 + e < t1 ? (int)v[i0 + e] : 0;
      tsum += vals[e];
    }
    // block_scan_excl ends in a barrier, so every thread has read the
    // previous chunk's total before it is overwritten here
    int run = carry + block_scan_excl(tsum, 0, Add(), smem);
    if (threadIdx.x == THREADS - 1) chunk_total = run - carry + tsum;
#pragma unroll
    for (int e = 0; e < APPLY_ITEMS; ++e) {
      run += vals[e];
      vals[e] = run;
    }
    if (i0 + APPLY_ITEMS <= t1) {
      *reinterpret_cast<int4*>(out + i0) =
          make_int4(vals[0], vals[1], vals[2], vals[3]);
    } else {
#pragma unroll
      for (int e = 0; e < APPLY_ITEMS; ++e)
        if (i0 + e < t1) out[i0 + e] = vals[e];
    }
    __syncthreads();
    carry += chunk_total;
  }
}

// B3.  A tile's descriptor: 0 until the tile publishes, then a flag in
// the high 32 bits and an int32 in the low 32.
constexpr unsigned long long TILE_SUM = 1ull << 32;     // the tile's own sum
constexpr unsigned long long TILE_PREFIX = 2ull << 32;  // sum of tiles 0..t

__device__ inline void publish(unsigned long long* p, unsigned long long flag,
                               int value) {
  const unsigned long long w = flag | (uint32_t)value;
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ inline unsigned long long peek(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

__device__ inline int warp_sum(int x) {
  for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(FULL, x, d);
  return x;
}

// Where int4 q (0..3) of thread t's 16 results sits in the staging tile.
// The XOR keeps both the writes (one int4 per thread) and the striped
// reads (int4 o = s * THREADS + t) free of bank conflicts: each quarter-
// warp phase of a 16-byte access touches 8 distinct 16-byte bank groups.
__device__ inline int stage_slot(int t, int q) {
  return t * 4 + (q ^ ((t >> 1) & 3));
}

// The exclusive prefix of tile `tile`, from the descriptors of the tiles
// before it; called by warp 0.  Each round reads a window of 32 x LOOK
// tiles, nearest first (lane l holds tiles end - LOOK*l - i), with LOOK
// independent loads in flight per lane, and stops at the nearest tile
// that holds its inclusive prefix (tiles before 0 read as prefix 0).
constexpr int LOOK = 4;

__device__ int look_back(const unsigned long long* desc, int tile) {
  const int lane = threadIdx.x & 31;
  int prefix = 0;
  for (int end = tile - 1;; end -= 32 * LOOK) {
    unsigned long long d[LOOK];
#pragma unroll
    for (int i = 0; i < LOOK; ++i) {
      const int p = end - LOOK * lane - i;
      d[i] = p >= 0 ? peek(desc + p) : TILE_PREFIX;
    }
    for (;;) {
      bool ready = true;
#pragma unroll
      for (int i = 0; i < LOOK; ++i) ready &= (d[i] >> 32) != 0;
      if (__all_sync(FULL, ready)) break;
#pragma unroll
      for (int i = 0; i < LOOK; ++i)
        if ((d[i] >> 32) == 0) d[i] = peek(desc + (end - LOOK * lane - i));
    }
    int first = LOOK;  // this lane's nearest tile with its prefix
#pragma unroll
    for (int i = LOOK - 1; i >= 0; --i)
      if ((d[i] >> 32) == 2) first = i;
    const unsigned done = __ballot_sync(FULL, first < LOOK);
    const int stop_lane = done ? __ffs(done) - 1 : 32;
    int sum = 0;
#pragma unroll
    for (int i = 0; i < LOOK; ++i)
      if (lane < stop_lane || (lane == stop_lane && i <= first))
        sum += (int)(uint32_t)d[i];
    prefix += warp_sum(sum);
    if (done) return prefix;
  }
}

// One tile of VEC x TILE elements per block, as VEC sub-tiles of TILE;
// tiles are numbered in the order blocks start (the ticket), so tile t
// waits only on running blocks.
constexpr int VEC = 4;

__global__ void __launch_bounds__(THREADS)
cumsum_lookback(const int8_t* v, long long n, int* out,
                unsigned long long* desc, unsigned* ticket) {
  __shared__ int4 stage[TILE / 4];
  __shared__ int smem[WARPS];
  __shared__ int tile_sh, prefix_sh;
  const int t = threadIdx.x;
  if (t == 0) tile_sh = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = tile_sh;
  const long long base = (long long)tile * VEC * TILE;
  uint32_t w[VEC][4];
  int excl[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    const long long i0 = base + u * TILE + t * ITEMS;
    if (i0 + ITEMS <= n && ((uintptr_t)v & 15) == 0) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(v + i0));
      w[u][0] = q.x; w[u][1] = q.y; w[u][2] = q.z; w[u][3] = q.w;
    } else {  // the lane's ragged end, or a lane not 16-byte aligned
#pragma unroll
      for (int e = 0; e < ITEMS; ++e) {
        if (e % 4 == 0) w[u][e / 4] = 0;
        if (i0 + e < n)
          w[u][e / 4] |= (uint32_t)(uint8_t)v[i0 + e] << (8 * (e % 4));
      }
    }
  }
  int total = 0;
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    int tsum = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) tsum = __dp4a((int)w[u][q], 0x01010101, tsum);
    excl[u] = total + block_scan_excl(tsum, 0, Add(), smem);
    // block_scan_excl leaves the inclusive scan of the warp totals in
    // smem, so its last entry is the sub-tile's sum
    total += smem[WARPS - 1];
    if (u + 1 < VEC) __syncthreads();  // read before the next scan writes
  }
  if (t < 32) {
    int prefix = 0;
    if (tile == 0) {
      if (t == 0) publish(desc, TILE_PREFIX, total);
    } else {
      if (t == 0) publish(desc + tile, TILE_SUM, total);
      prefix = look_back(desc, tile);
      if (t == 0) publish(desc + tile, TILE_PREFIX, prefix + total);
    }
    if (t == 0) prefix_sh = prefix;
  }
  __syncthreads();
  const int prefix = prefix_sh;
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    if (u > 0) __syncthreads();  // the previous sub-tile's reads are done
    int run = prefix + excl[u];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int r[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        run += (int)(int8_t)(w[u][q] >> (8 * b));
        r[b] = run;
      }
      stage[stage_slot(t, q)] = make_int4(r[0], r[1], r[2], r[3]);
    }
    __syncthreads();
    const long long sub = base + u * TILE;
#pragma unroll
    for (int s = 0; s < ITEMS / 4; ++s) {
      const int o = s * THREADS + t;
      const int4 x = stage[stage_slot(o >> 2, o & 3)];
      const long long e = sub + 4LL * o;
      if (e + 4 <= n) {
        *reinterpret_cast<int4*>(out + e) = x;
      } else {
        if (e < n) out[e] = x.x;
        if (e + 1 < n) out[e + 1] = x.y;
        if (e + 2 < n) out[e + 2] = x.z;
      }
    }
  }
}

}  // namespace

// Elements per tile: scratch holds (2 + 4 * n_sets) ints per tile.
extern "C" int es_scan_tile_elems() { return TILE; }

extern "C" const char* es_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// B3: out[i] = v[0] + ... + v[i] in int32, for n >= 1.  scratch holds
// (ceil(n / (VEC * TILE)) + 1) 64-bit words: the tiles' descriptors and
// the ticket, zeroed here in stream order before the launch.  out and
// scratch must be 16-byte aligned; v may have any alignment.
extern "C" int es_cumsum_i8(const void* v, void* out, void* scratch,
                            long long scratch_bytes, long long n,
                            void* stream) {
  const long long tiles = (n + VEC * TILE - 1) / (VEC * TILE);
  if (n <= 0 || tiles > 0x7fffffffLL || scratch_bytes < (tiles + 1) * 8 ||
      (((uintptr_t)out | (uintptr_t)scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* desc = (unsigned long long*)scratch;
  const cudaError_t err = cudaMemsetAsync(desc, 0, (tiles + 1) * 8, st);
  if (err != cudaSuccess) return (int)err;
  cumsum_lookback<<<(unsigned)tiles, THREADS, 0, st>>>(
      (const int8_t*)v, n, (int*)out, desc, (unsigned*)(desc + tiles));
  return (int)cudaGetLastError();
}

// B2: for each of n_sets (1 or 2) boundary sets, the total of v over the
// run that holds each element.
extern "C" int es_run_totals_i8(const void* v, const void* start0,
                                const void* end0, const void* start1,
                                const void* end1, void* out0, void* out1,
                                void* scratch, long long n, int n_sets,
                                void* stream) {
  Masks m = {{(const uint8_t*)start0, (const uint8_t*)start1},
             {(const uint8_t*)end0, (const uint8_t*)end1}};
  if (n_sets == 1)
    return run_scans<1>((const int8_t*)v, m, n, (int*)scratch, (int*)out0,
                        nullptr, (cudaStream_t)stream);
  if (n_sets == 2)
    return run_scans<2>((const int8_t*)v, m, n, (int*)scratch, (int*)out0,
                        (int*)out1, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// B4's apply: the tiles' elements are a multiple of this.
extern "C" int es_cumsum_apply_chunk() { return CHUNK; }

// B4's apply: out[i] = base[i / tile_elems] + the inclusive cumsum of v
// over i's tile up to i.  out must be 16-byte aligned.
extern "C" int es_cumsum_apply_i8(const void* v, const void* base, void* out,
                                  long long n, long long tile_elems,
                                  void* stream) {
  if (n <= 0 || tile_elems <= 0 || tile_elems % CHUNK != 0 ||
      ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + tile_elems - 1) / tile_elems;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cumsum_apply<<<(unsigned)tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)v, (const int*)base, n, tile_elems, (int*)out);
  return (int)cudaGetLastError();
}
