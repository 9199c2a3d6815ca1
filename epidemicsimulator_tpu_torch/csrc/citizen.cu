// The fused citizen phase (B1) of the step, for Hopper.
//
// Replaces epidemicsimulator_tpu/ops/pallas_citizen.py: citizen_phase
// (_kernel).  One pass: disease timers, movement for the citizen-order
// schedule and its work-order twin (frozen under lockdown), infected
// household members at home, the mask-adjusted home exposure probability
// q = 1 - exp(n log(1 - p)), the home draw from the counter hash of
// (seed, citizen id), the home hits applied, the packed gates lane for
// the work and bus sides, and the pre-exposure census.
//
// Bound: memory.  Per citizen it reads status (1 B), timer (4 B), sched
// (1 B) and five packed static bytes, and writes status, timer, sched and
// gates (7 B): 18 bytes, 62 MB at 3,457,142 citizens.  The design keeps
// it to that traffic and one device operation per call:
//
//   - a block takes a tile of 2,048 citizens, 4 per thread: every byte
//     lane moves as one 4-byte access per thread and the timer as one
//     16-byte access, so each warp access is contiguous (128 or 512
//     bytes).  Few citizens per thread keep the kernel at 40 registers,
//     three blocks of 512 threads per SM, so that one block's loads
//     overlap another's arithmetic; with 16 citizens per thread and
//     16-byte loads of every lane it took so many registers that one
//     block fit on an SM, and it was the slowest of the shapes measured
//     on the H100;
//   - each citizen's timer advance, movement and "infected at home" bit
//     is computed once.  The bits go into a shared bitmap of the tile
//     with a halo word of 32 citizens on each side (a household holds
//     at most 31, so every housemate of a tile citizen is in the map;
//     warps 0 and 1 compute the halo citizens from their lanes).  A
//     citizen's count of infected housemates at home is then one popcount
//     over the bits of its household, [i - pos, i - pos + size): no
//     housemate is read or recomputed, and no loop depends on the size;
//   - q takes at most 64 values in a step (two exposure chances, masked
//     or not, times n = 0..31), so each block first fills a table with
//     them, by the same __fmul_rn/__fsub_rn/logf/expf sequence that one
//     citizen would run: q is bitwise what the per-citizen formula gives,
//     NaN included (p = 1 and n = 0), and the citizen's q = 0 at work in
//     another OA is applied after the lookup, as before;
//   - the census is a warp reduction, one 8-int partial per block, and
//     the last block to finish (an atomic ticket, which wraps to 0 for
//     the next call) sums the partials into the totals: no same-address
//     atomics, and no memset before the launch.
//
// Ensemble mode (engine/packed.py): R replicas of one world lie in R
// contiguous spans of tiles_per_rep tiles.  Each block reads its
// replica's row of two small tables, (R, 4) int32 [move, mask status,
// exposed time, infected time] and (R, 2) float32 [exposure chance,
// 1 - mask effectiveness], in place of the scalars, and the last block
// also sums the partials of each replica's tiles into an (R, 8) census.
// A halo read across a replica's edge is advanced with this block's row,
// which is harmless: a household never crosses a replica, and only the
// citizen's own household's bits are counted.
//
// Built without fast math; products are written with __fmul_rn so that
// no multiply-add is contracted.  The hash index is the global citizen
// id: gid0 + lane, wrapping as u32, where gid0 is the global id of lane 0
// (0 for one world on one card; a shard's or a rank's first id in the
// sharded engines, parallel/fastmesh.py and parallel/ensemble_mesh.py).
// The census and the lanes' bounds stay on the local lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

constexpr int TILE_ITEMS = 4;
constexpr int TILE_THREADS = 512;
constexpr int TILE_ELEMS = TILE_THREADS * TILE_ITEMS;
constexpr int WARPS = TILE_THREADS / 32;
constexpr int W = TILE_ITEMS / 4;  // words of a thread's byte group
constexpr int HALO = 32;  // citizens on each side of the tile
constexpr int HOME_WORDS = TILE_ELEMS / 32 + 2;
constexpr int CENSUS = 8;
constexpr unsigned FULL = 0xffffffffu;

struct Step {
  int h24, move, mask_status, e_time, i_time, ref_mask_sem, u8_trunc;
  unsigned seed, gid0;
  float p0, mask_scale;
};

struct Lanes {
  const int8_t *sa, *sb, *sc, *sd, *se, *status;
  const int32_t* timer;
  const int8_t* sched;
};

struct Outs {
  int8_t *status, *sched, *gates;
  int32_t* timer;
  float* q;        // may be null
  int* partials;   // CENSUS ints per block
  int* totals;     // CENSUS ints
  unsigned* ticket;  // 0 between calls
  int* rep_totals;   // CENSUS ints per replica, ensemble mode only
};

// The ensemble mode's parameter rows (ints null outside it).
struct Reps {
  const int* ints;     // (n, 4): move, mask_status, e_time, i_time
  const float* f32s;   // (n, 2): p0, mask_scale
  int tiles, n;        // tiles per replica, replicas
};

__device__ __forceinline__ void advance(int st, int tm, const Step& s,
                                        int& st1, int& tm1) {
  const bool is_e = st == 1, is_i = st == 2;
  const bool e_to_i = is_e && tm >= s.e_time;
  const bool i_to_r = is_i && tm >= s.i_time;
  st1 = i_to_r ? 3 : (e_to_i ? 2 : st);
  tm1 = (e_to_i || i_to_r) ? 0 : ((is_e || is_i) ? tm + 1 : tm);
}

// citizen.rs:168-216 schedule match; frozen when !move.
__device__ __forceinline__ void movement(const Step& s, int ws, int we,
                                         bool uses, int at_work, int on_bus,
                                         int& at_work1, int& on_bus1,
                                         bool& arm_bus_out) {
  arm_bus_out = s.h24 == ws - 1 && uses;
  const bool arm_to_work = s.h24 == ws;
  const bool arm_bus_home = s.h24 == we - 1 && uses;
  const bool arm_to_home = s.h24 == we;
  on_bus1 = s.move ? (arm_bus_out || arm_bus_home) : on_bus;
  at_work1 = s.move ? (arm_to_work ? 1 : (arm_to_home ? 0 : at_work))
                    : at_work;
}

// Whether a citizen is infected and positioned at home after this step's
// timer advance and movement (pa, pb: static bytes a and b).
__device__ __forceinline__ bool at_home_infected(int st, int tm, int pa,
                                                 int pb, int sch,
                                                 const Step& s) {
  int st1, tm1, at_work1, on_bus1;
  bool arm;
  advance(st, tm, s, st1, tm1);
  movement(s, pa & 31, pb & 31, (pa >> 5) & 1, sch & 1, (sch >> 1) & 1,
           at_work1, on_bus1, arm);
  return st1 == 2 && !on_bus1 && (!at_work1 || !((pa >> 6) & 1));
}

__device__ __forceinline__ float hash_uniform(unsigned seed, unsigned idx) {
  unsigned x = idx * 0x9E3779B9u + seed;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x ^= x >> 16;
  return __fmul_rn((float)(int)(x >> 8), 1.0f / 16777216.0f);
}

// The four timers of citizens i0 .. i0 + 3 (0 past n): one 16-byte load.
__device__ __forceinline__ void load_int4(const int32_t* p, long long i0,
                                           long long n, bool aligned,
                                           int (&r)[4]) {
  if (aligned && i0 + 4 <= n) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p + i0));
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) r[e] = i0 + e < n ? p[i0 + e] : 0;
}

// Writes four int32s at i0 (16-byte aligned), none at or past n.
__device__ __forceinline__ void store_int4(int32_t* p, long long i0,
                                            long long n, const int (&r)[4]) {
  if (i0 + 4 <= n) {
    *reinterpret_cast<int4*>(p + i0) = make_int4(r[0], r[1], r[2], r[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (i0 + e < n) p[i0 + e] = r[e];
}

template <bool WANT_Q>
__global__ void __launch_bounds__(TILE_THREADS, 3)
citizen_tile(Lanes in, Outs out, long long n, Step s, bool aligned,
             Reps reps) {
  __shared__ uint32_t home[HOME_WORDS];  // bit 32 + k: tile citizen k
  __shared__ float qtab[64];             // [masked][n infected at home]
  __shared__ int wsum[WARPS][CENSUS];
  __shared__ bool last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = (long long)blockIdx.x * TILE_ELEMS;
  const long long i0 = base + (long long)t * TILE_ITEMS;
  if (reps.ints) {
    const int r = blockIdx.x / reps.tiles;
    s.move = __ldg(reps.ints + 4 * r) != 0;
    s.mask_status = __ldg(reps.ints + 4 * r + 1);
    s.e_time = __ldg(reps.ints + 4 * r + 2);
    s.i_time = __ldg(reps.ints + 4 * r + 3);
    s.p0 = __ldg(reps.f32s + 2 * r);
    s.mask_scale = __ldg(reps.f32s + 2 * r + 1);
  }

  // the halo: warp 0 the 32 citizens before the tile, warp 1 those after;
  // their lanes are read first, with the tile's, and used after
  const long long j = warp == 0 ? base - HALO + lane : base + TILE_ELEMS + lane;
  const bool halo = warp < 2 && j >= 0 && j < n;
  int h_st = 0, h_tm = 0, h_pa = 0, h_pb = 0, h_sch = 0;
  if (halo) {
    h_st = in.status[j];
    h_tm = in.timer[j];
    h_pa = (uint8_t)in.sa[j];
    h_pb = (uint8_t)in.sb[j];
    h_sch = (uint8_t)in.sched[j];
  }
  uint32_t A[W], B[W], C[W], D[W], E[W], ST[W], SC[W];
  tileio::load_bytes<TILE_ITEMS>(in.sa, i0, n, aligned, A);
  tileio::load_bytes<TILE_ITEMS>(in.sb, i0, n, aligned, B);
  tileio::load_bytes<TILE_ITEMS>(in.sc, i0, n, aligned, C);
  tileio::load_bytes<TILE_ITEMS>(in.sd, i0, n, aligned, D);
  tileio::load_bytes<TILE_ITEMS>(in.se, i0, n, aligned, E);
  tileio::load_bytes<TILE_ITEMS>(in.status, i0, n, aligned, ST);
  tileio::load_bytes<TILE_ITEMS>(in.sched, i0, n, aligned, SC);
  int tm[TILE_ITEMS];
  load_int4(in.timer, i0, n, aligned, tm);
  if (warp < 2) {
    const unsigned word = __ballot_sync(
        FULL, halo && at_home_infected(h_st, h_tm, h_pa, h_pb, h_sch, s));
    if (lane == 0) home[warp == 0 ? 0 : HOME_WORDS - 1] = word;
  }
  if (t < 64) {
    const float p = __fmul_rn(s.p0, t >= 32 ? s.mask_scale : 1.0f);
    qtab[t] = __fsub_rn(
        1.0f, expf(__fmul_rn((float)(t & 31), logf(__fsub_rn(1.0f, p)))));
  }

  // Everything but the home draw.  st1 goes into ST, the new schedule
  // into SC, the gates without the hit bit into G.
  uint32_t G[W] = {};
  int c[CENSUS] = {0, 0, 0, 0, 0, 0, 0, 0};
  unsigned seirv = 0;  // this thread's S, E, I, R, V counts, 6 bits each
  unsigned home_bits = 0;
#pragma unroll
  for (int e = 0; e < TILE_ITEMS; ++e) {
    const bool valid = i0 + e < n;
    const int pa = tileio::byte_at(A, e), pb = tileio::byte_at(B, e);
    const int pd = tileio::byte_at(D, e), pe = tileio::byte_at(E, e);
    const int sch = tileio::byte_at(SC, e);
    int st1, tm1, at_work1, on_bus1;
    bool arm_bus_out;
    advance((int)(int8_t)tileio::byte_at(ST, e), tm[e], s, st1, tm1);
    tm[e] = tm1;
    movement(s, pa & 31, pb & 31, (pa >> 5) & 1, sch & 1, (sch >> 1) & 1,
             at_work1, on_bus1, arm_bus_out);
    const bool wneq = (pa >> 6) & 1;
    const bool inf_active = st1 == 2 && !on_bus1;
    home_bits |= (unsigned)(valid && inf_active && (!at_work1 || !wneq)) << e;

    // the work-order twin of the schedule
    int at_work_ws1, on_bus_ws1;
    bool arm_ws;
    movement(s, pd & 31, pe & 31, (pe >> 5) & 1, (sch >> 3) & 1,
             (sch >> 4) & 1, at_work_ws1, on_bus_ws1, arm_ws);
    const int btw1 = s.move ? arm_bus_out : (sch >> 2) & 1;
    const int contrib_work = inf_active && at_work1 && wneq;
    const int sched1 = at_work1 | (on_bus1 << 1) | (btw1 << 2) |
                       (at_work_ws1 << 3) | (on_bus_ws1 << 4);
    const int gates = contrib_work | ((st1 == 0) << 1) | (on_bus1 << 3) |
                      ((st1 == 2) << 4);
    const int sh = 8 * (e & 3);
    ST[e >> 2] = (ST[e >> 2] & ~(0xFFu << sh)) | ((uint32_t)(st1 & 0xFF) << sh);
    SC[e >> 2] = (SC[e >> 2] & ~(0xFFu << sh)) | ((uint32_t)sched1 << sh);
    G[e >> 2] |= (uint32_t)gates << sh;
    if (valid) {
      if ((unsigned)st1 < 5) seirv += 1u << (6 * st1);
      c[5] += contrib_work;
      c[6] += on_bus1 && st1 == 2;
    }
  }
  // the bits of the 32 / TILE_ITEMS threads that share a bitmap word
  constexpr int SHARE = 32 / TILE_ITEMS;
  home_bits <<= TILE_ITEMS * (lane % SHARE);
#pragma unroll
  for (int d = 1; d < SHARE; d <<= 1)
    home_bits |= __shfl_xor_sync(FULL, home_bits, d);
  if (lane % SHARE == 0) home[1 + t * TILE_ITEMS / 32] = home_bits;
  __syncthreads();  // the bitmap and the q table are whole

  int q[TILE_ITEMS];  // the home probabilities' bits, kept for q_out
#pragma unroll
  for (int e = 0; e < TILE_ITEMS; ++e) {
    const int pb = tileio::byte_at(B, e), pc = tileio::byte_at(C, e);
    const int pd = tileio::byte_at(D, e);
    const int pos = ((pb >> 5) & 7) | ((pc & 3) << 3);
    const int size = (pc >> 2) & 31;
    // infected housemates at home, this citizen included: the household's
    // bits [lo, lo + size) of the bitmap (lo >= 1, lo + size < 32 * HOME_WORDS)
    const int lo = HALO + t * TILE_ITEMS + e - pos;
    const unsigned long long pair =
        ((unsigned long long)home[(lo >> 5) + 1] << 32) | home[lo >> 5];
    const int n_h = __popcll((pair >> (lo & 31)) & ((1ull << size) - 1));

    const int sched1 = tileio::byte_at(SC, e), gates = tileio::byte_at(G, e);
    const int at_work1 = sched1 & 1, on_bus1 = (sched1 >> 1) & 1;
    const bool compliant = (pd >> 5) & 1;
    const bool same_oa = (pd >> 6) & 1;
    const bool active = s.ref_mask_sem
        ? (s.mask_status == 2 && !compliant)
        : (compliant && (s.mask_status == 2 ||
                         (s.mask_status == 1 && on_bus1)));
    // n_h <= 31, so the reference's u8 truncation leaves it as it is
    const int nh_eff = s.u8_trunc ? (n_h & 0xFF) : n_h;
    float qe = qtab[(active ? 32 : 0) + (nh_eff & 31)];
    if (!(!at_work1 || same_oa)) qe = 0.0f;
    q[e] = __float_as_int(qe);

    const bool valid = i0 + e < n;
    const bool hit =
        valid && ((gates >> 1) & 1) &&
        hash_uniform(s.seed, s.gid0 + (unsigned)(i0 + e)) < qe;
    const int sh = 8 * (e & 3);
    if (hit) {
      ST[e >> 2] = (ST[e >> 2] & ~(0xFFu << sh)) | (1u << sh);
      tm[e] = 0;
      G[e >> 2] |= 4u << sh;
    }
    c[7] += hit;
  }
  tileio::store_bytes<TILE_ITEMS>(out.status, i0, n, ST);
  tileio::store_bytes<TILE_ITEMS>(out.sched, i0, n, SC);
  tileio::store_bytes<TILE_ITEMS>(out.gates, i0, n, G);
  store_int4(out.timer, i0, n, tm);
  if (WANT_Q) store_int4(reinterpret_cast<int32_t*>(out.q), i0, n, q);

  // the census: warp sums, one partial per block, the last block sums them
#pragma unroll
  for (int k = 0; k < 5; ++k) c[k] = (seirv >> (6 * k)) & 63;
#pragma unroll
  for (int k = 0; k < CENSUS; ++k) {
    const int w = __reduce_add_sync(FULL, c[k]);
    if (lane == 0) wsum[warp][k] = w;
  }
  __syncthreads();
  if (t < CENSUS) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += wsum[w][t];
    out.partials[blockIdx.x * CENSUS + t] = sum;
    __threadfence();
  }
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicInc(out.ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // thread t adds census entry t % 8 of blocks t / 8, t / 8 + 64, ...
  int sum = 0;
  for (long long j = t; j < (long long)gridDim.x * CENSUS; j += TILE_THREADS)
    sum += __ldcg(out.partials + j);
  sum += __shfl_xor_sync(FULL, sum, 8);
  sum += __shfl_xor_sync(FULL, sum, 16);
  if (lane < CENSUS) wsum[warp][lane] = sum;
  __syncthreads();
  if (t < CENSUS) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += wsum[w][t];
    out.totals[t] = total;
  }
  if (!reps.ints) return;
  // thread t adds census entry t % 8 of replica t / 8 over its tiles
  for (int o = t; o < reps.n * CENSUS; o += TILE_THREADS) {
    const int* p = out.partials + (long long)(o / CENSUS) * reps.tiles * CENSUS +
                   o % CENSUS;
    int rep_sum = 0;
#pragma unroll 8
    for (int j = 0; j < reps.tiles; ++j) rep_sum += __ldcg(p + j * CENSUS);
    out.rep_totals[o] = rep_sum;
  }
}

}  // namespace

// totals (8 ints) receives S, E, I, R, V before exposure, then work
// contributors, infected riders on a bus and home hits.  q_out may be
// null; otherwise it receives each citizen's home probability.  partials
// holds 8 ints per tile of 2,048 citizens; ticket is one unsigned that is
// 0 before the first call and that each call leaves at 0, so calls that
// share it must run in stream order.  Outputs must be 16-byte aligned;
// the input lanes may have any alignment.
//
// gid0 offsets the home draw's hash index, in both modes.
//
// Ensemble mode: rep_ints (n_reps x 4 int32) and rep_f32s (n_reps x 2
// float) on the device, n = n_reps * tiles_per_rep * 2,048, and
// rep_totals receives n_reps x 8 ints; move, mask_status, e_time,
// i_time, p0 and mask_scale are then unused.  rep_ints null: no
// ensemble mode.
extern "C" int es_citizen_phase(
    const void* sa, const void* sb, const void* sc, const void* sd,
    const void* se, const void* status, const void* timer, const void* sched,
    void* status_out, void* timer_out, void* sched_out, void* gates_out,
    void* totals, void* partials, long long partials_bytes, void* ticket,
    void* q_out, long long n, int h24, int move, int mask_status,
    unsigned seed, unsigned gid0, int e_time, int i_time, float p0,
    float mask_scale, int ref_mask_sem, int u8_trunc, const void* rep_ints,
    const void* rep_f32s, int tiles_per_rep, int n_reps, void* rep_totals,
    void* stream) {
  const long long blocks = (n + TILE_ELEMS - 1) / TILE_ELEMS;
  const uintptr_t outs = (uintptr_t)status_out | (uintptr_t)timer_out |
                         (uintptr_t)sched_out | (uintptr_t)gates_out |
                         (uintptr_t)q_out;
  if (n <= 0 || blocks > 0x7fffffffLL || (outs & 15) != 0 ||
      partials_bytes < blocks * CENSUS * (long long)sizeof(int))
    return (int)cudaErrorInvalidValue;
  if (rep_ints && (!rep_f32s || !rep_totals || tiles_per_rep <= 0 ||
                   n_reps <= 0 ||
                   n != (long long)n_reps * tiles_per_rep * TILE_ELEMS))
    return (int)cudaErrorInvalidValue;
  const Reps reps{(const int*)rep_ints, (const float*)rep_f32s, tiles_per_rep,
                  n_reps};
  const uintptr_t ins = (uintptr_t)sa | (uintptr_t)sb | (uintptr_t)sc |
                        (uintptr_t)sd | (uintptr_t)se | (uintptr_t)status |
                        (uintptr_t)timer | (uintptr_t)sched;
  Step s{h24, move, mask_status, e_time, i_time, ref_mask_sem, u8_trunc,
         seed, gid0, p0, mask_scale};
  Lanes in{(const int8_t*)sa, (const int8_t*)sb, (const int8_t*)sc,
           (const int8_t*)sd, (const int8_t*)se, (const int8_t*)status,
           (const int32_t*)timer, (const int8_t*)sched};
  Outs out{(int8_t*)status_out, (int8_t*)sched_out, (int8_t*)gates_out,
           (int32_t*)timer_out, (float*)q_out, (int*)partials, (int*)totals,
           (unsigned*)ticket, (int*)rep_totals};
  const bool aligned = (ins & 15) == 0;
  if (q_out)
    citizen_tile<true><<<(unsigned)blocks, TILE_THREADS, 0,
                         (cudaStream_t)stream>>>(in, out, n, s, aligned, reps);
  else
    citizen_tile<false><<<(unsigned)blocks, TILE_THREADS, 0,
                          (cudaStream_t)stream>>>(in, out, n, s, aligned, reps);
  return (int)cudaGetLastError();
}
