// The fused citizen phase (B1) of the step, for Hopper.
//
// Replaces epidemicsimulator_tpu/ops/pallas_citizen.py: citizen_phase
// (_kernel).  One thread per citizen, one pass: disease timers, movement
// for the citizen-order schedule and its work-order twin (frozen under
// lockdown), infected household members at home, the mask-adjusted home
// exposure probability q = 1 - exp(n log(1 - p)), the home draw from the
// counter hash of (seed, citizen id), the home hits applied, the packed
// gates lane for the work and bus sides, and the pre-exposure census.
//
// The TPU kernel reads each household's neighbours through 32-row halo
// blocks; here a household is a contiguous run given by the static
// (position, size) lanes, so each thread reads its housemates' lanes from
// global memory (households hold at most 24, on average about 4; the
// neighbours' bytes are in L1/L2).  The census is a block count
// (__syncthreads_count) added into 8 ints with atomics.
//
// Bound: memory.  Per citizen it reads status (1 B), timer (4 B), sched
// (1 B) and five packed static bytes, and writes status, timer, sched and
// gates (7 B).  Built without fast math; the products are written with
// __fmul_rn so that no multiply-add is contracted, and q uses logf and
// expf in the order of the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Step {
  int h24, move, mask_status, e_time, i_time, ref_mask_sem, u8_trunc;
  unsigned seed;
  float p0, mask_scale;
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

// Whether citizen j is infected and positioned at home after this step's
// timer advance and movement.
__device__ __forceinline__ int home_contrib(
    long long j, const int8_t* sa, const int8_t* sb, const int8_t* status,
    const int32_t* timer, const int8_t* sched, const Step& s) {
  int st1, tm1;
  advance(status[j], timer[j], s, st1, tm1);
  const int pa = (uint8_t)sa[j], sch = (uint8_t)sched[j];
  int at_work1, on_bus1;
  bool arm;
  movement(s, pa & 31, (uint8_t)sb[j] & 31, (pa >> 5) & 1, sch & 1,
           (sch >> 1) & 1, at_work1, on_bus1, arm);
  const bool wneq = (pa >> 6) & 1;
  return st1 == 2 && !on_bus1 && (!at_work1 || !wneq);
}

__device__ __forceinline__ float hash_uniform(unsigned seed, unsigned idx) {
  unsigned x = idx * 0x9E3779B9u + seed;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x ^= x >> 16;
  return __fmul_rn((float)(int)(x >> 8), 1.0f / 16777216.0f);
}

__global__ void citizen_phase_kernel(
    const int8_t* __restrict__ sa, const int8_t* __restrict__ sb,
    const int8_t* __restrict__ sc, const int8_t* __restrict__ sd,
    const int8_t* __restrict__ se, const int8_t* __restrict__ status,
    const int32_t* __restrict__ timer, const int8_t* __restrict__ sched,
    int8_t* __restrict__ status_out, int32_t* __restrict__ timer_out,
    int8_t* __restrict__ sched_out, int8_t* __restrict__ gates_out,
    int* __restrict__ totals, float* __restrict__ q_out, long long n,
    Step s) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  int st1 = 5, hit = 0, contrib_work = 0, on_bus1 = 0;
  if (valid) {
    int tm1;
    advance(status[i], timer[i], s, st1, tm1);
    const int pa = (uint8_t)sa[i], pb = (uint8_t)sb[i], pc = (uint8_t)sc[i];
    const int pd = (uint8_t)sd[i], pe = (uint8_t)se[i];
    const int sch = (uint8_t)sched[i];
    const bool wneq = (pa >> 6) & 1;
    const int pos = ((pb >> 5) & 7) | ((pc & 3) << 3);
    const int size = (pc >> 2) & 31;

    int at_work1;
    bool arm_bus_out;
    movement(s, pa & 31, pb & 31, (pa >> 5) & 1, sch & 1, (sch >> 1) & 1,
             at_work1, on_bus1, arm_bus_out);
    const bool inf_active = st1 == 2 && !on_bus1;

    // infected housemates at home, this citizen included
    int n_h = 0;
    const long long first = i - pos;
    for (int k = 0; k < size; ++k) {
      const long long j = first + k;
      n_h += j == i ? (inf_active && (!at_work1 || !wneq))
                    : home_contrib(j, sa, sb, status, timer, sched, s);
    }

    // the work-order twin of the schedule
    int at_work_ws1, on_bus_ws1;
    bool arm_ws;
    movement(s, pd & 31, pe & 31, (pe >> 5) & 1, (sch >> 3) & 1,
             (sch >> 4) & 1, at_work_ws1, on_bus_ws1, arm_ws);
    const int btw1 = s.move ? arm_bus_out : (sch >> 2) & 1;

    const bool compliant = (pd >> 5) & 1;
    const bool same_oa = (pd >> 6) & 1;
    const bool active = s.ref_mask_sem
        ? (s.mask_status == 2 && !compliant)
        : (compliant && (s.mask_status == 2 ||
                         (s.mask_status == 1 && on_bus1)));
    const float p = __fmul_rn(s.p0, active ? s.mask_scale : 1.0f);
    const int nh_eff = s.u8_trunc ? (n_h & 0xFF) : n_h;
    float q = __fsub_rn(
        1.0f, expf(__fmul_rn((float)nh_eff, logf(__fsub_rn(1.0f, p)))));
    if (!(!at_work1 || same_oa)) q = 0.0f;
    if (q_out) q_out[i] = q;

    const bool susceptible = st1 == 0;
    hit = susceptible && hash_uniform(s.seed, (unsigned)i) < q;
    contrib_work = inf_active && at_work1 && wneq;

    status_out[i] = (int8_t)(hit ? 1 : st1);
    timer_out[i] = hit ? 0 : tm1;
    sched_out[i] = (int8_t)(at_work1 | (on_bus1 << 1) | (btw1 << 2) |
                            (at_work_ws1 << 3) | (on_bus_ws1 << 4));
    gates_out[i] = (int8_t)(contrib_work | (susceptible << 1) | (hit << 2) |
                            (on_bus1 << 3) | ((st1 == 2) << 4));
  }
  // pre-exposure census and the gate counts (invalid lanes carry st1 = 5)
  int c[8];
  for (int k = 0; k < 5; ++k) c[k] = __syncthreads_count(st1 == k);
  c[5] = __syncthreads_count(contrib_work);
  c[6] = __syncthreads_count(on_bus1 && st1 == 2);
  c[7] = __syncthreads_count(hit);
  if (threadIdx.x == 0)
    for (int k = 0; k < 8; ++k)
      if (c[k]) atomicAdd(&totals[k], c[k]);
}

}  // namespace

// totals (8 ints, zeroed by the caller) receives S, E, I, R, V before
// exposure, then work contributors, infected riders on a bus and home hits.
// q_out may be null; otherwise it receives each citizen's home probability.
extern "C" int es_citizen_phase(
    const void* sa, const void* sb, const void* sc, const void* sd,
    const void* se, const void* status, const void* timer, const void* sched,
    void* status_out, void* timer_out, void* sched_out, void* gates_out,
    void* totals, void* q_out, long long n, int h24, int move,
    int mask_status, unsigned seed, int e_time, int i_time, float p0,
    float mask_scale, int ref_mask_sem, int u8_trunc, void* stream) {
  Step s{h24, move, mask_status, e_time, i_time, ref_mask_sem, u8_trunc,
         seed, p0, mask_scale};
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  citizen_phase_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const int8_t*)sa, (const int8_t*)sb, (const int8_t*)sc,
      (const int8_t*)sd, (const int8_t*)se, (const int8_t*)status,
      (const int32_t*)timer, (const int8_t*)sched, (int8_t*)status_out,
      (int32_t*)timer_out, (int8_t*)sched_out, (int8_t*)gates_out,
      (int*)totals, (float*)q_out, n, s);
  return (int)cudaGetLastError();
}
