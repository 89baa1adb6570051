// Batched LCMP path decision (paper §3.4), for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lcmp_decide.py::lcmp_decide
// (body _decide_kernel). Per flow: cost = alpha*C_path + beta*C_cong with
// invalid slots at 1<<24; keys cost*8 + slot sorted by the 19-comparator
// Batcher odd-even network; keep ceil(m/keep_num) of the m valid candidates;
// pick rank fmix32(flow_id) % keep; rank 0 when the least valid C_cong is at
// or above cong_fallback; -1 when no candidate is valid. That decision is one
// __device__ function, lcmp_choose, used by both entries:
//
// - lcmp_decide_launch keeps the TPU kernel's contract: per-flow candidate
//   scores in, the candidate index out. One thread owns one flow and keeps
//   its <= 8 keys in registers (the network's indices are compile-time
//   constants, so the array never touches local memory).
//
// - route_arrivals_launch is the fluid engine's whole arrival routing for
//   one step (netsim/engine.py::_route_arrivals, reference
//   src/repro/netsim/engine.py::_route_arrivals) in one launch. For each
//   slot of arrivals[t]: the flow (pads are -1), its pair and hash key, the
//   pair's <= 8 candidates; per candidate, hop liveness and C_path, and
//   for lcmp the delayed congestion view of path_cong_view (the max over
//   hops of hist_c[link, (t - sig_delay) mod HIST], the modulo floored so
//   the negative offsets of early steps wrap to the ring's end); the
//   decision (lcmp_choose for lcmp; for ecmp the fmix32(fid) % m-th valid
//   slot in slot order, as core.select.ecmp_select); then for a routed
//   flow the standing-queue wait, summed hop by hop in hop order with IEEE
//   division, and rtt = max(2*path_prop // dt, 1), and IN-PLACE writes of
//   the flow's eight fields (flow_path, remaining, rate, cc_target, active,
//   extra_wait, rtt_steps, route_step). Pads and flows with no valid
//   candidate write nothing, as the reference's drop-mode scatter, so a pad
//   can never overwrite a real flow 0.
//
// Bound on the H100: bytes, and at the engine's sizes launch latency. The
// standalone decision reads 8 bytes of id and 9 bytes per candidate and
// writes 4, some 84 bytes per flow for ~150 integer operations. The route
// reads about 650 bytes per arrival at testbed8's K = 8 candidates of H = 5
// hops (the slot, pair, id and size; 8 candidate path ids; per candidate H
// hop links, liveness bytes, signal delays and ring cells and one C_path;
// the chosen path's queues and capacities, delay and rate) and writes 29,
// for a few hundred integer operations: a few hundred scattered 4-byte
// gathers, so neither TMA nor wgmma applies. At 7-24 arrivals a step the
// call moves under 16 KB, which the card's 3.35 TB/s moves in a few
// nanoseconds; what costs is the chain of dependent loads (arrival -> flow
// -> pair -> candidate -> hops -> ring). The layout overlaps those chains:
// one warp per arrival slot with its lanes over the candidates, so the K
// chains run side by side; the keys meet by warp shuffles; the chosen
// path's hops are read one per lane and one lane adds them in hop order and
// stores the eight fields. Everything fixed for a run sits in one struct
// that the host builds once, and the step's queue and eight field pointers
// in a second, which the host rewrites only where a tensor changed, so a
// launch passes two struct pointers, t and the stream.
#include <cuda_runtime.h>
#include <stdint.h>

#define P_MAX 8
#define H_MAX 8
#define COST_INVALID (1 << 24)
#define SCORE_MAX 255
#define THREADS 128
#define WARPS (THREADS / 32)
#define FULL 0xFFFFFFFFu
// policy codes of netsim/engine.py::POLICY_CODES
#define POLICY_LCMP 0
#define POLICY_ECMP 2

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ void cmpx(int& a, int& b) {
  const int lo = min(a, b);
  const int hi = max(a, b);
  a = lo;
  b = hi;
}

// The LCMP decision over 8 keys cost*8 + slot (distinct, so the order is
// total): the candidate slot, or -1 when num_valid is 0.
__device__ __forceinline__ int lcmp_choose(int (&key)[P_MAX], int num_valid,
                                           int min_cong, uint32_t fid,
                                           int keep_num, int cong_fallback) {
  // Batcher odd-even mergesort network for 8 keys (19 comparators)
  cmpx(key[0], key[1]); cmpx(key[2], key[3]); cmpx(key[4], key[5]); cmpx(key[6], key[7]);
  cmpx(key[0], key[2]); cmpx(key[1], key[3]); cmpx(key[4], key[6]); cmpx(key[5], key[7]);
  cmpx(key[1], key[2]); cmpx(key[5], key[6]);
  cmpx(key[0], key[4]); cmpx(key[1], key[5]); cmpx(key[2], key[6]); cmpx(key[3], key[7]);
  cmpx(key[2], key[4]); cmpx(key[3], key[5]);
  cmpx(key[1], key[2]); cmpx(key[3], key[4]); cmpx(key[5], key[6]);

  const int keep = max((num_valid + keep_num - 1) / keep_num, 1);
  int pick = (int)(fmix32(fid) % (uint32_t)keep);
  if (min_cong >= cong_fallback) pick = 0;

  int picked = key[0];
#pragma unroll
  for (int i = 1; i < P_MAX; ++i) picked = (pick == i) ? key[i] : picked;
  return num_valid > 0 ? (picked & (P_MAX - 1)) : -1;
}

// ECMP: the fmix32(fid) % m-th of the m valid slots, in slot order (-1
// when none is valid). vmask holds the valid slots as bits.
__device__ __forceinline__ int ecmp_choose(uint32_t vmask, uint32_t fid) {
  const int num_valid = __popc(vmask);
  if (num_valid == 0) return -1;
  uint32_t m = vmask;
  for (uint32_t r = fmix32(fid) % (uint32_t)num_valid; r > 0; --r) m &= m - 1;
  return __ffs(m) - 1;
}

__global__ void __launch_bounds__(THREADS) lcmp_decide_kernel(
    int F, int P, const long long* __restrict__ flow_ids,
    const int* __restrict__ c_path, const int* __restrict__ c_cong,
    const unsigned char* __restrict__ valid, int* __restrict__ out, int alpha,
    int beta, int keep_num, int cong_fallback) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;

  const long long base = (long long)f * P;
  int key[P_MAX];
  int num_valid = 0;
  int min_cong = SCORE_MAX + 1;
#pragma unroll
  for (int i = 0; i < P_MAX; ++i) {
    int cost = COST_INVALID;
    if (i < P && valid[base + i]) {
      const int cc = c_cong[base + i];
      cost = alpha * c_path[base + i] + beta * cc;
      num_valid += 1;
      min_cong = min(min_cong, cc);
    }
    key[i] = cost * P_MAX + i;  // the slot in the low bits breaks ties
  }
  out[f] = lcmp_choose(key, num_valid, min_cong, (uint32_t)flow_ids[f],
                       keep_num, cong_fallback);
}

extern "C" int lcmp_decide_launch(int F, int P, const void* flow_ids,
                                  const void* c_path, const void* c_cong,
                                  const void* valid, void* out, int alpha,
                                  int beta, int keep_num, int cong_fallback,
                                  void* stream) {
  const int blocks = (F + THREADS - 1) / THREADS;
  lcmp_decide_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      F, P, (const long long*)flow_ids, (const int*)c_path,
      (const int*)c_cong, (const unsigned char*)valid, (int*)out, alpha, beta,
      keep_num, cong_fallback);
  return (int)cudaGetLastError();
}

// Fixed for a run; its layout is mirrored by
// kernels/lcmp_decide.py::_RouteArgs.
struct RouteArgs {
  const int* arrivals;          // (T, A) flow index, -1 pad
  const int* f_pair;            // (F,)
  const long long* f_id;        // (F,) uint32 values
  const float* f_size;          // (F,)
  const int* pair_cand;         // (NPAIR, K) path index, -1 pad
  const int* path_links;        // (NP, H) link index, -1 pad
  const int* path_sig;          // (NP, H) signal delay, steps
  const int* path_prop;         // (NP,) us
  const float* path_cap;        // (NP,)
  const float* link_cap;        // (L,)
  const unsigned char* link_alive;  // (L,) bool
  const int* hist_c;            // (L, hist_len) ring
  const int* c_path;            // (NP,)
  long long hist_len;
  int A, K, H, policy, alpha, beta, keep_num, cong_fallback, dt_us;
};

// What a step passes: the link queues, and the per-flow state the route
// writes in place. Its layout is mirrored by
// kernels/lcmp_decide.py::_StepTensors.
struct StepTensors {
  const float* q_bytes;         // (L,)
  int* flow_path;
  float* remaining;
  float* rate;
  float* cc_target;
  unsigned char* active;
  float* extra_wait;
  int* rtt_steps;
  int* route_step;
};

__global__ void __launch_bounds__(THREADS) route_arrivals_kernel(
    const RouteArgs a, const StepTensors o, int t) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= a.A) return;                          // the whole warp leaves
  const int f = a.arrivals[(long long)t * a.A + s];
  if (f < 0) return;                             // a pad: nothing written
  const int pair = a.f_pair[f];
  const uint32_t fid = (uint32_t)a.f_id[f];

  // lane k < K: candidate k, its hops in registers
  const int cand = lane < a.K ? a.pair_cand[(long long)pair * a.K + lane] : -1;
  int link[H_MAX];
#pragma unroll
  for (int h = 0; h < H_MAX; ++h)
    link[h] = (cand >= 0 && h < a.H) ? a.path_links[(long long)cand * a.H + h] : -1;

  bool valid = cand >= 0;
  int cc = 0;
  if (cand >= 0) {
    const int ring = (int)a.hist_len;
    cc = -2147483647 - 1;
#pragma unroll
    for (int h = 0; h < H_MAX; ++h) {
      if (h < a.H && link[h] >= 0) {
        valid = valid && a.link_alive[link[h]] != 0;
        if (a.policy == POLICY_LCMP) {
          const int sd = a.path_sig[(long long)cand * a.H + h];
          const int slot = ((t - sd) % ring + ring) % ring;   // floored
          cc = max(cc, a.hist_c[(long long)link[h] * a.hist_len + slot]);
        }
      } else if (h < a.H) {
        cc = max(cc, 0);                         // a pad hop reads as 0
      }
    }
  }
  const uint32_t vmask = __ballot_sync(FULL, valid);

  int kidx;
  if (a.policy == POLICY_LCMP) {
    const int cost = valid ? a.alpha * a.c_path[cand] + a.beta * cc : COST_INVALID;
    int key[P_MAX];
#pragma unroll
    for (int i = 0; i < P_MAX; ++i)
      key[i] = __shfl_sync(FULL, cost * P_MAX + lane, i);
    int mc = valid ? cc : SCORE_MAX + 1;         // least valid C_cong
#pragma unroll
    for (int off = P_MAX / 2; off > 0; off >>= 1)
      mc = min(mc, __shfl_xor_sync(FULL, mc, off));
    mc = __shfl_sync(FULL, mc, 0);
    kidx = lcmp_choose(key, __popc(vmask), mc, fid, a.keep_num, a.cong_fallback);
  } else {
    kidx = ecmp_choose(vmask, fid);
  }
  if (kidx < 0) return;                          // no valid candidate
  const int path = __shfl_sync(FULL, cand, kidx);

  // standing-queue wait: lane h reads hop h, lane 0 adds in hop order
  const int hop = lane < a.H ? a.path_links[(long long)path * a.H + lane] : -1;
  const float v = hop >= 0 ? __fdiv_rn(o.q_bytes[hop], a.link_cap[hop]) : 0.0f;
  float qw = __shfl_sync(FULL, v, 0);
#pragma unroll
  for (int h = 1; h < H_MAX; ++h) {
    const float vh = __shfl_sync(FULL, v, h);
    if (h < a.H) qw = __fadd_rn(qw, vh);
  }
  if (lane != 0) return;
  const float cap = a.path_cap[path];
  o.flow_path[f] = path;
  o.remaining[f] = a.f_size[f];
  o.rate[f] = cap;
  o.cc_target[f] = cap;
  o.active[f] = 1;
  o.extra_wait[f] = qw;
  o.rtt_steps[f] = max(2 * a.path_prop[path] / a.dt_us, 1);
  o.route_step[f] = t;
}

extern "C" int route_arrivals_launch(const RouteArgs* args,
                                     const StepTensors* step, int t,
                                     void* stream) {
  const int blocks = (args->A + WARPS - 1) / WARPS;
  route_arrivals_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      *args, *step, t);
  return (int)cudaGetLastError();
}
