// Batched path decisions (paper §3.4 and the baselines of §6.1), for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lcmp_decide.py::lcmp_decide
// (body _decide_kernel). Per flow: cost = alpha*C_path + beta*C_cong with
// invalid slots at 1<<24; keys cost*8 + slot sorted by the 19-comparator
// Batcher odd-even network; keep ceil(m/keep_num) of the m valid candidates;
// pick rank fmix32(flow_id) % keep; rank 0 when the least valid C_cong is at
// or above cong_fallback; -1 when no candidate is valid. Three entries:
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
//   pair's <= 8 candidates; per candidate (candidate_lane), hop liveness
//   and, for the laws that read it, the delayed congestion view of
//   path_cong_view (the max over hops of hist_c[link, (t - sig_delay) mod
//   HIST], the modulo floored so the negative offsets of early steps wrap
//   to the ring's end); the policy's law (choose); then for a routed flow
//   the standing-queue wait, summed hop by hop in hop order with IEEE
//   division, and rtt = max(2*path_prop // dt, 1), and IN-PLACE writes of
//   the flow's eight fields (flow_path, remaining, rate, cc_target, active,
//   extra_wait, rtt_steps, route_step). Pads and flows with no valid
//   candidate write nothing, as the reference's drop-mode scatter, so a pad
//   can never overwrite a real flow 0.
//
// - decide_launch is netsim/engine.py::decide (reference
//   src/repro/netsim/engine.py::decide) for N given (hash key, pair): the
//   same candidate_lane and choose, the view read at sig_step (the failover
//   passes t - 1, which may be -1), out (k_idx, chosen path), -1 where no
//   candidate is valid. Its callers are the failover at a trip step (all
//   flows) and the re-decision epoch (salted keys).
//
// The law of a decision is RouteArgs.policy, or, when pair_policy is set (a
// merged sweep world: netsim/engine.py::merge_cells), the code of the
// decision's pair, read once per warp (law_of): one warp decides one
// arrival, so the dispatch stays warp-uniform with the laws mixed across
// warps, and each decision is its cell's own law, as the reference's
// sweep-mode decide gathers it.
//
// choose is the one law dispatch of all three engine entries, bit for bit
// the reference's decide._choice over a warp's <= 8 candidate lanes:
//   lcmp, lcmp_r  the LCMP decision above (lcmp_choose);
//   lcmp_w        the same kept prefix, the stage-2 pick weighted by
//                 path_cap_gbps in rank order (max(w, 1) inside the prefix,
//                 0 outside): the count of cumulative weights <=
//                 int32(fmix32(fid) >> 1) % total, then the same fallback;
//   ecmp, amp     the fmix32(fid) % m-th valid slot in slot order;
//   ucmp          cost 1000000 / max(cap, 1) (1<<30 when invalid), the first
//                 least cost over the K slots rotated by fmix32(fid) % K;
//   wcmp, redte   weighted hash over slot order, weights path_cap_gbps or
//                 the pair's redte_w row, max(w, 1) where valid and 0
//                 elsewhere; -1 when the total is 0;
//   fatpaths      ecmp over the valid candidates of least path_len, or over
//                 all valid ones when each of those has C_cong >=
//                 cong_fallback;
//   matchrdma     avail = int32(min(bneck * (256 - C_cong), 1e9)) with bneck
//                 the least effective span capacity (link_cap_gbps x the
//                 degrade factor from link_deg_step on, float32, unfused
//                 multiplies), then the first least -avail under ucmp's
//                 rotation.
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
// one warp per arrival slot (per decision, in decide) with its lanes over
// the candidates, so the K chains run side by side; the lanes' values meet
// by warp shuffles; the chosen path's hops are read one per lane and one
// lane adds them in hop order and stores the eight fields. Everything fixed
// for a run sits in one struct that the host builds once, and the step's
// queue and eight field pointers in a second, which the host rewrites only
// where a tensor changed, so a launch passes two struct pointers, t and the
// stream.
#include <cuda_runtime.h>
#include <stdint.h>

#define P_MAX 8
#define H_MAX 8
#define COST_INVALID (1 << 24)
#define BIG (1 << 30)
#define SCORE_MAX 255
#define THREADS 128
#define WARPS (THREADS / 32)
#define FULL 0xFFFFFFFFu
// policy codes of netsim/engine.py::POLICY_CODES
#define POLICY_LCMP 0
#define POLICY_LCMP_W 1
#define POLICY_ECMP 2
#define POLICY_UCMP 3
#define POLICY_WCMP 4
#define POLICY_REDTE 5
#define POLICY_FATPATHS 6
#define POLICY_AMP 7
#define POLICY_LCMP_R 8
#define POLICY_MATCHRDMA 9

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

// Batcher odd-even mergesort network for 8 keys (19 comparators).
__device__ __forceinline__ void sort8(int (&key)[P_MAX]) {
  cmpx(key[0], key[1]); cmpx(key[2], key[3]); cmpx(key[4], key[5]); cmpx(key[6], key[7]);
  cmpx(key[0], key[2]); cmpx(key[1], key[3]); cmpx(key[4], key[6]); cmpx(key[5], key[7]);
  cmpx(key[1], key[2]); cmpx(key[5], key[6]);
  cmpx(key[0], key[4]); cmpx(key[1], key[5]); cmpx(key[2], key[6]); cmpx(key[3], key[7]);
  cmpx(key[2], key[4]); cmpx(key[3], key[5]);
  cmpx(key[1], key[2]); cmpx(key[3], key[4]); cmpx(key[5], key[6]);
}

// key[pick] with pick a runtime rank, without indexing the array by it
__device__ __forceinline__ int key_at(const int (&key)[P_MAX], int pick) {
  int picked = key[0];
#pragma unroll
  for (int i = 1; i < P_MAX; ++i) picked = (pick == i) ? key[i] : picked;
  return picked;
}

// The LCMP decision over 8 keys cost*8 + slot (distinct, so the order is
// total): the candidate slot, or -1 when num_valid is 0.
__device__ __forceinline__ int lcmp_choose(int (&key)[P_MAX], int num_valid,
                                           int min_cong, uint32_t fid,
                                           int keep_num, int cong_fallback) {
  sort8(key);
  const int keep = max((num_valid + keep_num - 1) / keep_num, 1);
  int pick = (int)(fmix32(fid) % (uint32_t)keep);
  if (min_cong >= cong_fallback) pick = 0;
  return num_valid > 0 ? (key_at(key, pick) & (P_MAX - 1)) : -1;
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

// The least of v over lanes 0-7, in every lane (lanes 8-31 mix only among
// themselves, and lane 0's value is broadcast).
__device__ __forceinline__ int min8(int v) {
#pragma unroll
  for (int off = P_MAX / 2; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(FULL, v, off));
  return __shfl_sync(FULL, v, 0);
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
  const int* path_cap_gbps;     // (NP,)
  const int* path_len;          // (NP,) hops
  const int* link_cap_gbps;     // (L,)
  const int* link_deg_step;     // (L,) degrade onset step
  const float* link_deg_factor; // (L,)
  const int* redte_w;           // (NPAIR, K) split weights
  const int* pair_policy;       // (NPAIR,) law code per pair, or null
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

// What one lane knows of its candidate (lane k < K: slot k of the pair).
struct Lane {
  int cand;      // path index, -1 for a pad slot or a lane past K
  bool valid;    // the candidate exists and every hop is alive
  int cc;        // the delayed congestion view (laws that read it)
  float bneck;   // matchrdma: the least effective span capacity
};

// The law of a decision for pair `pair` (the same in every lane of a warp).
__device__ __forceinline__ int law_of(const RouteArgs& a, int pair) {
  return a.pair_policy != nullptr ? a.pair_policy[pair] : a.policy;
}

__device__ __forceinline__ bool reads_view(int policy) {
  return policy == POLICY_LCMP || policy == POLICY_LCMP_W ||
         policy == POLICY_LCMP_R || policy == POLICY_FATPATHS ||
         policy == POLICY_MATCHRDMA;
}

// Lane `lane`'s candidate of pair `pair`: hop liveness, the view at ring
// step sig_step when law `law` reads it, and for matchrdma the bottleneck
// at step t.
__device__ __forceinline__ Lane candidate_lane(const RouteArgs& a, int law,
                                               int pair, int lane, int t,
                                               int sig_step) {
  Lane l;
  l.cand = lane < a.K ? a.pair_cand[(long long)pair * a.K + lane] : -1;
  l.valid = l.cand >= 0;
  l.cc = 0;
  l.bneck = 1e9f;
  if (l.cand < 0) return l;
  int link[H_MAX];
#pragma unroll
  for (int h = 0; h < H_MAX; ++h)
    link[h] = h < a.H ? a.path_links[(long long)l.cand * a.H + h] : -1;
  const bool view = reads_view(law);
  const int ring = (int)a.hist_len;
  int cc = -2147483647 - 1;
#pragma unroll
  for (int h = 0; h < H_MAX; ++h) {
    if (h < a.H && link[h] >= 0) {
      l.valid = l.valid && a.link_alive[link[h]] != 0;
      if (view) {
        const int sd = a.path_sig[(long long)l.cand * a.H + h];
        const int slot = ((sig_step - sd) % ring + ring) % ring;   // floored
        cc = max(cc, a.hist_c[(long long)link[h] * a.hist_len + slot]);
      }
      if (law == POLICY_MATCHRDMA) {
        const float fac = t >= a.link_deg_step[link[h]] ? a.link_deg_factor[link[h]]
                                                        : 1.0f;
        l.bneck = fminf(l.bneck, __fmul_rn((float)a.link_cap_gbps[link[h]], fac));
      }
    } else if (h < a.H) {
      cc = max(cc, 0);                           // a pad hop reads as 0
    }
  }
  l.cc = cc;
  return l;
}

// The first least cost over the K slots rotated by rot (-1 when no slot is
// valid): the reference's argmin over the rotated candidates.
__device__ __forceinline__ int rotated_argmin(int cost, int K, uint32_t rot,
                                              uint32_t vmask) {
  int best = 2147483647, choice = -1;
  for (int j = 0; j < K; ++j) {
    const int idx = (int)(((uint32_t)j + rot) % (uint32_t)K);
    const int c = __shfl_sync(FULL, cost, idx);
    if (c < best) {
      best = c;
      choice = idx;
    }
  }
  return vmask ? choice : -1;
}

// Weighted hash over slot order: the count of cumulative weights <=
// int32(fmix32(fid) >> 1) % total (zero-weight slots count too), -1 when
// the total is 0. w is this lane's weight, 0 past K.
__device__ __forceinline__ int weighted_hash(int w, int K, uint32_t fid) {
  int total = 0;
  for (int i = 0; i < K; ++i) total += __shfl_sync(FULL, w, i);
  if (total <= 0) return -1;
  const int h = (int)(fmix32(fid) >> 1) % total;
  int cum = 0, count = 0;
  for (int i = 0; i < K; ++i) {
    cum += __shfl_sync(FULL, w, i);
    count += cum <= h;
  }
  return count;
}

// The law dispatch: the candidate slot law `law` picks (-1 when none is
// valid), the same in every lane. Every lane of the warp calls it, with its
// own candidate in l; the branch is the same for the whole warp.
__device__ int choose(const RouteArgs& a, int law, const Lane& l, int lane,
                      int pair, uint32_t fid) {
  const uint32_t vmask = __ballot_sync(FULL, l.valid);
  const int num_valid = __popc(vmask);
  const int capg = l.cand >= 0 ? a.path_cap_gbps[l.cand] : 0;
  switch (law) {
    case POLICY_LCMP:
    case POLICY_LCMP_R:
    case POLICY_LCMP_W: {
      const int cost = l.valid ? a.alpha * a.c_path[l.cand] + a.beta * l.cc
                               : COST_INVALID;
      int key[P_MAX];
#pragma unroll
      for (int i = 0; i < P_MAX; ++i)
        key[i] = __shfl_sync(FULL, cost * P_MAX + lane, i);
      const int mc = min8(l.valid ? l.cc : SCORE_MAX + 1);  // least valid C_cong
      if (law != POLICY_LCMP_W)
        return lcmp_choose(key, num_valid, mc, fid, a.keep_num, a.cong_fallback);
      sort8(key);
      const int keep = max((num_valid + a.keep_num - 1) / a.keep_num, 1);
      int w[P_MAX];
      int total = 0;
#pragma unroll
      for (int r = 0; r < P_MAX; ++r) {   // the weights in rank order
        const int wr = __shfl_sync(FULL, capg, key[r] & (P_MAX - 1));
        w[r] = r < keep ? max(wr, 1) : 0;
        total += w[r];
      }
      const int hv = (int)(fmix32(fid) >> 1) % max(total, 1);
      int pick = 0, cum = 0;
#pragma unroll
      for (int r = 0; r < P_MAX; ++r) {
        cum += w[r];
        pick += cum <= hv;
      }
      if (mc >= a.cong_fallback) pick = 0;
      return num_valid > 0 ? (key_at(key, pick) & (P_MAX - 1)) : -1;
    }
    case POLICY_ECMP:
    case POLICY_AMP:
      return ecmp_choose(vmask, fid);
    case POLICY_UCMP: {
      const int cost = l.valid ? 1000000 / max(capg, 1) : BIG;
      return rotated_argmin(cost, a.K, fmix32(fid) % (uint32_t)a.K, vmask);
    }
    case POLICY_MATCHRDMA: {
      const float avail = __fmul_rn(l.bneck, (float)(256 - l.cc));
      const int cost = l.valid ? -(int)fminf(avail, 1e9f) : BIG;
      return rotated_argmin(cost, a.K, fmix32(fid) % (uint32_t)a.K, vmask);
    }
    case POLICY_WCMP:
      return weighted_hash(l.valid ? max(capg, 1) : 0, a.K, fid);
    case POLICY_REDTE: {
      const int w = l.valid ? a.redte_w[(long long)pair * a.K + lane] : 0;
      return weighted_hash(l.valid ? max(w, 1) : 0, a.K, fid);
    }
    case POLICY_FATPATHS: {
      const int plen = l.valid ? a.path_len[l.cand] : BIG;
      const int minlen = min8(plen);
      const bool layer0 = l.valid && plen == minlen;
      const bool spill = min8(layer0 ? l.cc : BIG) >= a.cong_fallback;
      return ecmp_choose(__ballot_sync(FULL, spill ? l.valid : layer0), fid);
    }
    default:
      return -1;
  }
}

__global__ void __launch_bounds__(THREADS) route_arrivals_kernel(
    const RouteArgs a, const StepTensors o, int t) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= a.A) return;                          // the whole warp leaves
  const int f = a.arrivals[(long long)t * a.A + s];
  if (f < 0) return;                             // a pad: nothing written
  const int pair = a.f_pair[f];
  const uint32_t fid = (uint32_t)a.f_id[f];

  const int law = law_of(a, pair);
  const Lane l = candidate_lane(a, law, pair, lane, t, t);
  const int kidx = choose(a, law, l, lane, pair, fid);
  if (kidx < 0) return;                          // no valid candidate
  const int path = __shfl_sync(FULL, l.cand, kidx);

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

__global__ void __launch_bounds__(THREADS) decide_kernel(
    const RouteArgs a, int N, const long long* __restrict__ fids,
    const int* __restrict__ pairs, int* __restrict__ k_out,
    int* __restrict__ path_out, int t, int sig_step) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= N) return;                            // the whole warp leaves
  const int pair = pairs[i];
  const int law = law_of(a, pair);
  const Lane l = candidate_lane(a, law, pair, lane, t, sig_step);
  const int kidx = choose(a, law, l, lane, pair, (uint32_t)fids[i]);
  const int path = __shfl_sync(FULL, l.cand, max(kidx, 0));
  if (lane != 0) return;
  k_out[i] = kidx;
  path_out[i] = kidx >= 0 ? path : -1;
}

extern "C" int decide_launch(const RouteArgs* args, int N, const void* fids,
                             const void* pairs, void* k_out, void* path_out,
                             int t, int sig_step, void* stream) {
  const int blocks = (N + WARPS - 1) / WARPS;
  decide_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      *args, N, (const long long*)fids, (const int*)pairs, (int*)k_out,
      (int*)path_out, t, sig_step);
  return (int)cudaGetLastError();
}
