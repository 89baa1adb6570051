// Batched path decisions (paper §3.4 and the baselines of §6.1), for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lcmp_decide.py::lcmp_decide
// (body _decide_kernel). Per flow: cost = alpha*C_path + beta*C_cong with
// invalid slots at 1<<24; keys cost*8 + slot sorted by the 19-comparator
// Batcher odd-even network; keep ceil(m/keep_num) of the m valid candidates;
// pick rank fmix32(flow_id) % keep; rank 0 when the least valid C_cong is at
// or above cong_fallback; -1 when no candidate is valid. Four entries:
//
// - lcmp_decide_launch keeps the TPU kernel's contract: per-flow candidate
//   scores in, the candidate index out. One thread owns one flow and keeps
//   its <= 8 keys in registers (the network's indices are compile-time
//   constants, so the array never touches local memory).
//
// - switch_route_launch is the switch's whole batch of arrivals
//   (core/switchd.py::route_batch: flow-cache lookup with lazy failover,
//   refresh, the LCMP decision over the switch's <= 8 candidates, insert)
//   in two kernels, writing the cache in place. Every arrival of a batch
//   sees the same candidates, so the first kernel builds the switch's one
//   LCMP record per block (lcmp_header) where the TPU contract sorts the
//   same row once per flow; see switch_probe_kernel and
//   switch_commit_kernel at the end of this file.
//
// - route_arrivals_launch is the fluid engine's whole arrival routing for
//   one step (netsim/engine.py::_route_arrivals, reference
//   src/repro/netsim/engine.py::_route_arrivals) in one launch. For each
//   slot of arrivals[t]: the flow (pads are -1), its pair and hash key, the
//   pair's <= 8 candidates; per candidate (candidate_lane), hop liveness
//   and, for the laws that read it, the delayed congestion view of
//   path_cong_view (the max over hops of hist_c[link, (t - sig_delay) mod
//   HIST], the modulo floored so the negative offsets of early steps wrap
//   to the ring's end); the law (pair_record, then pick); then for a routed
//   flow the standing-queue wait, summed hop by hop in hop order with IEEE
//   division, and rtt = max(2*path_prop // dt, 1), and IN-PLACE writes of
//   the flow's eight fields (flow_path, remaining, rate, cc_target, active,
//   extra_wait, rtt_steps, route_step). Pads and flows with no valid
//   candidate write nothing, as the reference's drop-mode scatter, so a pad
//   can never overwrite a real flow 0.
//
// - decide_launch is netsim/engine.py::decide (reference
//   src/repro/netsim/engine.py::decide) for N given (hash key, pair), the
//   view read at sig_step (the failover passes t - 1, which may be -1), out
//   (k_idx, chosen path), -1 where no candidate is valid. Its callers are
//   the failover at a trip step (all flows) and the re-decision epoch
//   (salted keys). It is two kernels on the caller's stream: decide_pairs
//   writes one record per pair of the run, decide_pick one decision per
//   thread from its pair's record.
//
// The ten laws (the reference's decide._choice, bit for bit) are written
// once each, in two halves. Every law reads its decision's hash key only
// through fmix32(fid); all else it reads (t, sig_step, the ring,
// link_alive, C_path, capacities, RedTE weights) is the same for every
// decision of one pair in one call. pair_record is the per-pair half over
// a warp's <= 8 candidate lanes: a header sel | n << 24 | law << 28 and up
// to 8 cumulative weights cum. pick is the per-decision half, one thread's
// integer code on that record and fmix32(fid). By law (record; pick):
//   lcmp, lcmp_r  sel the slot order (rank r's slot in bits 3r..3r+2),
//                 n = keep, 1 when the least valid C_cong is at or above
//                 cong_fallback, 0 when m = 0; order[fmix32 % n].
//   lcmp_w        the same sel and n, cum the kept ranks' cumulative
//                 weights max(path_cap_gbps, 1); rank = the count of
//                 cum[r] <= int32(fmix32 >> 1) % cum[n-1] over r < n, then
//                 order[rank] (the fallback is n = 1: rank 0).
//   wcmp, redte   sel the identity order, n = K, cum over slot order of
//                 max(w, 1) where valid and 0 elsewhere (w path_cap_gbps,
//                 or the pair's redte_w row); the same weighted pick, -1
//                 when the total cum[n-1] is <= 0.
//   ecmp, amp     sel the valid mask, n = m; the (fmix32 % n)-th set bit.
//   fatpaths      sel the valid candidates of least path_len, or all valid
//                 ones when each of those has C_cong >= cong_fallback,
//                 n = its popcount; as ecmp.
//   ucmp,         sel the slots of least cost (ucmp 1000000 / max(cap, 1);
//   matchrdma     matchrdma -int32(min(bneck * (256 - C_cong), 1e9)), bneck
//                 the least effective span capacity, link_cap_gbps x the
//                 degrade factor from link_deg_step on, float32, unfused
//                 multiplies; BIG when invalid), n = K; the first set bit
//                 at or after fmix32 % K, cyclically (the reference's first
//                 least cost over the candidates rotated by fmix32 % K).
// Under pair_policy (a merged sweep world: netsim/engine.py::merge_cells)
// each pair's law is its own code, read once per warp (law_of), so the
// dispatch of pair_record stays warp-uniform with the laws mixed across
// warps; pick reads the law from the record.
//
// decide's record table is RouteArgs.records, npair x 16 int32 (64 bytes a
// pair, 64-byte aligned), which the host launcher allocates once per run.
// Word k < 8 holds slot k's path id (-1 for a pad) in its low 28 bits,
// sign-extended on reading (the host checks that path ids fit), and nibble
// k of the header in its top 4 bits; words 8-15 hold cum[0..7] (0 past n
// and for the unweighted laws). Lanes 0-15 of a warp store a record in one
// 64-byte write; stage 2 reads words 0-7 (one 32-byte sector), words 8-15
// only for the weighted laws, and never pair_cand.
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
// chains run side by side; the lanes' values meet by warp shuffles; the
// chosen path's hops are read one per lane and one lane adds them in hop
// order and stores the eight fields.
//
// decide must move each pair's candidate bytes once and 16 bytes a decision
// (an 8-byte key, the pair, two 4-byte results): 18 MB for 2^20 decisions
// over 4096 pairs, 5.5 us at 3.35 TB/s. At the main path's 16,745-50,100
// decisions over 42-840 pairs it is under 1 MB, and two launches and stage
// 1's dependent loads bound it. Stage 1 takes the route's layout, one warp
// per pair. Stage 2 takes one thread per decision: the decisions are
// independent and 10^4-10^6 a call, so the key, pair and result accesses
// coalesce and each decision costs one record read from L2 (4096 records
// are 256 KB; a world with few pairs reads the same lines, which L1
// holds) and a few dozen integer operations. (A warp per decision, the
// layout before, left 24 of 32 lanes idle and redid the pair's K x H
// gathers, sort and weights for every decision.)
//
// switch_route must move per arrival its 8-byte id, 5 bytes of results and
// its slot's 13 cache bytes, and write back what changed (4 bytes on a hit,
// 17 on an insert): under 200 KB for a batch of 4096, some 0.05 us at
// 3.35 TB/s, so two launches bound it. The cache (65,536 slots x 17 bytes)
// stays in the 50 MB L2 between batches; the probes are random 1-8 byte
// gathers, so neither TMA nor wgmma applies, and the per-lane id, choice and
// flag accesses coalesce. The commit needs a second launch because a slot's
// winner is the last bidding lane of the whole batch, known only when every
// block has bid.
//
// Everything fixed for a run sits in one struct that the host builds once,
// and the step's queue and eight field pointers in a second, which the host
// rewrites only where a tensor changed, so a launch passes two struct
// pointers, t and the stream.
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

// The LCMP law's record header (see the note at the top) from 8 keys
// cost*8 + slot (distinct, so the order is total) of m valid candidates
// whose least C_cong is min_cong: sel the slot order, rank r's slot in bits
// 3r..3r+2; n = keep = ceil(m / keep_num), 1 when min_cong is at or above
// cong_fallback, 0 when m = 0; sel | n << 24 | law << 28. Sorts key.
__device__ __forceinline__ uint32_t lcmp_header(int (&key)[P_MAX], int m,
                                                int min_cong, int keep_num,
                                                int cong_fallback, int law) {
  sort8(key);
  uint32_t sel = 0;
#pragma unroll
  for (int r = 0; r < P_MAX; ++r)
    sel |= (uint32_t)(key[r] & (P_MAX - 1)) << (3 * r);
  const int keep = max((m + keep_num - 1) / keep_num, 1);
  const int n = m == 0 ? 0 : (min_cong >= cong_fallback ? 1 : keep);
  return sel | ((uint32_t)n << 24) | ((uint32_t)law << 28);
}

// The LCMP law's pick from its header and the hashed key hv = fmix32(fid):
// the slot of rank hv % n, -1 when n is 0.
__device__ __forceinline__ int lcmp_pick(uint32_t hdr, uint32_t hv) {
  const uint32_t n = (hdr >> 24) & 15u;
  return n > 0 ? (int)((hdr >> (3 * (hv % n))) & 7u) : -1;
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
  out[f] = lcmp_pick(lcmp_header(key, num_valid, min_cong, keep_num,
                                 cong_fallback, POLICY_LCMP),
                     fmix32((uint32_t)flow_ids[f]));
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
  int* records;                 // (npair, RECORD_WORDS) decide's table
  int npair;
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

#define RECORD_WORDS 16
#define PICK_THREADS 256
#define IDENTITY_ORDER 0xFAC688u  // rank r -> slot r, 3 bits a rank
#define PATH_BITS 28              // a table word: path id low, header nibble high

// What one lane knows of its candidate (lane k < K: slot k of the pair).
struct Lane {
  int cand;      // path index, -1 for a pad slot or a lane past K
  bool valid;    // the candidate exists and every hop is alive
  int cc;        // the delayed congestion view (laws that read it)
  float bneck;   // matchrdma: the least effective span capacity
};

// A pair's record as one thread holds it for pick: the header and cum.
struct Record {
  uint32_t hdr;      // sel (bits 0-23) | n << 24 | law << 28
  int cum[P_MAX];    // cumulative weights, 0 past n and for unweighted laws
};

// A pair's record as pair_record leaves it in a warp: the header in every
// lane, cum[lane] in lanes 0-7.
struct PairRec {
  uint32_t hdr;
  int cum;
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

__device__ __forceinline__ bool weighted(int law) {
  return law == POLICY_LCMP_W || law == POLICY_WCMP || law == POLICY_REDTE;
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

// Inclusive prefix sum over lanes 0-7 (and within each later group of 8).
__device__ __forceinline__ int scan8(int v, int lane) {
#pragma unroll
  for (int d = 1; d < P_MAX; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d, P_MAX);
    if ((lane & (P_MAX - 1)) >= d) v += u;
  }
  return v;
}

// The per-pair half of law `law` (see the note at the top). Every lane of
// the warp calls it, with its own candidate in l; the branch is the same
// for the whole warp. A code outside the ten gives n = 0: every pick -1.
__device__ PairRec pair_record(const RouteArgs& a, int law, const Lane& l,
                               int lane, int pair) {
  const uint32_t vmask = __ballot_sync(FULL, l.valid);
  const int m = __popc(vmask);
  const int capg = l.cand >= 0 ? a.path_cap_gbps[l.cand] : 0;
  uint32_t sel = 0;
  int n = 0, w = 0;                 // w: this lane's weight, weighted laws
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
      const uint32_t hdr = lcmp_header(key, m, mc, a.keep_num, a.cong_fallback,
                                       law);
      sel = hdr & 0xFFFFFFu;
      n = (int)((hdr >> 24) & 15u);
      if (law == POLICY_LCMP_W) {   // rank `lane`'s weight; kept ranks are valid
        const int wr = __shfl_sync(FULL, capg, (sel >> (3 * (lane & 7))) & 7);
        w = lane < n ? max(wr, 1) : 0;
      }
      break;
    }
    case POLICY_ECMP:
    case POLICY_AMP:
      sel = vmask;
      n = m;
      break;
    case POLICY_UCMP:
    case POLICY_MATCHRDMA: {
      int cost = BIG;
      if (law == POLICY_UCMP) {
        if (l.valid) cost = 1000000 / max(capg, 1);
      } else {
        const float avail = __fmul_rn(l.bneck, (float)(256 - l.cc));
        if (l.valid) cost = -(int)fminf(avail, 1e9f);
      }
      const int least = min8(cost);
      sel = __ballot_sync(FULL, l.valid && cost == least);
      n = a.K;
      break;
    }
    case POLICY_WCMP:
    case POLICY_REDTE: {
      const int x = law == POLICY_WCMP ? capg
                    : (l.valid ? a.redte_w[(long long)pair * a.K + lane] : 0);
      w = l.valid ? max(x, 1) : 0;
      sel = IDENTITY_ORDER;
      n = a.K;
      break;
    }
    case POLICY_FATPATHS: {
      const int plen = l.valid ? a.path_len[l.cand] : BIG;
      const int minlen = min8(plen);
      const bool layer0 = l.valid && plen == minlen;
      const bool spill = min8(layer0 ? l.cc : BIG) >= a.cong_fallback;
      sel = __ballot_sync(FULL, spill ? l.valid : layer0);
      n = __popc(sel);
      break;
    }
    default:
      break;
  }
  PairRec r;
  r.hdr = sel | ((uint32_t)n << 24) | ((uint32_t)law << 28);
  r.cum = 0;
  if (weighted(law)) {               // the same branch in every lane
    const int cum = scan8(w, lane);
    r.cum = lane < n ? cum : 0;
  }
  return r;
}

// The per-decision half: the candidate slot of a decision with hash key
// fid under its pair's record (-1 when none is valid). One thread's
// integer code; runtime indices go through selects, never local memory.
__device__ __forceinline__ int pick(const Record& r, uint32_t fid) {
  const int law = (int)(r.hdr >> 28);
  const int n = (int)((r.hdr >> 24) & 15u);
  const uint32_t sel = r.hdr & 0xFFFFFFu;
  const uint32_t hv = fmix32(fid);
  switch (law) {
    case POLICY_LCMP:
    case POLICY_LCMP_R:
      return lcmp_pick(r.hdr, hv);
    case POLICY_LCMP_W:
    case POLICY_WCMP:
    case POLICY_REDTE: {
      int total = r.cum[0];
#pragma unroll
      for (int i = 1; i < P_MAX; ++i) total = (i == n - 1) ? r.cum[i] : total;
      if (n == 0 || total <= 0) return -1;
      const int h = (int)(hv >> 1) % total;
      int rank = 0;
#pragma unroll
      for (int i = 0; i < P_MAX; ++i) rank += (i < n && r.cum[i] <= h);
      return (int)((sel >> (3 * rank)) & 7u);
    }
    case POLICY_ECMP:
    case POLICY_AMP:
    case POLICY_FATPATHS: {
      if (n == 0) return -1;
      uint32_t mk = sel;
      for (uint32_t k = hv % (uint32_t)n; k > 0; --k) mk &= mk - 1;
      return __ffs(mk) - 1;
    }
    case POLICY_UCMP:
    case POLICY_MATCHRDMA: {
      if (sel == 0) return -1;
      const uint32_t hi = sel & (0xFFFFFFFFu << (hv % (uint32_t)n));
      return __ffs(hi ? hi : sel) - 1;
    }
    default:
      return -1;
  }
}

// A warp's record in every lane, for pick (cum only where the law reads it).
__device__ __forceinline__ Record warp_record(const PairRec& p) {
  Record r;
  r.hdr = p.hdr;
  const bool wt = weighted((int)(p.hdr >> 28));
#pragma unroll
  for (int i = 0; i < P_MAX; ++i) r.cum[i] = wt ? __shfl_sync(FULL, p.cum, i) : 0;
  return r;
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
  const int kidx = pick(warp_record(pair_record(a, law, l, lane, pair)), fid);
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

// decide's stage 1: one warp per pair writes the pair's record (lanes 0-7
// the path words with the header's nibbles, lanes 8-15 the weights).
__global__ void __launch_bounds__(THREADS) decide_pairs_kernel(
    const RouteArgs a, int t, int sig_step) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pair >= a.npair) return;                   // the whole warp leaves
  const int law = law_of(a, pair);
  const Lane l = candidate_lane(a, law, pair, lane, t, sig_step);
  const PairRec r = pair_record(a, law, l, lane, pair);
  const int cum = __shfl_sync(FULL, r.cum, lane & (P_MAX - 1));
  int* rec = a.records + (long long)pair * RECORD_WORDS;
  if (lane < P_MAX)
    rec[lane] = (int)(((uint32_t)l.cand & ((1u << PATH_BITS) - 1)) |
                      (((r.hdr >> (4 * lane)) & 15u) << PATH_BITS));
  else if (lane < RECORD_WORDS)
    rec[lane] = cum;
}

// decide's stage 2: one thread per decision, from its pair's record.
__global__ void __launch_bounds__(PICK_THREADS) decide_pick_kernel(
    const int4* __restrict__ records, int N, const long long* __restrict__ fids,
    const int* __restrict__ pairs, int* __restrict__ k_out,
    int* __restrict__ path_out) {
  const int i = blockIdx.x * PICK_THREADS + threadIdx.x;
  if (i >= N) return;
  const int4* rp = records + (long long)pairs[i] * (RECORD_WORDS / 4);
  const int4 lo = rp[0], hi = rp[1];
  const int word[P_MAX] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  Record r;
  r.hdr = 0;
#pragma unroll
  for (int k = 0; k < P_MAX; ++k)
    r.hdr |= ((uint32_t)word[k] >> PATH_BITS) << (4 * k);
  if (weighted((int)(r.hdr >> 28))) {
    const int4 c0 = rp[2], c1 = rp[3];
    r.cum[0] = c0.x; r.cum[1] = c0.y; r.cum[2] = c0.z; r.cum[3] = c0.w;
    r.cum[4] = c1.x; r.cum[5] = c1.y; r.cum[6] = c1.z; r.cum[7] = c1.w;
  } else {
#pragma unroll
    for (int k = 0; k < P_MAX; ++k) r.cum[k] = 0;
  }
  const int kidx = pick(r, (uint32_t)fids[i]);
  int path = -1;
#pragma unroll
  for (int k = 0; k < P_MAX; ++k)   // the low bits, sign-extended
    path = kidx == k ? (int)((uint32_t)word[k] << (32 - PATH_BITS)) >> (32 - PATH_BITS)
                     : path;
  k_out[i] = kidx;
  path_out[i] = path;
}

extern "C" int decide_pairs_launch(const RouteArgs* args, int t, int sig_step,
                                   void* stream) {
  const int blocks = (args->npair + WARPS - 1) / WARPS;
  decide_pairs_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      *args, t, sig_step);
  return (int)cudaGetLastError();
}

extern "C" int decide_pick_launch(const RouteArgs* args, int N,
                                  const void* fids, const void* pairs,
                                  void* k_out, void* path_out, void* stream) {
  const int blocks = (N + PICK_THREADS - 1) / PICK_THREADS;
  decide_pick_kernel<<<blocks, PICK_THREADS, 0, (cudaStream_t)stream>>>(
      (const int4*)args->records, N, (const long long*)fids,
      (const int*)pairs, (int*)k_out, (int*)path_out);
  return (int)cudaGetLastError();
}

extern "C" int decide_launch(const RouteArgs* args, int N, const void* fids,
                             const void* pairs, void* k_out, void* path_out,
                             int t, int sig_step, void* stream) {
  const int err = decide_pairs_launch(args, t, sig_step, stream);
  if (err != 0) return err;
  return decide_pick_launch(args, N, fids, pairs, k_out, path_out, stream);
}

// Fixed for a switch (core/switchd.py); its layout is mirrored by
// kernels/lcmp_decide.py::_SwitchArgs. The switch's state is updated in
// place, so these pointers stay valid for the switch's life.
struct SwitchArgs {
  const int* c_path;                // (P,) installed C_path of each candidate
  const int* cand_port;             // (P,) egress port of each candidate
  const unsigned char* cand_valid;  // (P,) bool: candidate installed
  const int* c_cong;                // (num_ports,) C_cong of the registers
  const unsigned char* port_alive;  // (num_ports,) bool
  long long* flow_id;               // (C,) the flow cache: key, uint32 values
  int* out_idx;                     // (C,) cached candidate index
  int* last_seen;                   // (C,) us
  unsigned char* valid;             // (C,) bool
  int* win;                         // (C,) scratch: -1 between batches
  int capacity;                     // C
  int P, alpha, beta, keep_num, cong_fallback;
};

#define SWITCH_THREADS 128

// switch_route's first kernel, probe and decide: one thread per arrival.
// Thread 0 builds the switch's one LCMP record (every arrival sees the same
// candidates) into shared memory while every thread probes the cache for
// its flow, so the record's loads and the probes are in flight together.
// A lane hits when its slot is valid, holds its key and its cached
// candidate is installed on a live port (lazy failover); otherwise it takes
// the fresh pick. A hit refreshes last_seen (every hit on a slot stores the
// same time); a miss with a fresh decision bids for its slot with
// atomicMax(win, lane). Nothing else of the cache is written, so every
// lane probes the cache as it was before the batch.
__global__ void __launch_bounds__(SWITCH_THREADS) switch_probe_kernel(
    const SwitchArgs a, int F, const long long* __restrict__ flow_ids,
    int* __restrict__ choice, unsigned char* __restrict__ is_new, int now_us) {
  __shared__ uint32_t s_hdr;
  __shared__ uint32_t s_alive;      // bit k: candidate k installed and alive
  const int i = blockIdx.x * SWITCH_THREADS + threadIdx.x;
  uint32_t hv = 0, slot = 0;
  bool key_ok = false;
  int out = -1;
  if (i < F) {
    const uint32_t fid = (uint32_t)flow_ids[i];
    hv = fmix32(fid);               // the cache slot and the pick both read it
    slot = hv % (uint32_t)a.capacity;
    key_ok = a.valid[slot] != 0 && a.flow_id[slot] == (long long)fid;
    out = a.out_idx[slot];
  }
  if (threadIdx.x == 0) {
    int key[P_MAX];
    int m = 0, min_cong = SCORE_MAX + 1;
    uint32_t alive = 0;
    // every load issued unconditionally: two dependent rounds (the
    // candidates, then their ports) for all candidates at once
    int cc[P_MAX];
    bool ok[P_MAX];
#pragma unroll
    for (int k = 0; k < P_MAX; ++k) {
      if (k < a.P) {
        const int port = a.cand_port[k];
        ok[k] = a.cand_valid[k] && a.port_alive[port];
        cc[k] = a.c_cong[port];
        key[k] = a.c_path[k];
      } else {
        ok[k] = false;
        cc[k] = key[k] = 0;
      }
    }
#pragma unroll
    for (int k = 0; k < P_MAX; ++k) {
      const int cost = ok[k] ? a.alpha * key[k] + a.beta * cc[k] : COST_INVALID;
      m += ok[k] ? 1 : 0;
      min_cong = ok[k] ? min(min_cong, cc[k]) : min_cong;
      alive |= ok[k] ? 1u << k : 0u;
      key[k] = cost * P_MAX + k;    // the slot in the low bits breaks ties
    }
    s_hdr = lcmp_header(key, m, min_cong, a.keep_num, a.cong_fallback,
                        POLICY_LCMP);
    s_alive = alive;
  }
  __syncthreads();
  if (i >= F) return;
  const int o = max(out, 0);        // flowcache.lookup reads alive[max(out, 0)]
  const bool hit = key_ok && o < P_MAX && ((s_alive >> o) & 1u);
  const int fresh = lcmp_pick(s_hdr, hv);
  choice[i] = hit ? out : fresh;
  is_new[i] = hit ? 0 : 1;
  if (hit)
    a.last_seen[slot] = now_us;
  else if (fresh >= 0)
    atomicMax(&a.win[slot], i);
}

// switch_route's second kernel, commit: the last bidding lane of each slot
// writes its entry and puts the slot's bid back to -1. A lane reads its
// slot's bid once; the winner's reset can only turn another lane's read
// into -1, which matches no lane.
__global__ void __launch_bounds__(SWITCH_THREADS) switch_commit_kernel(
    const SwitchArgs a, int F, const long long* __restrict__ flow_ids,
    const int* __restrict__ choice, const unsigned char* __restrict__ is_new,
    int now_us) {
  const int i = blockIdx.x * SWITCH_THREADS + threadIdx.x;
  if (i >= F) return;
  const bool bid = is_new[i] != 0;      // both loads in flight together
  const uint32_t fid = (uint32_t)flow_ids[i];
  if (!bid) return;
  const uint32_t slot = fmix32(fid) % (uint32_t)a.capacity;
  if (a.win[slot] != i) return;
  a.flow_id[slot] = (long long)fid;
  a.out_idx[slot] = choice[i];
  a.last_seen[slot] = now_us;
  a.valid[slot] = 1;
  a.win[slot] = -1;
}

extern "C" int switch_route_launch(const SwitchArgs* args, int F,
                                   const void* flow_ids, void* choice,
                                   void* is_new, int now_us, void* stream) {
  const int blocks = (F + SWITCH_THREADS - 1) / SWITCH_THREADS;
  switch_probe_kernel<<<blocks, SWITCH_THREADS, 0, (cudaStream_t)stream>>>(
      *args, F, (const long long*)flow_ids, (int*)choice,
      (unsigned char*)is_new, now_us);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  switch_commit_kernel<<<blocks, SWITCH_THREADS, 0, (cudaStream_t)stream>>>(
      *args, F, (const long long*)flow_ids, (const int*)choice,
      (const unsigned char*)is_new, now_us);
  return (int)cudaGetLastError();
}
