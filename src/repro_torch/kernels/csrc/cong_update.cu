// One LCMP switch-monitor tick over every port (paper §3.3), for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cong_update.py::cong_update
// (body _cong_kernel): Eq. 3 shift-EWMA of the queue delta, the 15-threshold
// quantization of the queue level (shared q_thresh) and of the trend
// (per-port trend_thresh row), the duration counter, the level_score lookup
// and C_cong = min((w_ql*Q + w_tl*T + w_dp*D) >> s_cong, 255), all int32.
//
// Two entries share that register math (cong_port below):
// - cong_update_launch keeps the TPU kernel's contract: queue depths in
//   cells (int32) in, C_cong out, the hist_c ring slot written when a ring
//   is given;
// - monitor_tick_launch is the fluid engine's whole monitor tick in one
//   launch: it reads the link queues q_bytes (float32) and forms the cells
//   itself as (int)(q / CELL_BYTES), truncated as the engine's
//   `(q_bytes / CELL_BYTES).to(int32)` does, then updates the registers,
//   writes C_cong into the state's persistent c_cong and the hist_c ring
//   slot. CELL_BYTES is 1024, a power of two, so q / 1024 and q * 2^-10
//   are the same exact float (no rounding: only the exponent changes), and
//   the cells equal the plain version's bit for bit whether PyTorch divides
//   or multiplies by the reciprocal.
// Both update CongState IN PLACE (queue_cur, queue_prev, trend, dur_cnt and
// last_sample are overwritten), so no state tensors are allocated per step.
//
// Bound on the H100: bytes. Each port reads 4 values of state and queue
// depth plus its 15-int trend_thresh row and writes 7 ints, some 100 bytes
// for ~60 integer operations, far below the card's operations-per-byte
// balance. At the engine's sizes (24 or 152 ports) a call moves a few KB and
// is bound by launch latency. The design therefore does the least per
// launch: one thread per port, no second pass, the shared 15 q_thresh and 16
// level_score entries staged once per block in shared memory, and every
// pointer and parameter that is fixed for a run passed in one struct that
// the host builds once, so a step passes only the queue pointer, the ring
// slot and the time. At a launch this small, what is left past the launch
// itself is rounds of dependent loads: cong_update_kernel issues each
// port's loads before the block stages the shared tables, so the two
// rounds overlap (monitor_tick_kernel, on the fluid engines' path, keeps
// the order it was measured with).
#include <cuda_runtime.h>

#define NLEV 16
#define SCORE_MAX 255
#define THREADS 128
#define CELL_BYTES 1024

// Fixed for a run; its layout is mirrored by kernels/cong_update.py::_Args.
struct CongArgs {
  int* queue_cur;
  int* queue_prev;
  int* trend;
  int* dur_cnt;
  int* last_sample;
  const int* trend_thresh;  // (n, NLEV - 1)
  const int* q_thresh;      // (NLEV - 1,)
  const int* level_score;   // (NLEV,)
  int* c_cong;              // (n,)
  int* hist_c;              // (n, hist_len) ring, or null
  long long hist_len;
  long long n;
  int high_water, w_ql, w_tl, w_dp, ewma_k, dur_shift, s_cong;
};

// What port i's update reads of its own: its registers and trend_thresh
// row. cong_update_kernel loads it before the block's tables are staged,
// so the two rounds of loads overlap.
struct PortRegs {
  int q_old, t_old, d_old;
  int tth[NLEV - 1];
};

__device__ __forceinline__ PortRegs load_port(const CongArgs& a, long long i) {
  PortRegs r;
  r.q_old = a.queue_cur[i];
  r.t_old = a.trend[i];
  r.d_old = a.dur_cnt[i];
  const int* tth = a.trend_thresh + i * (NLEV - 1);
#pragma unroll
  for (int k = 0; k < NLEV - 1; ++k) r.tth[k] = tth[k];
  return r;
}

// The register update of port i from its queue depth q (cells) and its
// loaded registers r; writes C_cong to c_cong[i] and the ring slot.
__device__ __forceinline__ void cong_port(const CongArgs& a, long long i, int q,
                                          const PortRegs& r, const int* s_qth,
                                          const int* s_lsc, int slot,
                                          int now_us) {
  const int q_old = r.q_old;
  const int t_old = r.t_old;
  const int d_old = r.d_old;

  // Eq. (3): arithmetic shifts on signed ints (the trend goes negative)
  const int tr = t_old - (t_old >> a.ewma_k) + ((q - q_old) >> a.ewma_k);

  int q_level = 0, t_level = 0;
#pragma unroll
  for (int k = 0; k < NLEV - 1; ++k) {
    q_level += (s_qth[k] <= q) ? 1 : 0;
    t_level += (r.tth[k] <= tr) ? 1 : 0;
  }

  const int dur = (q_level >= a.high_water) ? d_old + 1 : (d_old >> 1);
  const int q_score = s_lsc[q_level];
  const int t_score = tr > 0 ? s_lsc[t_level] : 0;
  const int d_score = min(dur >> a.dur_shift, SCORE_MAX);
  const int cc = min((a.w_ql * q_score + a.w_tl * t_score + a.w_dp * d_score)
                         >> a.s_cong,
                     SCORE_MAX);

  a.queue_cur[i] = q;
  a.queue_prev[i] = q_old;
  a.trend[i] = tr;
  a.dur_cnt[i] = dur;
  a.last_sample[i] = now_us;
  a.c_cong[i] = cc;
  if (a.hist_c != nullptr) a.hist_c[i * a.hist_len + slot] = cc;
}

__device__ __forceinline__ void stage_tables(const CongArgs& a, int* s_qth,
                                             int* s_lsc) {
  if (threadIdx.x < NLEV - 1) s_qth[threadIdx.x] = a.q_thresh[threadIdx.x];
  if (threadIdx.x < NLEV) s_lsc[threadIdx.x] = a.level_score[threadIdx.x];
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) cong_update_kernel(
    const CongArgs a, const int* __restrict__ qcells, int slot, int now_us) {
  __shared__ int s_qth[NLEV - 1];
  __shared__ int s_lsc[NLEV];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the port's loads first: in flight while the tables are staged
  PortRegs r;
  int q = 0;
  if (i < a.n) {
    r = load_port(a, i);
    q = qcells[i];
  }
  stage_tables(a, s_qth, s_lsc);
  if (i >= a.n) return;
  cong_port(a, i, q, r, s_qth, s_lsc, slot, now_us);
}

__global__ void __launch_bounds__(THREADS) monitor_tick_kernel(
    const CongArgs a, const float* __restrict__ q_bytes, int slot, int now_us) {
  __shared__ int s_qth[NLEV - 1];
  __shared__ int s_lsc[NLEV];
  stage_tables(a, s_qth, s_lsc);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  // exact: a division by a power of two (see the header); the cast
  // truncates toward zero as PyTorch's float -> int32 conversion does
  const int q = __float2int_rz(__fdiv_rn(q_bytes[i], (float)CELL_BYTES));
  cong_port(a, i, q, load_port(a, i), s_qth, s_lsc, slot, now_us);
}

static int blocks_of(long long n) { return (int)((n + THREADS - 1) / THREADS); }

extern "C" int cong_update_launch(const CongArgs* args, const void* qcells,
                                  int slot, int now_us, void* stream) {
  cong_update_kernel<<<blocks_of(args->n), THREADS, 0, (cudaStream_t)stream>>>(
      *args, (const int*)qcells, slot, now_us);
  return (int)cudaGetLastError();
}

extern "C" int monitor_tick_launch(const CongArgs* args, const void* q_bytes,
                                   int slot, int now_us, void* stream) {
  monitor_tick_kernel<<<blocks_of(args->n), THREADS, 0, (cudaStream_t)stream>>>(
      *args, (const float*)q_bytes, slot, now_us);
  return (int)cudaGetLastError();
}
