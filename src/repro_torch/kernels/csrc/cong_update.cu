// One LCMP switch-monitor tick over every port (paper §3.3), for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cong_update.py::cong_update
// (body _cong_kernel): Eq. 3 shift-EWMA of the queue delta, the 15-threshold
// quantization of the queue level (shared q_thresh) and of the trend
// (per-port trend_thresh row), the duration counter, the level_score lookup
// and C_cong = min((w_ql*Q + w_tl*T + w_dp*D) >> s_cong, 255), all int32.
// It also fuses the ring write of the engine's monitor_tick: C_cong goes to
// hist_c[port * hist_len + slot], the slot already wrapped as t % HIST.
//
// Bound on the H100: bytes. Each port reads 4 ints of state and queue depth
// plus its 15-int trend_thresh row and writes 7 ints, some 100 bytes for ~60
// integer operations, far below the card's operations-per-byte balance. At
// the engine's sizes (24 or 152 ports) the whole call moves a few KB and is
// bound by launch latency. The design therefore does the least per launch:
// one thread per port, no second pass, the shared 15 q_thresh and 16
// level_score entries staged once per block in shared memory, and the
// registers of CongState updated IN PLACE (the tensors passed as queue_cur,
// queue_prev, trend, dur_cnt and last_sample are overwritten) so that no
// state tensors are allocated per step.
#include <cuda_runtime.h>

#define NLEV 16
#define SCORE_MAX 255
#define THREADS 128

__global__ void __launch_bounds__(THREADS) cong_update_kernel(
    int n, int* __restrict__ queue_cur, int* __restrict__ queue_prev,
    int* __restrict__ trend, int* __restrict__ dur_cnt,
    int* __restrict__ last_sample, const int* __restrict__ qcells,
    const int* __restrict__ trend_thresh, const int* __restrict__ q_thresh,
    const int* __restrict__ level_score, int* __restrict__ c_cong,
    int* __restrict__ hist_c, long long hist_len, int slot, int now_us,
    int high_water, int w_ql, int w_tl, int w_dp, int ewma_k, int dur_shift,
    int s_cong) {
  __shared__ int s_qth[NLEV - 1];
  __shared__ int s_lsc[NLEV];
  if (threadIdx.x < NLEV - 1) s_qth[threadIdx.x] = q_thresh[threadIdx.x];
  if (threadIdx.x < NLEV) s_lsc[threadIdx.x] = level_score[threadIdx.x];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const int q_old = queue_cur[i];
  const int t_old = trend[i];
  const int d_old = dur_cnt[i];
  const int q = qcells[i];

  // Eq. (3): arithmetic shifts on signed ints (the trend goes negative)
  const int tr = t_old - (t_old >> ewma_k) + ((q - q_old) >> ewma_k);

  const int* tth = trend_thresh + (long long)i * (NLEV - 1);
  int q_level = 0, t_level = 0;
#pragma unroll
  for (int k = 0; k < NLEV - 1; ++k) {
    q_level += (s_qth[k] <= q) ? 1 : 0;
    t_level += (tth[k] <= tr) ? 1 : 0;
  }

  const int dur = (q_level >= high_water) ? d_old + 1 : (d_old >> 1);
  const int q_score = s_lsc[q_level];
  const int t_score = tr > 0 ? s_lsc[t_level] : 0;
  const int d_score = min(dur >> dur_shift, SCORE_MAX);
  const int cc = min((w_ql * q_score + w_tl * t_score + w_dp * d_score) >> s_cong,
                     SCORE_MAX);

  queue_cur[i] = q;
  queue_prev[i] = q_old;
  trend[i] = tr;
  dur_cnt[i] = dur;
  last_sample[i] = now_us;
  c_cong[i] = cc;
  if (hist_c != nullptr) hist_c[(long long)i * hist_len + slot] = cc;
}

extern "C" int cong_update_launch(
    int n, void* queue_cur, void* queue_prev, void* trend, void* dur_cnt,
    void* last_sample, const void* qcells, const void* trend_thresh,
    const void* q_thresh, const void* level_score, void* c_cong, void* hist_c,
    long long hist_len, int slot, int now_us, int high_water, int w_ql,
    int w_tl, int w_dp, int ewma_k, int dur_shift, int s_cong, void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  cong_update_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      n, (int*)queue_cur, (int*)queue_prev, (int*)trend, (int*)dur_cnt,
      (int*)last_sample, (const int*)qcells, (const int*)trend_thresh,
      (const int*)q_thresh, (const int*)level_score, (int*)c_cong,
      (int*)hist_c, hist_len, slot, now_us, high_water, w_ql, w_tl, w_dp,
      ewma_k, dur_shift, s_cong);
  return (int)cudaGetLastError();
}
