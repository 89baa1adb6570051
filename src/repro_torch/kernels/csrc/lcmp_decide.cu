// Batched LCMP path decision (paper §3.4), for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lcmp_decide.py::lcmp_decide
// (body _decide_kernel). Per flow: cost = alpha*C_path + beta*C_cong with
// invalid slots at 1<<24; keys cost*8 + slot sorted by the 19-comparator
// Batcher odd-even network; keep ceil(m/keep_num) of the m valid candidates;
// pick rank fmix32(flow_id) % keep; rank 0 when the least valid C_cong is at
// or above cong_fallback; -1 when no candidate is valid.
//
// Bound on the H100: bytes. A flow reads 8 bytes of id and 9 bytes per
// candidate and writes 4, some 84 bytes at P = 8 for ~150 integer
// operations. On the engine's path a step decides 7-24 arrivals, under 2 KB,
// so the call is bound by launch latency. The TPU layout (candidates on
// sublanes, 128-flow lane blocks) does not carry over: here one thread owns
// one flow and keeps its <= 8 keys in registers (the network's indices are
// compile-time constants, so the array never touches local memory), with no
// shared memory, no synchronisation and one coalesced store per flow.
#include <cuda_runtime.h>
#include <stdint.h>

#define P_MAX 8
#define COST_INVALID (1 << 24)
#define SCORE_MAX 255
#define THREADS 128

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

  // Batcher odd-even mergesort network for 8 keys (19 comparators)
  cmpx(key[0], key[1]); cmpx(key[2], key[3]); cmpx(key[4], key[5]); cmpx(key[6], key[7]);
  cmpx(key[0], key[2]); cmpx(key[1], key[3]); cmpx(key[4], key[6]); cmpx(key[5], key[7]);
  cmpx(key[1], key[2]); cmpx(key[5], key[6]);
  cmpx(key[0], key[4]); cmpx(key[1], key[5]); cmpx(key[2], key[6]); cmpx(key[3], key[7]);
  cmpx(key[2], key[4]); cmpx(key[3], key[5]);
  cmpx(key[1], key[2]); cmpx(key[3], key[4]); cmpx(key[5], key[6]);

  const int keep = max((num_valid + keep_num - 1) / keep_num, 1);
  int pick = (int)(fmix32((uint32_t)flow_ids[f]) % (uint32_t)keep);
  if (min_cong >= cong_fallback) pick = 0;

  int picked = key[0];
#pragma unroll
  for (int i = 1; i < P_MAX; ++i) picked = (pick == i) ? key[i] : picked;

  out[f] = num_valid > 0 ? (picked & (P_MAX - 1)) : -1;
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
