// Blockwise int8 quantization with stochastic rounding, and its inverse,
// for sm_90a: the wire format of the cross-pod gradient reduction.
//
// Replaces the Pallas TPU kernels src/repro/kernels/qsr_int8.py::qsr_int8
// (body _quant_kernel) and ::qsr_dequant (body _dequant_kernel). Per
// 1024-element scale block: amax = max|x|, scale = amax / 127,
// q = clip(floor(x * (127 / amax) + (bits >> 8) * 2^-24), -127, 127) as
// int8, with q = 0 and scale 0 for a zero block; the inverse is
// x = q * scale[block].
//
// Bound on the H100: bytes. Quantization reads 4 B of x and 4 B of random
// bits and writes 1 B of q per element (and 4 B of scale per block), some
// 9 B for a handful of float operations; dequantization reads 1 B and
// writes 4 B. Both sit far below the card's operations-per-byte balance, so
// the design moves each byte once, in wide accesses: one CTA of 256 threads
// per scale block (the TPU kernel's (8, 128) VMEM tile is this CTA's 1024
// elements), each thread one 16-byte load of x (float4) and one of bits
// (uint4) and one 4-byte store of q (char4). The block's amax comes from a
// warp-shuffle max and a max over the 8 warps through shared memory, so x
// is read from device memory once. A gradient of 10^9 elements is some 10^6
// CTAs; indices are 64-bit.
//
// Rounding. The multiply and the add are written as __fmul_rn and
// __fadd_rn, so nvcc cannot contract them into one FMA (which rounds once
// and moves floor() at ties), and both divisions are IEEE divisions
// (__fdiv_rn), 127 / amax and amax / 127, exactly as the reference writes
// them; inv is not the reciprocal of the scale. With that the kernel
// equals the plain PyTorch version (kernels/ref.py) bit for bit for finite
// inputs. (A block whose amax is nonzero but below 127 / FLT_MAX makes inv
// infinite; the reference then produces NaN, which has no int8 value.)
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256                 // 4 elements a thread; 1024 a CTA
#define WARPS (THREADS / 32)

__device__ __forceinline__ signed char quant(float x, uint32_t bits,
                                             float inv) {
  // (bits >> 8) has 24 bits: exact in float32, as is the scaling by 2^-24
  const float u = __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);
  const float y = floorf(__fadd_rn(__fmul_rn(x, inv), u));
  return (signed char)__float2int_rn(fminf(fmaxf(y, -127.0f), 127.0f));
}

__global__ void __launch_bounds__(THREADS) qsr_int8_kernel(
    const float4* __restrict__ x, const uint4* __restrict__ bits,
    char4* __restrict__ q, float* __restrict__ scales) {
  __shared__ float s_max[WARPS];
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const float4 v = x[i];
  const uint4 b = bits[i];

  float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float amax = s_max[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) amax = fmaxf(amax, s_max[w]);

  const float inv = amax > 0.0f ? __fdiv_rn(127.0f, amax) : 0.0f;
  char4 out;
  out.x = quant(v.x, b.x, inv);
  out.y = quant(v.y, b.y, inv);
  out.z = quant(v.z, b.z, inv);
  out.w = quant(v.w, b.w, inv);
  q[i] = out;
  if (threadIdx.x == 0) scales[blockIdx.x] = __fdiv_rn(amax, 127.0f);
}

__global__ void __launch_bounds__(THREADS) qsr_dequant_kernel(
    const char4* __restrict__ q, const float* __restrict__ scales,
    float4* __restrict__ x) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const float s = scales[blockIdx.x];
  const char4 c = q[i];
  x[i] = make_float4(__fmul_rn((float)c.x, s), __fmul_rn((float)c.y, s),
                     __fmul_rn((float)c.z, s), __fmul_rn((float)c.w, s));
}

// n_blocks scale blocks of 1024 elements; x and bits 16-byte aligned, q and
// scales 4-byte aligned (the wrapper checks).
extern "C" int qsr_int8_launch(long long n_blocks, const void* x,
                               const void* bits, void* q, void* scales,
                               void* stream) {
  qsr_int8_kernel<<<(unsigned)n_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const uint4*)bits, (char4*)q, (float*)scales);
  return (int)cudaGetLastError();
}

extern "C" int qsr_dequant_launch(long long n_blocks, const void* q,
                                  const void* scales, void* x, void* stream) {
  qsr_dequant_kernel<<<(unsigned)n_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const char4*)q, (const float*)scales, (float4*)x);
  return (int)cudaGetLastError();
}
