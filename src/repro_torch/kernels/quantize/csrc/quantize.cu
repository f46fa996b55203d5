// Block-wise int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package
// (src/repro/kernels/quantize/kernel.py):
//   bq_quantize_f32 / bq_quantize_bf16  <- quantize_pallas   (_quant_kernel)
//   bq_dequantize                       <- dequantize_pallas (_dequant_kernel)
//
// What they compute, over a contiguous [R, C] payload with C % block == 0,
// i.e. over its R * C / block consecutive quantization blocks:
//   quantize  : scale = max(max|x| / 127, 1e-12), q = clip(round(x / scale),
//               -127, 127) as int8, one f32 scale per block;
//   dequantize: x = q * scale.
//
// Parity. The reference's wire bytes need IEEE division (__fdiv_rn, never a
// reciprocal multiply), round-half-to-even (rintf in the default rounding
// mode) and an f32 1e-12 floor. The block maximum is exact in any order, so
// a warp reduction gives the reference's scale bit for bit. bf16 input is
// widened to f32 first, which is exact. Dequantize is one rounded product
// (__fmul_rn). Finite inputs only: fmaxf drops a NaN that jnp.max keeps.
//
// Design. The kernels walk the quantization blocks, not the rows, so a
// single-row [1, n_pad] payload (the codec's flattened catalog) fills the
// card. One warp owns one block at a time (grid-stride over blocks): lanes
// read the block coalesced, reduce |x| with shuffles, then read it again
// (from L1) to write the codes; lane 0 writes the scale.
//
// Bound on an H100: bytes. Quantize reads 4 (f32) or 2 (bf16) bytes and
// writes 1 byte per element plus 4 bytes per block; dequantize reads 1 byte
// per element plus 4 per block and writes 4. At 3.35 TB/s that is about
// 5 / 3.35e12 s per f32 element either way; the arithmetic (one division per
// element) is far below the card's rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;                 // 8 warps per block
constexpr long long MAX_GRID = 1LL << 24;    // grid-stride beyond this

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ long long warp_id() {
  return (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
}

__device__ __forceinline__ long long n_warps() {
  return (static_cast<long long>(gridDim.x) * THREADS) >> 5;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, long long n_blocks, int block,
                int8_t* __restrict__ q, float* __restrict__ s) {
  const int lane = threadIdx.x & 31;
  for (long long k = warp_id(); k < n_blocks; k += n_warps()) {
    const T* xb = x + k * block;
    float amax = 0.0f;
    for (int e = lane; e < block; e += 32) amax = fmaxf(amax, fabsf(widen(xb[e])));
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
    if (lane == 0) s[k] = scale;
    int8_t* qb = q + k * block;
    for (int e = lane; e < block; e += 32) {
      const float r = rintf(__fdiv_rn(widen(xb[e]), scale));
      qb[e] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  long long n_blocks, int block, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (long long k = warp_id(); k < n_blocks; k += n_warps()) {
    const float scale = s[k];
    const int8_t* qb = q + k * block;
    float* ob = out + k * block;
    for (int e = lane; e < block; e += 32)
      ob[e] = __fmul_rn(static_cast<float>(qb[e]), scale);
  }
}

inline unsigned int grid_for(long long n_blocks) {
  const long long warps_per_cta = THREADS / 32;
  long long g = (n_blocks + warps_per_cta - 1) / warps_per_cta;
  return static_cast<unsigned int>(g < MAX_GRID ? g : MAX_GRID);
}

template <typename T>
int launch_quantize(const T* x, long long n_blocks, int block, int8_t* q,
                    float* s, void* stream) {
  if (n_blocks <= 0) return 0;
  quantize_kernel<T><<<grid_for(n_blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, n_blocks,
                                                            block, q, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched). No block
// launches nothing and returns 0; the Python wrappers never pass none.
int bq_quantize_f32(const float* x, long long n_blocks, int block, int8_t* q,
                    float* s, void* stream) {
  return launch_quantize(x, n_blocks, block, q, s, stream);
}

int bq_quantize_bf16(const __nv_bfloat16* x, long long n_blocks, int block,
                     int8_t* q, float* s, void* stream) {
  return launch_quantize(x, n_blocks, block, q, s, stream);
}

int bq_dequantize(const int8_t* q, const float* s, long long n_blocks,
                  int block, float* out, void* stream) {
  if (n_blocks <= 0) return 0;
  dequantize_kernel<<<grid_for(n_blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(q, s, n_blocks,
                                                           block, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
