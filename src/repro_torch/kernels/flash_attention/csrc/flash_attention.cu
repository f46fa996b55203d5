// Causal GQA flash-attention forward for Hopper (sm_90a), on CUDA cores.
//
// Replaces the Pallas TPU kernel of the JAX package
// (src/repro/kernels/flash_attention/kernel.py, flash_attention_pallas with
// its body _flash_kernel):
//   fa_forward_f32 / fa_forward_bf16  <- flash_attention_pallas
//
// What it computes, for q [B, S, H, DH] and k, v [B, S, KV, DH] (contiguous,
// G = H / KV query heads per kv head, query head h reads kv head h / G):
//   s    = (q . k) * scale                        in f32
//   s    = softcap * tanh(s / softcap)            when softcap != 0
//   s    = -2e9 unless kpos < S, causal: qpos >= kpos,
//                      window: qpos - kpos < window
//   o    = softmax(s) . v, online over key tiles: a running max m, running
//          denominator l and f32 accumulator per query row, rescaled by
//          alpha = exp(m_old - m_new) at each tile; o = acc / max(l, 1e-20)
// read as f32 or bf16 and written in the input's dtype. The semantics are the
// TPU kernel's, tile skipping included: a key tile that the causal or window
// test rules out for the whole query tile is never loaded. A row whose first
// loaded tile is wholly masked takes exp(0) terms from it (m stays -2e9), as
// on the TPU; the first tile with a real key sets alpha = exp(-2e9 - m) = 0
// and wipes them, and every real row has one (its own position).
//
// Design. One block of 256 threads per (query tile of BQ = 64 rows, query
// head, batch row); blocks of the last query tiles (the most key tiles under
// the causal mask) are scheduled first. The block keeps its Q tile, one K
// and one V tile (f32) and the tile's scores in shared memory:
//   scores  S = Q K^T, 64 x 64: thread (ty, tx) owns rows ty + 16 i and
//           columns tx + 16 j (i, j < 4), a 4 x 4 register tile; Q and K rows
//           are padded to DH + 1 floats so the 16 key rows a half-warp reads
//           fall in distinct banks;
//   softmax four threads per row (shuffles within the quad) update m and l,
//           turn the row into p in place and leave alpha for the next step;
//   P V     thread (ty, tx) owns output rows ty + 16 i and columns tx + 16 j
//           (j < DH / 16) in registers.
// Every product is an explicit __fmaf_rn: the library is built with
// -fmad=false for the pair kernels' parity, which would otherwise split each
// multiply-add in two.
//
// Bound on an H100: operations. The causal scores and the context take
// 4 * B * H * (S^2 / 2) * DH flops (1.37e11 at B 8, S 2048, H 32, DH 64); the
// inputs and output are 151 MB in bf16. This first kernel runs on the FP32
// lanes (67 TFLOP/s dense), not the tensor cores (989 TFLOP/s bf16), and its
// inner loops are bound by shared-memory loads: 8 loads per 16 FMAs in the
// score loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int SS = BK + 1;             // padded score row
constexpr float NEG_INF = -2.0e9f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float x, float* out) { *out = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ) * (DH + 1)   // Q
                          + static_cast<size_t>(BK) * (DH + 1) // K
                          + static_cast<size_t>(BK) * DH       // V
                          + static_cast<size_t>(BQ) * SS       // scores / p
                          + 3 * BQ);                           // m, l, alpha
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KV, float scale, int causal, int window, float softcap) {
  constexpr int QS = DH + 1;
  constexpr int NJ = DH / 16;          // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][QS]
  float* Ks = Qs + BQ * QS;            // [BK][QS]
  float* Vs = Ks + BK * QS;            // [BK][DH]
  float* Ss = Vs + BK * DH;            // [BQ][SS]
  float* Ms = Ss + BQ * SS;            // running max         [BQ]
  float* Ls = Ms + BQ;                 // running denominator [BQ]
  float* As = Ls + BQ;                 // this tile's alpha   [BQ]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q_lo = qt * BQ;
  const long long q_stride = static_cast<long long>(H) * DH;   // per position
  const long long kv_stride = static_cast<long long>(KV) * DH;
  const T* qb = q + (static_cast<long long>(b) * S * H + h) * DH;
  const T* kb = k + (static_cast<long long>(b) * S * KV + kh) * DH;
  const T* vb = v + (static_cast<long long>(b) * S * KV + kh) * DH;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, c = e % DH, s = q_lo + r;
    Qs[r * QS + c] = s < S ? widen(qb[s * q_stride + c]) : 0.0f;
  }
  if (tid < BQ) {
    Ms[tid] = NEG_INF;
    Ls[tid] = 0.0f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  // key tiles that meet the query tile under the causal and window tests
  const int q_hi = q_lo + BQ - 1;
  const int nk = (S + BK - 1) / BK;
  const int kt_end = causal ? min(nk - 1, q_hi / BK) : nk - 1;
  const int kt_begin = window > 0 ? max(0, q_lo - window + 1) / BK : 0;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();                   // the last tile's K, V, p are read
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int r = e / DH, c = e % DH, s = k_lo + r;
      const bool in = s < S;
      Ks[r * QS + c] = in ? widen(kb[s * kv_stride + c]) : 0.0f;
      Vs[r * DH + c] = in ? widen(vb[s * kv_stride + c]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = __fmaf_rn(qa[i], ka[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q_lo + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k_lo + c;
        float x = sc[i][j] * scale;
        if (softcap != 0.0f) x = softcap * tanhf(x / softcap);
        bool ok = kpos < S;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        Ss[r * SS + c] = ok ? x : NEG_INF;
      }
    }
    __syncthreads();

    {  // online softmax: the quad of lanes 4r..4r+3 owns row r
      const int r = tid >> 2, part = tid & 3;
      float* row = Ss + r * SS;
      const float m_prev = Ms[r];
      float mx = NEG_INF;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = part; c < BK; c += 4) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        As[r] = alpha;
        Ls[r] = __fmaf_rn(Ls[r], alpha, sum);
        Ms[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = As[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], va[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ss[(ty + 16 * i) * SS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) va[j] = Vs[kk * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = __fmaf_rn(pa[i], va[j], acc[i][j]);
    }
  }

  T* ob = o + (static_cast<long long>(b) * S * H + h) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q_lo + r;
    if (s >= S) continue;
    const float l = fmaxf(Ls[r], 1e-20f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) narrow(acc[i][j] / l, ob + s * q_stride + tx + 16 * j);
  }
}

template <typename T, int DH>
int launch(const T* q, const T* k, const T* v, T* o, int B, int S, int H,
           int KV, float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, S, H, KV, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int B, int S, int H,
             int KV, int DH, float scale, int causal, int window,
             float softcap, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, st);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head dim it has no instance for (the Python
// wrapper refuses those first). No row launches nothing and returns 0.
int fa_forward_f32(const float* q, const float* k, const float* v, float* o,
                   int B, int S, int H, int KV, int DH, float scale,
                   int causal, int window, float softcap, void* stream) {
  return dispatch(q, k, v, o, B, S, H, KV, DH, scale, causal, window, softcap,
                  stream);
}

int fa_forward_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                    const __nv_bfloat16* v, __nv_bfloat16* o, int B, int S,
                    int H, int KV, int DH, float scale, int causal,
                    int window, float softcap, void* stream) {
  return dispatch(q, k, v, o, B, S, H, KV, DH, scale, causal, window, softcap,
                  stream);
}

}  // extern "C"
