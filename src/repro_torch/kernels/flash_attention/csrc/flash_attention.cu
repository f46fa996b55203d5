// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
// (src/repro/kernels/flash_attention/kernel.py, flash_attention_pallas with
// its body _flash_kernel):
//   fa_forward_bf16  <- flash_attention_pallas, bf16: tensor cores (wgmma)
//   fa_forward_f32   <- flash_attention_pallas, f32: CUDA cores
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
// written in the input's dtype. The semantics are the TPU kernel's, tile
// skipping included: a key tile that the causal or window test rules out for
// the whole query tile is never computed. A row whose first computed tile is
// wholly masked takes exp(0) terms from it (m stays -2e9), as on the TPU;
// the first tile with a real key sets alpha = exp(-2e9 - m) = 0 and wipes
// them, and every real row has one (its own position).
//
// bf16: flash_tc_kernel, built for the tensor cores. A block of two consumer
// warpgroups and one producer warp owns TQ = 128 query rows of one head (64
// per warpgroup); blocks of the last query tiles (the most key tiles under
// the causal mask) are scheduled first. For DH <= 64 an SM holds two blocks
// (at most 112 registers a thread), so four warpgroups overlap one
// another's tensor-core and softmax phases.
//   loads    the producer warp's first lane moves Q once and each K and V
//            tile of TK = 64 keys with TMA (4-D tensor maps over (DH, heads,
//            S, B), rows past S filled with zeros) into a ring of STAGES
//            slots behind mbarriers: one "full" barrier per K and per V tile
//            (expected bytes) and one "empty" barrier per slot, which every
//            consumer thread arrives on when its products have read the slot.
//            A tile of DH columns is DH / CW chunks of CW = min(DH, 64)
//            columns, each a [rows][CW] box with the swizzle of its row
//            width (128 B for 64 columns, 64 B for 32, 32 B for 16), which
//            the wgmma descriptors name.
//   S = QK^T wgmma m64n64k16 over DH / 16 steps, Q and K K-major from
//            shared memory, f32 accumulators in registers.
//   softmax  in registers: each thread holds 2 rows x 16 columns of S; row
//            max across the quad of threads that share a row by shuffles
//            (the row sums stay per thread until the end); ex2.approx with
//            log2(e) folded into the scale, so that on a tile with no mask
//            and no softcap each p is one FFMA and one ex2; the softcap is a
//            compile-time branch and the mask is applied only on tiles that
//            cross the diagonal, the window edge or S.
//   O += PV  P rounded to bf16 in registers is the A operand of wgmma
//            m64nCWk16 (the accumulator layout of S is the A layout); V is the
//            B operand read MN-major from its slot (transpose flag), so it
//            needs no transpose pass.
// wgmma fence / commit / wait_group order every product before its registers
// are read, and the register writes (rescale, P) before the next product.
//
// f32: flash_fwd_kernel, on CUDA cores (TF32 or bf16 tensor cores would
// miss the f32 tolerance). One block of 256 threads per (query tile of BQ =
// 64 rows, query head, batch row). Q, K, V and the tile's scores live in
// shared memory in f32 (rows padded to DH + 1 floats); each thread holds a
// 4 x 4 score tile and 4 x DH/16 outputs; four threads per row run the
// online softmax. Every product is an explicit __fmaf_rn.
//
// Bound on an H100: operations. The causal scores and the context take
// 4 * B * H * (S^2 / 2) * DH flops (1.37e11 at B 8, S 2048, H 32, DH 64); the
// inputs and output are 151 MB in bf16. The bf16 kernel runs at the tensor
// cores' 989 TFLOP/s peak at best; the f32 one on the FP32 lanes (67
// TFLOP/s).

#include <cuda.h>                 // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e9f;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int SS = BK + 1;             // padded score row

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ) * (DH + 1)   // Q
                          + static_cast<size_t>(BK) * (DH + 1) // K
                          + static_cast<size_t>(BK) * DH       // V
                          + static_cast<size_t>(BQ) * SS       // scores / p
                          + 3 * BQ);                           // m, l, alpha
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int KV, float scale, int causal, int window,
                 float softcap) {
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
  const float* qb = q + (static_cast<long long>(b) * S * H + h) * DH;
  const float* kb = k + (static_cast<long long>(b) * S * KV + kh) * DH;
  const float* vb = v + (static_cast<long long>(b) * S * KV + kh) * DH;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, c = e % DH, s = q_lo + r;
    Qs[r * QS + c] = s < S ? qb[s * q_stride + c] : 0.0f;
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
      Ks[r * QS + c] = in ? kb[s * kv_stride + c] : 0.0f;
      Vs[r * DH + c] = in ? vb[s * kv_stride + c] : 0.0f;
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

  float* ob = o + (static_cast<long long>(b) * S * H + h) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q_lo + r;
    if (s >= S) continue;
    const float l = fmaxf(Ls[r], 1e-20f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) ob[s * q_stride + tx + 16 * j] = acc[i][j] / l;
  }
}

// f32: the CUDA-core kernel.
template <int DH>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int S, int H, int KV, float scale, int causal, int window,
           float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DH><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, S, H, KV, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, mbarriers
// ---------------------------------------------------------------------------

constexpr int NWG = 2;                 // consumer warpgroups
constexpr int TQ = 64 * NWG;           // query rows per block
constexpr int TK = 64;                 // keys per tile
constexpr int TC_THREADS = 128 * NWG + 32;   // + one producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Tc {
  static constexpr int CW = DH < 64 ? DH : 64;   // columns per chunk
  static constexpr int NCH = DH / CW;            // chunks per row
  static constexpr int ROWB = 2 * CW;            // bytes per chunk row
  static constexpr int STAGES = DH <= 128 ? 3 : 2;
  static constexpr int Q_CHUNK = TQ * ROWB;      // bytes
  static constexpr int KV_CHUNK = TK * ROWB;
  static constexpr int Q_BYTES = Q_CHUNK * NCH;
  static constexpr int KV_BYTES = KV_CHUNK * NCH;
  static constexpr int BARS = 1 + 3 * STAGES;    // q, k full, v full, empty
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : (ROWB == 64 ? 2 : 3);
  // two blocks an SM (at most 112 registers a thread) where DH allows
  static constexpr int MIN_BLOCKS = DH <= 64 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout type, base offset 0 (every
// tile starts on a 1024-byte boundary).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until every committed group of products has finished.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of operand registers across
// the asynchronous products, or reusing them while a product runs.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {     // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory;
// scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] B[16 x N]: A in registers (a 64 x 16 slice of P
// in the accumulator layout, packed to bf16 pairs), B MN-major in shared
// memory (transpose flag 1). N is one chunk of the head dim: 16, 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31},\n"
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16\n{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15},\n"
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16\n{"
        "%0, %1, %2, %3, %4, %5, %6, %7},\n"
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

template <int DH>
__global__ void __launch_bounds__(TC_THREADS, Tc<DH>::MIN_BLOCKS)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int S, int H, int KV,
                float scale, int causal, int window, float softcap) {
  using C = Tc<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                           // [NCH][TQ][CW]
  const uint32_t sk = sq + C::Q_BYTES;                // [STAGES][NCH][TK][CW]
  const uint32_t sv = sk + C::STAGES * C::KV_BYTES;   // [STAGES][NCH][TK][CW]
  const uint32_t bars = sv + C::STAGES * C::KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + C::STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * C::STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;        // heaviest tiles first
  const int kh = h / (H / KV);
  const int q_lo = qt * TQ;
  const int nk = (S + TK - 1) / TK;
  // key tiles that meet the block's query rows under the causal and window
  // tests; the producer loads exactly these
  const int kt_end = causal ? min(nk - 1, (q_lo + TQ - 1) / TK) : nk - 1;
  const int kt_begin = window > 0 ? max(0, q_lo - window + 1) / TK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {                   // producer warp
    if (threadIdx.x != 128 * NWG) return;
    mbar_expect_tx(q_full, C::Q_BYTES);
    for (int c = 0; c < C::NCH; ++c)
      tma_load(sq + c * C::Q_CHUNK, &tm_q, q_full, c * C::CW, h, q_lo, b);
    for (int kt = kt_begin, i = 0; kt <= kt_end; ++kt, ++i) {
      const int s = i % C::STAGES;
      if (i >= C::STAGES) mbar_wait(empty(s), ((i / C::STAGES) - 1) & 1);
      mbar_expect_tx(k_full(s), C::KV_BYTES);
      for (int c = 0; c < C::NCH; ++c)
        tma_load(sk + s * C::KV_BYTES + c * C::KV_CHUNK, &tm_k, k_full(s),
                 c * C::CW, kh, kt * TK, b);
      mbar_expect_tx(v_full(s), C::KV_BYTES);
      for (int c = 0; c < C::NCH; ++c)
        tma_load(sv + s * C::KV_BYTES + c * C::KV_CHUNK, &tm_v, v_full(s),
                 c * C::CW, kh, kt * TK, b);
    }
    return;
  }

  // consumer warpgroup wg: query rows wq_lo .. wq_lo + 63; this thread holds
  // rows r0 and r0 + 8 and, in each 8-column block, columns cq and cq + 1
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int lane = t & 31;
  const int r0 = (t >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int wq_lo = q_lo + wg * 64;
  // the warpgroup's own tile range; it waits on, and releases, the others
  int w_end = causal ? min(nk - 1, (wq_lo + 63) / TK) : nk - 1;
  const int w_begin = window > 0 ? max(0, wq_lo - window + 1) / TK : 0;
  if (wq_lo >= S) w_end = -1;                        // all padding rows
  const bool capped = softcap != 0.0f;
  const float qk_scale = capped ? scale : scale * LOG2E;
  const float inv_cap = capped ? 1.0f / softcap : 0.0f;
  const float neg = NEG_INF;
  constexpr uint32_t SBO = 8 * C::ROWB;              // next 8 rows

  float acc[C::NCH][C::CW / 2];
#pragma unroll
  for (int c = 0; c < C::NCH; ++c)
#pragma unroll
    for (int i = 0; i < C::CW / 2; ++i) acc[c][i] = 0.0f;
  float m[2] = {neg, neg}, l[2] = {0.0f, 0.0f};
  float sc[32];                  // S of the tile, then its p
  uint32_t pa[4][4];             // p in bf16, four 64 x 16 A slices

  // S = Q K^T for the tile in slot s, issued and committed (not waited)
  auto issue_scores = [&](int s) {
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const int c = (ks * 16) / C::CW;
      const uint32_t in = (ks * 16 - c * C::CW) * 2;   // bytes into the row
      const uint64_t da = gmma_desc(
          sq + c * C::Q_CHUNK + wg * 64 * C::ROWB + in, 16, SBO, C::LAYOUT);
      const uint64_t db = gmma_desc(
          sk + s * C::KV_BYTES + c * C::KV_CHUNK + in, 16, SBO, C::LAYOUT);
      wgmma_ss_n64(sc, da, db, ks > 0);
    }
    wgmma_commit();
  };
  // O += P V for the tile in slot s, issued and committed
  auto issue_pv = [&](int s) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        const uint64_t dv = gmma_desc(
            sv + s * C::KV_BYTES + c * C::KV_CHUNK + ks * 16 * C::ROWB,
            C::KV_CHUNK, SBO, C::LAYOUT);
        wgmma_rs<C::CW>(acc[c], pa[ks], dv);
      }
    wgmma_commit();
  };
  // The online softmax of tile kt in log2 units: sc becomes p, m and l move
  // on, alpha rescales what O holds so far. sc[4j + e] is row r0 + 8 (e >> 1),
  // column 8j + cq + (e & 1). A tile with no mask and no softcap keeps its
  // raw scores (k = qk_scale): the row max is scaled once and each p is one
  // FFMA and one ex2. Otherwise (k = 1) sc is scaled, capped (a compile-time
  // choice: Flag<true> or Flag<false>) and masked first.
  auto softmax = [&](int kt, float (&alpha)[2], auto cap) {
    const int k_lo = kt * TK;
    const bool edge = (causal && k_lo + TK - 1 > wq_lo) ||
                      (window > 0 && wq_lo + 63 - k_lo >= window) ||
                      k_lo + TK > S;
    const bool raw = !decltype(cap)::value && !edge;
    const float k = raw ? qk_scale : 1.0f;
    if (!raw) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i] * qk_scale;
        if constexpr (decltype(cap)::value)
          x = softcap * tanhf(x * inv_cap) * LOG2E;
        sc[i] = x;
      }
    }
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = wq_lo + r0 + 8 * (e >> 1);
          const int kpos = k_lo + 8 * j + cq + (e & 1);
          bool ok = kpos < S;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          if (!ok) sc[4 * j + e] = neg;
        }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {           // row r0 + 8 hr
      float mx = neg;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx * k);
      alpha[hr] = ex2(m[hr] - m_new);
      m[hr] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = ex2(fmaf(sc[4 * j + 2 * hr + e], k, -m_new));
          sc[4 * j + 2 * hr + e] = pe;
          sum += pe;
        }
      l[hr] = l[hr] * alpha[hr] + sum;        // this thread's share of the row
    }
  };
  // rescale O by alpha, and P (as four 64 x 16 A slices) from sc
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int i = 0; i < C::CW / 2; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[ks][r] = pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
  };
  auto fence_pv_operands = [&]() {
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) reg_fence(acc[c]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) reg_fence(pa[ks]);
  };

  // Tiles kt_begin..kt_end arrive in slots (kt - kt_begin) % STAGES. This
  // warpgroup computes the part act_begin..act_end that its rows meet and
  // only waits on, and releases, the rest. Each tile runs scores, softmax
  // and PV in turn; the two warpgroups of a block, and the two blocks an SM
  // holds, overlap one another's tensor-core and softmax phases.
  const int act_begin = max(kt_begin, w_begin);
  const int act_end = min(kt_end, w_end);
  mbar_wait(q_full, 0);
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int s = (kt - kt_begin) % C::STAGES;
    const uint32_t par = ((kt - kt_begin) / C::STAGES) & 1;
    mbar_wait(k_full(s), par);
    if (kt < act_begin || kt > act_end) {           // no row of ours meets it
      mbar_wait(v_full(s), par);
      mbar_arrive(empty(s));
      continue;
    }
    __syncwarp();                             // converged for .aligned ops
    wgmma_fence();
    issue_scores(s);
    wgmma_wait_all();
    reg_fence(sc);
    float alpha[2];
    if (capped)
      softmax(kt, alpha, Flag<true>{});
    else
      softmax(kt, alpha, Flag<false>{});
    rescale_and_pack(alpha);
    mbar_wait(v_full(s), par);
    __syncwarp();
    wgmma_fence();
    issue_pv(s);
    wgmma_wait_all();
    fence_pv_operands();
    mbar_arrive(empty(s));
  }

  // o = acc / l, rows below S; acc[c][4j + e] is row r0 + 8 (e >> 1),
  // column c CW + 8j + cq + (e & 1)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  const long long q_stride = static_cast<long long>(H) * DH;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qpos = wq_lo + r0 + 8 * hr;
    if (qpos >= S) continue;
    const float inv = 1.0f / fmaxf(l[hr], 1e-20f);
    __nv_bfloat16* orow =
        o + (static_cast<long long>(b) * S + qpos) * q_stride + h * DH;
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int j = 0; j < C::CW / 8; ++j) {
        const uint32_t v2 = pack_bf16(acc[c][4 * j + 2 * hr] * inv,
                                      acc[c][4 * j + 2 * hr + 1] * inv);
        *reinterpret_cast<uint32_t*>(orow + c * C::CW + 8 * j + cq) = v2;
      }
  }
}

// cuTensorMapEncodeTiled, taken from the CUDA driver at run time so that the
// library need not link libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [B, S, heads, DH] tensor as a 4-D map over (DH, heads, S, B) with
// box (cw, 1, rows, 1) and the swizzle of a cw-column row.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int DH,
              int heads, int S, int B, int rows, int cw) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * DH;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cw), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : (cw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B);
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16: the tensor-core kernel.
template <int DH>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* o, int B, int S, int H,
           int KV, float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  using C = Tc<DH>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, DH, H, S, B, TQ, C::CW) ||
      !make_map(enc, &tk, k, DH, KV, S, B, TK, C::CW) ||
      !make_map(enc, &tv, v, DH, KV, S, B, TK, C::CW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + TQ - 1) / TQ);
  flash_tc_kernel<DH><<<grid, TC_THREADS, C::SMEM, stream>>>(
      tq, tk, tv, o, S, H, KV, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int B, int S, int H,
             int KV, int DH, float scale, int causal, int window,
             float softcap, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 16: return launch<16>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, st);
    case 32: return launch<32>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, st);
    case 64: return launch<64>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, st);
    case 128: return launch<128>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, st);
    case 256: return launch<256>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head dim it has no instance for (the Python
// wrapper refuses those first). No row launches nothing and returns 0. The
// bf16 one also returns cudaErrorInvalidValue where a tensor map cannot be
// encoded (a pointer not 16-byte aligned) and cudaErrorSymbolNotFound where
// the driver has no cuTensorMapEncodeTiled.
int fa_forward_f32(const float* q, const float* k, const float* v, float* o,
                   int B, int S, int H, int KV, int DH, float scale,
                   int causal, int window, float softcap, void* stream) {
  return dispatch(q, k, v, o, B, S, H, KV, DH, scale, causal, window, softcap,
                  stream);
}

// The bf16 kernel's dynamic shared memory for head dim DH (0 for none).
int fa_tc_smem_bytes(int DH) {
  switch (DH) {
    case 16: return Tc<16>::SMEM;
    case 32: return Tc<32>::SMEM;
    case 64: return Tc<64>::SMEM;
    case 128: return Tc<128>::SMEM;
    case 256: return Tc<256>::SMEM;
    default: return 0;
  }
}

int fa_forward_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                    const __nv_bfloat16* v, __nv_bfloat16* o, int B, int S,
                    int H, int KV, int DH, float scale, int causal,
                    int window, float softcap, void* stream) {
  return dispatch(q, k, v, o, B, S, H, KV, DH, scale, causal, window, softcap,
                  stream);
}

}  // extern "C"
