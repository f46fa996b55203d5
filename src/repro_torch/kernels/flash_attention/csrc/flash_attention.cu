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
// f32: flash_fwd_kernel, on the CUDA cores (TF32 or bf16 tensor cores would
// miss the f32 tolerance), every product an explicit __fmaf_rn. Bound on an
// H100: FP32 operations, 2 * DH FFMAs a kept (query, key) pair at 67 TFLOP/s
// (4 * B * H * pairs * DH flops: 8.6e10 at gemma2-2b's 1 x 4,608, window
// 4,096, H 8, DH 256, 1.28 ms). An SM retires four warp-FFMAs a clock but
// one 128-byte shared-memory wavefront, so the design keeps the products
// fed from registers and the loads off the products' path:
//   block    two consumer warpgroups (eight warps) and one producer
//            warpgroup own FQ = 64 query rows of one head (8 a warp); the
//            producer gives its registers to the consumers (setmaxnreg 24
//            and 240), so that O, S and the operands fit without spills.
//            Blocks of the last query tiles (the most key tiles under the
//            causal mask) are scheduled first, over all heads and batches.
//   loads    the producer's first thread moves each key tile of FK = 128 keys
//            with TMA into a ring of F_STAGES 16 KB slots behind full and
//            empty mbarriers: K in chunks of 32 head-dim columns (rows
//            swizzled, 128 B), then V in chunks of whole rows; so tile j+1
//            streams in while tile j's products run, and no consumer waits
//            on a block-wide barrier. Each warp copies its own 8 Q rows once
//            (rows padded to DH + 4 floats).
//   S = QK^T each lane holds a 4 x 8 score tile (rows tr + 2i, keys
//            tc + 16j) and reads Q and K as float4 along the head dim: 12
//            loads for 128 FFMAs. A load of Q is two addresses that the
//            warp broadcasts, one of K sixteen keys that fill each bank
//            twice, so at most one wavefront goes with six FFMAs.
//   softmax  in registers, the 16 lanes of a half-warp sharing a row (max
//            and sum by shuffles); the precise tanhf for the softcap (the
//            approximate one misses 1e-5 at |s| near 50), p = 2^((s - m)
//            log2 e) with the difference taken first (its rounding does not
//            grow with |s|), the mask only on tiles that cross the
//            diagonal, the window edge or S. P (and the rows' alpha) go to
//            the warp's own rows in shared memory once.
//   O += PV  each lane holds up to 8 rows x 8 columns of O in registers (64
//            floats at DH 256) and reads P as float4 (one broadcast
//            address) and V as float4 along the head dim (contiguous), one
//            wavefront to six FFMAs again.
// A warp computes only the tiles its own rows meet and waits on, and
// releases, the rest. Query heads of one kv head do not share a block: at DH
// 256 the 64 rows of Q take 66 KB of the 227 and the kernel is bound by its
// FFMAs, not by the K and V bytes that sharing would save.
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

// ---------------------------------------------------------------------------
// f32: CUDA cores, register tiles, K and V brought in by TMA
// ---------------------------------------------------------------------------

constexpr int F_WARPS = 8;                       // consumer warps
constexpr int F_THREADS = 32 * F_WARPS + 128;    // + one producer warpgroup
constexpr int FQ = 8 * F_WARPS;                  // query rows per block
constexpr int FK = 128;                          // keys per tile
constexpr int F_SLOT = 16384;                    // bytes per ring slot
constexpr int F_STAGES = 6;                      // ring slots
constexpr int PS = FK + 4;                       // padded row of P (floats)

template <int DH>
struct F32 {
  // a K chunk: the tile's FK keys over KCW head-dim columns, rows of ROWB
  // bytes in the swizzle of that width (128 B; 64 B at DH 16)
  static constexpr int KCW = DH < 32 ? DH : 32;
  static constexpr int NKC = DH / KCW;           // K chunks per tile
  static constexpr int ROWB = 4 * KCW;
  static constexpr int K_BYTES = FK * ROWB;
  // a V chunk: VK whole rows of the tile, no swizzle
  static constexpr int VK = FK * DH * 4 <= F_SLOT ? FK : F_SLOT / (4 * DH);
  static constexpr int NVC = FK / VK;            // V chunks per tile
  static constexpr int V_BYTES = VK * DH * 4;
  static constexpr int QS = DH + 4;              // padded row of Q (floats)
  // O += P V: a lane holds OR of its warp's 8 rows x NG float4 columns; PC
  // lanes across the head dim, PR down the rows
  static constexpr int PC = DH / 4 < 32 ? DH / 4 : 32;
  static constexpr int PR = 32 / PC;
  static constexpr int OR = 8 / PR;
  static constexpr int NG = DH / (4 * PC);
  // shared memory from a 1024-byte boundary: the ring; each warp's Q rows,
  // P rows and row factors; the full and empty barriers
  static constexpr int Q_OFF = F_STAGES * F_SLOT;
  static constexpr int P_OFF = Q_OFF + FQ * QS * 4;
  static constexpr int A_OFF = P_OFF + FQ * PS * 4;
  static constexpr int BAR_OFF = A_OFF + FQ * 4;
  static constexpr int SMEM = 1024 + BAR_OFF + 16 * F_STAGES;
};

template <int DH>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const float* __restrict__ q, float* __restrict__ o, int S,
                 int H, int KV, float scale, int causal, int window,
                 float softcap) {
  using C = F32<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) -
                            smem_u32(smem_raw));
  const uint32_t ring = smem_u32(sm);
  auto full = [&](int s) { return ring + C::BAR_OFF + 8u * s; };
  auto empty = [&](int s) { return ring + C::BAR_OFF + 8u * (F_STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;        // heaviest tiles first
  const int kh = h / (H / KV);
  const int q_lo = qt * FQ;
  const int nk = (S + FK - 1) / FK;
  // key tiles that meet the block's rows under the causal and window tests;
  // the producer loads exactly these, NKC K chunks then NVC V chunks each
  const int kt_end = causal ? min(nk - 1, (q_lo + FQ - 1) / FK) : nk - 1;
  const int kt_begin = window > 0 ? max(0, q_lo - window + 1) / FK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 32 * F_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32 * F_WARPS) {                // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 32 * F_WARPS) return;
    int s = 0, n = 0;
    for (int kt = kt_begin; kt <= kt_end; ++kt)
      for (int c = 0; c < C::NKC + C::NVC; ++c, ++n) {
        if (n >= F_STAGES) mbar_wait(empty(s), ((n / F_STAGES) - 1) & 1);
        const uint32_t dst = ring + s * F_SLOT;
        if (c < C::NKC) {
          mbar_expect_tx(full(s), C::K_BYTES);
          tma_load(dst, &tm_k, full(s), c * C::KCW, kh, kt * FK, b);
        } else {
          mbar_expect_tx(full(s), C::V_BYTES);
          tma_load(dst, &tm_v, full(s), 0, kh,
                   kt * FK + (c - C::NKC) * C::VK, b);
        }
        if (++s == F_STAGES) s = 0;
      }
    return;
  }

  // consumer warp w: query rows wq_lo .. wq_lo + 7, private Q, P and row
  // factors. S = QK^T: lane (tr, tc) holds rows tr + 2i (i < 4) and keys
  // tc + 16j (j < 8). O += PV: lane (pr, pc) holds rows pr + PR i (i < OR)
  // and columns 4 pc + 4 PC g (g < NG), four each.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tr = lane >> 4, tc = lane & 15;
  const int pr = lane / C::PC, pc = lane % C::PC;
  const int wq_lo = q_lo + 8 * w;
  float* Qw = reinterpret_cast<float*>(sm + C::Q_OFF) + w * 8 * C::QS;
  float* Pw = reinterpret_cast<float*>(sm + C::P_OFF) + w * 8 * PS;
  float* Aw = reinterpret_cast<float*>(sm + C::A_OFF) + w * 8;
  const long long q_stride = static_cast<long long>(H) * DH;  // per position
  const float* qb = q + (static_cast<long long>(b) * S * H + h) * DH;
  for (int e = lane; e < 2 * DH; e += 32) {         // 8 rows of DH / 4 float4
    const int r = e / (DH / 4), c = 4 * (e % (DH / 4)), s = wq_lo + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s < S) x = *reinterpret_cast<const float4*>(qb + s * q_stride + c);
    *reinterpret_cast<float4*>(Qw + r * C::QS + c) = x;
  }
  __syncwarp();

  // K rows are swizzled by TMA: 16-byte unit u of key c lies at unit
  // u ^ (c & 7) (128-byte rows) or u ^ ((c >> 1) & 3) (64-byte rows); the
  // keys tc + 16j of a lane share the mask, and the 16 keys one load reads
  // fill every bank twice
  const int kx = (C::ROWB == 128 ? (tc & 7) : ((tc >> 1) & 3)) << 4;
  const float* qrow = Qw + tr * C::QS;
  const float* prow = Pw + pr * PS;

  float acc[C::OR][C::NG][4];
#pragma unroll
  for (int i = 0; i < C::OR; ++i)
#pragma unroll
    for (int g = 0; g < C::NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.0f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
  }

  // The warp computes the tiles act_begin .. act_end that its rows meet and
  // only waits on, and releases, the rest: a tile wholly masked for all 8
  // rows would leave m, l and O as they are, or be wiped by the first real
  // tile's alpha = 0.
  const int act_begin =
      window > 0 ? max(kt_begin, max(0, wq_lo - window + 1) / FK) : kt_begin;
  const int act_end = wq_lo < S ? kt_end : kt_begin - 1;
  const float inv_cap = softcap != 0.0f ? 1.0f / softcap : 0.0f;
  int s = 0;
  uint32_t par = 0;
  auto next = [&]() {
    if (++s == F_STAGES) {
      s = 0;
      par ^= 1u;
    }
  };
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    if (kt < act_begin || kt > act_end) {
      for (int c = 0; c < C::NKC + C::NVC; ++c) {
        mbar_wait(full(s), par);
        mbar_arrive(empty(s));
        next();
      }
      continue;
    }

    // S = Q K^T over the K chunks, every product an FFMA in head-dim order
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.0f;
    for (int kc = 0; kc < C::NKC; ++kc) {
      mbar_wait(full(s), par);
      const uint8_t* kb = sm + s * F_SLOT + tc * C::ROWB;
      const float* qp = qrow + kc * C::KCW;
#pragma unroll
      for (int u = 0; u < C::KCW / 4; ++u) {
        float4 qa[4], ka[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qa[i] = *reinterpret_cast<const float4*>(qp + 2 * i * C::QS + 4 * u);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          ka[j] = *reinterpret_cast<const float4*>(kb + ((u << 4) ^ kx) +
                                                   16 * j * C::ROWB);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float t = sc[i][j];
            t = __fmaf_rn(qa[i].x, ka[j].x, t);
            t = __fmaf_rn(qa[i].y, ka[j].y, t);
            t = __fmaf_rn(qa[i].z, ka[j].z, t);
            sc[i][j] = __fmaf_rn(qa[i].w, ka[j].w, t);
          }
      }
      mbar_arrive(empty(s));
      next();
    }

    // online softmax in registers: the 16 lanes of a half-warp share a row;
    // the mask only on tiles that cross the diagonal, the window edge or S
    const int k_lo = kt * FK;
    const bool edge = (causal && k_lo + FK - 1 > wq_lo) ||
                      (window > 0 && wq_lo + 7 - k_lo >= window) ||
                      k_lo + FK > S;
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = wq_lo + tr + 2 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = sc[i][j] * scale;
        if (softcap != 0.0f) x = softcap * tanhf(x * inv_cap);
        if (edge) {
          const int kpos = k_lo + tc + 16 * j;
          bool ok = kpos < S;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          if (!ok) x = NEG_INF;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int d = 1; d < 16; d <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ex2((sc[i][j] - m_new) * LOG2E);
        sc[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int d = 1; d < 16; d <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, d);
      alpha[i] = ex2((m[i] - m_new) * LOG2E);
      l[i] = __fmaf_rn(l[i], alpha[i], sum);
      m[i] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Pw[(tr + 2 * i) * PS + tc + 16 * j] = sc[i][j];
    if (tc == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) Aw[tr + 2 * i] = alpha[i];
    }
    __syncwarp();

    // O = alpha O + P V over the V chunks, keys in order
#pragma unroll
    for (int i = 0; i < C::OR; ++i) {
      const float a = Aw[pr + C::PR * i];
#pragma unroll
      for (int g = 0; g < C::NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= a;
    }
    for (int vc = 0; vc < C::NVC; ++vc) {
      mbar_wait(full(s), par);
      const float* vb = reinterpret_cast<const float*>(sm + s * F_SLOT) + 4 * pc;
      const float* pp = prow + vc * C::VK;
#pragma unroll
      for (int kk = 0; kk < C::VK; kk += 4) {
        float4 pa[C::OR];
#pragma unroll
        for (int i = 0; i < C::OR; ++i)
          pa[i] = *reinterpret_cast<const float4*>(pp + C::PR * i * PS + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4 va[C::NG];
#pragma unroll
          for (int g = 0; g < C::NG; ++g)
            va[g] = *reinterpret_cast<const float4*>(vb + (kk + e) * DH +
                                                     4 * C::PC * g);
#pragma unroll
          for (int i = 0; i < C::OR; ++i) {
            const float p = e == 0 ? pa[i].x : e == 1 ? pa[i].y
                          : e == 2 ? pa[i].z : pa[i].w;
#pragma unroll
            for (int g = 0; g < C::NG; ++g) {
              acc[i][g][0] = __fmaf_rn(p, va[g].x, acc[i][g][0]);
              acc[i][g][1] = __fmaf_rn(p, va[g].y, acc[i][g][1]);
              acc[i][g][2] = __fmaf_rn(p, va[g].z, acc[i][g][2]);
              acc[i][g][3] = __fmaf_rn(p, va[g].w, acc[i][g][3]);
            }
          }
        }
      }
      mbar_arrive(empty(s));
      next();
    }
    __syncwarp();                 // P and alpha are read before they move on
  }

  // o = O / l, rows below S
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) Aw[tr + 2 * i] = l[i];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < C::OR; ++i) {
    const int r = pr + C::PR * i, qpos = wq_lo + r;
    if (qpos >= S) continue;
    const float lr = fmaxf(Aw[r], 1e-20f);
    float* orow = o + (static_cast<long long>(b) * S + qpos) * q_stride +
                  h * DH + 4 * pc;
#pragma unroll
    for (int g = 0; g < C::NG; ++g)
      *reinterpret_cast<float4*>(orow + 4 * C::PC * g) =
          make_float4(acc[i][g][0] / lr, acc[i][g][1] / lr,
                      acc[i][g][2] / lr, acc[i][g][3] / lr);
  }
}

// An f32 [B, S, heads, DH] tensor as a 4-D map over (DH, heads, S, B) with
// box (cols, 1, rows, 1).
bool make_map_f32(EncodeTiled enc, CUtensorMap* map, const float* ptr,
                  int DH, int heads, int S, int B, int cols, int rows,
                  CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 4ull * DH;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr),
             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// f32: the CUDA-core kernel.
template <int DH>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int S, int H, int KV, float scale, int causal, int window,
           float softcap, cudaStream_t stream) {
  using C = F32<DH>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tk, tv;
  if (!make_map_f32(enc, &tk, k, DH, KV, S, B, C::KCW, FK,
                    C::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map_f32(enc, &tv, v, DH, KV, S, B, DH, C::VK,
                    CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + FQ - 1) / FQ);
  flash_fwd_kernel<DH><<<grid, F_THREADS, C::SMEM, stream>>>(
      tk, tv, q, o, S, H, KV, scale, causal, window, softcap);
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
// wrapper refuses those first). No row launches nothing and returns 0. Both
// also return cudaErrorInvalidValue where a tensor map cannot be encoded (a
// pointer not 16-byte aligned) and cudaErrorSymbolNotFound where the CUDA
// library has no cuTensorMapEncodeTiled.
int fa_forward_f32(const float* q, const float* k, const float* v, float* o,
                   int B, int S, int H, int KV, int DH, float scale,
                   int causal, int window, float softcap, void* stream) {
  return dispatch(q, k, v, o, B, S, H, KV, DH, scale, causal, window, softcap,
                  stream);
}

// The f32 kernel's dynamic shared memory for head dim DH (0 for none).
int fa_f32_smem_bytes(int DH) {
  switch (DH) {
    case 16: return F32<16>::SMEM;
    case 32: return F32<32>::SMEM;
    case 64: return F32<64>::SMEM;
    case 128: return F32<128>::SMEM;
    case 256: return F32<256>::SMEM;
    default: return 0;
  }
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
