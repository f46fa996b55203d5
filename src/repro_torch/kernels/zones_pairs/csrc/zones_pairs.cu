// Batched Zones pair kernels for Hopper (sm_90a), CUDA cores only.
//
// Replaces four Pallas TPU kernels of the JAX package
// (src/repro/kernels/zones_pairs/kernel.py):
//   zp_count_masked  <- pair_count_masked_pallas (_count_masked_kernel)
//   zp_hist_masked   <- pair_hist_masked_pallas  (_hist_masked_kernel)
//   zp_count         <- pair_count_pallas        (_count_kernel)
//   zp_hist          <- pair_hist_pallas         (_hist_kernel)
//
// What they compute, over P partitions (a: [P, C1, 3], b: [P, C2, 3] f32):
//   count: #{(p, i, j) : dot(a[p,i], b[p,j]) >= cmin}
//   hist : per cell with score >= the loosest edge, c = #{k : score >= e[k]}
//          is added to hist[c]; the caller turns the histogram into the
//          cumulative per-edge counts (edges sorted descending).
// The masked kernels (device engine, one launch per size tier) count only
// cells with i < n_a[p] and j < n_b[p]. The unmasked kernels (host engine,
// one launch over all partitions at one global capacity, the batched form
// of the JAX package's lax.map over partitions) score every cell: padding
// rows are zero vectors that score 0, exactly as on the TPU. Their
// exclude_self drops the cells i == j of each partition (the count leaves
// them out; the hist scores them -2, as the reference does).
//
// Parity. Each score is the reference's rounded-op formulation,
// (a0*b0 + a1*b1) + a2*b2 with every product and sum rounded to f32
// (__fmul_rn/__fadd_rn, which the compiler never contracts; the build also
// passes -fmad=false). At the paper's radii every within-radius pair sits a
// few ulps from its threshold, so one FMA, TF32 or tensor-core product would
// change the counts. No matrix unit is used: K = 3 is too thin for one, and
// its rounding differs. Counts and bins are integers summed with 64-bit
// atomics, so no result depends on block order.
//
// Which kernel serves which entry point (all four run the walk below):
//   zp_count_masked, zp_count -> count_tiled_kernel<kMasked>
//   zp_hist_masked, zp_hist   -> hist_tiled_kernel<kMasked>
//
// The walk, for the FP32 issue rate. A block of 128 threads owns COWN =
// 128 * CR owned rows (CR = 8) of one partition and walks all of that
// partition's real bucket rows, min(n_b[p], C2) (C2 unmasked), in slabs of
// BT = 256 rows; the grid is P x ceil(C1 / COWN) blocks, and a block whose
// rows start at or past min(n_a[p], C1) returns before any load. Warp w
// owns rows w * 32CR + 32r + lane (r < CR), held in registers, so each
// bucket row read from shared memory feeds up to CR cells; a warp scores
// only its Rw = ceil(real rows of the warp / 32) row slots (a template
// instance per Rw). A row slot past n_a holds NaN, which scores NaN and
// passes no threshold. Slabs stay the contiguous [rows, 3] layout,
// double-buffered with cp.async: 16-byte copies where the slab's address
// allows them, 4-byte copies otherwise; a slab whose rows are not a multiple
// of 4 is padded with NaN rows to the next one. Four bucket rows are three
// broadcast 16-byte shared loads, so the per-cell work is:
//   count: 3 FMUL, 2 FADD, a compare and an add (float counts per slab,
//          see count_slab); the unmasked exclude_self re-scores each row's
//          diagonal cell once at the end and takes it off if it passed.
//   hist : 3 FMUL, 2 FADD and an FMNMX into a running max per row slot; one
//          test of the max against the loosest edge per quad of bucket rows
//          covers all the thread's row slots (4 Rw cells). Only a quad that
//          passes takes the rare path (bin_quad): for each row slot that
//          passed, it reads the row again and re-scores the quad's cells
//          with the same score(), so the bins are those of the exact scores,
//          finds c by a branchless binary search over the descending edges
//          in shared memory and adds one to a shared 64-bit bin. At the
//          paper's radii a hit is rare (about 1.5 per owned row over its
//          whole partition, the self pair included, against about 5,000
//          cells), but a warp enters the rare path whenever one of its
//          lanes has a hit in the quad. The unmasked exclude_self re-scores
//          each row's diagonal cell once at the end, takes it out of its bin
//          if it was binned, and bins -2 in its place where -2 passes the
//          loosest edge, as the reference scores the diagonal.
// Staging, the reduction and the flush are paid once per block.
//
// Bound on an H100. Per score cell: 3 FMUL + 2 FADD (5 FP32 issue slots, no
// FMA possible without losing parity). The floor is 5 ops per cell over 132
// SMs x 128 FP32 lanes x the SM clock (the 67 TFLOP/s FP32 peak counts an
// FMA as 2): per real cell for the masked kernels, per padded cell
// (P * C1 * C2) for the unmasked ones, which score every cell. Memory
// traffic is O(P * (C1 + C2) * 12 B), negligible beside O(P * C1 * C2)
// cells.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float score(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// ---------------------------------------------------------------------------
// The walk: register-tiled owned rows, whole-partition bucket slabs
// ---------------------------------------------------------------------------

constexpr int CR = 8;                   // owned rows per thread
constexpr int CWARP_ROWS = 32 * CR;     // owned rows per warp
constexpr int COWN = 4 * CWARP_ROWS;    // owned rows per block (4 warps)
constexpr int BT = 256;                 // bucket rows per staged slab
constexpr int BT_FLOATS = 3 * BT;

__device__ __forceinline__ float nan_f32() {
  return __int_as_float(0x7fffffff);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `rows` rows of the [rows, 3] slab at `src` into `dst` (16-byte
// aligned): 16-byte copies when `aligned` (src is 16-byte aligned), the
// tail and every unaligned slab in 4-byte copies. Reads no float past the
// slab. Rows up to the next multiple of 4 are NaN, so a slab is whole quads.
__device__ __forceinline__ void stage_slab(float* dst, const float* src,
                                           int rows, bool aligned) {
  const int n = rows * 3;
  int done = 0;
  if (aligned) {
    const int n16 = n / 4;
    for (int c = threadIdx.x; c < n16; c += THREADS)
      cp_async16(dst + 4 * c, src + 4 * c);
    done = 4 * n16;
  }
  for (int f = done + threadIdx.x; f < n; f += THREADS)
    cp_async4(dst + f, src + f);
  for (int f = n + threadIdx.x; f < 3 * ((rows + 3) & ~3); f += THREADS)
    dst[f] = nan_f32();
}

// A thread's owned rows: row slot r is row w0 + 32 r + lane.
struct Rows {
  float x[CR], y[CR], z[CR];
};

// Score R row slots against the `quads` quads of a staged slab, adding to
// c[r] the cells with score >= cmin. The counts are floats, a select of 1.0
// or 0.0 and an FADD (faster on an H100 than integer counts); a slab adds at
// most BT = 256 to each, so every sum is exact.
template <int R>
__device__ __forceinline__ void count_slab(const Rows& w, const float* slab,
                                           int quads, float cmin,
                                           float (&c)[CR]) {
  const float4* s4 = reinterpret_cast<const float4*>(slab);
#pragma unroll 2
  for (int q = 0; q < quads; ++q) {
    const float4 u = s4[3 * q], v = s4[3 * q + 1], t = s4[3 * q + 2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = w.x[r], y = w.y[r], z = w.z[r];
      c[r] += score(x, y, z, u.x, u.y, u.z) >= cmin ? 1.0f : 0.0f;
      c[r] += score(x, y, z, u.w, v.x, v.y) >= cmin ? 1.0f : 0.0f;
      c[r] += score(x, y, z, v.z, v.w, t.x) >= cmin ? 1.0f : 0.0f;
      c[r] += score(x, y, z, t.y, t.z, t.w) >= cmin ? 1.0f : 0.0f;
    }
  }
}

// The count's consumer: a thread's count of cells with score >= cmin, then
// a block sum and one 64-bit atomic.
template <bool kMasked>
struct CountOp {
  float cmin;
  int exclude_self;                     // unmasked only
  unsigned long long* out;
  unsigned long long cnt;               // this thread's count so far

  __device__ __forceinline__ void begin(const float*, int) { cnt = 0; }

  template <int R>
  __device__ __forceinline__ void slab(const Rows& w, const float* s,
                                       int quads) {
    float c[CR];
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = 0.0f;
    count_slab<R>(w, s, quads, cmin, c);
#pragma unroll
    for (int r = 0; r < R; ++r) cnt += static_cast<unsigned>(c[r]);
  }

  // bp: the partition's bucket rows; rows_a owned and rows_b bucket rows
  // are real, and w0 is this warp's first owned row.
  __device__ __forceinline__ void finish(const Rows& w, const float* bp,
                                         int rows_a, int rows_b, int w0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (!kMasked && exclude_self) {     // take off the passing diagonal
#pragma unroll
      for (int r = 0; r < CR; ++r) {
        const int i = w0 + 32 * r + lane;
        if (i < rows_b) {
          const float* q = bp + 3LL * i;
          cnt -= score(w.x[r], w.y[r], w.z[r], q[0], q[1], q[2]) >= cmin;
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1)
      cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    __shared__ unsigned long long warp_sum[THREADS / 32];
    if (lane == 0) warp_sum[warp] = cnt;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long sum = 0;
      for (int k = 0; k < THREADS / 32; ++k) sum += warp_sum[k];
      if (sum) atomicAdd(out, sum);
    }
  }
};

// c = #{k : s >= e[k]} for a score at or above the loosest edge e[nb - 1]:
// nb less the first k with e[k] <= s, found by a branchless binary search
// over the descending edges (ceil(log2 nb) steps for every lane). A
// duplicated edge counts once per copy, as a linear count over the edges
// would.
__device__ __forceinline__ int edges_passed(float s, const float* e, int nb) {
  int lo = 0;                           // the first k with e[k] <= s is in
  for (int n = nb; n > 1;) {            // [lo, lo + n)
    const int half = n >> 1;
    lo = e[lo + half - 1] > s ? lo + half : lo;
    n -= half;
  }
  return nb - lo;
}

// The histogram's consumer. Bins in shared memory: nb + 1 64-bit bins (a
// block covers 1,024 x C2 cells, more than 32 bits hold for C2 >= 4M),
// then nb f32 edges sorted descending.
template <bool kMasked>
struct HistOp {
  const float* edges_desc;
  int nb;
  int exclude_self;                     // unmasked only
  unsigned long long* hist;
  unsigned long long* h;                // shared bins
  float* e;                             // shared edges
  const float* ap;                      // the partition's owned rows
  int row0;                             // this thread's row slot 0

  __device__ __forceinline__ void begin(const float* ap_, int row0_) {
    ap = ap_;
    row0 = row0_;
    for (int k = threadIdx.x; k < nb; k += THREADS) e[k] = edges_desc[k];
    for (int k = threadIdx.x; k <= nb; k += THREADS) h[k] = 0;
  }

  // The rare path: bin the cells of the quad (u, v, t) for the row slots
  // in `slots` (bit r: slot r's running max reached the loosest edge). A
  // slot's row is read again from global memory (registers cannot be
  // indexed by a run-time slot) and re-scored with score(), so every bin
  // holds exact scores; each lane bins its own passing cells, in step with
  // the other lanes.
  __device__ __forceinline__ void bin_quad(unsigned slots, float4 u,
                                           float4 v, float4 t, float e_min) {
#pragma unroll 1
    while (slots) {
      const int r = __ffs(slots) - 1;
      slots &= slots - 1;
      const float* q = ap + 3LL * (row0 + 32 * r);
      const float x = q[0], y = q[1], z = q[2];
      const float s0 = score(x, y, z, u.x, u.y, u.z);
      const float s1 = score(x, y, z, u.w, v.x, v.y);
      const float s2 = score(x, y, z, v.z, v.w, t.x);
      const float s3 = score(x, y, z, t.y, t.z, t.w);
      unsigned cells = (s0 >= e_min) | (s1 >= e_min) << 1 |
                       (s2 >= e_min) << 2 | (s3 >= e_min) << 3;
      while (cells) {
        const int k = __ffs(cells) - 1;
        cells &= cells - 1;
        const float s = k == 0 ? s0 : k == 1 ? s1 : k == 2 ? s2 : s3;
        atomicAdd(&h[edges_passed(s, e, nb)], 1ull);
      }
    }
  }

  template <int R>
  __device__ __forceinline__ void slab(const Rows& w, const float* s,
                                       int quads) {
    const float e_min = e[nb - 1];      // the loosest edge
    const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll 1                        // unrolled twice, the rare path spills
    for (int q = 0; q < quads; ++q) {
      const float4 u = s4[3 * q], v = s4[3 * q + 1], t = s4[3 * q + 2];
      float m[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = w.x[r], y = w.y[r], z = w.z[r];
        m[r] = fmaxf(fmaxf(score(x, y, z, u.x, u.y, u.z),
                           score(x, y, z, u.w, v.x, v.y)),
                     fmaxf(score(x, y, z, v.z, v.w, t.x),
                           score(x, y, z, t.y, t.z, t.w)));
      }
      float top = m[0];
#pragma unroll
      for (int r = 1; r < R; ++r) top = fmaxf(top, m[r]);
      if (top >= e_min) {               // one screen per quad; rarely passes
        unsigned slots = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) slots |= (m[r] >= e_min ? 1u : 0u) << r;
        bin_quad(slots, u, v, t, e_min);
      }
    }
  }

  // Under exclude_self the reference scores each diagonal cell (i, i) -2:
  // the cell is re-scored with score() (its owned row read again from
  // global memory, as in bin_quad, so no register row stays live past the
  // walk), taken out of the bin the walk put it in (if it reached the
  // loosest edge), and -2 is binned in its place (if it reaches the loosest
  // edge). A bin may wrap below 0 in one thread; the block's sums are exact.
  __device__ __forceinline__ void finish(const Rows&, const float* bp,
                                         int rows_a, int rows_b, int) {
    if (!kMasked && exclude_self) {
      const float e_min = e[nb - 1];
      unsigned long long diag = 0;      // this thread's diagonal cells
#pragma unroll 1
      for (int i = row0; i < min(rows_a, rows_b) && i < row0 + 32 * CR;
           i += 32) {
        const float* p = ap + 3LL * i;
        const float* q = bp + 3LL * i;
        const float s = score(p[0], p[1], p[2], q[0], q[1], q[2]);
        if (s >= e_min) atomicAdd(&h[edges_passed(s, e, nb)], ~0ull);
        ++diag;
      }
      if (diag && -2.0f >= e_min)
        atomicAdd(&h[edges_passed(-2.0f, e, nb)], diag);
    }
    __syncthreads();
    for (int k = threadIdx.x; k <= nb; k += THREADS)
      if (h[k]) atomicAdd(&hist[k], h[k]);
  }
};

// One block's walk over its partition; `op` is the per-slab consumer
// (CountOp or HistOp). kMasked: the real counts come from n_a and n_b;
// otherwise every row of the capacity is real.
template <bool kMasked, class Op>
__device__ __forceinline__ void walk(const float* __restrict__ a,
                                     const float* __restrict__ b,
                                     const int* __restrict__ n_a,
                                     const int* __restrict__ n_b, int C1,
                                     int C2, int gm, Op& op) {
  const long long blk = blockIdx.x;
  const int ti = static_cast<int>(blk % gm);
  const int p = static_cast<int>(blk / gm);
  const int na = kMasked ? min(n_a[p], C1) : C1;
  const int nb = kMasked ? min(n_b[p], C2) : C2;
  const int i0 = ti * COWN;
  if (i0 >= na || nb <= 0) return;              // no real cell

  __shared__ __align__(16) float slab[2][BT_FLOATS];
  const float* bp = b + static_cast<long long>(p) * C2 * 3;
  // 16-byte copies need the partition's slab 16-byte aligned; each slab
  // starts 12 * BT bytes, a multiple of 16, further on
  const bool aligned = (reinterpret_cast<uintptr_t>(bp) & 15) == 0;
  const int tiles = (nb + BT - 1) / BT;
  stage_slab(slab[0], bp, min(BT, nb), aligned);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = i0 + warp * CWARP_ROWS;        // this warp's first row
  const int rw = max(0, min(CR, (na - w0 + 31) / 32));  // row slots scored
  Rows w;
#pragma unroll
  for (int r = 0; r < CR; ++r) {
    const int i = w0 + 32 * r + lane;
    const float* ap = a + (static_cast<long long>(p) * C1 + i) * 3;
    w.x[r] = i < na ? ap[0] : nan_f32();
    w.y[r] = i < na ? ap[1] : nan_f32();
    w.z[r] = i < na ? ap[2] : nan_f32();
  }
  op.begin(a + static_cast<long long>(p) * C1 * 3, w0 + lane);

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int j1 = (t + 1) * BT;
      stage_slab(slab[(t + 1) & 1], bp + 3LL * j1, min(BT, nb - j1), aligned);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                            // slab t landed for all
    const float* s = slab[t & 1];
    const int quads = (min(BT, nb - t * BT) + 3) >> 2;
    switch (rw) {                               // warp-uniform
      case 1: op.template slab<1>(w, s, quads); break;
      case 2: op.template slab<2>(w, s, quads); break;
      case 3: op.template slab<3>(w, s, quads); break;
      case 4: op.template slab<4>(w, s, quads); break;
      case 5: op.template slab<5>(w, s, quads); break;
      case 6: op.template slab<6>(w, s, quads); break;
      case 7: op.template slab<7>(w, s, quads); break;
      case 8: op.template slab<8>(w, s, quads); break;
      default: break;
    }
    __syncthreads();                            // slab t read: reusable
  }
  op.finish(w, bp, na, nb, w0);
}

template <bool kMasked>
__global__ void __launch_bounds__(THREADS)
count_tiled_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const int* __restrict__ n_a, const int* __restrict__ n_b,
                   int C1, int C2, int gm, float cmin, int exclude_self,
                   unsigned long long* __restrict__ out) {
  CountOp<kMasked> op{cmin, exclude_self, out, 0};
  walk<kMasked>(a, b, n_a, n_b, C1, C2, gm, op);
}

template <bool kMasked>
__global__ void __launch_bounds__(THREADS)
hist_tiled_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const int* __restrict__ n_a, const int* __restrict__ n_b,
                  int C1, int C2, int gm,
                  const float* __restrict__ edges_desc, int nb,
                  int exclude_self, unsigned long long* __restrict__ hist) {
  extern __shared__ __align__(16) unsigned long long bins[];
  HistOp<kMasked> op{edges_desc, nb, exclude_self, hist, bins,
                     reinterpret_cast<float*>(bins + nb + 1)};
  walk<kMasked>(a, b, n_a, n_b, C1, C2, gm, op);
}

// -> the walk's grid, P x ceil(C1 / COWN), or 0 when it has no cell.
inline long long walk_blocks(int P, int C1, int C2) {
  return C2 ? static_cast<long long>(P) * ((C1 + COWN - 1) / COWN) : 0;
}

// n_a and n_b null: the unmasked instances.
int launch_count(const float* a, const float* b, const int* n_a,
                 const int* n_b, int P, int C1, int C2, float cmin,
                 bool exclude_self, unsigned long long* out, void* stream) {
  const long long n = walk_blocks(P, C1, C2);
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (n == 0) return 0;
  const int gm = (C1 + COWN - 1) / COWN;
  const unsigned int grid = static_cast<unsigned int>(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_a)
    count_tiled_kernel<true><<<grid, THREADS, 0, s>>>(a, b, n_a, n_b, C1, C2,
                                                      gm, cmin, 0, out);
  else
    count_tiled_kernel<false><<<grid, THREADS, 0, s>>>(
        a, b, nullptr, nullptr, C1, C2, gm, cmin, exclude_self, out);
  return static_cast<int>(cudaGetLastError());
}

int launch_hist(const float* a, const float* b, const int* n_a,
                const int* n_b, int P, int C1, int C2,
                const float* edges_desc, int nb, bool exclude_self,
                unsigned long long* hist, void* stream) {
  const long long n = walk_blocks(P, C1, C2);
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (n == 0 || nb == 0) return 0;
  const int smem = static_cast<int>(sizeof(unsigned long long) * (nb + 1) +
                                    sizeof(float) * nb);
  const auto kern = n_a ? &hist_tiled_kernel<true> : &hist_tiled_kernel<false>;
  if (smem > 48 * 1024) {               // beyond the default dynamic limit
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<static_cast<unsigned int>(n), THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
      a, b, n_a, n_b, C1, C2, (C1 + COWN - 1) / COWN, edges_desc, nb,
      n_a ? 0 : static_cast<int>(exclude_self), hist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched). An empty
// grid launches nothing and returns 0; the Python wrappers never pass one.
int zp_count_masked(const float* a, const float* b, const int* n_a,
                    const int* n_b, int P, int C1, int C2, float cmin,
                    unsigned long long* out, void* stream) {
  return launch_count(a, b, n_a, n_b, P, C1, C2, cmin, false, out, stream);
}

int zp_hist_masked(const float* a, const float* b, const int* n_a,
                   const int* n_b, int P, int C1, int C2,
                   const float* edges_desc, int nb, unsigned long long* hist,
                   void* stream) {
  return launch_hist(a, b, n_a, n_b, P, C1, C2, edges_desc, nb, false, hist,
                     stream);
}

int zp_count(const float* a, const float* b, int P, int M, int N, float cmin,
             int exclude_self, unsigned long long* out, void* stream) {
  return launch_count(a, b, nullptr, nullptr, P, M, N, cmin,
                      exclude_self != 0, out, stream);
}

int zp_hist(const float* a, const float* b, int P, int M, int N,
            const float* edges_desc, int nb, int exclude_self,
            unsigned long long* hist, void* stream) {
  return launch_hist(a, b, nullptr, nullptr, P, M, N, edges_desc, nb,
                     exclude_self != 0, hist, stream);
}

}  // extern "C"
