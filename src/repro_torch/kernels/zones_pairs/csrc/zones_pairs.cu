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
// exclude_self drops the cells i == j of each partition (the count skips
// them; the hist scores them -2, as the reference does).
//
// Parity. Each score is the reference's rounded-op formulation,
// (a0*b0 + a1*b1) + a2*b2 with every product and sum rounded to f32
// (__fmul_rn/__fadd_rn, which the compiler never contracts; the build also
// passes -fmad=false). At the paper's radii every within-radius pair sits a
// few ulps from its threshold, so one FMA, TF32 or tensor-core product would
// change the counts. No matrix unit is used: K = 3 is too thin for one, and
// its rounding differs.
//
// Design of zp_hist_masked, zp_count and zp_hist. One block per
// (partition, owned tile, bucket tile), TM = TN = 128 rows, 128 threads;
// ragged C1 and C2 are masked by the tile's row counts, so no shape has to
// divide the tile. A masked block whose tile starts past n_a[p] or n_b[p]
// returns before any load (the Pallas kernel's pl.when). Both tiles are
// staged in shared memory as x/y/z arrays with coalesced loads of the
// contiguous [rows, 3] f32 slab. Each thread owns one owned row and scores
// it against every row of the bucket tile; warp lanes read the same bucket
// row, a shared-memory broadcast. Counts are exact integers: a register
// count, a warp and block reduction, then one 64-bit atomicAdd per block, so
// the result does not depend on block order.
//
// Design of zp_count_masked, for the FP32 issue rate. A block of 128
// threads owns COWN = 128 * CR owned rows (CR = 8) of one partition and
// walks all of that partition's real bucket rows, min(n_b[p], C2), in tiles
// of BT = 256 rows; the grid is P x ceil(C1 / COWN) blocks, and a block whose
// rows start at or past min(n_a[p], C1) returns before any load. Warp w owns
// rows w * 32CR + 32r + lane (r < CR), held in registers, so each bucket row
// read from shared memory feeds up to CR cells; a warp scores only its Rw =
// ceil(real rows of the warp / 32) row slots (a template instance per Rw),
// and a row slot past n_a is scored but not counted. Bucket tiles stay the
// contiguous [rows, 3] slab, double-buffered with cp.async: 16-byte copies
// where the slab's address allows them, 4-byte copies otherwise. Four
// bucket rows are three broadcast 16-byte shared loads, so a cell costs 3
// FMUL, 2 FADD, a compare and an add plus 3 / (4 CR) loads. The per-tile
// counts are floats (see count_slab), moved into an integer count after
// each tile. Staging, the reduction and the atomic are paid once per block.
//
// Bound on an H100. Per score cell: 3 FMUL + 2 FADD (5 FP32 issue slots, no
// FMA possible without losing parity) plus a compare and an add. The floor
// is 5 ops per cell over 132 SMs x 128 FP32 lanes x the SM clock (the
// 67 TFLOP/s FP32 peak counts an FMA as 2): per real cell for the masked
// kernels, per padded cell (P * C1 * C2) for the unmasked ones, which score
// every cell. Memory traffic is O(P * (C1 + C2) * 12 B), negligible beside
// O(P * C1 * C2) cells.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;        // owned rows per tile = threads per block
constexpr int TN = 128;        // bucket rows per tile
constexpr int THREADS = TM;

__device__ __forceinline__ float score(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// Stage `rows` rows of a contiguous [rows, 3] f32 slab into x/y/z arrays.
__device__ __forceinline__ void stage(const float* __restrict__ src, int rows,
                                      float* sx, float* sy, float* sz) {
  for (int f = threadIdx.x; f < rows * 3; f += THREADS) {
    const float v = src[f];
    const int r = f / 3, c = f - 3 * r;
    (c == 0 ? sx : (c == 1 ? sy : sz))[r] = v;
  }
}

// Block coordinates: blockIdx.x enumerates (p, ti, tj) with tj fastest.
struct Tile {
  int p, i0, j0, rows_a, rows_b;
  long long a_off, b_off;      // first float of the tile's slabs
};

// n_a == nullptr: unmasked, every row of the capacity is real.
__device__ __forceinline__ bool locate(const int* __restrict__ n_a,
                                       const int* __restrict__ n_b, int C1,
                                       int C2, int gm, int gn, Tile* t) {
  const long long blk = blockIdx.x;
  const int tj = static_cast<int>(blk % gn);
  const int ti = static_cast<int>((blk / gn) % gm);
  const int p = static_cast<int>(blk / (static_cast<long long>(gn) * gm));
  const int i0 = ti * TM, j0 = tj * TN;
  const int na = n_a ? min(n_a[p], C1) : C1;    // as the mask does
  const int nb = n_b ? min(n_b[p], C2) : C2;
  if (i0 >= na || j0 >= nb) return false;       // all-padding tile
  t->p = p;
  t->i0 = i0;
  t->j0 = j0;
  t->rows_a = min(TM, na - i0);
  t->rows_b = min(TN, nb - j0);
  t->a_off = (static_cast<long long>(p) * C1 + i0) * 3;
  t->b_off = (static_cast<long long>(p) * C2 + j0) * 3;
  return true;
}

// The unmasked count. kExcludeSelf: skip the cell i == j of each partition.
template <bool kExcludeSelf>
__global__ void __launch_bounds__(THREADS)
count_kernel(const float* __restrict__ a, const float* __restrict__ b,
             int C1, int C2, int gm, int gn, float cmin,
             unsigned long long* __restrict__ out) {
  Tile t;
  if (!locate(nullptr, nullptr, C1, C2, gm, gn, &t)) return;
  __shared__ float ax[TM], ay[TM], az[TM];
  __shared__ float bx[TN], by[TN], bz[TN];
  stage(a + t.a_off, t.rows_a, ax, ay, az);
  stage(b + t.b_off, t.rows_b, bx, by, bz);
  __syncthreads();

  unsigned int cnt = 0;
  const int i = threadIdx.x;
  if (i < t.rows_a) {
    const float x = ax[i], y = ay[i], z = az[i];
    const int diag = t.i0 + i - t.j0;            // this row's i == j column
#pragma unroll 4
    for (int j = 0; j < t.rows_b; ++j) {
      bool ok = score(x, y, z, bx[j], by[j], bz[j]) >= cmin;
      if (kExcludeSelf) ok = ok && j != diag;
      cnt += ok;
    }
  }

  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  __shared__ unsigned int warp_sum[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sum[w];
    if (s) atomicAdd(out, s);
  }
}

// Dynamic shared memory: nb edges (f32, sorted descending) + nb+1 bins.
template <bool kExcludeSelf>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const float* __restrict__ a, const float* __restrict__ b,
            const int* __restrict__ n_a, const int* __restrict__ n_b,
            int C1, int C2, int gm, int gn,
            const float* __restrict__ edges_desc, int nb,
            unsigned long long* __restrict__ hist) {
  Tile t;
  if (!locate(n_a, n_b, C1, C2, gm, gn, &t)) return;
  extern __shared__ float dyn[];
  float* e = dyn;
  unsigned int* h = reinterpret_cast<unsigned int*>(dyn + nb);
  __shared__ float ax[TM], ay[TM], az[TM];
  __shared__ float bx[TN], by[TN], bz[TN];
  for (int k = threadIdx.x; k < nb; k += THREADS) e[k] = edges_desc[k];
  for (int k = threadIdx.x; k <= nb; k += THREADS) h[k] = 0;
  stage(a + t.a_off, t.rows_a, ax, ay, az);
  stage(b + t.b_off, t.rows_b, bx, by, bz);
  __syncthreads();

  const float e_min = e[nb - 1];                 // the loosest edge
  const int i = threadIdx.x;
  if (i < t.rows_a) {
    const float x = ax[i], y = ay[i], z = az[i];
    const int diag = t.i0 + i - t.j0;            // this row's i == j column
#pragma unroll 4
    for (int j = 0; j < t.rows_b; ++j) {
      float s = score(x, y, z, bx[j], by[j], bz[j]);
      if (kExcludeSelf && j == diag) s = -2.0f;  // the reference's diagonal
      if (s >= e_min) {                          // rare: a pair within range
        int c = 0;
        for (int k = 0; k < nb; ++k) c += s >= e[k];
        atomicAdd(&h[c], 1u);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k <= nb; k += THREADS)
    if (h[k]) atomicAdd(&hist[k], static_cast<unsigned long long>(h[k]));
}

inline int blocks_of(int P, int C1, int C2, int* gm, int* gn,
                     unsigned int* grid) {
  *gm = (C1 + TM - 1) / TM;
  *gn = (C2 + TN - 1) / TN;
  const long long n = static_cast<long long>(P) * *gm * *gn;
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  *grid = static_cast<unsigned int>(n);
  return 0;
}

// The unmasked count (zp_count); the masked one has its own kernel below.
int launch_count(const float* a, const float* b, int P, int C1, int C2,
                 float cmin, bool exclude_self, unsigned long long* out,
                 void* stream) {
  int gm, gn;
  unsigned int grid;
  if (int err = blocks_of(P, C1, C2, &gm, &gn, &grid)) return err;
  if (grid == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exclude_self)
    count_kernel<true><<<grid, THREADS, 0, s>>>(a, b, C1, C2, gm, gn, cmin,
                                                out);
  else
    count_kernel<false><<<grid, THREADS, 0, s>>>(a, b, C1, C2, gm, gn, cmin,
                                                 out);
  return static_cast<int>(cudaGetLastError());
}

int launch_hist(const float* a, const float* b, const int* n_a,
                const int* n_b, int P, int C1, int C2,
                const float* edges_desc, int nb, bool exclude_self,
                unsigned long long* hist, void* stream) {
  int gm, gn;
  unsigned int grid;
  if (int err = blocks_of(P, C1, C2, &gm, &gn, &grid)) return err;
  if (grid == 0 || nb == 0) return 0;
  const size_t smem = sizeof(float) * nb + sizeof(unsigned int) * (nb + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exclude_self)
    hist_kernel<true><<<grid, THREADS, smem, s>>>(a, b, n_a, n_b, C1, C2, gm,
                                                  gn, edges_desc, nb, hist);
  else
    hist_kernel<false><<<grid, THREADS, smem, s>>>(a, b, n_a, n_b, C1, C2, gm,
                                                   gn, edges_desc, nb, hist);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// zp_count_masked: register-tiled rows, whole-partition bucket walk
// ---------------------------------------------------------------------------

constexpr int CR = 8;                   // owned rows per thread
constexpr int CWARP_ROWS = 32 * CR;     // owned rows per warp
constexpr int COWN = 4 * CWARP_ROWS;    // owned rows per block (4 warps)
constexpr int BT = 256;                 // bucket rows per staged tile
constexpr int BT_FLOATS = 3 * BT;

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
// slab.
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
}

// Score this warp's R row slots against `rows` bucket rows of a staged
// slab, adding to c[r] the cells with score >= cmin. The counts are floats,
// a select of 1.0 or 0.0 and an FADD (faster on an H100 than integer
// counts); a tile adds at most BT = 256 to each, so every sum is exact.
template <int R>
__device__ __forceinline__ void count_slab(const float (&x)[CR],
                                           const float (&y)[CR],
                                           const float (&z)[CR],
                                           const float* slab, int rows,
                                           float cmin, float (&c)[CR]) {
  const float4* s4 = reinterpret_cast<const float4*>(slab);
  const int quads = rows >> 2;
#pragma unroll 2
  for (int q = 0; q < quads; ++q) {
    const float4 u = s4[3 * q], v = s4[3 * q + 1], w = s4[3 * q + 2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      c[r] += score(x[r], y[r], z[r], u.x, u.y, u.z) >= cmin ? 1.0f : 0.0f;
      c[r] += score(x[r], y[r], z[r], u.w, v.x, v.y) >= cmin ? 1.0f : 0.0f;
      c[r] += score(x[r], y[r], z[r], v.z, v.w, w.x) >= cmin ? 1.0f : 0.0f;
      c[r] += score(x[r], y[r], z[r], w.y, w.z, w.w) >= cmin ? 1.0f : 0.0f;
    }
  }
  for (int j = quads << 2; j < rows; ++j) {
    const float bx = slab[3 * j], by = slab[3 * j + 1], bz = slab[3 * j + 2];
#pragma unroll
    for (int r = 0; r < R; ++r)
      c[r] += score(x[r], y[r], z[r], bx, by, bz) >= cmin ? 1.0f : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
count_masked_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const int* __restrict__ n_a, const int* __restrict__ n_b,
                    int C1, int C2, int gm, float cmin,
                    unsigned long long* __restrict__ out) {
  const long long blk = blockIdx.x;
  const int ti = static_cast<int>(blk % gm);
  const int p = static_cast<int>(blk / gm);
  const int na = min(n_a[p], C1);
  const int nb = min(n_b[p], C2);
  const int i0 = ti * COWN;
  if (i0 >= na || nb <= 0) return;              // no real cell

  __shared__ __align__(16) float slab[2][BT_FLOATS];
  const float* bp = b + static_cast<long long>(p) * C2 * 3;
  // 16-byte copies need the partition's slab 16-byte aligned; each tile
  // starts 12 * BT bytes, a multiple of 16, further on
  const bool aligned = (reinterpret_cast<uintptr_t>(bp) & 15) == 0;
  const int tiles = (nb + BT - 1) / BT;
  stage_slab(slab[0], bp, min(BT, nb), aligned);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = i0 + warp * CWARP_ROWS;        // this warp's first row
  const int rw = max(0, min(CR, (na - w0 + 31) / 32));  // row slots scored
  float x[CR], y[CR], z[CR];
  float c[CR];                                  // this tile's counts
  bool real[CR];
  unsigned long long cnt = 0;                   // real rows' counts so far
#pragma unroll
  for (int r = 0; r < CR; ++r) {
    const int i = w0 + 32 * r + lane;
    real[r] = i < na;
    const float* ap = a + (static_cast<long long>(p) * C1 + i) * 3;
    x[r] = real[r] ? ap[0] : 0.0f;
    y[r] = real[r] ? ap[1] : 0.0f;
    z[r] = real[r] ? ap[2] : 0.0f;
  }

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int j1 = (t + 1) * BT;
      stage_slab(slab[(t + 1) & 1], bp + 3LL * j1, min(BT, nb - j1), aligned);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                            // tile t landed for all
    const float* s = slab[t & 1];
    const int rows = min(BT, nb - t * BT);
#pragma unroll
    for (int r = 0; r < CR; ++r) c[r] = 0.0f;
    switch (rw) {                               // warp-uniform
      case 1: count_slab<1>(x, y, z, s, rows, cmin, c); break;
      case 2: count_slab<2>(x, y, z, s, rows, cmin, c); break;
      case 3: count_slab<3>(x, y, z, s, rows, cmin, c); break;
      case 4: count_slab<4>(x, y, z, s, rows, cmin, c); break;
      case 5: count_slab<5>(x, y, z, s, rows, cmin, c); break;
      case 6: count_slab<6>(x, y, z, s, rows, cmin, c); break;
      case 7: count_slab<7>(x, y, z, s, rows, cmin, c); break;
      case 8: count_slab<8>(x, y, z, s, rows, cmin, c); break;
      default: break;
    }
#pragma unroll
    for (int r = 0; r < CR; ++r)
      cnt += real[r] ? static_cast<unsigned>(c[r]) : 0u;
    __syncthreads();                            // tile t read: reusable
  }

  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  __shared__ unsigned long long warp_sum[THREADS / 32];
  if (lane == 0) warp_sum[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < THREADS / 32; ++w) sum += warp_sum[w];
    if (sum) atomicAdd(out, sum);
  }
}

int launch_count_masked(const float* a, const float* b, const int* n_a,
                        const int* n_b, int P, int C1, int C2, float cmin,
                        unsigned long long* out, void* stream) {
  const int gm = (C1 + COWN - 1) / COWN;
  const long long n = static_cast<long long>(P) * gm;
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (n == 0 || C2 == 0) return 0;
  count_masked_kernel<<<static_cast<unsigned int>(n), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, b, n_a, n_b, C1, C2, gm, cmin, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched). An empty
// grid launches nothing and returns 0; the Python wrappers never pass one.
int zp_count_masked(const float* a, const float* b, const int* n_a,
                    const int* n_b, int P, int C1, int C2, float cmin,
                    unsigned long long* out, void* stream) {
  return launch_count_masked(a, b, n_a, n_b, P, C1, C2, cmin, out, stream);
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
  return launch_count(a, b, P, M, N, cmin, exclude_self != 0, out, stream);
}

int zp_hist(const float* a, const float* b, int P, int M, int N,
            const float* edges_desc, int nb, int exclude_self,
            unsigned long long* hist, void* stream) {
  return launch_hist(a, b, nullptr, nullptr, P, M, N, edges_desc, nb,
                     exclude_self != 0, hist, stream);
}

}  // extern "C"
