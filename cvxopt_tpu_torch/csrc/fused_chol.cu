// Fused condensed-KKT factor and solve for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of cvxopt_tpu/ops/pallas_chol.py:
//   schur_chol  <- fused_schur_cholesky (:129) and
//                  fused_schur_cholesky_batched (:338)
//   chol_solve  <- fused_cholesky_solve (:194) and
//                  fused_cholesky_solve_batched (:404)
//
// At n = 64 schur_chol is one launch, schur_chol64 (below).  At larger n
// it is two launches (for a batch much smaller than the SM count the
// second is panel_factor's loop instead, and the solve panel_solve: see
// "the small-batch path" below):
//   schur_assemble  S = P + Gt diag(dinv2) Gt', S's lower 128x128 tiles,
//                   one block per (instance, tile), written into L
//   schur_factor    one block per instance:
//                   [equilibrate] deq = 1/sqrt(max(diag S, 1e-30)), S := D S D
//                   S = L L'  blocked right-looking Cholesky, panel BP = 64
//                   Dinv[j] = inverse of L's j-th diagonal 64x64 block
// chol_solve: x = (L L')^{-1} b for b stored as rows, panel by panel through
// the Dinv products (forward, then backward), in one of two kernels:
//   solve_many  nrhs > FEW: one block per (instance, 64 rows of b)
//   solve_few   nrhs <= FEW: one block per (instance, row of b)
//
// What bounds them on this card, and what the design does about it.
//
// f32 runs on the CUDA cores (FFMA): TF32 is off in the port, because the
// interior-point method diverges on reduced-precision products.
//
// schur_assemble is n (n+1) m FLOP per instance for S's lower triangle and
// is bound by FP32 operations, provided shared memory and L2 keep up.  Each
// thread owns an 8x8 register micro-tile (rows and columns tr*4 + i and
// 64 + tr*4 + i) and reads its operands k-major, two 16-byte vectors per
// operand per k: 4 vector loads for 64 FMAs.  k-chunks of KC = 16 are
// copied row by row by a 3-stage cp.async ring, so the next chunks' copies
// overlap this chunk's FMAs.  After the chunk's first barrier each thread
// moves one 4x4 block of it k-major with 16-byte reads (conflict-free at
// the row pitch KC + 4) and writes, the A side times dinv2 (copied with
// the chunk), and a second barrier publishes it; the scaled G is never
// formed.  The 64x64 quadrant of a diagonal tile above the diagonal is
// skipped (uniformly, so no warp diverges): a diagonal tile costs 3/4 of
// a full one, and n = 256 does 1.25x the lower triangle's FLOPs (64-wide
// tiles: also 1.25x).  L2 traffic for a shared
// Gt at B = 1024, n = 256, m = 512: 3 tiles x 2 x 128 x 512 x 4 bytes =
// 1.5 MB per instance, 1.6 GB in all, about 0.3 ms at the L2's ~5.5 TB/s
// against 0.73 ms of FFMA at the FP32 peak.
//
// f64 schur_assemble runs on the FP64 tensor cores (DMMA, 67 TFLOP/s;
// the FP64 FMAs give half that).  Hopper's wgmma has no f64 form, so it is
// mma.sync (m16n8k8 f64, IEEE double).  One block of 8 warps per 128x128
// tile, each warp a 32x64 piece as 2 x 8 DMMA tiles of 16x8 whose 64
// accumulators stay in registers.  At n = m = 10,240 the tile reads
// 2 x 128 x m doubles for 2 x 128^2 x m FLOP, 16 FLOP/B: about 68 GB
// through L2, ~12 ms at its ~5.5 TB/s, near the 16 ms of the DMMA peak,
// so the design keeps operands streaming from L2: k-chunks of DKC = 32
// are copied, k contiguous as Gt holds them, by a 3-stage cp.async ring
// (one barrier per chunk, two chunks in flight), and the fragments are
// read straight from that layout at a row pitch of DKC + 4 doubles, where
// the 16 lanes of each half-warp's LDS.64 fall on 16 different bank pairs
// (64-bit operands get no ldmatrix).  dinv2 rides with the chunk and
// scales the A fragments in registers, so the scaled G is never formed.
// The diagonal tile's 64x64 quadrant above the diagonal is skipped by the
// two warps that own it.  On an NVIDIA H100 80GB HBM3 at 700 W this runs
// at 37-38 TFLOP/s, 55-57 % of the DMMA peak, at n = m = 10,240
// (scripts/torch_f64_factor.py).  Variants built and timed the same way
// were no faster (PERF.md): m16n8k4 and m16n8k16 about 1.5 % slower than
// m16n8k8, rings from 5 x 16 to 2 x 48 deep no faster than 3 x 32.  So
// neither copy latency nor the mma shape sets the pace; what does is not
// measured (no profiler of the SM's pipes runs on that machine).
//
// schur_chol64 (n = 64: the socp path's per-instance factor, the ilp node
// batches) is one block per instance.  schur_assemble's 128x128 tiles
// would spend two thirds of their FMAs on padding at n = 64, and a second
// launch would read S back to factor one panel.  Here the block streams
// Gt's 64 rows by k-chunks of 32 through a 3-stage cp.async ring (one
// operand serves both sides of the product; dinv2 scales the A side in
// the k-major copy), 136 threads each accumulate one 4x4 micro-tile on or
// below the diagonal in registers, then S, its Jacobi scaling and its
// factor and inverse (diag_factor) stay in shared memory, and L, Dinv and
// deq are written once.  The ring aliases the factor's tiles (52 KB in
// f32, 4 blocks an SM; 100 KB in f64, 2).  What bounds it: issue.  At
// B = 1024, m = 400 the FMAs take 27 us at the FP32 peak and the bytes
// 44 us, against 0.18-0.19 ms measured on an NVIDIA H100 80GB HBM3 at
// 700 W (0.40 ms for the two launches it replaces, 0.40 for torch's S
// and Cholesky): 4 of 8 warps carry the FMAs, every chunk takes two
// barriers, and the pivot chain of diag_factor overlaps only with the
// other resident blocks.
//
// schur_factor is latency-bound: 64 dependent pivots per panel.  The
// diagonal block is factored in shared memory by 16-column sub-panels:
// the sub-panel's columns are updated by those to their left (all
// threads), its 16x16 diagonal block is factored in one warp's registers
// with the pivots and columns passed by shuffle, and the rows below it are
// solved by forward substitution, with three barriers per sub-panel (12
// per panel, not one per pivot).  A pivot <= 0 or not finite sets a flag
// the whole block reads after a barrier.  The triangular inverse of L11 is
// a blocked 2x2 recursion (8x8 diagonal inverses, then X21 = -C^-1 B A^-1
// at 8, 16 and 32 with unrolled full-length dots) on all threads.  L21 and
// the trailing update are 64x64x64 tile products (4x4 register
// micro-tiles, 16-byte operand reads) on tiles copied by cp.async; S lives
// in the L output buffer in device memory and L2 holds the instance
// (256 KB at n = 256).  A block uses 52 KB of shared memory in f32, so
// three blocks share an SM and hide each other's barriers.
//
// solve_many does 64x64x64 tile products too: forward
// acc = b_j - sum_kt Y[:, kt] L[o, kt]', y_j = acc Dinv[j]'; backward
// acc = y_j - sum_kt X[:, kt] L[kt, o], x_j = acc Dinv[j].  Finished panels
// of y and x live in the output X in device memory and come back through
// L2; only the current panel is on chip, so n has no shared-memory cap.
// L and X tiles are double-buffered with cp.async.  solve_few is bound by
// the bytes of L: each panel's mat-vec has warps over rows and lanes over k
// (forward), or threads over columns (backward), with coalesced reads and a
// shuffle or shared-memory reduction.
//
// Singularity contract: a pivot that is <= 0 or not finite poisons the
// whole instance: L and Dinv come back all NaN, as a failed
// torch.linalg.cholesky_ex does in the plain version (the TPU kernel
// clamped the pivot and returned finite garbage).  The solvers turn
// NaN into a status code.  The solve tests no pivot: a NaN L gives NaN x.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstring>
#include <initializer_list>
#include <mutex>
#include <vector>

namespace {

constexpr int BP = 64;       // panel width (factor, solve)
constexpr int NT = 256;      // threads per block
constexpr int AT = 128;      // assembly output tile
constexpr int KC = 16;       // assembly k-chunk
constexpr int STAGES = 3;    // assembly cp.async ring depth
constexpr int FEW = 8;       // chol_solve: nrhs <= FEW takes solve_few

template <typename T> struct Vec;   // 16 bytes of T
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };
template <typename T> constexpr int VW = 16 / sizeof(T);
template <typename T> constexpr int APITCH = KC + VW<T>;   // assembly rows
template <typename T> constexpr int TPITCH = BP + VW<T>;   // 64x64 tiles

// Shared-memory bytes of each kernel; ops/fused_chol.py's launch_config
// computes the same numbers and the launchers check that they agree.
template <typename T> constexpr int SMEM_ASM =
    (STAGES * 2 * AT * APITCH<T> + 2 * KC * (AT + VW<T>) + STAGES * KC) * sizeof(T);
template <typename T> constexpr int SMEM_FAC = (3 * BP * TPITCH<T> + BP) * sizeof(T);
template <typename T> constexpr int SMEM_MANY = 6 * BP * TPITCH<T> * sizeof(T);
template <typename T> constexpr int SMEM_FEW = 17 * BP * sizeof(T);

template <typename T> __device__ __forceinline__ T dsqrt(T x);
template <> __device__ __forceinline__ float dsqrt<float>(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double dsqrt<double>(double x) { return sqrt(x); }

template <typename T> __device__ __forceinline__ T drsqrt(T x);
template <> __device__ __forceinline__ float drsqrt<float>(float x) { return rsqrtf(x); }
template <> __device__ __forceinline__ double drsqrt<double>(double x) { return rsqrt(x); }

// deq_i = 1/sqrt(max(S_ii, 1e-30)); NaN stays NaN
template <typename T>
__device__ __forceinline__ T deq_of(T s) {
  return T(1) / dsqrt((s != s) ? s : (s > T(1e-30) ? s : T(1e-30)));
}

template <typename T> __device__ __forceinline__ T qnan();
template <> __device__ __forceinline__ float qnan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// W = VW<T> consecutive elements at p (16-byte aligned) into v.
template <typename T>
__device__ __forceinline__ void ld16(const T* p, T* v) {
  const typename Vec<T>::type x = *reinterpret_cast<const typename Vec<T>::type*>(p);
  if constexpr (sizeof(T) == 4) {
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = x.x; v[1] = x.y;
  }
}

// Four consecutive elements at p (16-byte aligned).
template <typename T>
__device__ __forceinline__ void ld4(const T* p, T* v) {
  ld16(p, v);
  if constexpr (sizeof(T) == 8) ld16(p + 2, v + 2);
}

// Four consecutive elements to p (16-byte aligned).
template <typename T>
__device__ __forceinline__ void st4(T* p, const T* v) {
  using V16 = typename Vec<T>::type;
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<V16*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    reinterpret_cast<V16*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<V16*>(p)[1] = make_double2(v[2], v[3]);
  }
}

// ---- cp.async ---------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte copy; src_bytes < 16 zero-fills the rest of the destination.
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// One element (4 or 8 bytes); src_bytes = 0 writes a zero.
template <int BYTES>
__device__ __forceinline__ void cp_elem(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::
               "r"(smem_addr(dst)), "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy `rows` x `cols` elements of a row-major matrix (leading dimension
// ld) into shared memory with row pitch `pitch`, by cp.async.  Source rows
// >= nr and columns >= nc are zero-filled.  With `vec`, src rows are
// 16-byte aligned and cols is a multiple of VW<T>: one 16-byte copy per
// thread step; otherwise one element.  Thread `t` copies items t, t + NT,
// ...; the assembly's dinv2 scaling walks the same items.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* src,
                                      long long ld, int rows, int cols,
                                      int nr, int nc, bool vec) {
  if (vec) {
    constexpr int W = VW<T>;
    const int cv = cols / W;
    for (int idx = threadIdx.x; idx < rows * cv; idx += NT) {
      const int r = idx / cv, c = (idx % cv) * W;
      const int valid = r < nr ? max(0, min(W, nc - c)) : 0;
      cp16(dst + r * pitch + c, valid ? src + r * ld + c : src,
           valid * (int)sizeof(T));
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += NT) {
      const int r = idx / cols, c = idx % cols;
      const bool ok = r < nr && c < nc;
      cp_elem<sizeof(T)>(dst + r * pitch + c, ok ? src + r * ld + c : src,
                         ok ? (int)sizeof(T) : 0);
    }
  }
}

// ---- 64x64x64 tile products on 256 threads, 4x4 micro-tiles -----------
// Thread (tr, tc) = (tid / 16, tid % 16).

// acc[i][j] += sum_k a[(tr+16i)][k] b[(tc+16j)][k]   (A B')
template <typename T>
__device__ __forceinline__ void tile_abt(const T* a, const T* b, int tr,
                                         int tc, T acc[4][4]) {
  constexpr int W = VW<T>, P = TPITCH<T>;
#pragma unroll 4
  for (int k = 0; k < BP; k += W) {
    T av[4][W], bv[4][W];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld16(a + (tr + 16 * i) * P + k, av[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) ld16(b + (tc + 16 * j) * P + k, bv[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[i][j] += av[i][w] * bv[j][w];
  }
}

// acc[i][j] += sum_k a[(tr+16i)][k] b[k][tc*4+j]   (A B), columns
// tc*4 .. tc*4+3 of the output
template <typename T>
__device__ __forceinline__ void tile_ab(const T* a, const T* b, int tr,
                                        int tc, T acc[4][4]) {
  constexpr int W = VW<T>, P = TPITCH<T>;
#pragma unroll 4
  for (int k = 0; k < BP; k += W) {
    T av[4][W];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld16(a + (tr + 16 * i) * P + k, av[i]);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      T bv[4];
      ld4(b + (k + w) * P + tc * 4, bv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i][w] * bv[j];
    }
  }
}

// ---- schur_assemble ---------------------------------------------------

// Lower tile t = 0, 1, 2, ... of a triangle of 128-wide tiles, row-major:
// (0,0), (1,0), (1,1), (2,0), ...
__device__ __forceinline__ void tri_tile(int t, int& I, int& J) {
  I = 0;
  while (t > I) { t -= I + 1; ++I; }
  J = t;
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
schur_assemble_kernel(const T* __restrict__ P, long long p_bs,
                      const T* __restrict__ Gt, long long gt_bs,
                      const T* __restrict__ dinv2, long long d_bs,
                      T* __restrict__ L, int B, int n, int m, int vec) {
  static_assert(sizeof(T) == 4, "f64 takes schur_assemble_f64_kernel");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int PA = APITCH<T>, PT = AT + VW<T>;
  T* ring = reinterpret_cast<T*>(smem_raw);   // STAGES x {A, B} x AT x PA
  T* kmaj = ring + STAGES * 2 * AT * PA;      // {A, B} x KC x PT
  T* dring = kmaj + 2 * KC * PT;              // STAGES x KC: dinv2

  // consecutive blocks take one tile of consecutive instances, so a
  // shared Gt's chunks are read from L2 by many blocks at once
  const long long b = blockIdx.x % B;
  int I, J;
  tri_tile(blockIdx.x / B, I, J);
  const int r0 = I * AT, c0 = J * AT;
  const int nrA = min(AT, n - r0), nrB = min(AT, n - c0);
  const T* gA = Gt + b * gt_bs + (long long)r0 * m;
  const T* gB = Gt + b * gt_bs + (long long)c0 * m;
  const T* d2 = dinv2 + b * d_bs;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const bool diag = I == J;
  const int nchunk = (m + KC - 1) / KC;

  auto raw = [&](int c, int side) { return ring + (2 * (c % STAGES) + side) * AT * PA; };
  auto fetch = [&](int c) {
    if (c < nchunk) {
      const int k0 = c * KC;
      stage(raw(c, 0), PA, gA + k0, m, AT, KC, nrA, m - k0, vec);
      stage(raw(c, 1), PA, gB + k0, m, AT, KC, nrB, m - k0, vec);
      stage(dring + (c % STAGES) * KC, KC, d2 + k0, 0, 1, KC, 1, m - k0, vec);
    }
    cp_commit();
  };
  // Chunk c k-major, A times dinv2: thread t < 128 moves the 4x4 block
  // (rows 4 (t / 4) .., k 4 (t % 4) ..) of A, thread t >= 128 that of B,
  // with 16-byte reads and writes (conflict-free reads at pitch PA).
  auto transpose = [&](int c) {
    const int side = tid / 128, t = tid % 128;
    const int r = (t / 4) * 4, k = (t % 4) * 4;
    const T* src = raw(c, side) + r * PA + k;
    T v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld4(src + i * PA, v[i]);
    if (side == 0) {
      T dv[4];
      ld4(dring + (c % STAGES) * KC + k, dv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] *= dv[j];
    }
    T* dst = kmaj + side * KC * PT + k * PT + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T w[4] = {v[0][j], v[1][j], v[2][j], v[3][j]};
      st4(dst + j * PT, w);
    }
  };

  // thread rows (and columns) tr*4 + i and 64 + tr*4 + i, i < 4; the
  // block (i < 4, j >= 4) of a diagonal tile lies above the diagonal
  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);

  for (int c = 0; c < STAGES - 1; ++c) fetch(c);
  for (int c = 0; c < nchunk; ++c) {
    cp_wait<STAGES - 2>();
    __syncthreads();      // chunk c has landed; chunk c-1 is used up
    fetch(c + STAGES - 1);
    transpose(c);
    __syncthreads();      // chunk c is k-major
    const T* a = kmaj;
    const T* bb = kmaj + KC * PT;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      T av[8], bv[8];
      ld4(a + k * PT + tr * 4, av);
      ld4(a + k * PT + 64 + tr * 4, av + 4);
      ld4(bb + k * PT + tc * 4, bv);
      ld4(bb + k * PT + 64 + tc * 4, bv + 4);
      if (diag) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < (i < 4 ? 4 : 8); ++j) acc[i][j] += av[i] * bv[j];
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
  }
  cp_wait<0>();

  const T* Pb = P + b * p_bs;
  T* Lb = L + b * (long long)n * n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + (i < 4 ? 0 : 64) + tr * 4 + i % 4;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + (j < 4 ? 0 : 64) + tc * 4 + j % 4;
      if (col >= n || (diag && i < 4 && j >= 4)) continue;
      const long long e = (long long)row * n + col;
      Lb[e] = acc[i][j] + Pb[e];
    }
  }
}

// ---- f64 on the FP64 tensor cores (DMMA) --------------------------------

constexpr int DKC = 32;        // k-chunk of the DMMA main loop
constexpr int DSTAGES = 3;     // its cp.async ring depth
constexpr int DPK = DKC + 4;   // ring row pitch in doubles (see dmma_tile)
constexpr int MK = 8;          // k of one mma.sync
// shared memory of schur_assemble and trail_update in f64
constexpr int SMEM_DMMA = (DSTAGES * 2 * AT * DPK + DSTAGES * DKC) * 8;

// One m16n8k8 DMMA (f64, IEEE double): c += A B for a 16x8 A, an 8x8 B and
// a 16x8 C.  Lane l, g = l / 4, t = l % 4, holds A[g + 8 (q % 2)][t + 4
// (q / 2)] in a[q] (q < 4), B[t + 4 q][g] in b[q] (q < 2),
// C[g][2t + {0, 1}] in c[0], c[1] and C[g + 8][2t + {0, 1}] in c[2], c[3].
__device__ __forceinline__ void dmma(double* c, const double* a, const double* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Warp w's piece of a 128x128 tile: rows 32 (w / 2) .., columns 64 (w % 2)
// .., as 2 x 8 DMMA tiles of 16x8; acc[i][j] holds rows 16 i + g (+ 8)
// and columns 8 j + 2 t (+ 1) of it.
struct WarpTile {
  int g, t, wr, wc;
  __device__ WarpTile()
      : g(threadIdx.x % 32 / 4), t(threadIdx.x % 4),
        wr(threadIdx.x / 64 * 32), wc(threadIdx.x / 32 % 2 * 64) {}
  // wholly above the diagonal of a diagonal tile (warps 1 and 3)
  __device__ bool above() const { return wc > wr + 31; }
};

// The DMMA main loop of one 128x128 tile on NT threads: acc += A diag(d) B'
// (SCALE) or A B' over k < K, where A's and B's 128 rows start at gA and
// gB (leading dimension ld, k contiguous; rows >= nrA / nrB read as 0)
// and d holds K scales.  A warp with `idle` set copies its share of every
// chunk but skips the products.
template <bool SCALE>
__device__ __forceinline__ void dmma_tile(double* smem, const double* gA,
                                          const double* gB, const double* d,
                                          long long ld, int K, int nrA,
                                          int nrB, bool vec, bool idle,
                                          double (&acc)[2][8][4]) {
  double* ring = smem;                              // DSTAGES x {A, B} x AT x DPK
  double* dring = ring + DSTAGES * 2 * AT * DPK;    // DSTAGES x DKC
  const WarpTile w;
  const int nchunk = (K + DKC - 1) / DKC;
  auto slot = [&](int c, int side) {
    return ring + (2 * (c % DSTAGES) + side) * AT * DPK;
  };
  auto fetch = [&](int c) {
    if (c < nchunk) {
      const int k0 = c * DKC;
      stage(slot(c, 0), DPK, gA + k0, ld, AT, DKC, nrA, K - k0, vec);
      stage(slot(c, 1), DPK, gB + k0, ld, AT, DKC, nrB, K - k0, vec);
      if (SCALE)
        stage(dring + (c % DSTAGES) * DKC, DKC, d + k0, 0, 1, DKC, 1, K - k0,
              vec);
    }
    cp_commit();
  };
  for (int c = 0; c < DSTAGES - 1; ++c) fetch(c);
  for (int c = 0; c < nchunk; ++c) {
    cp_wait<DSTAGES - 2>();
    __syncthreads();      // chunk c has landed; chunk c-1's slot is free
    fetch(c + DSTAGES - 1);
    if (idle) continue;
    // lane (g, t) reads rows g (+ 8, + 16, ...) at k t (+ 4, ...): at the
    // pitch DKC + 4 a half-warp's 16 lanes hit 16 distinct bank pairs
    const double* a = slot(c, 0) + (w.wr + w.g) * DPK + w.t;
    const double* b = slot(c, 1) + (w.wc + w.g) * DPK + w.t;
    const double* dv = dring + (c % DSTAGES) * DKC + w.t;
#pragma unroll
    for (int kk = 0; kk < DKC; kk += MK) {
      double af[2][MK / 2], bf[8][MK / 4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < MK / 2; ++q) {
          af[i][q] = a[(16 * i + 8 * (q % 2)) * DPK + kk + 4 * (q / 2)];
          if (SCALE) af[i][q] *= dv[kk + 4 * (q / 2)];
        }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < MK / 4; ++q) bf[j][q] = b[8 * j * DPK + kk + 4 * q];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dmma(acc[i][j], af[i], bf[j]);
    }
  }
  cp_wait<0>();
}

// f64 schur_assemble: the lower 128x128 tiles of S = P + Gt diag(dinv2) Gt'
// into L, one block per (instance, tile), as schur_assemble_kernel lays
// them out (and writes the same elements).
__global__ void __launch_bounds__(NT, 1)
schur_assemble_f64_kernel(const double* __restrict__ P, long long p_bs,
                          const double* __restrict__ Gt, long long gt_bs,
                          const double* __restrict__ dinv2, long long d_bs,
                          double* __restrict__ L, int B, int n, int m,
                          int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long b = blockIdx.x % B;
  int I, J;
  tri_tile(blockIdx.x / B, I, J);
  const int r0 = I * AT, c0 = J * AT;
  const WarpTile w;
  // the warps of the diagonal tile's part above the diagonal
  const bool idle = I == J && w.above();
  const double* G = Gt + b * gt_bs;
  double acc[2][8][4] = {};
  dmma_tile<true>(reinterpret_cast<double*>(smem_raw), G + (long long)r0 * m,
                  G + (long long)c0 * m, dinv2 + b * d_bs, m, m,
                  min(AT, n - r0), min(AT, n - c0), vec, idle, acc);
  if (idle) return;
  const double* Pb = P + b * p_bs;
  double* Lb = L + b * (long long)n * n;
  // n is a multiple of 64, so a pair of columns is inside or outside
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    double pv[2][8][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = r0 + w.wr + 16 * i + 8 * h + w.g;
        const int col = c0 + w.wc + 8 * j + 2 * w.t;
        const long long e = (long long)row * n + col;
        const bool ok = row < n && col < n;
        pv[h][j][0] = ok ? Pb[e] : 0.0;
        pv[h][j][1] = ok ? Pb[e + 1] : 0.0;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = r0 + w.wr + 16 * i + 8 * h + w.g;
        const int col = c0 + w.wc + 8 * j + 2 * w.t;
        if (row >= n || col >= n) continue;
        *reinterpret_cast<double2*>(Lb + (long long)row * n + col) =
            make_double2(acc[i][j][2 * h] + pv[h][j][0],
                         acc[i][j][2 * h + 1] + pv[h][j][1]);
      }
  }
}

// ---- schur_factor -----------------------------------------------------

// One level of the blocked triangular inverse of the 64x64 lower L in
// sL (strict upper zero): for each 2H-block, X21 = -C^-1 (B A^-1) with
// A^-1 and C^-1 already in sLi (zero above their diagonals); sX holds
// B A^-1.  Full-length dots: the zeros make them exact.
template <int H, typename T>
__device__ __forceinline__ void inv_level(const T* sL, T* sLi, T* sX) {
  constexpr int P = TPITCH<T>, NE = BP / 2 * H;
  for (int e = threadIdx.x; e < NE; e += NT) {
    const int base = e / (H * H) * 2 * H, r = e / H % H, c = e % H;
    T s = T(0);
#pragma unroll
    for (int k = 0; k < H; ++k)
      s += sL[(base + H + r) * P + base + k] * sLi[(base + k) * P + base + c];
    sX[(base + H + r) * P + base + c] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NE; e += NT) {
    const int base = e / (H * H) * 2 * H, r = e / H % H, c = e % H;
    T s = T(0);
#pragma unroll
    for (int k = 0; k < H; ++k)
      s += sLi[(base + H + r) * P + base + H + k] * sX[(base + H + k) * P + base + c];
    sLi[(base + H + r) * P + base + c] = -s;
  }
  __syncthreads();
}

// Factor the 64x64 block in sL (pitch TPITCH; only its lower triangle is
// read) in shared memory: L11 in sL with its strict upper triangle zero,
// inv(L11) in sLi, 1 / diag(L11) in sRd.  Returns true when a pivot is <=
// 0 or not finite (sbad is set and read after a barrier, so the return
// is uniform over the block).  The caller has set sbad to 0 and made sL
// visible to the block with a barrier.
template <typename T>
__device__ __forceinline__ bool diag_factor(T* sL, T* sLi, T* sX, T* sRd,
                                            int& sbad) {
  constexpr int P = TPITCH<T>, W = VW<T>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // ---- Cholesky of the diagonal block by 16-column sub-panels q
  for (int q = 0; q < BP; q += 16) {
    // (a) the sub-panel's columns minus the sub-panels to their left
    if (q > 0) {
      for (int e = tid; e < (BP - q) * 16; e += NT) {
        const int i = q + e / 16, c = q + e % 16;
        if (i < c) continue;
        T s = T(0);
        for (int k = 0; k < q; k += W) {
          T u[W], v[W];
          ld16(sL + i * P + k, u);
          ld16(sL + c * P + k, v);
#pragma unroll
          for (int w = 0; w < W; ++w) s += u[w] * v[w];
        }
        sL[i * P + c] -= s;
      }
      __syncthreads();
    }
    // (b) its 16x16 diagonal block in warp 0, lane i holding row i; the
    // pivot and the columns travel by shuffle
    if (warp == 0) {
      const int i = lane % 16;
      T d[16], rd = T(0);
#pragma unroll
      for (int j = 0; j < 16; ++j) d[j] = j <= i ? sL[(q + i) * P + q + j] : T(0);
      bool badp = false;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const T akk = __shfl_sync(0xffffffffu, d[k], k);
        badp |= !(akk > T(0)) || isinf(akk);
        const T inv = drsqrt(akk);
        if (i == k) { d[k] = akk * inv; rd = inv; }
        else if (i > k) d[k] *= inv;
#pragma unroll
        for (int j = k + 1; j < 16; ++j) {
          const T ljk = __shfl_sync(0xffffffffu, d[k], j);
          if (i >= j) d[j] -= d[k] * ljk;
        }
      }
      if (lane < 16) {
#pragma unroll
        for (int j = 0; j < 16; ++j) sL[(q + i) * P + q + j] = j <= i ? d[j] : T(0);
        sRd[q + i] = rd;
      }
      if (lane == 0 && badp) sbad = 1;
    }
    __syncthreads();
    // (c) the rows below it: x D' = a by forward substitution
    for (int i = q + 16 + tid; i < BP; i += NT) {
      T x[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        T s = sL[i * P + q + k];
#pragma unroll
        for (int j = 0; j < k; ++j) s -= x[j] * sL[(q + k) * P + q + j];
        x[k] = s * sRd[q + k];
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) sL[i * P + q + k] = x[k];
    }
    __syncthreads();
  }
  if (sbad) return true;                 // uniform: read after a barrier
  for (int idx = tid; idx < BP * P; idx += NT) {
    sLi[idx] = T(0);
    if (idx % P > idx / P) sL[idx] = T(0);   // strictly upper (and pad)
  }
  __syncthreads();

  // ---- inv(L11) by blocked 2x2 recursion: 8x8 diagonal blocks, then
  // X21 = -C^-1 (B A^-1) for h = 8, 16, 32 (A^-1, C^-1 already in sLi)
  if (tid < BP) {
    const int base = (tid / 8) * 8, c = tid % 8;
    T x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      T s = (i == c) ? T(1) : T(0);
#pragma unroll
      for (int j = 0; j < i; ++j) s -= sL[(base + i) * P + base + j] * x[j];
      x[i] = i < c ? T(0) : s * sRd[base + i];
      sLi[(base + i) * P + base + c] = x[i];
    }
  }
  __syncthreads();
  inv_level<8>(sL, sLi, sX);
  inv_level<16>(sL, sLi, sX);
  inv_level<32>(sL, sLi, sX);
  return false;
}

// Factor the 64x64 diagonal block at Ld (leading dimension n) in shared
// memory, as schur_factor's panel step: L11 into Ld with its strict upper
// triangle zero, inv(L11) into Dj and left in sLi.  Returns true, and
// writes nothing, when a pivot is <= 0 or not finite (uniform over the
// block, as diag_factor's).
template <typename T>
__device__ __forceinline__ bool diag_panel(T* Ld, int n, T* Dj, T* sL,
                                           T* sLi, T* sX, T* sRd,
                                           int& sbad) {
  constexpr int P = TPITCH<T>;
  for (int idx = threadIdx.x; idx < BP * BP; idx += NT)
    sL[idx / BP * P + idx % BP] = Ld[(long long)(idx / BP) * n + idx % BP];
  __syncthreads();
  if (diag_factor(sL, sLi, sX, sRd, sbad)) return true;
  for (int idx = threadIdx.x; idx < BP * BP; idx += NT) {
    const int r = idx / BP, c = idx % BP;
    Ld[(long long)r * n + c] = sL[r * P + c];
    Dj[idx] = sLi[r * P + c];
  }
  return false;
}

template <typename T>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 3 : 2)
schur_factor_kernel(T* __restrict__ L, T* __restrict__ Dinv,
                    T* __restrict__ deq, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = TPITCH<T>;
  T* sL = reinterpret_cast<T*>(smem_raw);   // L11, then the L21[J] operand
  T* sLi = sL + BP * P;                     // inv(L11)
  T* sX = sLi + BP * P;                     // A21 -> L21[I]; inverse scratch
  T* sRd = sX + BP * P;                     // 1 / diag(L11)

  const long long b = blockIdx.x;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int npan = n / BP;
  T* Lb = L + b * (long long)n * n;
  T* Db = Dinv + b * (long long)npan * BP * BP;
  T* dq = deq ? deq + b * n : nullptr;

  // ---- equilibration: deq_i = 1/sqrt(max(S_ii, 1e-30)), NaN stays NaN
  if (dq) {
    for (int i = tid; i < n; i += NT) dq[i] = deq_of(Lb[(long long)i * n + i]);
    __syncthreads();
    for (int I = 0; I < npan; ++I)
      for (int J = 0; J <= I; ++J)
        for (int idx = tid; idx < BP * BP; idx += NT) {
          const int r = I * BP + idx / BP, c = J * BP + idx % BP;
          T* p = Lb + (long long)r * n + c;
          *p = *p * dq[r] * dq[c];
        }
    __syncthreads();
  }

  __shared__ int sbad;
  if (tid == 0) sbad = 0;
  bool bad = false;
  for (int jp = 0; jp < npan; ++jp) {
    const int o = jp * BP;
    if (diag_panel(Lb + (long long)o * n + o, n, Db + (long long)jp * BP * BP,
                   sL, sLi, sX, sRd, sbad)) {
      bad = true;
      break;
    }

    // ---- L21[I] = A21[I] inv(L11)', then S[I, J] -= L21[I] L21[J]'
    for (int I = jp + 1; I < npan; ++I) {
      T* aI = Lb + (long long)(I * BP) * n + o;
      __syncthreads();                     // sX and sL are free
      stage(sX, P, aI, n, BP, BP, BP, BP, true);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      T acc[4][4] = {};
      tile_abt(sX, sLi, tr, tc, acc);
      __syncthreads();                     // A21 is read
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tr + 16 * i, c = tc + 16 * j;
          sX[r * P + c] = acc[i][j];
          aI[(long long)r * n + c] = acc[i][j];
        }
      __threadfence();                     // L21[I] is read back by cp.async
      __syncthreads();
      for (int J = jp + 1; J <= I; ++J) {
        const T* lJ = sX;
        if (J < I) {
          stage(sL, P, Lb + (long long)(J * BP) * n + o, n, BP, BP, BP, BP,
                true);
          cp_commit();
          cp_wait<0>();
          __syncthreads();
          lJ = sL;
        }
        // S[I, J] is read before the product, so its latency overlaps
        T* sij = Lb + (long long)(I * BP) * n + J * BP;
        T up[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            up[i][j] = -sij[(long long)(tr + 16 * i) * n + tc + 16 * j];
        tile_abt(sX, lJ, tr, tc, up);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sij[(long long)(tr + 16 * i) * n + tc + 16 * j] = -up[i][j];
        __syncthreads();                   // sL is free again
      }
    }
    __syncthreads();
  }
  __syncthreads();

  if (bad) {
    const T nan = qnan<T>();
    for (long long idx = tid; idx < (long long)n * n; idx += NT) Lb[idx] = nan;
    for (long long idx = tid; idx < (long long)npan * BP * BP; idx += NT) Db[idx] = nan;
    return;
  }
  // zero the strictly upper tiles (the diagonal blocks' upper halves are
  // written as zeros above)
  for (int I = 0; I < npan; ++I)
    for (int J = I + 1; J < npan; ++J)
      for (int idx = tid; idx < BP * BP; idx += NT)
        Lb[(long long)(I * BP + idx / BP) * n + J * BP + idx % BP] = T(0);
}

// ---- schur_chol64: the whole factor of a one-panel system (n = 64) -----

constexpr int C64_KC = 32;       // schur_chol64: k-chunk
constexpr int C64_STAGES = 3;    // and its cp.async ring depth
constexpr int C64_TILES = 136;   // 4x4 micro-tiles on or below the diagonal

// The ring, the k-major chunk and dinv2's chunks alias the factor's
// tiles: the assembly is over before the factor starts.
template <typename T> constexpr int C64_RING =
    (C64_STAGES * BP * (C64_KC + VW<T>) + 2 * C64_KC * TPITCH<T> +
     C64_STAGES * C64_KC) * sizeof(T);
static_assert(C64_RING<float> <= SMEM_FAC<float>, "ring exceeds the tiles");
static_assert(C64_RING<double> <= SMEM_FAC<double>, "ring exceeds the tiles");

// One block per instance: S = P + Gt diag(dinv2) Gt' for the 64x64 block,
// accumulated in registers over k-chunks of Gt's 64 rows (one operand for
// both sides of the product), then [equilibrate] and factor and inverse
// in shared memory (diag_factor), and L, Dinv (and deq) written once.
template <typename T>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 4 : 2)
schur_chol64_kernel(const T* __restrict__ P, const T* __restrict__ Gt,
                    long long gt_bs, const T* __restrict__ dinv2,
                    long long d_bs, T* __restrict__ L, T* __restrict__ Dinv,
                    T* __restrict__ deq, int m, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P_ = TPITCH<T>, PA = C64_KC + VW<T>, KC = C64_KC;
  T* sL = reinterpret_cast<T*>(smem_raw);   // S, then L11
  T* sLi = sL + BP * P_;                    // inv(L11)
  T* sX = sLi + BP * P_;                    // inverse scratch
  T* sRd = sX + BP * P_;                    // deq, then 1 / diag(L11)
  T* ring = sL;                             // C64_STAGES x 64 x PA
  T* kmaj = ring + C64_STAGES * BP * PA;    // {A dinv2, A} x KC x P_
  T* dring = kmaj + 2 * KC * P_;            // C64_STAGES x KC: dinv2
  __shared__ int sbad;

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const T* G = Gt + b * gt_bs;
  const T* d2 = dinv2 + b * d_bs;
  const int nchunk = (m + KC - 1) / KC;
  if (tid == 0) sbad = 0;

  auto fetch = [&](int c) {
    if (c < nchunk) {
      const int k0 = c * KC, s = c % C64_STAGES;
      stage(ring + s * BP * PA, PA, G + k0, m, BP, KC, BP, m - k0, vec);
      stage(dring + s * KC, KC, d2 + k0, 0, 1, KC, 1, m - k0, vec);
    }
    cp_commit();
  };
  // Chunk c k-major: thread t < 128 moves the 4x4 block (rows 4 (t / 8)
  // .., k 4 (t % 8) ..) times dinv2 into the A side, thread t >= 128 the
  // same block as it is into the B side.
  auto transpose = [&](int c) {
    const int side = tid / 128, t = tid % 128, s = c % C64_STAGES;
    const int r = (t / 8) * 4, k = (t % 8) * 4;
    T v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld4(ring + s * BP * PA + (r + i) * PA + k, v[i]);
    if (side == 0) {
      T dv[4];
      ld4(dring + s * KC + k, dv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] *= dv[j];
    }
    T* dst = kmaj + side * KC * P_ + k * P_ + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T w[4] = {v[0][j], v[1][j], v[2][j], v[3][j]};
      st4(dst + j * P_, w);
    }
  };

  // threads t < C64_TILES own the lower 4x4 micro-tile t (row-major over
  // the triangle of the 16 x 16 micro-tiles): rows 4 tr .., columns 4 tc ..
  int tr, tc;
  tri_tile(tid < C64_TILES ? tid : 0, tr, tc);
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int c = 0; c < C64_STAGES - 1; ++c) fetch(c);
  for (int c = 0; c < nchunk; ++c) {
    cp_wait<C64_STAGES - 2>();
    __syncthreads();      // chunk c has landed; chunk c-1's k-major is read
    fetch(c + C64_STAGES - 1);
    transpose(c);
    __syncthreads();      // chunk c is k-major
    if (tid < C64_TILES) {
      const T* a = kmaj + tr * 4;
      const T* bb = kmaj + KC * P_ + tc * 4;
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        T av[4], bv[4];
        ld4(a + k * P_, av);
        ld4(bb + k * P_, bv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
  }
  cp_wait<0>();
  __syncthreads();        // the ring is free: S goes to sL

  const T* Pb = P + b * (BP * BP);
  if (tid < C64_TILES)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tr * 4 + i, c = tc * 4 + j;
        sL[r * P_ + c] = acc[i][j] + Pb[r * BP + c];
      }
  __syncthreads();

  if (deq) {
    // deq_i = 1/sqrt(max(S_ii, 1e-30)), NaN stays NaN; S := D S D
    if (tid < BP) {
      const T d = deq_of(sL[tid * P_ + tid]);
      sRd[tid] = d;
      deq[b * BP + tid] = d;
    }
    __syncthreads();
    for (int idx = tid; idx < BP * BP; idx += NT) {
      const int r = idx / BP, c = idx % BP;
      if (c <= r) sL[r * P_ + c] = sL[r * P_ + c] * sRd[r] * sRd[c];
    }
    __syncthreads();
  }

  T* Lb = L + b * (BP * BP);
  T* Db = Dinv + b * (BP * BP);
  if (diag_factor(sL, sLi, sX, sRd, sbad)) {
    const T nan = qnan<T>();
    for (int idx = tid; idx < BP * BP; idx += NT) {
      Lb[idx] = nan;
      Db[idx] = nan;
    }
    return;
  }
  for (int idx = tid; idx < BP * BP; idx += NT) {
    const int r = idx / BP, c = idx % BP;
    Lb[idx] = sL[r * P_ + c];
    Db[idx] = sLi[r * P_ + c];
  }
}

// ---- chol_solve -------------------------------------------------------

template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// nrhs > FEW: one block per (instance, 64 rows of b).  L, Dinv and X are
// 16-byte aligned (the wrapper sees to it).
template <typename T>
__global__ void __launch_bounds__(NT, 2)
solve_many_kernel(const T* __restrict__ L, const T* __restrict__ Dinv,
                  const T* __restrict__ Bm, long long b_bs, T* X, int n,
                  int nrhs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = TPITCH<T>;
  T* sbuf = reinterpret_cast<T*>(smem_raw);   // 2 stages x {X rows, L tile}
  T* sAcc = sbuf + 4 * BP * P;
  T* sD = sAcc + BP * P;                      // Dinv[jp], copied ahead
  const int nblk = (nrhs + BP - 1) / BP;
  const long long b = blockIdx.x / nblk;
  const int r0 = (blockIdx.x % nblk) * BP;
  const int nr = min(BP, nrhs - r0);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int npan = n / BP;
  const T* Lb = L + b * (long long)n * n;
  const T* Db = Dinv + b * (long long)npan * BP * BP;
  const T* Bb = Bm + b * b_bs + (long long)r0 * n;
  T* Xb = X + (b * nrhs + r0) * (long long)n;
  auto sA = [&](int s) { return sbuf + 2 * s * BP * P; };
  auto sB = [&](int s) { return sbuf + (2 * s + 1) * BP * P; };

  // forward, A B' layout (rows tr + 16 i, cols tc + 16 j):
  // acc = -(b_j - sum_kt Y[:, kt] L[o, kt]'), y_j = (-acc) Dinv[j]'
  for (int jp = 0; jp < npan; ++jp) {
    const int o = jp * BP;
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tr + 16 * i;
        acc[i][j] = r < nr ? -Bb[(long long)r * n + o + tc + 16 * j] : T(0);
      }
    auto fetch = [&](int kt) {
      if (kt < jp) {
        stage(sA(kt & 1), P, Xb + kt * BP, n, BP, BP, nr, BP, true);
        stage(sB(kt & 1), P, Lb + (long long)o * n + kt * BP, n, BP, BP, BP,
              BP, true);
      }
      cp_commit();
    };
    stage(sD, P, Db + (long long)jp * BP * BP, BP, BP, BP, BP, BP, true);
    fetch(0);                             // Dinv[jp] rides with this group
    for (int kt = 0; kt < jp; ++kt) {
      fetch(kt + 1);
      cp_wait<1>();
      __syncthreads();
      tile_abt(sA(kt & 1), sB(kt & 1), tr, tc, acc);
      __syncthreads();
    }
    cp_wait<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sAcc[(tr + 16 * i) * P + tc + 16 * j] = -acc[i][j];
    __syncthreads();
    T y[4][4] = {};
    tile_abt(sAcc, sD, tr, tc, y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      if (r >= nr) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) Xb[(long long)r * n + o + tc + 16 * j] = y[i][j];
    }
    __threadfence();                      // y_j is read back by cp.async
    __syncthreads();
  }

  // backward, A B layout (rows tr + 16 i, cols tc * 4 + j):
  // acc = -(y_j - sum_kt X[:, kt] L[kt, o]), x_j = (-acc) Dinv[j]
  for (int jp = npan - 1; jp >= 0; --jp) {
    const int o = jp * BP;
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tr + 16 * i;
        acc[i][j] = r < nr ? -Xb[(long long)r * n + o + tc * 4 + j] : T(0);
      }
    auto fetch = [&](int kt) {
      if (kt < npan) {
        const int s = (kt - jp - 1) & 1;
        stage(sA(s), P, Xb + kt * BP, n, BP, BP, nr, BP, true);
        stage(sB(s), P, Lb + (long long)(kt * BP) * n + o, n, BP, BP, BP, BP,
              true);
      }
      cp_commit();
    };
    stage(sD, P, Db + (long long)jp * BP * BP, BP, BP, BP, BP, BP, true);
    fetch(jp + 1);                        // Dinv[jp] rides with this group
    for (int kt = jp + 1; kt < npan; ++kt) {
      fetch(kt + 1);
      cp_wait<1>();
      __syncthreads();
      const int s = (kt - jp - 1) & 1;
      tile_ab(sA(s), sB(s), tr, tc, acc);
      __syncthreads();
    }
    cp_wait<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sAcc[(tr + 16 * i) * P + tc * 4 + j] = -acc[i][j];
    __syncthreads();
    T x[4][4] = {};
    tile_ab(sAcc, sD, tr, tc, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      if (r >= nr) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) Xb[(long long)r * n + o + tc * 4 + j] = x[i][j];
    }
    __threadfence();
    __syncthreads();
  }
}

// part[g][c0 .. c0+3] = sum over k = k0 + g, k0 + g + 16, ... < k1 of
// v[k] M[k][c0 ..], for c0 = (tid % 16) * 4, g = tid / 16: each k row of M
// is read as 64 contiguous elements.
template <typename T>
__device__ __forceinline__ void col_partials(const T* M, long long ld,
                                             const T* v, int k0, int k1,
                                             T* part) {
  const int c0 = (threadIdx.x % 16) * 4, g = threadIdx.x / 16;
  T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 8
  for (int k = k0 + g; k < k1; k += 16) {
    T mv[4];
    ld4(M + k * ld + c0, mv);
    const T vk = v[k];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] += vk * mv[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) part[g * BP + c0 + j] = s[j];
}

// out[c] = sum_k M[c][k] v[k] for the 64 rows c of M, k < K; warp w takes
// rows 8 w .. 8 w + 7, lanes take 16-byte pieces of k.  Lane 0 holds the
// sums in s.
template <typename T>
__device__ __forceinline__ void row_dots(const T* M, long long ld,
                                         const T* v, int K, T s[8]) {
  constexpr int W = VW<T>;
  const int lane = threadIdx.x % 32, w8 = threadIdx.x / 32 * 8;
#pragma unroll
  for (int r = 0; r < 8; ++r) s[r] = T(0);
#pragma unroll 2
  for (int k = lane * W; k < K; k += 32 * W) {
    T vk[W];
    ld16(v + k, vk);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      T mv[W];
      ld16(M + (w8 + r) * ld + k, mv);
#pragma unroll
      for (int q = 0; q < W; ++q) s[r] += mv[q] * vk[q];
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) s[r] = warp_sum(s[r]);
}

// nrhs <= FEW: one block per (instance, row of b); bound by L's bytes.
template <typename T>
__global__ void __launch_bounds__(NT)
solve_few_kernel(const T* __restrict__ L, const T* __restrict__ Dinv,
                 const T* __restrict__ Bm, long long b_bs, T* X, int n,
                 int nrhs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sv = reinterpret_cast<T*>(smem_raw);   // 64: the panel's right side
  T* part = sv + BP;                        // 16 x 64 partial sums
  const long long b = blockIdx.x / nrhs;
  const int row = blockIdx.x % nrhs;
  const int tid = threadIdx.x, lane = tid % 32, w8 = tid / 32 * 8;
  const int npan = n / BP;
  const T* Lb = L + b * (long long)n * n;
  const T* Db = Dinv + b * (long long)npan * BP * BP;
  const T* bv = Bm + b * b_bs + (long long)row * n;
  T* x = X + (b * nrhs + row) * (long long)n;

  // forward: y_j = (b_j - L[o:o+64, :o] y[:o]) Dinv[j]'
  for (int jp = 0; jp < npan; ++jp) {
    const int o = jp * BP;
    T s[8];
    row_dots(Lb + (long long)o * n, n, x, o, s);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < 8; ++r) sv[w8 + r] = bv[o + w8 + r] - s[r];
    __syncthreads();
    row_dots(Db + (long long)jp * BP * BP, BP, sv, BP, s);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < 8; ++r) x[o + w8 + r] = s[r];
    __syncthreads();
  }
  // backward: x_j = (y_j - L[o+64:, o:o+64]' x[o+64:]) Dinv[j]
  for (int jp = npan - 1; jp >= 0; --jp) {
    const int o = jp * BP;
    col_partials(Lb + o, n, x, o + BP, n, part);
    __syncthreads();
    if (tid < BP) {
      T s = T(0);
      for (int g = 0; g < 16; ++g) s += part[g * BP + tid];
      sv[tid] = x[o + tid] - s;
    }
    __syncthreads();
    col_partials(Db + (long long)jp * BP * BP, BP, sv, 0, BP, part);
    __syncthreads();
    if (tid < BP) {
      T s = T(0);
      for (int g = 0; g < 16; ++g) s += part[g * BP + tid];
      x[o + tid] = s;
    }
    __syncthreads();
  }
}

// ---- the small-batch path: many blocks per instance -------------------
//
// panel_factor and panel_solve replace the same TPU kernels as
// schur_factor and solve_few (pallas_chol.py:129/:338 and :194/:404)
// where the batch is small.  schur_factor and solve_few run one block per
// instance (per right-hand side), so a batch smaller than the SM count
// leaves most SMs idle: one factor at n = 10,240 ran its n/64-panel loop
// on one of 132 SMs.  Here the same factor and solve are spread over the
// grid.  No kernel waits on another block through a grid barrier: that
// would need every block resident at once, and a wrong guess hangs the
// card.
//
// panel_factor (the launcher loops over the panels on the host; each
// step is one launch, so no block ever waits for another):
//   [panel_deq, panel_scale]  equilibration, as in schur_factor
//   per outer panel of NB = 256 columns, per 64-column panel jp in it:
//     panel_diag    one block per instance: the diagonal block's factor
//                   and inverse (diag_panel); a bad pivot sets the
//                   instance's flag in device memory, which every later
//                   launch reads and which skips the instance
//     panel_l21     one block per (instance, 64-row tile below):
//                   L21 = A21 inv(L11)'
//     panel_update  one block per (instance, row tile, column tile left
//                   in the outer panel): S[I, J] -= L21[I] L21[J]'
//   trail_update    one block per (instance, 128x128 lower tile of the
//                   trailing matrix): S -= L[:, panel] L[:, panel]', a
//                   rank-256 update (f64: two launches, the next panel's
//                   column strip and the rest, see below)
//   panel_finalize  one block per (instance, 64-row panel): zero the
//                   strictly upper tiles, or NaN the whole instance
// What bounds it: the trailing updates hold n^3/3 of the FLOPs.  Rank-64
// updates would re-read and re-write the trailing matrix n/64 times
// (about 45 GB at n = 10,240 in f64, more time than its FMAs); rank-256
// updates do it n/256 times, and the 64-wide steps touch only the current
// 256-wide panel.  In f32 trail_update stages 128x16 k-chunks of both
// operands k-major in shared memory (registers to shared memory,
// double-buffered), brings its 128x128 tile of S in by cp.async behind
// the products, and runs 8x8 FP32 FMA micro-tiles (no TF32: the
// interior-point method diverges on it).
// In f64 trail_update is the assembly's DMMA main loop over the panel's
// 256 columns of L (8 chunks of 32 through the same cp.async ring), and
// its 128x128 tile of S is prefetched into L2 when the block starts and
// read back in the epilogue, which leaves the ring all the shared memory.
// The chain of n/64 diagonal factors, one block each, sets the latency
// that is left; in f64 a lookahead hides most of it.  Each trailing
// update is split in two: the next outer panel's 256 columns (all rows
// below) on the launcher's main stream, and the rest of the trailing
// matrix on a side stream.  The next panel's diag/l21/update chain then
// runs on the main stream beside the bulk of the update.  Main has the
// device's greatest stream priority and side its least, so a chain block
// takes the first SM that frees up.  Events order the two: the rest of
// update p waits for panel p's chain ("panel"); the next update's strip,
// which overwrites columns that rest p updates, waits for rest p
// ("rest").  The launcher forks from the caller's stream and joins back
// to it before it returns (two streams and four events per device, made
// at first use and used by one call at a time, under a mutex).  The
// launcher issues the launches, streams, waits and records of its own
// plan only where they equal those launch_config lists, so the plan
// tests/test_torch_f64_factor.py walks and checks for races is the one
// that runs.  No kernel waits on another: the order is the streams'.  On
// an NVIDIA H100 80GB HBM3 at 700 W the f64 panel_factor at n = 10,240
// takes 15.8-16.3 ms against a 5.3 ms bound (n^3/3 FLOP at the DMMA
// peak), with 22 ms of kernels of which the lookahead overlaps 6.5-7.1
// (chip_smoke.py's factor_profile).  Not measured apart: the rests'
// tiles, each a pipeline fill and an epilogue around 8 chunks, and the
// chain of the last outer panels, which has little left to overlap.
//
// panel_solve: one block per (instance, right-hand side, 64-row panel,
// sweep), in one launch.  Each block takes a ticket from a counter in
// device memory and maps it to its work, panel order first, so a block
// only ever waits for blocks with lower tickets, which have started:
// there is no deadlock, whatever order the hardware starts blocks in.
// Forward block j sums s = L[j, k] y_k over k < j - 1 as the chain
// publishes y_k, then takes y_{j-1} and forms y_j = Dinv[j] (b_j - s -
// L[j, j-1] y_{j-1}); the backward blocks run the same chain from the
// last panel with the transposed tiles.  What bounds it: a chain of 2
// n/64 dependent steps, and each step needs every block still running to
// have read one more 64x64 tile of L.  So the design keeps both short:
//   - a value is published with its tag in one 64-bit word (two in f64),
//     so a hand-off is one store and one poll of the panel itself, with
//     no fence and no counter; warp 0 polls a panel once for the block
//     and shares it through shared memory;
//   - L's tiles come through a 4-slot ring filled by TMA, one tensor copy
//     a tile: with 16-byte copies one block streamed ~13 GB/s (the
//     requests in flight per SM), which paced every step;
//   - the sums over tiles stay in registers, 16 FMAs a tile a thread on
//     rows of 128 contiguous bytes, and are reduced once after the loop.
// On an NVIDIA H100 80GB HBM3 at 700 W, n = 10,240, one right-hand side
// (scripts/torch_panel_solve.py): 0.57 ms in f64, 0.40 ms in f32, against
// 1.64 / 1.03 ms for the design it replaced and a 0.23 / 0.11 ms bound
// (L read by both sweeps, less what of it the 50 MB L2 keeps between
// them).

constexpr int NB = 256;      // outer panel: rank of the trailing updates
constexpr int TT = 128;      // trail_update output tile
constexpr int TKC = 16;      // trail_update k-chunk
constexpr int TP = TT + 4;   // trail_update k-major row pitch
template <typename T> constexpr int SMEM_PTILE = 2 * BP * TPITCH<T> * sizeof(T);
constexpr int TCP = TT + 4;  // trail_update C tile pitch (f32)
constexpr int SMEM_TRAIL = (2 * 2 * TKC * TP + TT * TCP) * 4;

// deq = 1/sqrt(max(diag S, 1e-30)), NaN stays NaN; NT rows per block.
template <typename T>
__global__ void __launch_bounds__(NT)
panel_deq_kernel(const T* __restrict__ L, T* __restrict__ deq, int n,
                 int nblk) {
  const long long b = blockIdx.x / nblk;
  const int i = (blockIdx.x % nblk) * NT + threadIdx.x;
  if (i < n) deq[b * n + i] = deq_of(L[b * (long long)n * n + (long long)i * n + i]);
}

// S := D S D on one lower 64x64 tile per block.
template <typename T>
__global__ void __launch_bounds__(NT)
panel_scale_kernel(T* __restrict__ L, const T* __restrict__ deq, int n,
                   int ntile) {
  const long long b = blockIdx.x / ntile;
  int I, J;
  tri_tile(blockIdx.x % ntile, I, J);
  T* Lb = L + b * (long long)n * n;
  const T* dq = deq + b * n;
  for (int idx = threadIdx.x; idx < BP * BP; idx += NT) {
    const int r = I * BP + idx / BP, c = J * BP + idx % BP;
    T* p = Lb + (long long)r * n + c;
    *p = *p * dq[r] * dq[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 3 : 2)
panel_diag_kernel(T* __restrict__ L, T* __restrict__ Dinv,
                  int* __restrict__ bad, int n, int jp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = TPITCH<T>;
  T* sL = reinterpret_cast<T*>(smem_raw);
  T* sLi = sL + BP * P;
  T* sX = sLi + BP * P;
  T* sRd = sX + BP * P;
  __shared__ int sbad;
  const long long b = blockIdx.x;
  if (bad[b]) return;
  if (threadIdx.x == 0) sbad = 0;
  const int o = jp * BP;
  T* Lb = L + b * (long long)n * n;
  T* Dj = Dinv + (b * (n / BP) + jp) * (long long)(BP * BP);
  if (diag_panel(Lb + (long long)o * n + o, n, Dj, sL, sLi, sX, sRd, sbad) &&
      threadIdx.x == 0)
    bad[b] = 1;
}

// L21[I] = A21[I] Dinv[jp]' for the row tiles I = jp + 1 .. below.
template <typename T>
__global__ void __launch_bounds__(NT)
panel_l21_kernel(T* __restrict__ L, const T* __restrict__ Dinv,
                 const int* __restrict__ bad, int n, int jp, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = TPITCH<T>;
  T* sA = reinterpret_cast<T*>(smem_raw);
  T* sD = sA + BP * P;
  const long long b = blockIdx.x / rows;
  if (bad[b]) return;
  const int I = jp + 1 + blockIdx.x % rows, o = jp * BP;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  T* aI = L + b * (long long)n * n + (long long)(I * BP) * n + o;
  stage(sA, P, aI, n, BP, BP, BP, BP, true);
  stage(sD, P, Dinv + (b * (n / BP) + jp) * (long long)(BP * BP), BP, BP,
        BP, BP, BP, true);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  T acc[4][4] = {};
  tile_abt(sA, sD, tr, tc, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      aI[(long long)(tr + 16 * i) * n + tc + 16 * j] = acc[i][j];
}

// S[I, J] -= L21[I] L21[J]' for row tiles I > jp and the `cols` column
// tiles J = jp + 1 .. left in the outer panel (J <= I).
template <typename T>
__global__ void __launch_bounds__(NT)
panel_update_kernel(T* __restrict__ L, const int* __restrict__ bad, int n,
                    int jp, int rows, int cols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = TPITCH<T>;
  T* sI = reinterpret_cast<T*>(smem_raw);
  T* sJ = sI + BP * P;
  const long long b = blockIdx.x / (rows * cols);
  const int idx = blockIdx.x % (rows * cols);
  const int I = jp + 1 + idx / cols, J = jp + 1 + idx % cols, o = jp * BP;
  if (J > I || bad[b]) return;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  T* Lb = L + b * (long long)n * n;
  stage(sI, P, Lb + (long long)(I * BP) * n + o, n, BP, BP, BP, BP, true);
  stage(sJ, P, Lb + (long long)(J * BP) * n + o, n, BP, BP, BP, BP, true);
  cp_commit();
  T* sij = Lb + (long long)(I * BP) * n + J * BP;
  T up[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      up[i][j] = -sij[(long long)(tr + 16 * i) * n + tc + 16 * j];
  cp_wait<0>();
  __syncthreads();
  tile_abt(sI, sJ, tr, tc, up);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sij[(long long)(tr + 16 * i) * n + tc + 16 * j] = -up[i][j];
}

// f32: S[r0.., c0..] -= L[r0.., k0:k0+kw] L[c0.., k0:k0+kw]' on one
// 128x128 lower tile of the trailing matrix, which starts at row and
// column t0.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
trail_update_kernel(T* __restrict__ L, const int* __restrict__ bad, int n,
                    int k0, int kw, int t0, int ntile) {
  static_assert(sizeof(T) == 4, "f64 takes trail_update_f64_kernel");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);   // 2 stages x {A, B} x TKC x TP
  T* sC = sm + 2 * 2 * TKC * TP;            // the C tile, pitch TCP
  constexpr int PC = TCP;
  const long long b = blockIdx.x / ntile;
  if (bad[b]) return;
  int I, J;
  tri_tile(blockIdx.x % ntile, I, J);
  const int r0 = t0 + I * TT, c0 = t0 + J * TT;
  const bool diag = I == J;
  T* Lb = L + b * (long long)n * n;
  const int tid = threadIdx.x;
  // the C tile comes in by cp.async while the products run
  stage(sC, PC, Lb + (long long)r0 * n + c0, n, TT, TT, min(TT, n - r0),
        min(TT, n - c0), true);
  cp_commit();

  // staging: thread t moves row t % 128, k (t / 128) * 8 .. + 8 of a chunk
  // of each operand through registers into k-major shared memory
  const int sr = tid % TT, sk = (tid / TT) * 8;
  const bool okA = r0 + sr < n, okB = c0 + sr < n;
  const T* gA = Lb + (long long)(okA ? r0 + sr : 0) * n + k0 + sk;
  const T* gB = Lb + (long long)(okB ? c0 + sr : 0) * n + k0 + sk;
  T ra[8], rb[8];
  auto load = [&](int c) {
#pragma unroll
    for (int v = 0; v < 8; v += VW<T>) {
      ld16(gA + c * TKC + v, ra + v);
      ld16(gB + c * TKC + v, rb + v);
    }
    if (!okA)
#pragma unroll
      for (int q = 0; q < 8; ++q) ra[q] = T(0);
    if (!okB)
#pragma unroll
      for (int q = 0; q < 8; ++q) rb[q] = T(0);
  };
  auto store = [&](int s) {
    T* a = sm + 2 * s * TKC * TP;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      a[(sk + q) * TP + sr] = ra[q];
      a[TKC * TP + (sk + q) * TP + sr] = rb[q];
    }
  };
  const int nch = kw / TKC;

  // thread (tr, tc): rows and columns tr*4 + i and 64 + tr*4 + i, i < 4
  const int tr = tid / 16, tc = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  load(0);
  store(0);
  __syncthreads();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) load(c + 1);
    const float* a = sm + 2 * (c & 1) * TKC * TP;
    const float* bb = a + TKC * TP;
#pragma unroll
    for (int k = 0; k < TKC; ++k) {
      float av[8], bv[8];
      ld4(a + k * TP + tr * 4, av);
      ld4(a + k * TP + 64 + tr * 4, av + 4);
      ld4(bb + k * TP + tc * 4, bv);
      ld4(bb + k * TP + 64 + tc * 4, bv + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
    if (c + 1 < nch) store((c + 1) & 1);
    __syncthreads();
  }
  cp_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rl = (i < 4 ? 0 : 64) + tr * 4 + i % 4, row = r0 + rl;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = (j < 4 ? 0 : 64) + tc * 4 + j % 4, col = c0 + cl;
      if (col >= n || (diag && row < col)) continue;
      Lb[(long long)row * n + col] = sC[rl * PC + cl] - acc[i][j];
    }
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// f64: the same update through the DMMA main loop.  The tile is one of
// `ntile` lower 128x128 tiles of the trailing matrix at row and column t0:
// with `strip`, those in its first two columns of tiles (the next outer
// panel's 256 columns, all rows below), else all of its triangle.  The C
// tile is prefetched into L2 when the block starts and read back in the
// epilogue, half a warp tile at a time (its loads issued together).
__global__ void __launch_bounds__(NT, 1)
trail_update_f64_kernel(double* __restrict__ L, const int* __restrict__ bad,
                        int n, int k0, int kw, int t0, int ntile,
                        int strip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long b = blockIdx.x / ntile;
  if (bad[b]) return;
  const int tile = blockIdx.x % ntile;
  int I, J;
  if (strip) {
    const int tt = (n - t0 + TT - 1) / TT;   // row tiles: J = 0, then 1
    J = tile < tt ? 0 : 1;
    I = tile - J * (tt - 1);
  } else {
    tri_tile(tile, I, J);
  }
  const int r0 = t0 + I * TT, c0 = t0 + J * TT;
  const bool diag = I == J;
  double* Lb = L + b * (long long)n * n;
  for (int idx = threadIdx.x; idx < TT * 8; idx += NT) {
    const int row = r0 + idx / 8, col = c0 + (idx % 8) * 16;
    if (row < n && col < n) prefetch_l2(Lb + (long long)row * n + col);
  }
  const WarpTile w;
  const bool idle = diag && w.above();
  double acc[2][8][4] = {};
  dmma_tile<false>(reinterpret_cast<double*>(smem_raw),
                   Lb + (long long)r0 * n + k0, Lb + (long long)c0 * n + k0,
                   nullptr, n, kw, min(TT, n - r0), min(TT, n - c0), true,
                   idle, acc);
  if (idle) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    double2 cv[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = r0 + w.wr + 16 * i + 8 * h + w.g;
        const int col = c0 + w.wc + 8 * j + 2 * w.t;
        const bool ok = row < n && col < n && !(diag && row < col);
        cv[h][j] = ok ? *reinterpret_cast<const double2*>(
                            Lb + (long long)row * n + col)
                      : make_double2(0.0, 0.0);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = r0 + w.wr + 16 * i + 8 * h + w.g;
        const int col = c0 + w.wc + 8 * j + 2 * w.t;
        if (row >= n || col >= n || (diag && row < col)) continue;
        double* p = Lb + (long long)row * n + col;
        if (!diag || row > col)
          *reinterpret_cast<double2*>(p) =
              make_double2(cv[h][j].x - acc[i][j][2 * h],
                           cv[h][j].y - acc[i][j][2 * h + 1]);
        else
          p[0] = cv[h][j].x - acc[i][j][2 * h];
      }
  }
}

// Row panel I of each instance: zero its strictly upper tiles, or, for an
// instance with a bad pivot, NaN in all of its L rows and Dinv[I].
template <typename T>
__global__ void __launch_bounds__(NT)
panel_finalize_kernel(T* __restrict__ L, T* __restrict__ Dinv,
                      const int* __restrict__ bad, int n) {
  constexpr int W = VW<T>;
  using V16 = typename Vec<T>::type;
  const int npan = n / BP;
  const long long b = blockIdx.x / npan;
  const int I = blockIdx.x % npan;
  T* rows = L + b * (long long)n * n + (long long)(I * BP) * n;
  V16 fill;
  T* f = reinterpret_cast<T*>(&fill);
  const bool nan = bad[b] != 0;
#pragma unroll
  for (int w = 0; w < W; ++w) f[w] = nan ? qnan<T>() : T(0);
  const int c0 = nan ? 0 : (I + 1) * BP, wv = (n - c0) / W;
  for (int idx = threadIdx.x; idx < BP * wv; idx += NT)
    *reinterpret_cast<V16*>(rows + (long long)(idx / wv) * n + c0 +
                            (idx % wv) * W) = fill;
  if (nan) {
    T* Dj = Dinv + (b * npan + I) * (long long)(BP * BP);
    for (int idx = threadIdx.x; idx < BP * BP / W; idx += NT)
      reinterpret_cast<V16*>(Dj)[idx] = fill;
  }
}

// ---- panel_solve --------------------------------------------------------
//
// Scratch, zeroed by the wrapper before each launch (psolve_scratch
// bytes): the ticket counter, then per (chain, sweep) the n published
// values.  A value is published as one (f32) or two (f64: low and high
// half) 64-bit words whose high 32 bits hold the tag PS_TAG.  Each word is
// stored and loaded whole, so a reader that sees the tag sees the value,
// with no fence on either side and no counter.
//
// L's tiles stream through a ring of PS_RING slots in shared memory,
// one TMA copy (cp.async.bulk.tensor.2d) of a whole 64x64 tile each,
// completing on the slot's mbarrier.

constexpr int PS_RING = 4;   // slots of the ring of L's tiles
constexpr unsigned long long PS_TAG = 1ULL << 32;
template <typename T> constexpr int PS_WPV = sizeof(T) / 4;   // words a value
// A ring slot: a 64x64 tile, dense as TMA writes it (a multiple of the
// 128 bytes TMA aligns to).
constexpr int PS_SLOT = BP * BP;
// the ring (its first slot holds the partial sums after the loop), the
// panel's right side and four buffers of a published panel, behind up to
// 128 bytes that align the ring for TMA
template <typename T> constexpr int SMEM_PSOLVE =
    128 + (PS_RING * PS_SLOT + 5 * BP) * sizeof(T);

template <typename T>
__host__ __device__ constexpr long long psolve_scratch(int chains, int n) {
  return 128LL + (long long)chains * 2 * n * PS_WPV<T> * 8;
}

__device__ __forceinline__ void ld2_relaxed(const unsigned long long* p,
                                            unsigned long long& a,
                                            unsigned long long& b) {
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];\n"
               : "=l"(a), "=l"(b) : "l"(p));
}

__device__ __forceinline__ double join_halves(unsigned long long lo,
                                              unsigned long long hi) {
  return __longlong_as_double((long long)((hi << 32) | (lo & 0xffffffffULL)));
}

// Two consecutive values at p (16-byte aligned) into v; true when both
// are tagged.
template <typename T>
__device__ __forceinline__ bool take2(const unsigned long long* p, T* v) {
  unsigned long long a, b;
  ld2_relaxed(p, a, b);
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float((unsigned)a);
    v[1] = __uint_as_float((unsigned)b);
    return (a >= PS_TAG) & (b >= PS_TAG);
  } else {
    unsigned long long c, d;
    ld2_relaxed(p + 2, c, d);
    v[0] = join_halves(a, b);
    v[1] = join_halves(c, d);
    return (a >= PS_TAG) & (b >= PS_TAG) & (c >= PS_TAG) & (d >= PS_TAG);
  }
}

// Warp 0: the 64 values of a published panel at p into sy, polling until
// all are tagged (lane l takes values 2l and 2l + 1).
template <typename T>
__device__ __forceinline__ void take_panel(const unsigned long long* p, T* sy) {
  const int lane = threadIdx.x % 32;
  T v[2];
  while (!__all_sync(0xffffffffu, take2(p + 2 * lane * PS_WPV<T>, v))) {
  }
  sy[2 * lane] = v[0];
  sy[2 * lane + 1] = v[1];
}

template <typename T>
__device__ __forceinline__ void publish(unsigned long long* p, T v) {
  if constexpr (sizeof(T) == 4) {
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p),
                 "l"(PS_TAG | __float_as_uint(v)) : "memory");
  } else {
    const unsigned long long w = (unsigned long long)__double_as_longlong(v);
    asm volatile("st.relaxed.gpu.global.v2.b64 [%0], {%1, %2};\n" ::"l"(p),
                 "l"(PS_TAG | (w & 0xffffffffULL)), "l"(PS_TAG | (w >> 32))
                 : "memory");
  }
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait for the completion of the mbarrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  unsigned done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One thread: the 64x64 tile at (row, col) of the tensor map into dst
// (dense), completing on bar.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         int row, int col, int bytes,
                                         unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(col), "r"(row),
      "r"(smem_addr(bar)) : "memory");
}

// Sixteen consecutive elements at p (16-byte aligned).
template <typename T>
__device__ __forceinline__ void ld16x(const T* p, T* v) {
#pragma unroll
  for (int q = 0; q < 16; q += 4) ld4(p + q, v + q);
}

template <typename T>
__device__ __forceinline__ T quad_sum(T s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// One block per (chain = (instance, right-hand side), 64-row panel j,
// sweep), in ticket order.  Forward: y_j = Dinv[j] (b_j - s - L[j, j-1]
// y_{j-1}), with s = sum_{k < j-1} L[j, k] y_k summed before y_{j-1}
// arrives.  Backward: x_j = Dinv[j]' (y_j - s - L[j+1, j]' x_{j+1}), with
// s = sum_{k > j+1} L[k, j]' x_k.  In the loop over L's tiles thread t
// takes rows t / 8 and t / 8 + 32 and columns 16 q + 2 (t % 8) (+ 1),
// q < 4, of each tile, so that a quarter warp reads 128 contiguous bytes
// of one row; it sums in registers over all the tiles, and the sums are
// reduced once, after the loop, in a fixed order.  For the chain's step
// thread (rc, seg) = (t / 4, 16 (t % 4)) owns row rc and columns seg ..
// seg + 15 of the two 64x64 mat-vecs, whose parts it holds in registers
// from the start.  Warp 0 fetches the published panels the block needs
// into shared memory; thread 32 keeps the ring of L's tiles filled.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
panel_solve_kernel(const __grid_constant__ CUtensorMap lmap,
                   const T* __restrict__ L, const T* __restrict__ Dinv,
                   const T* __restrict__ Bm, long long b_bs,
                   T* __restrict__ X, int n, int nrhs, int chains,
                   unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int WPV = PS_WPV<T>, R = PS_RING;
  T* ring = reinterpret_cast<T*>(   // R slots of PS_SLOT
      smem_raw + (128 - smem_addr(smem_raw) % 128) % 128);
  T* sv = ring + R * PS_SLOT;       // 64: the panel's right side
  T* sy = sv + BP;                  // 4 x 64: published panels
  __shared__ __align__(8) unsigned long long bar[R];
  __shared__ int s_ticket;
  const int tid = threadIdx.x, warp = tid / 32;
  if (tid == 0) {
    s_ticket = atomicAdd(reinterpret_cast<int*>(scratch), 1);
    for (int s = 0; s < R; ++s) mbar_init(bar + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ticket = s_ticket;
  const int chain = ticket % chains, pos = ticket / chains;
  const long long b = chain / nrhs;
  const int row = chain % nrhs, npan = n / BP;
  const bool fwd = pos < npan;
  const int j = fwd ? pos : 2 * npan - 1 - pos, o = j * BP;
  const T* Lb = L + b * (long long)n * n;
  unsigned long long* ypub = reinterpret_cast<unsigned long long*>(scratch + 128) +
                             (long long)chain * 2 * n * WPV;
  unsigned long long* xpub = ypub + (long long)n * WPV;
  const unsigned long long* get = fwd ? ypub : xpub;
  const int rc = tid / 4, seg = (tid % 4) * 16;

  // the thread's part of Dinv[j] (row rc, or column rc backward) and of
  // the tile beside the diagonal (forward L[j, j-1] row rc; backward
  // L[j+1, j] column rc), for the chain's step
  const bool has_m = fwd ? j > 0 : j + 1 < npan;
  const T* Dj = Dinv + (b * npan + j) * (long long)(BP * BP);
  T dv[16], lv[16];
  if (fwd) {
    ld16x(Dj + rc * BP + seg, dv);
    if (has_m) ld16x(Lb + (long long)(o + rc) * n + o - BP + seg, lv);
  } else {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      dv[q] = Dj[(seg + q) * BP + rc];
      if (has_m) lv[q] = Lb[(long long)(o + BP + seg + q) * n + o + rc];
    }
  }

  // the loop over the tiles i of the panel's row (forward: k = i < j - 1)
  // or column (backward: k = npan - 1 - i > j + 1), each times the
  // published panel k (y_k, x_k), which warp 0 fetches into sy[i % 2]
  const int ntile = fwd ? max(j - 1, 0) : max(npan - j - 2, 0);
  const int lrow = (int)(b * n);   // the instance's first row in the map
  auto fetch = [&](int i) {   // thread 32: tile i into slot i % R
    if (i < ntile) {
      const int k = fwd ? i : npan - 1 - i;
      tma_tile(ring + (i % R) * PS_SLOT, &lmap,
               lrow + (fwd ? o : k * BP), fwd ? k * BP : o,
               BP * BP * (int)sizeof(T), bar + i % R);
    }
  };
  if (tid == 32)
    for (int i = 0; i < R - 1; ++i) fetch(i);
  const int r0 = tid / 8, c0 = (tid % 8) * 2;   // rows r0, r0 + 32; columns
                                                // c0 + 16 q (+ 1)
  T acc[8];   // forward: rows r0 (acc[0]), r0 + 32 (acc[1]); backward:
              // columns c0 + 16 q (+ 1) (acc[2 q], acc[2 q + 1])
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = T(0);
  for (int i = 0; i < ntile; ++i) {
    if (warp == 0)
      take_panel(get + (long long)(fwd ? i : npan - 1 - i) * BP * WPV,
                 sy + (i % 2) * BP);
    __syncthreads();   // panel i is in sy[i % 2]; every thread is done
                       // with tile i - 1, whose slot is free
    if (tid == 32) fetch(i + R - 1);
    mbar_wait(bar + i % R, (i / R) & 1);
    const T* t = ring + (i % R) * PS_SLOT;
    const T* y = sy + (i % 2) * BP;
    if (fwd) {   // acc[h] += L[j, k][r0 + 32 h][c] y_k[c] over its columns
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + 16 * q;
        const T y0 = y[c], y1 = y[c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const T* tr = t + (r0 + 32 * h) * BP + c;
          acc[h] += tr[0] * y0 + tr[1] * y1;
        }
      }
    } else {     // acc[c] += L[k, j][r][c] x_k[r] over its rows r
      const T x0 = y[r0], x1 = y[r0 + 32];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + 16 * q;
        const T* a = t + r0 * BP + c;
        const T* e = t + (r0 + 32) * BP + c;
        acc[2 * q] += a[0] * x0 + e[0] * x1;
        acc[2 * q + 1] += a[1] * x0 + e[1] * x1;
      }
    }
  }
  // s (64 values, into sv) from the threads' sums, in a fixed order
  T* part = ring;   // backward: 32 x 64 partial sums
  __syncthreads();  // the ring is read
  if (fwd) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T v = acc[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      if (tid % 8 == 0) sv[r0 + 32 * h] = v;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      part[r0 * BP + c0 + 16 * q] = acc[2 * q];
      part[r0 * BP + c0 + 16 * q + 1] = acc[2 * q + 1];
    }
  }
  __syncthreads();

  if (!fwd) {   // sv = y_j - s
    if (warp == 0) take_panel(ypub + (long long)o * WPV, sy + 2 * BP);
    T v = T(0);
    if (tid < BP)
      for (int g = 0; g < 32; ++g) v += part[g * BP + tid];
    __syncthreads();
    if (tid < BP) sv[tid] = sy[2 * BP + tid] - v;
  } else if (tid < BP) {   // sv = b_j - s
    sv[tid] = Bm[b * b_bs + (long long)row * n + o + tid] - sv[tid];
  }
  if (has_m) {   // the chain's step: sv -= L[j, j-1] y_{j-1}, or
                 // L[j+1, j]' x_{j+1} backward
    T* buf = sy + 3 * BP;
    if (warp == 0)
      take_panel(get + (long long)(fwd ? o - BP : o + BP) * WPV, buf);
    __syncthreads();
    T r = T(0);
#pragma unroll
    for (int q = 0; q < 16; ++q) r += lv[q] * buf[seg + q];
    r = quad_sum(r);
    if (tid % 4 == 0) sv[rc] -= r;
  }
  __syncthreads();
  T c = T(0);        // Dinv[j] sv (forward) or Dinv[j]' sv (backward)
#pragma unroll
  for (int q = 0; q < 16; ++q) c += dv[q] * sv[seg + q];
  const T out = quad_sum(c);
  if (tid % 4 == 0) {
    publish((fwd ? ypub : xpub) + (long long)(o + rc) * WPV, out);
    if (!fwd) X[(b * nrhs + row) * (long long)n + o + rc] = out;
  }
}

// ---- launches ---------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// launch_config disagrees with the kernel's own layout
constexpr int ERR_LAYOUT = -2;

template <typename T>
int launch_schur_assemble(const void* P, long long p_bs, const void* Gt,
                          long long gt_bs, const void* dinv2, long long d_bs,
                          void* L, int B, int n, int m, int vec, int smem,
                          void* stream) {
  if (B == 0) return 0;
  const int t = (n + AT - 1) / AT;
  const long long grid = (long long)B * (t * (t + 1) / 2);
  if constexpr (sizeof(T) == 8) {
    if (smem != SMEM_DMMA) return ERR_LAYOUT;
    cudaError_t e = set_smem(schur_assemble_f64_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    schur_assemble_f64_kernel<<<(unsigned)grid, NT, smem,
                                (cudaStream_t)stream>>>(
        (const T*)P, p_bs, (const T*)Gt, gt_bs, (const T*)dinv2, d_bs, (T*)L,
        B, n, m, vec);
  } else {
    if (smem != SMEM_ASM<T>) return ERR_LAYOUT;
    cudaError_t e = set_smem(schur_assemble_kernel<T>, smem);
    if (e != cudaSuccess) return (int)e;
    schur_assemble_kernel<T><<<(unsigned)grid, NT, smem, (cudaStream_t)stream>>>(
        (const T*)P, p_bs, (const T*)Gt, gt_bs, (const T*)dinv2, d_bs, (T*)L,
        B, n, m, vec);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_schur_factor(void* L, void* Dinv, void* deq, int B, int n,
                        int smem, void* stream) {
  if (B == 0) return 0;
  if (smem != SMEM_FAC<T>) return ERR_LAYOUT;
  cudaError_t e = set_smem(schur_factor_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  schur_factor_kernel<T><<<B, NT, smem, (cudaStream_t)stream>>>(
      (T*)L, (T*)Dinv, (T*)deq, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_schur_chol64(const void* P, const void* Gt, long long gt_bs,
                        const void* dinv2, long long d_bs, void* L,
                        void* Dinv, void* deq, int B, int m, int vec,
                        int smem, void* stream) {
  if (B == 0) return 0;
  if (smem != SMEM_FAC<T>) return ERR_LAYOUT;
  cudaError_t e = set_smem(schur_chol64_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  schur_chol64_kernel<T><<<B, NT, smem, (cudaStream_t)stream>>>(
      (const T*)P, (const T*)Gt, gt_bs, (const T*)dinv2, d_bs, (T*)L,
      (T*)Dinv, (T*)deq, m, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chol_solve(const void* L, const void* Dinv, const void* Bm,
                      long long b_bs, void* X, int B, int n, int nrhs,
                      int smem, void* stream) {
  if (B == 0 || nrhs == 0) return 0;
  const bool few = nrhs <= FEW;
  if (smem != (few ? SMEM_FEW<T> : SMEM_MANY<T>)) return ERR_LAYOUT;
  cudaError_t e = few ? set_smem(solve_few_kernel<T>, smem)
                      : set_smem(solve_many_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  if (few) {
    solve_few_kernel<T><<<(unsigned)((long long)B * nrhs), NT, smem,
                          (cudaStream_t)stream>>>(
        (const T*)L, (const T*)Dinv, (const T*)Bm, b_bs, (T*)X, n, nrhs);
  } else {
    const long long grid = (long long)B * ((nrhs + BP - 1) / BP);
    solve_many_kernel<T><<<(unsigned)grid, NT, smem, (cudaStream_t)stream>>>(
        (const T*)L, (const T*)Dinv, (const T*)Bm, b_bs, (T*)X, n, nrhs);
  }
  return (int)cudaGetLastError();
}

// One launch of panel_factor, as ops/fused_chol.py's plan_codes encodes
// an entry of launch_config: the kernel, its grid and dynamic shared
// memory, its stream, the events it waits for before it starts and
// records when it ends (bit masks), and its arguments (panel_diag and
// panel_l21: jp; panel_update: jp, cols; trail_update: k0, rank, t0,
// col0, col1, strip; zero past them).
enum { K_DEQ, K_SCALE, K_DIAG, K_L21, K_UPDATE, K_TRAIL, K_FINALIZE };
enum { S_CALLER, S_MAIN, S_SIDE };
enum { E_FORK = 1, E_PANEL = 2, E_REST = 4, E_JOIN = 8 };
constexpr int NEVENT = 4;
struct Step {
  int kernel, grid, smem, stream, waits, records, arg[6];
};
static_assert(sizeof(Step) == 12 * sizeof(int), "a Step is 12 ints");

// panel_factor's launches after schur_assemble, in issue order.  f32 runs
// on the caller's stream.  f64 splits each trailing update into the next
// outer panel's strip and the rest, and for n > 2 NB forks: every launch
// on `main` but the rests, on `side`.  The rest of update p waits for
// panel p's chain ("panel"); the next strip, which overwrites columns
// that rest p updates, and the finalize wait for the latest rest
// ("rest"); the first launch waits for the caller's stream ("fork"), and
// the caller's stream for the last ("join").
template <typename T>
std::vector<Step> panel_factor_plan(int B, int n, bool equilibrate) {
  constexpr bool f64 = sizeof(T) == 8;
  const int npan = n / BP, pw = NB / BP;
  const bool forked = f64 && n > 2 * NB;   // else no update has a rest
  const int ms = forked ? S_MAIN : S_CALLER;
  std::vector<Step> out;
  auto add = [&](int kernel, int grid, int smem, int stream, int waits,
                 std::initializer_list<int> args) {
    Step st{kernel, grid, smem, stream, waits, 0, {}};
    int i = 0;
    for (int a : args) st.arg[i++] = a;
    out.push_back(st);
  };
  int fork = forked ? E_FORK : 0;
  if (equilibrate) {
    add(K_DEQ, B * ((n + NT - 1) / NT), 0, ms, fork, {});
    add(K_SCALE, B * (npan * (npan + 1) / 2), 0, ms, 0, {});
    fork = 0;
  }
  bool rest_pending = false;   // a rest issued and not yet waited for
  for (int p0 = 0; p0 < npan; p0 += pw) {
    const int pend = min(p0 + pw, npan) - 1;
    for (int jp = p0; jp <= pend; ++jp) {
      const int rows = npan - 1 - jp, cols = pend - jp;
      add(K_DIAG, B, SMEM_FAC<T>, ms, fork, {jp});
      fork = 0;
      if (rows) add(K_L21, B * rows, SMEM_PTILE<T>, ms, 0, {jp});
      if (cols) add(K_UPDATE, B * rows * cols, SMEM_PTILE<T>, ms, 0, {jp, cols});
    }
    if (pend == npan - 1) continue;
    // the trailing update of rank 256 from columns k0 .. t0
    const int t0 = (pend + 1) * BP, k0 = p0 * BP;
    const int tt = (n - t0 + TT - 1) / TT;
    if (!f64) {
      add(K_TRAIL, B * (tt * (tt + 1) / 2), SMEM_TRAIL, S_CALLER, 0,
          {k0, t0 - k0, t0, t0, n, 0});
      continue;
    }
    const bool rest = t0 + NB < n;
    if (rest) out.back().records |= E_PANEL;
    add(K_TRAIL, B * (min(NB, n - t0) > TT ? 2 * tt - 1 : tt), SMEM_DMMA, ms,
        rest_pending ? E_REST : 0, {k0, t0 - k0, t0, t0, min(t0 + NB, n), 1});
    rest_pending = rest;
    if (!rest) continue;
    const int r0 = t0 + NB, tr = (n - r0 + TT - 1) / TT;
    add(K_TRAIL, B * (tr * (tr + 1) / 2), SMEM_DMMA, S_SIDE, E_PANEL,
        {k0, t0 - k0, r0, r0, n, 0});
    out.back().records |= E_REST;
  }
  add(K_FINALIZE, B * npan, 0, ms, rest_pending ? E_REST : 0, {});
  if (forked) out.back().records |= E_JOIN;
  return out;
}

// The f64 lookahead's streams and events on one device, made at first
// use: `main` at the device's greatest stream priority (the panel chain),
// `side` at its least (the rests).  Every call on any device uses them
// under lookahead_mutex, from the fork to the join: two host threads
// (ctypes lets go of the GIL) would otherwise interleave their records
// and waits on the same events.
struct Lookahead {
  cudaStream_t main = nullptr, side = nullptr;
  cudaEvent_t ev[NEVENT];   // fork, panel, rest, join
};

constexpr int MAX_DEVICES = 64;

std::mutex lookahead_mutex;

cudaError_t lookahead_of_current_device(Lookahead** out) {
  static Lookahead table[MAX_DEVICES];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Lookahead& la = table[dev];
  if (!la.main) {
    int least, greatest;
    cudaStream_t m, sd;
    if ((e = cudaDeviceGetStreamPriorityRange(&least, &greatest)) != cudaSuccess ||
        (e = cudaStreamCreateWithPriority(&m, cudaStreamNonBlocking, greatest)) !=
            cudaSuccess ||
        (e = cudaStreamCreateWithPriority(&sd, cudaStreamNonBlocking, least)) !=
            cudaSuccess)
      return e;
    for (cudaEvent_t& ev : la.ev)
      if ((e = cudaEventCreateWithFlags(&ev, cudaEventDisableTiming)) != cudaSuccess)
        return e;
    la.side = sd;
    la.main = m;   // last: the entry is complete
  }
  *out = &la;
  return cudaSuccess;
}

// The small-batch factor after schur_assemble: panel_factor_plan's
// launches, one at a time from the host.  `plan` holds nlaunch Steps as
// ops/fused_chol.py encodes launch_config's; ERR_LAYOUT, before anything
// is launched, unless they equal this source's plan in every field,
// streams, waits and records included.  A forked plan is joined back into
// the caller's stream before the return, also when a launch fails.
template <typename T>
int launch_panel_factor(void* L, void* Dinv, void* deq, void* bad, int B,
                        int n, const int* plan, int nlaunch, void* stream) {
  constexpr bool f64 = sizeof(T) == 8;
  if (B == 0) return 0;
  const std::vector<Step> steps = panel_factor_plan<T>(B, n, deq != nullptr);
  if (nlaunch != (int)steps.size() ||
      std::memcmp(steps.data(), plan, steps.size() * sizeof(Step)) != 0)
    return ERR_LAYOUT;
  cudaError_t e;
  if ((e = set_smem(panel_diag_kernel<T>, SMEM_FAC<T>)) != cudaSuccess ||
      (e = set_smem(panel_l21_kernel<T>, SMEM_PTILE<T>)) != cudaSuccess ||
      (e = set_smem(panel_update_kernel<T>, SMEM_PTILE<T>)) != cudaSuccess)
    return (int)e;
  if constexpr (f64)
    e = set_smem(trail_update_f64_kernel, SMEM_DMMA);
  else
    e = set_smem(trail_update_kernel<T>, SMEM_TRAIL);
  if (e != cudaSuccess) return (int)e;
  const bool fork = steps.front().waits & E_FORK;
  std::unique_lock<std::mutex> lock(lookahead_mutex, std::defer_lock);
  Lookahead* la = nullptr;
  cudaStream_t caller = (cudaStream_t)stream;
  if (fork) {
    lock.lock();
    if ((e = lookahead_of_current_device(&la)) != cudaSuccess ||
        (e = cudaEventRecord(la->ev[0], caller)) != cudaSuccess)
      return (int)e;
  }
  const cudaStream_t streams[3] = {caller, la ? la->main : caller,
                                   la ? la->side : caller};
  T* Lp = (T*)L;
  T* Dp = (T*)Dinv;
  int* bp = (int*)bad;
  const int npan = n / BP;
  auto run = [&]() -> cudaError_t {
    cudaError_t err;
    for (const Step& s : steps) {
      const cudaStream_t st = streams[s.stream];
      for (int k = 0; k < NEVENT; ++k)
        if ((s.waits >> k & 1) &&
            (err = cudaStreamWaitEvent(st, la->ev[k], 0)) != cudaSuccess)
          return err;
      const int per = s.grid / B;   // blocks per instance
      switch (s.kernel) {
        case K_DEQ:
          panel_deq_kernel<T><<<s.grid, NT, 0, st>>>(Lp, (T*)deq, n, per);
          break;
        case K_SCALE:
          panel_scale_kernel<T><<<s.grid, NT, 0, st>>>(Lp, (const T*)deq, n, per);
          break;
        case K_DIAG:
          panel_diag_kernel<T><<<s.grid, NT, s.smem, st>>>(Lp, Dp, bp, n, s.arg[0]);
          break;
        case K_L21:
          panel_l21_kernel<T><<<s.grid, NT, s.smem, st>>>(Lp, Dp, bp, n, s.arg[0], per);
          break;
        case K_UPDATE:
          panel_update_kernel<T><<<s.grid, NT, s.smem, st>>>(
              Lp, bp, n, s.arg[0], npan - 1 - s.arg[0], s.arg[1]);
          break;
        case K_TRAIL:
          if constexpr (f64)
            trail_update_f64_kernel<<<s.grid, NT, s.smem, st>>>(
                Lp, bp, n, s.arg[0], s.arg[1], s.arg[2], per, s.arg[5]);
          else
            trail_update_kernel<T><<<s.grid, NT, s.smem, st>>>(
                Lp, bp, n, s.arg[0], s.arg[1], s.arg[2], per);
          break;
        case K_FINALIZE:
          panel_finalize_kernel<T><<<s.grid, NT, 0, st>>>(Lp, Dp, bp, n);
          break;
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      for (int k = 0; k < NEVENT; ++k)
        if ((s.records >> k & 1) &&
            (err = cudaEventRecord(la->ev[k], st)) != cudaSuccess)
          return err;
    }
    return cudaSuccess;
  };
  e = run();
  if (!fork) return (int)e;
  // the join; after a failed launch, first everything issued on side, so
  // that nothing of this call runs on after the caller's stream moves on
  cudaError_t j = cudaSuccess;
  if (e != cudaSuccess) {
    j = cudaEventRecord(la->ev[2], la->side);
    if (j == cudaSuccess) j = cudaStreamWaitEvent(la->main, la->ev[2], 0);
    if (j == cudaSuccess) j = cudaEventRecord(la->ev[3], la->main);
  }
  if (j == cudaSuccess) j = cudaStreamWaitEvent(caller, la->ev[3], 0);
  return (int)(e != cudaSuccess ? e : j);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault);
    if (e != cudaSuccess) return e;
    if (!p) return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// the tensor map of L could not be made
constexpr int ERR_TMAP = -3;

template <typename T>
int launch_panel_solve(const void* L, const void* Dinv, const void* Bm,
                       long long b_bs, void* X, int B, int n, int nrhs,
                       void* scratch, long long scratch_bytes, int smem,
                       void* stream) {
  if (B == 0 || nrhs == 0) return 0;
  const int chains = B * nrhs;
  if (smem != SMEM_PSOLVE<T> || scratch_bytes != psolve_scratch<T>(chains, n))
    return ERR_LAYOUT;
  EncodeTiled enc;
  cudaError_t e = encode_tiled(&enc);
  if (e != cudaSuccess) return (int)e;
  // L as a (B n) x n row-major matrix, read in 64x64 boxes
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)B * n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * sizeof(T)};
  const cuuint32_t box[2] = {BP, BP}, unit[2] = {1, 1};
  if (enc(&map, sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
          2, const_cast<void*>(L), dims, strides, box, unit,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_TMAP;
  if ((e = set_smem(panel_solve_kernel<T>, smem)) != cudaSuccess) return (int)e;
  panel_solve_kernel<T><<<chains * 2 * (n / BP), NT, smem,
                          (cudaStream_t)stream>>>(
      map, (const T*)L, (const T*)Dinv, (const T*)Bm, b_bs, (T*)X, n, nrhs,
      chains, (unsigned char*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define FUSED_CHOL_EXPORTS(T, SFX)                                            \
  int schur_assemble_##SFX(const void* P, long long p_bs, const void* Gt,     \
                           long long gt_bs, const void* dinv2,                \
                           long long d_bs, void* L, int B, int n, int m,      \
                           int vec, int smem, void* stream) {                 \
    return launch_schur_assemble<T>(P, p_bs, Gt, gt_bs, dinv2, d_bs, L, B,    \
                                    n, m, vec, smem, stream);                 \
  }                                                                           \
  int schur_factor_##SFX(void* L, void* Dinv, void* deq, int B, int n,        \
                         int smem, void* stream) {                            \
    return launch_schur_factor<T>(L, Dinv, deq, B, n, smem, stream);          \
  }                                                                           \
  int schur_chol64_##SFX(const void* P, const void* Gt, long long gt_bs,     \
                         const void* dinv2, long long d_bs, void* L,          \
                         void* Dinv, void* deq, int B, int m, int vec,        \
                         int smem, void* stream) {                            \
    return launch_schur_chol64<T>(P, Gt, gt_bs, dinv2, d_bs, L, Dinv, deq,   \
                                  B, m, vec, smem, stream);                   \
  }                                                                           \
  int chol_solve_##SFX(const void* L, const void* Dinv, const void* Bm,       \
                       long long b_bs, void* X, int B, int n, int nrhs,       \
                       int smem, void* stream) {                              \
    return launch_chol_solve<T>(L, Dinv, Bm, b_bs, X, B, n, nrhs, smem,       \
                                stream);                                      \
  }                                                                           \
  int panel_factor_##SFX(void* L, void* Dinv, void* deq, void* bad, int B,    \
                         int n, const int* plan, int nlaunch, void* stream) { \
    return launch_panel_factor<T>(L, Dinv, deq, bad, B, n, plan, nlaunch,     \
                                  stream);                                    \
  }                                                                           \
  int panel_solve_##SFX(const void* L, const void* Dinv, const void* Bm,      \
                        long long b_bs, void* X, int B, int n, int nrhs,      \
                        void* scratch, long long scratch_bytes, int smem,     \
                        void* stream) {                                       \
    return launch_panel_solve<T>(L, Dinv, Bm, b_bs, X, B, n, nrhs, scratch,   \
                                 scratch_bytes, smem, stream);                \
  }

FUSED_CHOL_EXPORTS(float, f32)
FUSED_CHOL_EXPORTS(double, f64)

// Shared memory a block of `device` may opt in to, in bytes.
int smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Streaming multiprocessors of `device`.
int sm_count(int device, int* count) {
  return (int)cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount,
                                     device);
}

}  // extern "C"
