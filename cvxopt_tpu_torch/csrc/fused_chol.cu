// Fused condensed-KKT factor and solve for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of cvxopt_tpu/ops/pallas_chol.py:
//   schur_chol  <- fused_schur_cholesky (:129) and
//                  fused_schur_cholesky_batched (:338)
//   chol_solve  <- fused_cholesky_solve (:194) and
//                  fused_cholesky_solve_batched (:404)
//
// schur_chol, one thread block per instance:
//     S = P + Gt diag(dinv2) Gt'           (lower 64x64 tiles of S)
//     [equilibrate] deq = 1/sqrt(max(diag S, 1e-30)),  S := D S D
//     S = L L'  blocked right-looking Cholesky, panel BP = 64
//     Dinv[j] = inverse of L's j-th diagonal 64x64 block
// chol_solve, one block per (instance, R right-hand-side rows):
//     x = (L L')^{-1} b for b stored as rows, panel by panel through
//     the Dinv products (forward, then backward).
//
// What bounds them on this card.  At the main-path shape (B = 1024,
// n = 256, m = 512) the assembly of S's lower triangle is n (n+1) m FLOP
// per instance against n^2 words of output: it is bound by FP32/FP64
// operations on the CUDA cores (TF32 is off, so there is no tensor-core
// path for full f32).  The panel recurrences (64 pivots with a block
// barrier each, the 64x64 triangular inverse) are latency-bound.  The
// solve at nrhs = 1 reads L's strictly lower off-diagonal tiles and Dinv
// once per instance and is bound by bytes.  Its block holds R whole
// right-hand-side rows in shared memory; the caller picks R to fit
// (smem_optin), which limits n to what one row leaves room for.
//
// What the design does about it.  The TPU kernel held all of S in VMEM;
// here S (256 KB in f32 at n = 256) does not fit the 227 KB of shared
// memory a block may use, so S lives in the L output buffer in device
// memory and the L2 cache holds the working set of the resident blocks.
// Every product is done in 64x64 tiles staged through shared memory,
// 16x16 threads each owning a 4x4 register micro-tile.  The Gt chunks
// are scaled by dinv2 as they are staged, so the per-instance scaled G
// is never formed (Gt may be shared across the batch: batch stride 0).
// Latency of the sequential panel steps is hidden by running many
// instances (blocks) per SM, not inside one block.
//
// Singularity contract: a pivot that is <= 0 or not finite poisons the
// whole instance: L and Dinv come back all NaN, as a failed
// torch.linalg.cholesky_ex does in the plain version (the TPU kernel
// clamped the pivot and returned finite garbage).  The solvers turn
// NaN into a status code.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BP = 64;       // panel width
constexpr int PITCH = BP + 1;
constexpr int NT = 256;      // threads per block
constexpr int KC = 32;       // k-chunk of the assembly

template <typename T> __device__ __forceinline__ T dsqrt(T x);
template <> __device__ __forceinline__ float dsqrt<float>(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double dsqrt<double>(double x) { return sqrt(x); }

template <typename T> __device__ __forceinline__ T qnan();
template <> __device__ __forceinline__ float qnan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// out[r][c] (+)= sum_k a[r*PITCH+k] * b[c*PITCH+k] over k < kmax, for
// the 4x4 micro-tile r = tr + 16 i, c = tc + 16 j.
template <typename T>
__device__ __forceinline__ void tile_abt(const T* a, const T* b, int kmax,
                                         int tr, int tc, T acc[4][4]) {
  for (int k = 0; k < kmax; ++k) {
    T av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(tr + 16 * i) * PITCH + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tc + 16 * j) * PITCH + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// Stage a 64x64 tile of a row-major matrix (leading dimension ld) into
// shared memory with pitch PITCH, as is (dst[r][c] = src[r][c]) or
// transposed (dst[c][r] = src[r][c]); global reads are coalesced.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld,
                                          bool transpose) {
  for (int idx = threadIdx.x; idx < BP * BP; idx += NT) {
    const int r = idx / BP, c = idx % BP;
    const T v = src[r * ld + c];
    if (transpose) dst[c * PITCH + r] = v; else dst[r * PITCH + c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
schur_chol_kernel(const T* __restrict__ P, long long p_bs,
                  const T* __restrict__ Gt, long long gt_bs,
                  const T* __restrict__ dinv2, long long d_bs,
                  T* __restrict__ L, T* __restrict__ Dinv,
                  T* __restrict__ deq, int n, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);
  T* sB = sA + BP * PITCH;
  T* sC = sB + BP * PITCH;
  __shared__ int bad;

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int npan = n / BP;
  P += b * p_bs;
  Gt += b * gt_bs;
  dinv2 += b * d_bs;
  T* Lb = L + b * (long long)n * n;
  T* Db = Dinv + b * (long long)npan * BP * BP;
  T* dq = deq ? deq + b * n : nullptr;
  if (tid == 0) bad = 0;

  // ---- equilibration: deq_i = 1/sqrt(max(S_ii, 1e-30)), one warp/row
  if (dq) {
    const int warp = tid / 32, lane = tid % 32;
    for (int i = warp; i < n; i += NT / 32) {
      const T* g = Gt + (long long)i * m;
      T s = T(0);
      for (int k = lane; k < m; k += 32) s += g[k] * g[k] * dinv2[k];
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) {
        s += P[(long long)i * n + i];
        const T f = (s != s) ? s : (s > T(1e-30) ? s : T(1e-30));
        dq[i] = T(1) / dsqrt(f);
      }
    }
  }
  __syncthreads();

  // ---- assembly of the lower tiles of S into L
  // chunk buffers, k-major: sA[kk*PITCH + r] = Gt[I*64+r][k0+kk]*dinv2
  for (int I = 0; I < npan; ++I) {
    for (int J = 0; J <= I; ++J) {
      T acc[4][4] = {};
      for (int k0 = 0; k0 < m; k0 += KC) {
        __syncthreads();
        for (int idx = tid; idx < BP * KC; idx += NT) {
          const int r = idx / KC, kk = idx % KC;
          const int k = k0 + kk;
          T ga = T(0), gb = T(0);
          if (k < m) {
            ga = Gt[(long long)(I * BP + r) * m + k] * dinv2[k];
            gb = Gt[(long long)(J * BP + r) * m + k];
          }
          sA[kk * PITCH + r] = ga;
          sB[kk * PITCH + r] = gb;
        }
        __syncthreads();
        const int kmax = min(KC, m - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          T av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = sA[kk * PITCH + tr + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = sB[kk * PITCH + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = I * BP + tr + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = J * BP + tc + 16 * j;
          T v = acc[i][j] + P[(long long)row * n + col];
          if (dq) v = v * dq[row] * dq[col];
          Lb[(long long)row * n + col] = v;
        }
      }
    }
  }
  __syncthreads();

  // ---- blocked right-looking Cholesky, in place in Lb
  for (int jp = 0; jp < npan; ++jp) {
    const int o = jp * BP;
    T* diag = Lb + (long long)o * n + o;
    load_tile(sA, diag, n, false);
    __syncthreads();
    // unblocked Cholesky of the diagonal block (lower triangle)
    for (int k = 0; k < BP; ++k) {
      T akk = sA[k * PITCH + k];
      if (!(akk > T(0)) || isinf(akk)) {
        akk = qnan<T>();
        if (tid == 0) bad = 1;
      }
      const T lkk = dsqrt(akk);
      __syncthreads();   // every thread has read the pivot
      if (tid == 0) sA[k * PITCH + k] = lkk;
      for (int i = k + 1 + tid; i < BP; i += NT) sA[i * PITCH + k] /= lkk;
      __syncthreads();
      for (int idx = tid; idx < BP * BP; idx += NT) {
        const int i = idx / BP, j = idx % BP;
        if (j > k && i >= j) sA[i * PITCH + j] -= sA[i * PITCH + k] * sA[j * PITCH + k];
      }
      __syncthreads();
    }
    if (bad) break;    // block-uniform: read after a barrier
    // triangular inverse of L11, one column per thread
    if (tid < BP) {
      const int c = tid;
      for (int i = 0; i < BP; ++i) {
        if (i < c) { sB[i * PITCH + c] = T(0); continue; }
        T s = (i == c) ? T(1) : T(0);
        for (int k = c; k < i; ++k) s -= sA[i * PITCH + k] * sB[k * PITCH + c];
        sB[i * PITCH + c] = s / sA[i * PITCH + i];
      }
    }
    __syncthreads();
    T* Dj = Db + (long long)jp * BP * BP;
    for (int idx = tid; idx < BP * BP; idx += NT) {
      const int r = idx / BP, c = idx % BP;
      diag[(long long)r * n + c] = (r >= c) ? sA[r * PITCH + c] : T(0);
      Dj[idx] = sB[r * PITCH + c];
    }
    // L21 = A21 Linv11', tile by tile (sB = Linv11)
    for (int I = jp + 1; I < npan; ++I) {
      T* a21 = Lb + (long long)(I * BP) * n + o;
      __syncthreads();
      load_tile(sC, a21, n, false);
      __syncthreads();
      T acc[4][4] = {};
      tile_abt(sC, sB, BP, tr, tc, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a21[(long long)(tr + 16 * i) * n + tc + 16 * j] = acc[i][j];
    }
    __syncthreads();
    // trailing update of the lower tiles: S[I,J] -= L21[I] L21[J]'
    for (int I = jp + 1; I < npan; ++I) {
      __syncthreads();
      load_tile(sA, Lb + (long long)(I * BP) * n + o, n, false);
      for (int J = jp + 1; J <= I; ++J) {
        __syncthreads();
        load_tile(sC, Lb + (long long)(J * BP) * n + o, n, false);
        __syncthreads();
        T acc[4][4] = {};
        tile_abt(sA, sC, BP, tr, tc, acc);
        T* sij = Lb + (long long)(I * BP) * n + J * BP;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sij[(long long)(tr + 16 * i) * n + tc + 16 * j] -= acc[i][j];
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
  // zero the strictly upper tiles
  for (int I = 0; I < npan; ++I)
    for (int J = I + 1; J < npan; ++J)
      for (int idx = tid; idx < BP * BP; idx += NT)
        Lb[(long long)(I * BP + idx / BP) * n + J * BP + idx % BP] = T(0);
}

// x = (L L')^{-1} b for R right-hand-side rows per block.
// sY holds y (forward) and then x (backward) for the block's rows.
template <typename T>
__global__ void __launch_bounds__(NT)
chol_solve_kernel(const T* __restrict__ L, const T* __restrict__ Dinv,
                  const T* __restrict__ Bm, long long b_bs,
                  T* __restrict__ X, int n, int nrhs, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sT = reinterpret_cast<T*>(smem_raw);   // BP * PITCH
  T* sAcc = sT + BP * PITCH;                 // R * BP
  T* sY = sAcc + R * BP;                     // R * n

  const long long b = blockIdx.x;
  const int r0 = blockIdx.y * R;
  const int rows = min(R, nrhs - r0);
  const int tid = threadIdx.x;
  const int npan = n / BP;
  const T* Lb = L + b * (long long)n * n;
  const T* Db = Dinv + b * (long long)npan * BP * BP;
  const T* Bb = Bm + b * b_bs + (long long)r0 * n;
  T* Xb = X + b * (long long)nrhs * n + (long long)r0 * n;

  // forward: y_j = (b_j - y[:, :o] L[o:o+64, :o]') Dinv[j]'
  for (int jp = 0; jp < npan; ++jp) {
    const int o = jp * BP;
    for (int idx = tid; idx < rows * BP; idx += NT)
      sAcc[idx] = Bb[(long long)(idx / BP) * n + o + idx % BP];
    for (int kt = 0; kt < jp; ++kt) {
      __syncthreads();
      load_tile(sT, Lb + (long long)o * n + kt * BP, n, false);  // sT[c][k] = L[o+c][k0+k]
      __syncthreads();
      for (int idx = tid; idx < rows * BP; idx += NT) {
        const int r = idx / BP, c = idx % BP;
        const T* y = sY + r * n + kt * BP;
        T s = T(0);
        for (int k = 0; k < BP; ++k) s += y[k] * sT[c * PITCH + k];
        sAcc[idx] -= s;
      }
    }
    __syncthreads();
    load_tile(sT, Db + (long long)jp * BP * BP, BP, false);       // sT[c][k] = Dinv[c][k]
    __syncthreads();
    for (int idx = tid; idx < rows * BP; idx += NT) {
      const int r = idx / BP, c = idx % BP;
      T s = T(0);
      for (int k = 0; k <= c; ++k) s += sAcc[r * BP + k] * sT[c * PITCH + k];
      sY[r * n + o + c] = s;
    }
    __syncthreads();
  }
  // backward: x_j = (y_j - x[:, o+64:] L[o+64:, o:o+64]) Dinv[j]
  for (int jp = npan - 1; jp >= 0; --jp) {
    const int o = jp * BP;
    for (int idx = tid; idx < rows * BP; idx += NT)
      sAcc[idx] = sY[(idx / BP) * n + o + idx % BP];
    for (int kt = jp + 1; kt < npan; ++kt) {
      __syncthreads();
      load_tile(sT, Lb + (long long)(kt * BP) * n + o, n, true);  // sT[c][k] = L[k0+k][o+c]
      __syncthreads();
      for (int idx = tid; idx < rows * BP; idx += NT) {
        const int r = idx / BP, c = idx % BP;
        const T* x = sY + r * n + kt * BP;
        T s = T(0);
        for (int k = 0; k < BP; ++k) s += x[k] * sT[c * PITCH + k];
        sAcc[idx] -= s;
      }
    }
    __syncthreads();
    load_tile(sT, Db + (long long)jp * BP * BP, BP, true);        // sT[c][k] = Dinv[k][c]
    __syncthreads();
    for (int idx = tid; idx < rows * BP; idx += NT) {
      const int r = idx / BP, c = idx % BP;
      T s = T(0);
      for (int k = c; k < BP; ++k) s += sAcc[r * BP + k] * sT[c * PITCH + k];
      sY[r * n + o + c] = s;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < rows * n; idx += NT)
    Xb[(long long)(idx / n) * n + idx % n] = sY[idx];
}

template <typename T>
int launch_schur_chol(const void* P, long long p_bs, const void* Gt,
                      long long gt_bs, const void* dinv2, long long d_bs,
                      void* L, void* Dinv, void* deq, int B, int n, int m,
                      void* stream) {
  if (B == 0) return 0;
  const size_t smem = 3 * BP * PITCH * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      schur_chol_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  schur_chol_kernel<T><<<B, NT, smem, (cudaStream_t)stream>>>(
      (const T*)P, p_bs, (const T*)Gt, gt_bs, (const T*)dinv2, d_bs,
      (T*)L, (T*)Dinv, (T*)deq, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chol_solve(const void* L, const void* Dinv, const void* Bm,
                      long long b_bs, void* X, int B, int n, int nrhs,
                      int R, void* stream) {
  if (B == 0 || nrhs == 0) return 0;
  const size_t smem = (BP * PITCH + (size_t)R * BP + (size_t)R * n) * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      chol_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, (nrhs + R - 1) / R);
  chol_solve_kernel<T><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)L, (const T*)Dinv, (const T*)Bm, b_bs, (T*)X, n, nrhs, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int schur_chol_f32(const void* P, long long p_bs, const void* Gt,
                   long long gt_bs, const void* dinv2, long long d_bs,
                   void* L, void* Dinv, void* deq, int B, int n, int m,
                   void* stream) {
  return launch_schur_chol<float>(P, p_bs, Gt, gt_bs, dinv2, d_bs, L, Dinv,
                                  deq, B, n, m, stream);
}

int schur_chol_f64(const void* P, long long p_bs, const void* Gt,
                   long long gt_bs, const void* dinv2, long long d_bs,
                   void* L, void* Dinv, void* deq, int B, int n, int m,
                   void* stream) {
  return launch_schur_chol<double>(P, p_bs, Gt, gt_bs, dinv2, d_bs, L, Dinv,
                                   deq, B, n, m, stream);
}

// Shared memory a block of `device` may opt in to, in bytes.
int smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

int chol_solve_f32(const void* L, const void* Dinv, const void* Bm,
                   long long b_bs, void* X, int B, int n, int nrhs, int R,
                   void* stream) {
  return launch_chol_solve<float>(L, Dinv, Bm, b_bs, X, B, n, nrhs, R, stream);
}

int chol_solve_f64(const void* L, const void* Dinv, const void* Bm,
                   long long b_bs, void* X, int B, int n, int nrhs, int R,
                   void* stream) {
  return launch_chol_solve<double>(L, Dinv, Bm, b_bs, X, B, n, nrhs, R, stream);
}

}  // extern "C"
