// Block-arrow KKT factorization and back-solves for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of pockit_tpu/solver/pallas_kkt.py:
//   bak_factor_*     <- _factor_kernel      (pallas_kkt.py:160-382)
//   bak_apply_down_* <- _apply_down_kernel  (pallas_kkt.py:385-400)
//   bak_apply_up_*   <- _apply_up_kernel    (pallas_kkt.py:403-413)
//
// Layout: every array is batch-LAST, (..., Bp) with the lane index
// fastest, as pad_move in solver/cuda_kkt.py produces it; one lane is one
// KKT system.
//
// Numerics follow the Pallas bodies exactly: Jacobi equilibration
// sc = 1/sqrt(max(diag + d, 1e-30)), left-looking Cholesky and triangular
// solves with pairwise (tree) sums in the reference's order, the Schur
// complement in Gram form subtracted block by block in block order,
// block-local pivot acceptance with the per-block retry ladder. NaN must
// survive min/max (a negative pivot surfaces as sqrt(<0) = NaN and must
// fail the lane): fminf/fmaxf drop NaN, so nan_min/nan_max propagate it.
// Build WITHOUT --use_fast_math: approximate sqrt/division and
// flush-to-zero would move lanes across the pivot-ratio threshold.
// Parallelism goes across independent entries, rows, columns and blocks,
// never inside one sum: every sum keeps the reference's order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxInterior = 64;   // widest padded interior block (cuda_kkt.MAX_INTERIOR)
constexpr int kMaxReduced = 128;   // widest padded reduced block (cuda_kkt.MAX_REDUCED)
constexpr int kUpWarps = 8;        // most warps of an apply_up CTA
constexpr int kSmemMax = 232448;   // shared memory one H100 CTA may opt into (227 KB)
constexpr int kSmemDefault = 49152;  // without opting in (48 KB)

template <typename T>
__device__ __forceinline__ bool is_nan(T x) { return x != x; }

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (is_nan(a) || a < b) ? a : b; }

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (is_nan(a) || a > b) ? a : b; }

template <typename T>
__device__ __forceinline__ T inf_val() { return T(INFINITY); }

template <typename T>
__device__ __forceinline__ bool passes(T dmin, T dmax, T rtol) {
  return isfinite(dmin) && isfinite(dmax) && dmin > rtol * dmax;
}

// Pairwise sum of a[0..N) in the order of structured._tree_sum, for a
// compile-time count N over a register array: fully unrolled, so the array
// never leaves registers.
template <int N, typename T, int M>
__device__ __forceinline__ T tree_sum_n(T (&a)[M]) {
  static_assert(N >= 1 && N <= M, "tree_sum_n: bad count");
  if constexpr (N == 1) {
    return a[0];
  } else {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) a[j] = a[2 * j] + a[2 * j + 1];
    if constexpr ((N & 1) != 0) a[N / 2] = a[N - 1];
    return tree_sum_n<N / 2 + (N & 1)>(a);
  }
}

// The same sum, streamed one term at a time for a run-time count: a
// binary counter of partial sums (level l holds a sum of 2^l terms), which
// builds exactly the tree of _tree_sum when the levels are folded from
// the lowest up at the end. Every index is compile-time: registers only.
template <typename T>
struct TreeAcc {
  static constexpr int kLevels = 7;  // up to 127 terms: every dot of a block up to 128
  T st[kLevels];
  int n = 0;
  __device__ __forceinline__ void push(T p) {
    T carry = p;
    bool placed = false;
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      if (!placed) {
        if ((n >> l) & 1) {
          carry = st[l] + carry;
        } else {
          st[l] = carry;
          placed = true;
        }
      }
    }
    ++n;
  }
  __device__ __forceinline__ T total() const {
    T acc = T(0);
    bool have = false;
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      if ((n >> l) & 1) {
        acc = have ? st[l] + acc : st[l];
        have = true;
      }
    }
    return acc;
  }
};

// The same sum of term(0), ..., term(n - 1) for a run-time count n <= 127,
// eight terms at a time: each run of eight consecutive terms is a perfect
// tree, pushed into a counter whose level l holds 8 * 2^l terms, and the
// r = n % 8 terms left over are folded as TreeAcc folds its lowest levels
// (the tree of 4, then of 2, then the last term), below the runs. So the
// tree is TreeAcc's, and the products of a run are independent.
template <typename T, typename F>
__device__ __forceinline__ T tree_dot(int n, F&& term) {
  TreeAcc<T> runs;
  int j = 0;
  for (; j + 8 <= n; j += 8) {
    T a[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = term(j + u);
    runs.push(tree_sum_n<8>(a));
  }
  const int r = n - j;
  T a[7];
#pragma unroll
  for (int u = 0; u < 7; ++u) {
    a[u] = T(0);
    if (u < r) a[u] = term(j + u);
  }
  T acc = T(0);
  switch (r) {
    case 1: acc = a[0]; break;
    case 2: acc = a[0] + a[1]; break;
    case 3: acc = (a[0] + a[1]) + a[2]; break;
    case 4: acc = (a[0] + a[1]) + (a[2] + a[3]); break;
    case 5: acc = ((a[0] + a[1]) + (a[2] + a[3])) + a[4]; break;
    case 6: acc = ((a[0] + a[1]) + (a[2] + a[3])) + (a[4] + a[5]); break;
    case 7: acc = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + a[6]); break;
    default: break;
  }
  bool have = r > 0;
#pragma unroll
  for (int l = 0; l < TreeAcc<T>::kLevels; ++l) {
    if ((runs.n >> l) & 1) {
      acc = have ? runs.st[l] + acc : runs.st[l];
      have = true;
    }
  }
  return acc;
}

// Offset of row k in a packed lower triangle.
__host__ __device__ constexpr int tri(int k) { return k * (k + 1) / 2; }

// One element from device memory into shared memory, asynchronously
// (cp.async); cp.async.wait_all then waits for all of this thread's.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(sizeof(T)));
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// f(Int<B>{}), ..., f(Int<E-1>{}): a loop whose index is a constant.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(Int<B>{});
    static_for<B + 1, E>(f);
  }
}

// ---------------------------------------------------------------------------
// the (L L^T)-solves of apply_down and apply_up
// ---------------------------------------------------------------------------

// x <- sc (L L^T)^{-1} (sc x) for a compile-time size N, x in registers:
// the forward then the backward substitution, each dot a tree sum in
// _tree_sum's order, IEEE division by the diagonal (the reference's
// _blk_solve_lanes). L(k, j) and sc(k) read the factor wherever it lies:
// apply_down's interior blocks in device memory, apply_up's reduced block
// in shared memory.
template <int N, typename T, typename FL, typename FS>
__device__ __forceinline__ void blk_solve_n(T (&x)[N], FL&& L, FS&& sc) {
  static_for<0, N>([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    T v = x[k] * sc(k);
    if constexpr (k > 0) {
      T terms[k];
#pragma unroll
      for (int j = 0; j < k; ++j) terms[j] = x[j] * L(k, j);
      v = v - tree_sum_n<k>(terms);
    }
    x[k] = v / L(k, k);
  });
  static_for<0, N>([&](auto kc) {
    constexpr int k = N - 1 - decltype(kc)::value;
    T v = x[k];
    if constexpr (k < N - 1) {
      T terms[N - 1 - k];
#pragma unroll
      for (int j = k + 1; j < N; ++j) terms[j - k - 1] = x[j] * L(j, k);
      v = v - tree_sum_n<N - 1 - k>(terms);
    }
    x[k] = v / L(k, k);
  });
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = x[k] * sc(k);
}

// The same for a run-time size n <= 128, x in shared memory at x[k * 32],
// L(k, j) at L[(k n + j) ld] and sc(k) at sc[k ld] (one lane of a
// batch-last block in device memory); the solution is also written to
// out[k ld] in the loop that scales it, as both callers need it there.
// Each dot streams through TreeAcc, so every sum is the same tree.
template <typename T>
__device__ __forceinline__ void blk_solve_rt(T* x, int n, const T* __restrict__ L,
                                             const T* __restrict__ sc, T* __restrict__ out,
                                             int ld) {
  for (int k = 0; k < n; ++k) {
    T v = x[k * kWarp] * sc[(size_t)k * ld];
    if (k) {
      TreeAcc<T> acc;
      for (int j = 0; j < k; ++j) acc.push(x[j * kWarp] * L[(size_t)(k * n + j) * ld]);
      v = v - acc.total();
    }
    x[k * kWarp] = v / L[(size_t)(k * n + k) * ld];
  }
  for (int k = n - 1; k >= 0; --k) {
    T v = x[k * kWarp];
    if (k < n - 1) {
      TreeAcc<T> acc;
      for (int j = k + 1; j < n; ++j) acc.push(x[j * kWarp] * L[(size_t)(j * n + k) * ld]);
      v = v - acc.total();
    }
    x[k * kWarp] = v / L[(size_t)(k * n + k) * ld];
  }
  for (int k = 0; k < n; ++k) {
    x[k * kWarp] = x[k * kWarp] * sc[(size_t)k * ld];
    out[(size_t)k * ld] = x[k * kWarp];
  }
}

// ---------------------------------------------------------------------------
// factor: one warp per lane, TL lanes per CTA
// ---------------------------------------------------------------------------

// Lanes per CTA: one 32-byte sector of each element (8 float, 4 double).
// Where that tile would not fit in shared memory (wide blocks) the launcher
// takes the wide body below, one lane per CTA.
template <typename T>
__host__ __device__ constexpr int tile_lanes() { return 32 / (int)sizeof(T); }

// Per-lane shared-memory layout of the factor, in elements. Rows of the
// matrices a worker walks by row (the Cholesky's) are padded to an odd
// length so that 32 workers reading 32 rows hit 32 banks. The same count
// is cuda_kkt.factor_lane_bytes.
struct FactorLayout {
  int ldi, ldr, a, sc, x, s, scr, slot, lane_elems;
  __host__ __device__ FactorLayout(int ni, int nr) {
    ldi = ni + 1;
    ldr = nr + 1;
    a = 0;                 // K_ii[b], factored in place into L_i[b]
    sc = a + ni * ldi;     // sc_i[b]
    x = sc + ni;           // K_ir[b] -> t = L^{-1} sc K_ir -> X_ir[b]
    s = x + ni * nr;       // S, then factored in place into L_r
    scr = s + nr * ldr;    // sc_r
    slot = scr + nr;       // the current pivot, shared by the warp
    lane_elems = slot + 4;
  }
};

// Visit the (rows x cols) elements of a CTA's tl lanes (32 tl threads):
// thread t takes lane t % tl, so neighbouring threads touch neighbouring
// lanes of one element (one coalesced sector), and element t / tl + 32 k.
template <typename F>
__device__ __forceinline__ void for_tile(int tl, int rows, int cols, F&& f) {
  const int l = threadIdx.x % tl;
  int e = threadIdx.x / tl;
  int r = e / cols, c = e % cols;
  const int n = rows * cols;
  for (; e < n; e += kWarp) {
    f(l, e, r, c);
    c += kWarp;
    while (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// One lane's (rows x cols) matrix from device memory into shared memory,
// read by its own warp: the retry ladder's rare path.
template <typename T>
__device__ void reload_lane(T* dst, int ld, const T* g, int rows, int cols, int lane, int Bp,
                            int w) {
  for (int e = w; e < rows * cols; e += kWarp)
    dst[(e / cols) * ld + e % cols] = g[(size_t)e * Bp + lane];
  __syncwarp();
}

// Left-looking Cholesky of (A + d I) with Jacobi equilibration, in place
// (A (NI, NI) with row stride NI+1 becomes L; the strict upper part is
// written as the reference computes it). Worker w owns rows w + 32 q (one
// row up to NI = 32, two up to 64), each row's entry held in registers
// across the pivot's sync; column k's pivot passes through `slot`. Returns
// the pivot extrema over rows < n_real (the same in every worker).
template <int NI, typename T>
__device__ void chol_interior(T* A, T* sc, T* slot, int n_real, T d, int w, T& dmin, T& dmax) {
  constexpr int ld = NI + 1;
  constexpr int Q = (NI + kWarp - 1) / kWarp;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = w + kWarp * q;
    if (i < NI) sc[i] = T(1) / sqrt(nan_max(A[i * ld + i] + d, T(1e-30)));
  }
  __syncwarp();
  dmin = inf_val<T>();
  dmax = -inf_val<T>();
  static_for<0, NI>([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    T vi[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = w + kWarp * q;
      vi[q] = T(0);
      if (i < NI) {
        vi[q] = (A[i * ld + k] + (i == k ? T(1) : T(0)) * d) * sc[i] * sc[k];
        if constexpr (k > 0) {
          T terms[k];
#pragma unroll
          for (int j = 0; j < k; ++j) terms[j] = A[i * ld + j] * A[k * ld + j];
          vi[q] = vi[q] - tree_sum_n<k>(terms);
        }
        if (i == k) *slot = vi[q];
      }
    }
    __syncwarp();
    const T dk = sqrt(*slot);
    if (k < n_real) {
      dmin = nan_min(dmin, dk);
      dmax = nan_max(dmax, dk);
    }
    const T inv = T(1) / dk;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = w + kWarp * q;
      if (i < NI) A[i * ld + k] = vi[q] * inv * (i > k ? T(1) : T(0)) + (i == k ? T(1) : T(0)) * dk;
    }
    __syncwarp();
  });
}

// Column k's entry of row i in chol_rt before its pivot: the shifted,
// scaled entry less its dot over the columns before k (through TreeAcc).
template <typename T>
__device__ __forceinline__ T chol_entry(const T* A, int ld, int i, int k, T d, const T* sc) {
  T vi = (A[i * ld + k] + (i == k ? T(1) : T(0)) * d) * sc[i] * sc[k];
  if (k) {
    TreeAcc<T> acc;
    for (int j = 0; j < k; ++j) acc.push(A[i * ld + j] * A[k * ld + j]);
    vi = vi - acc.total();
  }
  return vi;
}

// chol_rt's columns. Q = 2: worker w holds its rows w and w + 32 in
// registers across each pivot's sync (nn <= 64). Q = 0: worker w owns rows
// w + 32 q, any number of them, and a row's unscaled entry waits in its own
// place A[i][k] for the pivot (column k's dots read only columns < k).
template <typename T, int Q>
__device__ __forceinline__ void chol_rt_cols(T* A, int ld, int nn, int n_real, T d, const T* sc,
                                             T* slot, int w, T& dmin, T& dmax) {
  for (int k = 0; k < nn; ++k) {
    T v[Q > 0 ? Q : 1];
    if constexpr (Q > 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int i = w + kWarp * q;
        v[q] = T(0);
        if (i < nn) {
          v[q] = chol_entry(A, ld, i, k, d, sc);
          if (i == k) *slot = v[q];
        }
      }
    } else {
      for (int i = w; i < nn; i += kWarp) {
        const T vi = chol_entry(A, ld, i, k, d, sc);
        A[i * ld + k] = vi;
        if (i == k) *slot = vi;
      }
    }
    __syncwarp();
    const T dk = sqrt(*slot);
    if (k < n_real) {
      dmin = nan_min(dmin, dk);
      dmax = nan_max(dmax, dk);
    }
    const T inv = T(1) / dk;
    if constexpr (Q > 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int i = w + kWarp * q;
        if (i < nn) A[i * ld + k] = v[q] * inv * (i > k ? T(1) : T(0)) + (i == k ? T(1) : T(0)) * dk;
      }
    } else {
      for (int i = w; i < nn; i += kWarp)
        A[i * ld + k] = A[i * ld + k] * inv * (i > k ? T(1) : T(0)) + (i == k ? T(1) : T(0)) * dk;
    }
    __syncwarp();
  }
}

// Blocks wider than 64 take chol_rt_cols<T, 0> through a call of its own,
// so that its registers do not weigh on the kernels' other paths.
template <typename T>
__device__ __noinline__ void chol_rt_wide(T* A, int ld, int nn, int n_real, T d, const T* sc,
                                          T* slot, int w, T& dmin, T& dmax) {
  chol_rt_cols<T, 0>(A, ld, nn, n_real, d, sc, slot, w, dmin, dmax);
}

// The same for a run-time size nn <= 128 (the reduced block, and interiors
// of a size the kernel is not built for); the column dots stream through
// TreeAcc. Up to 64 rows, two a worker in registers; above, a loop over
// rows in shared memory.
template <typename T>
__device__ void chol_rt(T* A, int ld, int nn, int n_real, T d, T* sc, T* slot, int w, T& dmin,
                        T& dmax) {
  for (int i = w; i < nn; i += kWarp) sc[i] = T(1) / sqrt(nan_max(A[i * ld + i] + d, T(1e-30)));
  __syncwarp();
  dmin = inf_val<T>();
  dmax = -inf_val<T>();
  if (nn <= 2 * kWarp)
    chol_rt_cols<T, 2>(A, ld, nn, n_real, d, sc, slot, w, dmin, dmax);
  else
    chol_rt_wide<T>(A, ld, nn, n_real, d, sc, slot, w, dmin, dmax);
}

// Column c of t = L^{-1} (sc K_ir), in place in X (ni, nr); L with row
// stride ld. A built NI keeps the column in registers; NI = 0 takes any
// ni up to 64 at run time, the column in shared memory.
template <int NI, typename T>
__device__ void fwd_col(const T* L, int ld, const T* sc, T* X, int ni, int nr, int c) {
  if constexpr (NI > 0) {
    T t[NI];
    static_for<0, NI>([&](auto kc) {
      constexpr int k = decltype(kc)::value;
      T v = X[k * nr + c] * sc[k];
      if constexpr (k > 0) {
        T terms[k];
#pragma unroll
        for (int j = 0; j < k; ++j) terms[j] = t[j] * L[k * ld + j];
        v = v - tree_sum_n<k>(terms);
      }
      t[k] = v / L[k * ld + k];
    });
#pragma unroll
    for (int k = 0; k < NI; ++k) X[k * nr + c] = t[k];
  } else {
    for (int k = 0; k < ni; ++k) {
      T v = X[k * nr + c] * sc[k];
      if (k) v = v - tree_dot<T>(k, [&](int j) { return X[j * nr + c] * L[k * ld + j]; });
      X[k * nr + c] = v / L[k * ld + k];
    }
  }
}

// t = L^{-1} (sc K_ir), column by column (worker w owns columns w + 32 q),
// in place over X (NI, nr).
template <int NI, typename T>
__device__ void fwd_sub_cols(const T* L, const T* sc, T* X, int nr, int w) {
  for (int c = w; c < nr; c += kWarp) fwd_col<NI>(L, NI + 1, sc, X, NI, nr, c);
}

// S -= t^T t in Gram form: worker w owns columns w + 32 q of S, each entry
// a tree sum over the NI rows of t.
template <int NI, typename T>
__device__ void gram_update(const T* X, T* S, int nr, int lds, int w) {
  for (int c = w; c < nr; c += kWarp) {
    T tc[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) tc[i] = X[i * nr + c];
    for (int r = 0; r < nr; ++r) {
      T terms[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) terms[i] = tc[i] * X[i * nr + r];
      S[r * lds + c] = S[r * lds + c] - tree_sum_n<NI>(terms);
    }
  }
}

// X = sc * L^{-T} t (bottom row first), = K_ii^{-1} K_ir, in place.
template <int NI, typename T>
__device__ void bwd_sub_cols(const T* L, const T* sc, T* X, int nr, int w) {
  constexpr int ld = NI + 1;
  for (int c = w; c < nr; c += kWarp) {
    T x[NI];
#pragma unroll
    for (int k = 0; k < NI; ++k) x[k] = X[k * nr + c];
    static_for<0, NI>([&](auto kc) {
      constexpr int k = NI - 1 - decltype(kc)::value;
      T v = x[k];
      if constexpr (k < NI - 1) {
        T terms[NI - 1 - k];
#pragma unroll
        for (int j = k + 1; j < NI; ++j) terms[j - k - 1] = x[j] * L[j * ld + k];
        v = v - tree_sum_n<NI - 1 - k>(terms);
      }
      x[k] = v / L[k * ld + k];
    });
#pragma unroll
    for (int k = 0; k < NI; ++k) X[k * nr + c] = x[k] * sc[k];
  }
}

// The three column sweeps above for a run-time interior size ni <= 64 (L
// with row stride ld), in place in shared memory: each dot streams through
// TreeAcc, so every sum is the same tree.
template <typename T>
__device__ void fwd_sub_cols_rt(const T* L, int ld, const T* sc, T* X, int ni, int nr, int w) {
  for (int c = w; c < nr; c += kWarp)
    for (int k = 0; k < ni; ++k) {
      T v = X[k * nr + c] * sc[k];
      if (k) {
        TreeAcc<T> acc;
        for (int j = 0; j < k; ++j) acc.push(X[j * nr + c] * L[k * ld + j]);
        v = v - acc.total();
      }
      X[k * nr + c] = v / L[k * ld + k];
    }
}

template <typename T>
__device__ void gram_update_rt(const T* X, T* S, int ni, int nr, int lds, int w) {
  for (int c = w; c < nr; c += kWarp)
    for (int r = 0; r < nr; ++r) {
      TreeAcc<T> acc;
      for (int i = 0; i < ni; ++i) acc.push(X[i * nr + c] * X[i * nr + r]);
      S[r * lds + c] = S[r * lds + c] - acc.total();
    }
}

template <typename T>
__device__ void bwd_sub_cols_rt(const T* L, int ld, const T* sc, T* X, int ni, int nr, int w) {
  for (int c = w; c < nr; c += kWarp) {
    for (int k = ni - 1; k >= 0; --k) {
      T v = X[k * nr + c];
      if (k < ni - 1) {
        TreeAcc<T> acc;
        for (int j = k + 1; j < ni; ++j) acc.push(X[j * nr + c] * L[j * ld + k]);
        v = v - acc.total();
      }
      X[k * nr + c] = v / L[k * ld + k];
    }
    for (int k = 0; k < ni; ++k) X[k * nr + c] = X[k * nr + c] * sc[k];
  }
}

// Replaces _factor_kernel (pallas_kkt.py:160).
//
// Bound: bytes. At the LQR bench shapes (float32, nb=10, ni_p=16,
// nr_p=32) it must read and write 70,464 bytes per lane, 1.15 GB at
// B=16384, 0.344 ms at 3.35 TB/s, against about 0.6 MFLOP per lane
// (0.15 ms at 67 TFLOP/s).
//
// Design: one warp per lane and TL lanes per CTA (8 float, 4 double, fewer
// where that tile does not fit in shared memory). Per interval block the
// CTA loads the TL lanes' K_ii[b] and K_ir[b] into shared memory in
// 32-byte coalesced sectors (one element of all TL lanes), each warp
// factors its lane there and writes L_i, sc_i and X_ir back the same way:
// every input is read once and every output written once, and nothing of
// the O(n^3) work touches device memory. Inside a warp the work splits
// over independent entries: the Cholesky by rows, t = L^{-1} sc K_ir and
// its back-solve by columns, the Gram update by columns of S. S stays in
// shared memory across the blocks, and block b's t^T t is subtracted
// before block b+1's, as in the reference. The interior size NI is a
// template parameter for the built sizes (8, 16, 24, 32), so every
// per-thread array is indexed at compile time and stays in registers;
// NI = 0 takes any other interior size up to 64 at run time, with the
// sweeps in shared memory (the *_rt functions). Retries reload the block's
// input for that lane alone (the factorization is in place). The reduced
// block (run-time nr_p <= 128) is factored at the end from S; when retries
// are allowed S is first saved to s_scr. Wide blocks leave room for fewer
// lanes than a full tile (at (ni_p 40, nr_p 128) a float lane takes 93,776
// bytes and a double lane 187,552): there factor_kernel_wide runs instead.
// At (64, 128) a double lane takes 232,480 bytes, 32 more than a CTA may
// hold, and the launcher refuses that shape.
// Several CTAs per SM overlap one CTA's loads with another's compute:
// the launch bound asks for 3 (the float tile takes 60.5 KB of shared
// memory at the bench shapes, and ptxas then fits 80 registers with a few
// spills), which measured 6% faster than 2 CTAs at 128 registers.
template <typename T, int NI>
__global__ void __launch_bounds__(kWarp * tile_lanes<T>(), 3)
factor_kernel(const T* __restrict__ kii, const T* __restrict__ kir, const T* __restrict__ krr,
              const T* __restrict__ delta, T* __restrict__ li, T* __restrict__ sci,
              T* __restrict__ xir, T* __restrict__ lr, T* __restrict__ scr, T* __restrict__ piv,
              T* __restrict__ dblk, T* __restrict__ s_scr, int nb, int ni_rt, int nr,
              int ni_real, int nr_real, int Bp, T rtol, T floor_d, int attempts) {
  const int ni = NI > 0 ? NI : ni_rt;
  const int TL = blockDim.x / kWarp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const FactorLayout lay(ni, nr);
  const int LE = lay.lane_elems;
  const int w = threadIdx.x % kWarp, tl = threadIdx.x / kWarp;
  const int lane0 = blockIdx.x * TL, lane = lane0 + tl;
  const bool active = lane < Bp;
  T* my = smem + tl * LE;
  T* A = my + lay.a;
  T* sc = my + lay.sc;
  T* X = my + lay.x;
  T* S = my + lay.s;
  T* scR = my + lay.scr;
  T* slot = my + lay.slot;
  // the interior Cholesky of A + d I, in place
  auto chol = [&](T d, T& dmin, T& dmax) {
    if constexpr (NI > 0)
      chol_interior<NI>(A, sc, slot, ni_real, d, w, dmin, dmax);
    else
      chol_rt(A, lay.ldi, ni, ni_real, d, sc, slot, w, dmin, dmax);
  };

  // S = K_rr + base_d I, accumulated below in Gram form
  for_tile(TL, nr, nr, [&](int l, int e, int r, int c) {
    const int ln = lane0 + l;
    if (ln < Bp)
      smem[l * LE + lay.s + r * lay.ldr + c] =
          krr[(size_t)e * Bp + ln] + (r == c ? T(1) : T(0)) * delta[ln];
  });

  const T base_d = active ? delta[lane] : T(0);
  T piv_min = inf_val<T>(), piv_max = -inf_val<T>();
  T d_up = base_d;
  T ok_all = T(1);
  for (int b = 0; b < nb; ++b) {
    const T* kii_b = kii + (size_t)b * ni * ni * Bp;
    const T* kir_b = kir + (size_t)b * ni * nr * Bp;
    __syncthreads();  // the previous block's outputs have left shared memory
    for_tile(TL, ni, ni, [&](int l, int e, int r, int c) {
      if (lane0 + l < Bp) smem[l * LE + lay.a + r * lay.ldi + c] = kii_b[(size_t)e * Bp + lane0 + l];
    });
    for_tile(TL, ni, nr, [&](int l, int e, int r, int c) {
      if (lane0 + l < Bp) smem[l * LE + lay.x + e] = kir_b[(size_t)e * Bp + lane0 + l];
    });
    __syncthreads();
    if (active) {
      T dmin, dmax;
      chol(base_d, dmin, dmax);
      T d = base_d;
      for (int a = 0; a < attempts - 1; ++a) {
        if (!passes(dmin, dmax, rtol)) {
          d = d < floor_d ? floor_d : d * T(10);
          reload_lane(A, lay.ldi, kii_b, ni, ni, lane, Bp, w);
          chol(d, dmin, dmax);
        }
      }
      // block-local acceptance: each block judged at its own final delta
      ok_all = ok_all * (passes(dmin, dmax, rtol) ? T(1) : T(0));
      if (w == 0) dblk[(size_t)b * Bp + lane] = d;
      if constexpr (NI > 0) fwd_sub_cols<NI>(A, sc, X, nr, w);
      else fwd_sub_cols_rt(A, lay.ldi, sc, X, ni, nr, w);
      __syncwarp();
      if constexpr (NI > 0) gram_update<NI>(X, S, nr, lay.ldr, w);
      else gram_update_rt(X, S, ni, nr, lay.ldr, w);
      __syncwarp();  // every column of t is read before X overwrites it
      if constexpr (NI > 0) bwd_sub_cols<NI>(A, sc, X, nr, w);
      else bwd_sub_cols_rt(A, lay.ldi, sc, X, ni, nr, w);
      piv_min = nan_min(piv_min, dmin);
      piv_max = nan_max(piv_max, dmax);
      d_up = nan_max(d_up, d);
    }
    __syncthreads();
    T* li_b = li + (size_t)b * ni * ni * Bp;
    T* sci_b = sci + (size_t)b * ni * Bp;
    T* xir_b = xir + (size_t)b * ni * nr * Bp;
    for_tile(TL, ni, ni, [&](int l, int e, int r, int c) {
      if (lane0 + l < Bp) li_b[(size_t)e * Bp + lane0 + l] = smem[l * LE + lay.a + r * lay.ldi + c];
    });
    for_tile(TL, 1, ni, [&](int l, int e, int r, int c) {
      if (lane0 + l < Bp) sci_b[(size_t)e * Bp + lane0 + l] = smem[l * LE + lay.sc + e];
    });
    for_tile(TL, ni, nr, [&](int l, int e, int r, int c) {
      if (lane0 + l < Bp) xir_b[(size_t)e * Bp + lane0 + l] = smem[l * LE + lay.x + e];
    });
  }

  // reduced block: the base delta is already in S; retries add extra and
  // refactor from the saved S
  __syncthreads();
  if (attempts > 1) {
    for_tile(TL, nr, nr, [&](int l, int e, int r, int c) {
      if (lane0 + l < Bp) s_scr[(size_t)e * Bp + lane0 + l] = smem[l * LE + lay.s + r * lay.ldr + c];
    });
    __syncthreads();
  }
  if (active) {
    T dmin, dmax;
    chol_rt(S, lay.ldr, nr, nr_real, T(0), scR, slot, w, dmin, dmax);
    T d = T(0);
    for (int a = 0; a < attempts - 1; ++a) {
      if (!passes(dmin, dmax, rtol)) {
        d = d < floor_d ? floor_d : d * T(10);
        reload_lane(S, lay.ldr, s_scr, nr, nr, lane, Bp, w);
        chol_rt(S, lay.ldr, nr, nr_real, d, scR, slot, w, dmin, dmax);
      }
    }
    if (w == 0) {
      const bool ok_r = passes(dmin, dmax, rtol);
      dblk[(size_t)nb * Bp + lane] = base_d + d;
      const T pmin = nan_min(piv_min, dmin);
      const T pmax = nan_max(piv_max, dmax);
      const bool finite = isfinite(pmin) && isfinite(pmax);
      piv[lane] = finite ? pmin : T(NAN);
      piv[(size_t)Bp + lane] = finite ? pmax : T(NAN);
      piv[(size_t)2 * Bp + lane] = nan_max(d_up, base_d + d);
      piv[(size_t)3 * Bp + lane] = ok_all * (ok_r ? T(1) : T(0));
    }
  }
  __syncthreads();
  for_tile(TL, nr, nr, [&](int l, int e, int r, int c) {
    if (lane0 + l < Bp) lr[(size_t)e * Bp + lane0 + l] = smem[l * LE + lay.s + r * lay.ldr + c];
  });
  for_tile(TL, 1, nr, [&](int l, int e, int r, int c) {
    if (lane0 + l < Bp) scr[(size_t)e * Bp + lane0 + l] = smem[l * LE + lay.scr + e];
  });
}

// ---------------------------------------------------------------------------
// factor, wide body: one lane per CTA of kWideWarps warps
// ---------------------------------------------------------------------------

constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWarp * kWideWarps;
constexpr int kTeam0 = kWideThreads - kWarp;  // the interior Cholesky's warp; the threads below work
constexpr int kGramRun = 8;  // Gram units a warp takes from the counter at a time
constexpr int kBarWork = 1;  // the working threads' named barrier

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory layout of the wide body, in elements. Pipelined (where it
// fits): three buffers of K_ii[b] (rows padded to ni + 1, factored in place
// into L_i[b]) and of sc_i[b], two of K_ir[b] (-> t -> X_ir[b]), so that
// block b + 1's factor and block b + 2's loads go on while block b is
// solved; else one of each. Then S's lower triangle, packed (row r at
// tri(r)), factored in place into L_r; sc_r; the pivot slot and the Gram
// update's unit counter. The same count is cuda_kkt.factor_lane_bytes for a
// shape that takes this body.
struct WideLayout {
  int ldi, na, nx, a, x, sc, s, scr, slot, elems;
  __host__ __device__ WideLayout(int ni, int nr, bool pipe) {
    ldi = ni + 1;
    na = pipe ? 3 : 1;
    nx = pipe ? 2 : 1;
    a = 0;
    x = na * ni * ldi;
    sc = x + nx * ni * nr;
    s = sc + na * ni;
    scr = s + tri(nr);
    slot = scr + nr;
    elems = slot + 4;
  }
};

// Column c of X_ir = sc L^{-T} t (bottom row first), each entry, scaled,
// written to out[(k nr + c) ld_out] (one lane in device memory) as soon as
// it is final. A built NI leaves t in X as it is, so that the Gram update
// may read it meanwhile; NI = 0 solves in place in X.
template <int NI, typename T>
__device__ void bwd_col(const T* L, int ld, const T* sc, T* X, int ni, int nr, int c, T* out,
                        int ld_out) {
  if constexpr (NI > 0) {
    T x[NI];
#pragma unroll
    for (int k = 0; k < NI; ++k) x[k] = X[k * nr + c];
    static_for<0, NI>([&](auto kc) {
      constexpr int k = NI - 1 - decltype(kc)::value;
      T v = x[k];
      if constexpr (k < NI - 1) {
        T terms[NI - 1 - k];
#pragma unroll
        for (int j = k + 1; j < NI; ++j) terms[j - k - 1] = x[j] * L[j * ld + k];
        v = v - tree_sum_n<NI - 1 - k>(terms);
      }
      x[k] = v / L[k * ld + k];
      out[(size_t)(k * nr + c) * ld_out] = x[k] * sc[k];
    });
  } else {
    for (int k = ni - 1; k >= 0; --k) {
      T v = X[k * nr + c];
      if (k < ni - 1)
        v = v - tree_dot<T>(ni - 1 - k, [&](int j) {
              return X[(k + 1 + j) * nr + c] * L[(k + 1 + j) * ld + k];
            });
      X[k * nr + c] = v / L[k * ld + k];
      out[(size_t)(k * nr + c) * ld_out] = X[k * nr + c] * sc[k];
    }
  }
}

// The tree sum over the NI rows of t of tc[i] t[i][r] (NI a multiple of 8):
// runs of eight rows, then the tree of the runs, which is tree_sum_n<NI>'s
// order; at most eight products live at a time.
template <int NI, typename T>
__device__ __forceinline__ T gram_entry(const T (&tc)[NI], const T* X, int nr, int r) {
  static_assert(NI % 8 == 0, "gram_entry: NI a multiple of 8");
  T run[NI / 8];
#pragma unroll
  for (int q = 0; q < NI / 8; ++q) {
    T a[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = tc[8 * q + u] * X[(8 * q + u) * nr + r];
    run[q] = tree_sum_n<8>(a);
  }
  return tree_sum_n<NI / 8>(run);
}

// S -= t^T t on S's lower triangle (packed, row r at tri(r)), each entry
// r >= c a tree sum over the ni rows of t. The entries fall into units: a
// row r and the 32 columns c = 32 ct + l of a column tile ct <= r / 32.
// Warps take kGramRun units at a time from the counter *next (zero at the
// start), in order, so a warp that comes late takes less; lane l keeps
// column c of t in registers (a built NI) while its tile stays the same,
// and reads row r's entries as broadcasts.
template <int NI, typename T>
__device__ void gram_lower(const T* X, T* S, int ni, int nr, int* next, int l) {
  const int tiles = (nr + kWarp - 1) / kWarp;
  int units = 0;
  for (int ct = 0; ct < tiles; ++ct) units += nr - kWarp * ct;
  T tc[NI > 0 ? NI : 1];
  int loaded = -1;
  for (;;) {
    int u = 0;
    if (l == 0) u = atomicAdd(next, kGramRun);
    u = __shfl_sync(0xffffffffu, u, 0);
    if (u >= units) break;
    int ct = 0, r = u;
    while (r >= nr - kWarp * ct) {
      r -= nr - kWarp * ct;
      ++ct;
    }
    r += kWarp * ct;
    for (const int end = min(u + kGramRun, units); u < end; ++u) {
      const int c = kWarp * ct + l;
      const int cc = c < nr ? c : nr - 1;  // in bounds; the entry is dropped
      T g;
      if constexpr (NI > 0) {
        if (ct != loaded) {
#pragma unroll
          for (int i = 0; i < NI; ++i) tc[i] = X[i * nr + cc];
          loaded = ct;
        }
        g = gram_entry<NI>(tc, X, nr, r);
      } else {
        g = tree_dot<T>(ni, [&](int i) { return X[i * nr + cc] * X[i * nr + r]; });
      }
      if (c <= r) S[tri(r) + c] = S[tri(r) + c] - g;
      if (++r == nr) r = kWarp * ++ct;
    }
  }
}

// The reduced block's Cholesky in the wide body: S's lower triangle
// (packed), shifted by d and equilibrated, factored in place across the
// CTA, thread i owning row i (nn <= kWideThreads). Column k computes only
// its rows i >= k, its pivot passing through `slot`; two __syncthreads a
// column. Every thread calls it; each returns the pivot extrema over rows
// < n_real.
template <typename T>
__device__ void chol_packed(T* S, int nn, int n_real, T d, T* sc, T* slot, int t, T& dmin,
                            T& dmax) {
  if (t < nn) sc[t] = T(1) / sqrt(nan_max(S[tri(t) + t] + d, T(1e-30)));
  __syncthreads();
  dmin = inf_val<T>();
  dmax = -inf_val<T>();
  T* Si = S + tri(t < nn ? t : 0);
  for (int k = 0; k < nn; ++k) {
    const bool row = t >= k && t < nn;
    T v = T(0);
    if (row) {
      const T* Sk = S + tri(k);
      v = (Si[k] + (t == k ? T(1) : T(0)) * d) * sc[t] * sc[k];
      if (k) v = v - tree_dot<T>(k, [&](int j) { return Si[j] * Sk[j]; });
      if (t == k) *slot = v;
    }
    __syncthreads();
    const T dk = sqrt(*slot);
    if (k < n_real) {
      dmin = nan_min(dmin, dk);
      dmax = nan_max(dmax, dk);
    }
    const T inv = T(1) / dk;
    if (row) Si[k] = v * inv * (t > k ? T(1) : T(0)) + (t == k ? T(1) : T(0)) * dk;
    __syncthreads();
  }
}

// Replaces _factor_kernel (pallas_kkt.py:160) at wide shapes: wherever a
// full tile of lanes (one 32-byte sector of each element) does not fit in
// shared memory, factor_kernel above gives up its point, and this body runs
// instead (the launcher's choice, factor_launch).
//
// Bound: bytes, and close to operations. At the 40x10 Radau orbit's padded
// shape (nb=40, ni_p=40, nr_p=128) in float64 at B=1024 it must move 4.69
// GB, 1.40 ms at 3.35 TB/s (1.09 ms at the real sizes (40, 37, 126)), and
// do 44 G operations, 60% of them the Gram update of S's lower triangle:
// 0.66 ms at 67 TFLOP/s, 1.3 ms at the scalar float64 rate of 34.
//
// Design: it replaces a lane tile of one warp per lane, which at that shape
// held one lane (187,552 bytes) in a CTA of 32 threads, one warp an SM,
// every dependent chain of the factorization on that one warp (815 ms a
// launch on an H100 80GB HBM3 at 700 W). Here a CTA of kWideWarps warps
// factors one lane, in roles that overlap. The team (the last warp, rows w
// and w + 32 of worker w) factors interior block b + 1 with its retry
// ladder while the seven working warps solve block b: a thread per column
// solves t = L^{-1} sc K_ir, and the other working threads start block
// b + 2's and b + 1's loads (cp.async) and store L_i[b] and sc_i[b]; then
// the column threads solve X_ir = sc L^{-T} t from t into device memory
// while the others start the Gram update of S's lower triangle (8,256
// entries at nr_p = 128), dealt out from a counter in runs of units, which
// the column threads join when they are done. At the built interior sizes
// (24, 32, 40) the Cholesky and the sweeps are compile-time bodies with
// the column in registers, and the Gram update keeps column c of t in
// registers; NI = 0 takes any other size with run-time loops over
// tree_dot in shared memory. (Run-time loops at NI = 40 measured 2-3 times
// slower than the unrolled bodies, and a Cholesky that the other warps
// wait for, 40% of each block.) The reduced block is factored at the end
// across the CTA (chol_packed), from S saved to s_scr when retries are
// allowed. Every sum is the reference's tree. L_r's strict upper part is
// not computed: the plain version writes v / dk * 0 there, which is 0 / dk
// wherever v is finite (every accepted lane of finite input), and that is
// what is written. Where three K_ii and two K_ir buffers do not fit (wide
// interiors in float64), one of each is loaded at the top of each block
// and the team factors it before the others go on. A float64 CTA takes up
// to 255 registers (its shared memory leaves room for one CTA an SM); a
// float32 CTA 128, so that two fit. One lane a CTA reads and writes 8 (or
// 4) bytes of each 32-byte sector, each access a request of its own; that,
// and eight warps to hide every latency, bound it now: 21.6-22.0 ms a
// launch at the orbit's shape in float64 on B=1024 with one attempt (H100
// 80GB HBM3, 700 W), 5% of the real sizes' bound.
template <typename T, int NI>
__global__ void __launch_bounds__(kWideThreads, sizeof(T) == 4 ? 2 : 1)
factor_kernel_wide(const T* __restrict__ kii, const T* __restrict__ kir,
                   const T* __restrict__ krr, const T* __restrict__ delta, T* __restrict__ li,
                   T* __restrict__ sci, T* __restrict__ xir, T* __restrict__ lr,
                   T* __restrict__ scr, T* __restrict__ piv, T* __restrict__ dblk,
                   T* __restrict__ s_scr, int nb, int ni_rt, int nr, int ni_real, int nr_real,
                   int Bp, T rtol, T floor_d, int attempts, int pipe) {
  const int ni = NI > 0 ? NI : ni_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const WideLayout lay(ni, nr, pipe != 0);
  const int t = threadIdx.x, l = t % kWarp;
  const bool team = t >= kTeam0;
  const int ncol = (nr + kWarp - 1) / kWarp * kWarp;  // column warps' threads; then the others'
  const int lane = blockIdx.x;
  T* S = smem + lay.s;
  T* scR = smem + lay.scr;
  T* slot = smem + lay.slot;
  int* next = reinterpret_cast<int*>(slot + 1);
  auto A_of = [&](int b) { return smem + lay.a + (b % lay.na) * ni * lay.ldi; };
  auto sc_of = [&](int b) { return smem + lay.sc + (b % lay.na) * ni; };
  auto X_of = [&](int b) { return smem + lay.x + (b % lay.nx) * ni * nr; };
  // block b's K_ii or K_ir into its buffer, asynchronously, by threads [t0, t0 + nt)
  auto load_kii = [&](int b, int t0, int nt) {
    const T* g = kii + (size_t)b * ni * ni * Bp + lane;
    T* A = A_of(b);
    for (int e = t - t0; e < ni * ni; e += nt)
      copy_async(A + (e / ni) * lay.ldi + e % ni, g + (size_t)e * Bp);
  };
  auto load_kir = [&](int b, int t0, int nt) {
    const T* g = kir + (size_t)b * ni * nr * Bp + lane;
    T* X = X_of(b);
    for (int e = t - t0; e < ni * nr; e += nt) copy_async(X + e, g + (size_t)e * Bp);
  };

  // S = K_rr + base_d I (its lower triangle), accumulated below in Gram form
  const T base_d = delta[lane];
  for (int e = t; e < nr * nr; e += kWideThreads) {
    const int r = e / nr, c = e % nr;
    if (c <= r) S[tri(r) + c] = krr[(size_t)e * Bp + lane] + (r == c ? T(1) : T(0)) * base_d;
  }
  // the team's record of the interior pivots (its first thread writes it out)
  T piv_min = inf_val<T>(), piv_max = -inf_val<T>();
  T d_up = base_d;
  T ok_all = T(1);
  // block b's interior Cholesky with the retry ladder, by the team's warp
  auto chol = [&](int b) {
    T* A = A_of(b);
    T* sc = sc_of(b);
    T dmin, dmax;
    auto attempt = [&](T d) {
      if constexpr (NI > 0)
        chol_interior<NI>(A, sc, slot, ni_real, d, l, dmin, dmax);
      else
        chol_rt(A, lay.ldi, ni, ni_real, d, sc, slot, l, dmin, dmax);
    };
    attempt(base_d);
    T d = base_d;
    for (int a = 0; a < attempts - 1; ++a) {
      if (!passes(dmin, dmax, rtol)) {
        d = d < floor_d ? floor_d : d * T(10);
        reload_lane(A, lay.ldi, kii + (size_t)b * ni * ni * Bp, ni, ni, lane, Bp, l);
        attempt(d);
      }
    }
    // block-local acceptance: each block judged at its own final delta
    ok_all = ok_all * (passes(dmin, dmax, rtol) ? T(1) : T(0));
    piv_min = nan_min(piv_min, dmin);
    piv_max = nan_max(piv_max, dmax);
    d_up = nan_max(d_up, d);
    if (l == 0) dblk[(size_t)b * Bp + lane] = d;
  };

  if (pipe && nb > 0) {
    load_kii(0, 0, kWideThreads);
    load_kir(0, 0, kWideThreads);
    if (nb > 1) load_kii(1, 0, kWideThreads);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (team) chol(0);
  }
  for (int b = 0; b < nb; ++b) {
    if (!pipe) {
      __syncthreads();  // block b - 1 has left the one buffer
      load_kii(b, 0, kWideThreads);
      load_kir(b, 0, kWideThreads);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // block b is factored (pipelined) or loaded; block b - 1 is done
    if (!pipe) {
      if (team) chol(b);
      __syncthreads();
    }
    if (team) {
      if (pipe && b + 1 < nb) chol(b + 1);
      continue;
    }
    T* A = A_of(b);
    T* sc = sc_of(b);
    T* X = X_of(b);
    if (t < ncol) {
      if (t < nr) fwd_col<NI>(A, lay.ldi, sc, X, ni, nr, t);
    } else {
      if (pipe && b + 2 < nb) load_kii(b + 2, ncol, kTeam0 - ncol);
      if (pipe && b + 1 < nb) load_kir(b + 1, ncol, kTeam0 - ncol);
      T* li_b = li + (size_t)b * ni * ni * Bp + lane;
      T* sci_b = sci + (size_t)b * ni * Bp + lane;
      for (int e = t - ncol; e < ni * ni; e += kTeam0 - ncol)
        li_b[(size_t)e * Bp] = A[(e / ni) * lay.ldi + e % ni];
      for (int e = t - ncol; e < ni; e += kTeam0 - ncol) sci_b[(size_t)e * Bp] = sc[e];
      if (t == ncol) *next = 0;
    }
    named_sync(kBarWork, kTeam0);  // t is complete
    T* xir_b = xir + (size_t)b * ni * nr * Bp + lane;
    if constexpr (NI > 0) {
      // the column threads solve X_ir from t first, then join the Gram update
      if (t < nr) bwd_col<NI>(A, lay.ldi, sc, X, ni, nr, t, xir_b, Bp);
      gram_lower<NI>(X, S, ni, nr, next, l);
    } else {
      gram_lower<NI>(X, S, ni, nr, next, l);
      named_sync(kBarWork, kTeam0);  // every entry of t is read before the solve overwrites it
      if (t < nr) bwd_col<NI>(A, lay.ldi, sc, X, ni, nr, t, xir_b, Bp);
    }
  }
  __syncthreads();

  // reduced block: the base delta is already in S; retries add extra and
  // refactor from the saved S (each thread saves and reloads its own entries)
  auto each_lower = [&](auto&& f) {
    for (int e = t; e < nr * nr; e += kWideThreads) {
      const int r = e / nr, c = e % nr;
      if (c <= r) f(e, tri(r) + c);
    }
  };
  if (attempts > 1) each_lower([&](int e, int s) { s_scr[(size_t)e * Bp + lane] = S[s]; });
  T dmin, dmax;
  chol_packed(S, nr, nr_real, T(0), scR, slot, t, dmin, dmax);
  T d = T(0);
  for (int a = 0; a < attempts - 1; ++a) {
    if (!passes(dmin, dmax, rtol)) {
      d = d < floor_d ? floor_d : d * T(10);
      each_lower([&](int e, int s) { S[s] = s_scr[(size_t)e * Bp + lane]; });
      __syncthreads();
      chol_packed(S, nr, nr_real, d, scR, slot, t, dmin, dmax);
    }
  }
  if (t == kTeam0) {
    const bool ok_r = passes(dmin, dmax, rtol);
    dblk[(size_t)nb * Bp + lane] = base_d + d;
    const T pmin = nan_min(piv_min, dmin);
    const T pmax = nan_max(piv_max, dmax);
    const bool finite = isfinite(pmin) && isfinite(pmax);
    piv[lane] = finite ? pmin : T(NAN);
    piv[(size_t)Bp + lane] = finite ? pmax : T(NAN);
    piv[(size_t)2 * Bp + lane] = nan_max(d_up, base_d + d);
    piv[(size_t)3 * Bp + lane] = ok_all * (ok_r ? T(1) : T(0));
  }
  for (int e = t; e < nr * nr; e += kWideThreads) {
    const int r = e / nr, c = e % nr;
    lr[(size_t)e * Bp + lane] = c <= r ? S[tri(r) + c] : T(0) / S[tri(c) + c];
  }
  for (int e = t; e < nr; e += kWideThreads) scr[(size_t)e * Bp + lane] = scR[e];
}

// ---------------------------------------------------------------------------
// apply_down: one thread per (lane, block)
// ---------------------------------------------------------------------------

// Replaces _apply_down_kernel (pallas_kkt.py:385).
//
// Bound: bytes. At the bench shapes it must read L_i (its lower triangle:
// the solves read nothing above the diagonal), sc_i, K_ir, b_i and b_r and
// write x_bi and r_red, 28,096 bytes per lane in float32: 0.46 GB at
// B=16384, 0.137 ms at 3.35 TB/s, for 16 kFLOP per lane.
//
// Design: a CTA owns 32 lanes and bw warps (bw = blockDim.y, up to 16).
// Warp w solves block b = b0 + w of its 32 lanes, so the nb interior
// solves of a lane run in parallel and every load of L_i and K_ir is one
// 128-byte (float) row of 32 lanes: x_bi = sc (L L^T)^{-1} sc b_i with x
// in registers (blk_solve_n, NI a template parameter), then the block's
// partial dots s_b[c] = sum_i K_ir[b,i,c] x_bi[i], each summed in i order,
// into shared memory. After each chunk of bw blocks the CTA applies
// r_red[c] -= s_b[c] in block order, so r_red = b_r - s_0 - s_1 - ... as
// in the reference. NI = 0 takes any other interior size up to 64 at run
// time, with x in shared memory (blk_solve_rt). Reduced blocks wider than
// 64 (r_red's row alone takes up to 32 KB in double) take the warps that
// fit in the opted-in 227 KB instead of the default 48 KB.
template <typename T, int NI>
__global__ void __launch_bounds__(512)
apply_down_kernel(const T* __restrict__ li, const T* __restrict__ sci,
                  const T* __restrict__ kir, const T* __restrict__ bi,
                  const T* __restrict__ br, T* __restrict__ xbi, T* __restrict__ rred,
                  int nb, int ni_rt, int nr, int Bp) {
  const int ni = NI > 0 ? NI : ni_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int l = threadIdx.x, w = threadIdx.y, bw = blockDim.y;
  T* R = reinterpret_cast<T*>(smem_raw);  // r_red   [nr][32]
  T* P = R + nr * kWarp;                  // s_b     [bw][nr][32]
  T* Xs = P + bw * nr * kWarp;            // x (NI = 0 only) [bw][ni][32]
  const int lane = blockIdx.x * kWarp + l;
  const bool active = lane < Bp;
  // thread (l, w) owns r_red[c] for c = w + bw q, from start to end
  if (active)
    for (int c = w; c < nr; c += bw) R[c * kWarp + l] = br[(size_t)c * Bp + lane];
  for (int b0 = 0; b0 < nb; b0 += bw) {
    const int b = b0 + w;
    if constexpr (NI == 0) {
      if (active && b < nb) {
        const T* L = li + (size_t)b * ni * ni * Bp + lane;
        const T* s = sci + (size_t)b * ni * Bp + lane;
        T* x = Xs + w * ni * kWarp + l;  // x[k] at x[k * 32]
        for (int k = 0; k < ni; ++k) x[k * kWarp] = bi[((size_t)b * ni + k) * Bp + lane];
        blk_solve_rt(x, ni, L, s, xbi + (size_t)b * ni * Bp + lane, Bp);
        const T* K = kir + (size_t)b * ni * nr * Bp + lane;
        for (int c = 0; c < nr; ++c) {
          T acc = T(0);
          for (int i = 0; i < ni; ++i) acc = acc + K[((size_t)i * nr + c) * Bp] * x[i * kWarp];
          P[(w * nr + c) * kWarp + l] = acc;
        }
      }
    } else if (active && b < nb) {
      const T* L = li + (size_t)b * NI * NI * Bp + lane;  // L[k][j] at L[(k NI + j) Bp]
      const T* s = sci + (size_t)b * NI * Bp + lane;
      T x[NI];
#pragma unroll
      for (int k = 0; k < NI; ++k) x[k] = bi[((size_t)b * NI + k) * Bp + lane];
      blk_solve_n(x, [&](int k, int j) { return L[(size_t)(k * NI + j) * Bp]; },
                  [&](int k) { return s[(size_t)k * Bp]; });
#pragma unroll
      for (int k = 0; k < NI; ++k) xbi[((size_t)b * NI + k) * Bp + lane] = x[k];
      const T* K = kir + (size_t)b * NI * nr * Bp + lane;
      for (int c = 0; c < nr; ++c) {
        T acc = T(0);
#pragma unroll
        for (int i = 0; i < NI; ++i) acc = acc + K[((size_t)i * nr + c) * Bp] * x[i];
        P[(w * nr + c) * kWarp + l] = acc;
      }
    }
    __syncthreads();
    if (active)
      for (int c = w; c < nr; c += bw) {
        T r = R[c * kWarp + l];
        for (int q = 0; q < bw && b0 + q < nb; ++q) r = r - P[(q * nr + c) * kWarp + l];
        R[c * kWarp + l] = r;
      }
    __syncthreads();
  }
  if (active)
    for (int c = w; c < nr; c += bw) rred[(size_t)c * Bp + lane] = R[c * kWarp + l];
}

// ---------------------------------------------------------------------------
// apply_up: a CTA of 32 lanes, the reduced solve once per lane, the
// interior rows across warps
// ---------------------------------------------------------------------------

// Shared memory of an apply_up CTA, in elements: for a built reduced size
// NR, the packed lower triangle of L_r, sc_r and r_red (then x_r) of its
// 32 lanes; for the run-time body (NR = 0), x_r alone.
__host__ __device__ constexpr int up_smem_elems(int NR, int nr) {
  return NR > 0 ? (tri(NR) + 2 * NR) * kWarp : nr * kWarp;
}

// Replaces _apply_up_kernel (pallas_kkt.py:403).
//
// Bound: bytes. At the bench shapes (float32, nb=10, ni_p=16, nr_p=32) it
// must read L_r (its lower triangle), sc_r, r_red, X_ir and x_bi and
// write x_r and x_i, 24,256 bytes per lane: 0.40 GB at B=16384, 0.119 ms
// at 3.35 TB/s, for 12.5 kFLOP per lane (3 us at 67 TFLOP/s). X_ir is 84%
// of the bytes.
//
// Design: a CTA owns 32 lanes and bw warps (bw = blockDim.y, up to 8), so
// every load and store of one element is one 128-byte (float) row of 32
// lanes. Part 1, the reduced solve x_r = sc_r (L_r L_r^T)^{-1} sc_r r_red,
// runs once per lane in warp 0. For the built reduced sizes NR (8, 16, 24,
// 32) every warp first copies the lanes' lower triangle of L_r, sc_r and
// r_red into shared memory with cp.async (all copies in flight at once,
// 75.8 KB per CTA in float at NR = 32), and warp 0 then runs the dependent
// chain of 2 NR divisions from shared memory with x in registers; NR = 0
// takes any other size up to 128 at run time, reading L_r from device
// memory with x in shared memory. x_r goes to shared memory as [nr][32]
// (conflict-free). Part 2, x_i = x_bi - X_ir x_r, after one
// __syncthreads: the interior rows (b, i) are independent, so they are one
// flat list of nb ni_p rows and warp w takes rows w, w + bw, ...; a thread
// loads its lane's row of X_ir (NR loads in flight, x_r in registers) and
// sums over c in order. The blocks and ni_p only set the row count, so
// every nb >= 1 and every ni_p runs the same body.
// Part 1's chain runs once per CTA while the other warps wait, and its
// unrolled body is what spills. The launch bound asks for 2 float CTAs per
// SM (up to 128 registers): on an H100 that ran 11% faster at the bench
// shapes than 3 CTAs at 80 registers (kernel_ab.py, in turns).
template <typename T, int NR>
__global__ void __launch_bounds__(kWarp * kUpWarps, sizeof(T) == 4 ? 2 : 1)
apply_up_kernel(const T* __restrict__ lr, const T* __restrict__ scr,
                const T* __restrict__ rred, const T* __restrict__ xir,
                const T* __restrict__ xbi, T* __restrict__ xr_out, T* __restrict__ xi,
                long long rows, int nr_rt, int Bp) {
  const int nr = NR > 0 ? NR : nr_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int l = threadIdx.x, w = threadIdx.y, bw = blockDim.y;
  const int lane = blockIdx.x * kWarp + l;
  const bool active = lane < Bp;
  T* xs;  // x_r of the CTA's lanes: x_r[c] at xs[c * 32 + l]
  if constexpr (NR > 0) {
    T* Ls = smem;                  // L_r[k][j] (j <= k) at Ls[(tri(k) + j) * 32 + l]
    T* Ss = Ls + tri(NR) * kWarp;  // sc_r
    xs = Ss + NR * kWarp;          // r_red, then x_r
    if (active) {
      for (int k = 0; k < NR; ++k)
        for (int j = w; j <= k; j += bw)
          copy_async(Ls + (tri(k) + j) * kWarp + l, lr + (size_t)(k * NR + j) * Bp + lane);
      for (int k = w; k < NR; k += bw) {
        copy_async(Ss + k * kWarp + l, scr + (size_t)k * Bp + lane);
        copy_async(xs + k * kWarp + l, rred + (size_t)k * Bp + lane);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (w == 0 && active) {
      T x[NR];
#pragma unroll
      for (int k = 0; k < NR; ++k) x[k] = xs[k * kWarp + l];
      blk_solve_n(x, [&](int k, int j) { return Ls[(tri(k) + j) * kWarp + l]; },
                  [&](int k) { return Ss[k * kWarp + l]; });
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        xs[k * kWarp + l] = x[k];
        xr_out[(size_t)k * Bp + lane] = x[k];
      }
    }
  } else {
    xs = smem;
    if (w == 0 && active) {
      T* x = xs + l;
      for (int k = 0; k < nr; ++k) x[k * kWarp] = rred[(size_t)k * Bp + lane];
      blk_solve_rt(x, nr, lr + lane, scr + lane, xr_out + lane, Bp);
    }
  }
  __syncthreads();
  if (!active) return;
  if constexpr (NR > 0) {
    T xr[NR];
#pragma unroll
    for (int c = 0; c < NR; ++c) xr[c] = xs[c * kWarp + l];
    for (long long r = w; r < rows; r += bw) {
      const T* X = xir + (size_t)r * NR * Bp + lane;
      T v[NR];
#pragma unroll
      for (int c = 0; c < NR; ++c) v[c] = X[(size_t)c * Bp];
      const T b = xbi[(size_t)r * Bp + lane];
      T s = T(0);
#pragma unroll
      for (int c = 0; c < NR; ++c) s = s + v[c] * xr[c];
      xi[(size_t)r * Bp + lane] = b - s;
    }
  } else {
    for (long long r = w; r < rows; r += bw) {
      const T* X = xir + (size_t)r * nr * Bp + lane;
      const T b = xbi[(size_t)r * Bp + lane];
      T s = T(0);
      int c = 0;
      for (; c + 8 <= nr; c += 8) {
        T v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = X[(size_t)(c + u) * Bp];
#pragma unroll
        for (int u = 0; u < 8; ++u) s = s + v[u] * xs[(c + u) * kWarp + l];
      }
      for (; c < nr; ++c) s = s + X[(size_t)c * Bp] * xs[c * kWarp + l];
      xi[(size_t)r * Bp + lane] = b - s;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Run fn(Int<N>{}) for the padded sizes the kernels are built for
// (cuda_kkt.KERNEL_SIZES: the interiors of the factor and apply_down,
// apply_up's reduced block), fn(Int<0>{}) (the run-time size) for any
// other size up to max_n.
template <typename F>
int dispatch_n(int n, int max_n, F&& fn) {
  switch (n) {
    case 8: return fn(Int<8>{});
    case 16: return fn(Int<16>{});
    case 24: return fn(Int<24>{});
    case 32: return fn(Int<32>{});
    default:
      if (n < 1 || n > max_n) return (int)cudaErrorInvalidValue;
      return fn(Int<0>{});
  }
}

// Lanes per factor CTA: tile_lanes, or fewer where that tile does not fit
// in shared memory; 0 if one lane does not.
template <typename T>
int factor_tile(int ni_p, int nr_p) {
  const int lane_bytes = FactorLayout(ni_p, nr_p).lane_elems * (int)sizeof(T);
  const int fit = kSmemMax / lane_bytes;
  return fit < tile_lanes<T>() ? fit : tile_lanes<T>();
}

// Whether the wide body's pipelined layout fits in shared memory.
template <typename T>
bool wide_pipe(int ni_p, int nr_p) {
  return WideLayout(ni_p, nr_p, true).elems * (int)sizeof(T) <= kSmemMax;
}

// The factor's launch at a shape, into fl[4]: the body (0, the lane tile;
// 1, the wide body), warps a CTA, lanes a CTA and the CTA's shared memory
// in bytes (cuda_kkt.factor_launch). The lane tile runs wherever a full
// tile (one 32-byte sector of each element) fits in shared memory; every
// other shape of which one lane fits the lane tile's layout takes the wide
// body. cudaErrorInvalidValue for a shape the factor does not take. The
// launcher launches exactly this.
template <typename T>
int factor_launch(int ni_p, int nr_p, int Bp, int* fl) {
  if (nr_p < 1 || nr_p > kMaxReduced || ni_p < 1 || ni_p > kMaxInterior || Bp < 1)
    return (int)cudaErrorInvalidValue;
  const int TL = factor_tile<T>(ni_p, nr_p);
  if (TL < 1) return (int)cudaErrorInvalidValue;
  const bool wide = TL < tile_lanes<T>();
  fl[0] = wide ? 1 : 0;
  fl[1] = wide ? kWideWarps : TL;
  fl[2] = wide ? 1 : TL;
  fl[3] = (wide ? WideLayout(ni_p, nr_p, wide_pipe<T>(ni_p, nr_p)).elems
                : TL * FactorLayout(ni_p, nr_p).lane_elems) * (int)sizeof(T);
  return (int)cudaSuccess;
}

// Run fn(Int<NI>{}) for the interior sizes the wide body is built for,
// fn(Int<0>{}) (the run-time size) for any other.
template <typename F>
int dispatch_wide(int n, F&& fn) {
  switch (n) {
    case 24: return fn(Int<24>{});
    case 32: return fn(Int<32>{});
    case 40: return fn(Int<40>{});
    default: return fn(Int<0>{});
  }
}

template <typename T>
int launch_factor(const T* kii, const T* kir, const T* krr, const T* delta, T* li, T* sci,
                  T* xir, T* lr, T* scr, T* piv, T* dblk, T* s_scr, int nb, int ni_p, int nr_p,
                  int ni_real, int nr_real, int Bp, double rtol, double floor_d, int attempts,
                  cudaStream_t stream) {
  int fl[4];
  if (int e = factor_launch<T>(ni_p, nr_p, Bp, fl)) return e;
  const int smem = fl[3];
  if (fl[0] == 1) {
    return dispatch_wide(ni_p, [&](auto nic) {
      constexpr int NI = decltype(nic)::value;
      auto kernel = factor_kernel_wide<T, NI>;
      cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      kernel<<<Bp, kWideThreads, smem, stream>>>(
          kii, kir, krr, delta, li, sci, xir, lr, scr, piv, dblk, s_scr, nb, ni_p, nr_p, ni_real,
          nr_real, Bp, T(rtol), T(floor_d), attempts, wide_pipe<T>(ni_p, nr_p) ? 1 : 0);
      return (int)cudaGetLastError();
    });
  }
  const int TL = fl[2];
  return dispatch_n(ni_p, kMaxInterior, [&](auto nic) {
    constexpr int NI = decltype(nic)::value;
    auto kernel = factor_kernel<T, NI>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(Bp + TL - 1) / TL, kWarp * TL, smem, stream>>>(
        kii, kir, krr, delta, li, sci, xir, lr, scr, piv, dblk, s_scr, nb, ni_p, nr_p, ni_real,
        nr_real, Bp, T(rtol), T(floor_d), attempts);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int launch_apply_down(const T* li, const T* sci, const T* kir, const T* bi, const T* br, T* xbi,
                      T* rred, int nb, int ni_p, int nr_p, int Bp, cudaStream_t stream) {
  if (nb < 1 || nr_p < 1 || nr_p > kMaxReduced || Bp < 1) return (int)cudaErrorInvalidValue;
  return dispatch_n(ni_p, kMaxInterior, [&](auto nic) {
    constexpr int NI = decltype(nic)::value;
    // blocks per chunk: up to 16 warps, shared memory (r_red, and per warp
    // its s_b and, at run-time sizes, its x) within the default 48 KB, or
    // within the opted-in 227 KB for reduced blocks wider than 64
    const int row = nr_p * kWarp * (int)sizeof(T);
    const int xrow = NI > 0 ? 0 : ni_p * kWarp * (int)sizeof(T);
    const int budget = nr_p > 64 ? kSmemMax : kSmemDefault;
    int bw = (budget - row) / (row + xrow);
    bw = bw < 16 ? bw : 16;
    bw = bw < nb ? bw : nb;
    const int smem = row + bw * (row + xrow);
    auto kernel = apply_down_kernel<T, NI>;
    if (smem > kSmemDefault) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(Bp + kWarp - 1) / kWarp, dim3(kWarp, bw), smem, stream>>>(
        li, sci, kir, bi, br, xbi, rred, nb, ni_p, nr_p, Bp);
    return (int)cudaGetLastError();
  });
}

// apply_up's launch at a shape, into up[3]: the body (the built reduced
// size NR; 0, the run-time body), warps per CTA of 32 lanes (one per
// interior row up to kUpWarps, so every nb ni_p rows run) and the CTA's
// shared memory in bytes. cudaErrorInvalidValue for a shape it does not
// take. The launcher launches exactly this (cuda_kkt.apply_up_launch
// reads it).
int up_launch(int nb, int ni_p, int nr_p, int Bp, int item, int* up) {
  if (nb < 1 || ni_p < 1 || ni_p > kMaxInterior || nr_p < 1 || nr_p > kMaxReduced || Bp < 1)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)nb * ni_p;
  up[0] = dispatch_n(nr_p, kMaxReduced, [](auto nrc) { return decltype(nrc)::value; });
  up[1] = rows < kUpWarps ? (int)rows : kUpWarps;
  up[2] = up_smem_elems(up[0], nr_p) * item;
  return (int)cudaSuccess;
}

template <typename T>
int launch_apply_up(const T* lr, const T* scr, const T* rred, const T* xir, const T* xbi, T* xr,
                    T* xi, int nb, int ni_p, int nr_p, int Bp, cudaStream_t stream) {
  int up[3];
  if (int e = up_launch(nb, ni_p, nr_p, Bp, (int)sizeof(T), up)) return e;
  const int bw = up[1], smem = up[2];
  return dispatch_n(nr_p, kMaxReduced, [&](auto nrc) {
    constexpr int NR = decltype(nrc)::value;
    auto kernel = apply_up_kernel<T, NR>;
    if (smem > kSmemDefault) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(Bp + kWarp - 1) / kWarp, dim3(kWarp, bw), smem, stream>>>(
        lr, scr, rred, xir, xbi, xr, xi, (long long)nb * ni_p, nr_p, Bp);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// Plain C launchers (bound with ctypes): raw pointers, sizes and the
// stream; each returns the cudaError_t of its launch. bak_factor_launch_*
// and bak_apply_up_launch_* return the factor's (factor_launch) and
// apply_up's (up_launch) launch at a shape without launching.
#define BAK_LAUNCHERS(T, SUF)                                                    \
  extern "C" int bak_factor_##SUF(                                               \
      const T* kii, const T* kir, const T* krr, const T* delta, T* li, T* sci,   \
      T* xir, T* lr, T* scr, T* piv, T* dblk, T* s_scr, int nb, int ni_p,        \
      int nr_p, int ni_real, int nr_real, int Bp, double rtol, double floor_d,   \
      int attempts, void* stream) {                                              \
    return launch_factor<T>(kii, kir, krr, delta, li, sci, xir, lr, scr, piv,    \
                            dblk, s_scr, nb, ni_p, nr_p, ni_real, nr_real, Bp,   \
                            rtol, floor_d, attempts, (cudaStream_t)stream);      \
  }                                                                              \
  extern "C" int bak_apply_down_##SUF(const T* li, const T* sci, const T* kir,   \
                                      const T* bi, const T* br, T* xbi, T* rred, \
                                      int nb, int ni_p, int nr_p, int Bp,        \
                                      void* stream) {                            \
    return launch_apply_down<T>(li, sci, kir, bi, br, xbi, rred, nb, ni_p, nr_p, \
                                Bp, (cudaStream_t)stream);                       \
  }                                                                              \
  extern "C" int bak_apply_up_##SUF(const T* lr, const T* scr, const T* rred,    \
                                    const T* xir, const T* xbi, T* xr, T* xi,    \
                                    int nb, int ni_p, int nr_p, int Bp,          \
                                    void* stream) {                              \
    return launch_apply_up<T>(lr, scr, rred, xir, xbi, xr, xi, nb, ni_p, nr_p,   \
                              Bp, (cudaStream_t)stream);                         \
  }                                                                              \
  extern "C" int bak_apply_up_launch_##SUF(int nb, int ni_p, int nr_p, int Bp,   \
                                           int* up) {                            \
    return up_launch(nb, ni_p, nr_p, Bp, (int)sizeof(T), up);                    \
  }                                                                              \
  extern "C" int bak_factor_launch_##SUF(int ni_p, int nr_p, int Bp, int* fl) {  \
    return factor_launch<T>(ni_p, nr_p, Bp, fl);                                 \
  }

BAK_LAUNCHERS(float, f32)
BAK_LAUNCHERS(double, f64)
