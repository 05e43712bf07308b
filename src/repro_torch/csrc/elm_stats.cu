// Fused feature -> moment kernel (kernel B1 of the port).
//
// Replaces the Pallas TPU kernel ``elm_stats_pallas`` of
// src/repro/kernels/elm_stats.py (body ``_elm_stats_kernel``, hidden
// tile ``hidden_tile``). For every node v of a stacked batch it computes
//
//     H = g(X_v W + b)            (N, L), never written to device memory
//     P_v = H^T H                 (L, L) f32
//     Q_v = H^T T_v               (L, M) f32
//
// Layout: X (V, N, D) in the operand dtype (f32 or bf16), W (D, L) in
// the operand dtype, b (L,) f32 (gamma for rbf, with W = centers^T),
// T (V, N, M) f32 (the wrapper widens bf16 targets, which is exact).
//
// Design. The TPU kernel carried the P block across a sequential grid
// axis over N. Blocks on the card run in no order, so here one block owns
// one (node, i-tile, j-tile) of P with i <= j and loops over N itself:
// per chunk of BN rows it builds the two hidden tiles H_i, H_j (BN x TL)
// in shared memory from X and W slices, then adds H_i^T H_j into a 4x4
// register tile per thread. The lower triangle is the mirror of the
// upper one (written by the same block), so P is exactly symmetric; a
// diagonal tile is symmetric too because fma(a, b, c) == fma(b, a, c).
// Q is accumulated by the diagonal blocks only, once per (i, chunk),
// straight into device memory: each element has one owner thread.
//
// Dtype policy (elm_stats.py docstring): feature product with f32
// accumulation, activation in f32, H rounded to the operand dtype before
// both moment products, f32 moments. Rows past N are masked to exact
// zeros (sigmoid(0) = 0.5 would otherwise leak into P and Q).
//
// Bound on the H100: the feature product is recomputed for both tiles of
// a pair (about twice the minimal feature work at L = 128), and all
// products run on the f32 FMA units, not the tensor cores; at the
// flagship shapes the minimal work (2.3 GFLOP) over 67 TFLOP/s sets the
// bound (operations), ahead of the ~90 MB the function must move.
#include "elm_common.cuh"

namespace {

constexpr int TL = 64;        // P tile edge (hidden columns per tile)
constexpr int BN = 32;        // rows per chunk
constexpr int BD = 32;        // input columns per staged slice
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 P entries each

template <typename Tin, bool RBF>
__global__ void __launch_bounds__(THREADS)
elm_stats_kernel(const Tin* __restrict__ X, const Tin* __restrict__ W,
                 const float* __restrict__ b, const float* __restrict__ T,
                 float* __restrict__ P, float* __restrict__ Q,
                 int N, int D, int L, int M, int act, int ntiles) {
  __shared__ float xs[BN][BD + 1];
  __shared__ float wis[BD][TL];
  __shared__ float wjs[BD][TL];
  __shared__ __align__(16) float hi[BN][TL];
  __shared__ __align__(16) float hj[BN][TL];

  const int v = blockIdx.x;
  // blockIdx.y enumerates the upper block triangle row by row
  int pair = blockIdx.y, ti = 0;
  while (pair >= ntiles - ti) { pair -= ntiles - ti; ++ti; }
  const int tj = ti + pair;
  const bool diag = ti == tj;
  const int i0 = ti * TL, j0 = tj * TL;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;     // P register tile
  const int hr = tid / 8, hc = (tid % 8) * 8;  // hidden tile: row, 8 cols

  const Tin* Xv = X + (size_t)v * N * D;
  const float* Tv = T + (size_t)v * N * M;
  float* Pv = P + (size_t)v * L * L;
  float* Qv = Q + (size_t)v * L * M;

  if (diag) {
    for (int e = tid; e < TL * M; e += THREADS) {
      const int l = i0 + e / M;
      if (l < L) Qv[(size_t)l * M + e % M] = 0.0f;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += BN) {
    float si[8], sj[8], ci[8], cj[8], xsq = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) si[k] = sj[k] = ci[k] = cj[k] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += BD) {
      for (int e = tid; e < BN * BD; e += THREADS) {
        const int r = e / BD, d = e % BD;
        const int n = n0 + r, dd = d0 + d;
        xs[r][d] = (n < N && dd < D) ? to_f32(Xv[(size_t)n * D + dd]) : 0.0f;
      }
      for (int e = tid; e < BD * TL; e += THREADS) {
        const int d = e / TL, c = e % TL;
        const int dd = d0 + d;
        wis[d][c] = (dd < D && i0 + c < L)
                        ? to_f32(W[(size_t)dd * L + i0 + c]) : 0.0f;
        if (!diag)
          wjs[d][c] = (dd < D && j0 + c < L)
                          ? to_f32(W[(size_t)dd * L + j0 + c]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < BD; ++d) {
        const float x = xs[hr][d];
        if (RBF) xsq += x * x;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float wi = wis[d][hc + k];
          si[k] += x * wi;
          if (RBF) ci[k] += wi * wi;
          if (!diag) {
            const float wj = wjs[d][hc + k];
            sj[k] += x * wj;
            if (RBF) cj[k] += wj * wj;
          }
        }
      }
      __syncthreads();
    }

    const bool row_ok = n0 + hr < N;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = hc + k;
      float h = 0.0f;
      if (row_ok && i0 + c < L) {
        const float bb = b[i0 + c];
        h = RBF ? expf(-bb * fmaxf(xsq - 2.0f * si[k] + ci[k], 0.0f))
                : elm_activation(act, si[k] + bb);
      }
      hi[hr][c] = round_to<Tin>(h);
      if (!diag) {
        h = 0.0f;
        if (row_ok && j0 + c < L) {
          const float bb = b[j0 + c];
          h = RBF ? expf(-bb * fmaxf(xsq - 2.0f * sj[k] + cj[k], 0.0f))
                  : elm_activation(act, sj[k] + bb);
        }
        hj[hr][c] = round_to<Tin>(h);
      }
    }
    __syncthreads();

    const float (*hjp)[TL] = diag ? hi : hj;
#pragma unroll 4
    for (int r = 0; r < BN; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(&hi[r][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&hjp[r][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(a4[a], b4[c], acc[a][c]);
    }

    if (diag) {
      const int rows = min(BN, N - n0);
      for (int e = tid; e < TL * M; e += THREADS) {
        const int l = e / M, m = e % M;
        if (i0 + l >= L) continue;
        float q = 0.0f;
        for (int r = 0; r < rows; ++r)
          q = fmaf(hi[r][l], Tv[(size_t)(n0 + r) * M + m], q);
        Qv[(size_t)(i0 + l) * M + m] += q;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = i0 + ty * 4 + a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = j0 + tx * 4 + c;
      if (row < L && col < L) {
        Pv[(size_t)row * L + col] = acc[a][c];
        if (!diag) Pv[(size_t)col * L + row] = acc[a][c];
      }
    }
  }
}

template <typename Tin, bool RBF>
void launch(const void* X, const void* W, const float* b, const float* T,
            float* P, float* Q, int V, int N, int D, int L, int M, int act,
            cudaStream_t stream) {
  const int ntiles = (L + TL - 1) / TL;
  const dim3 grid(V, ntiles * (ntiles + 1) / 2);
  elm_stats_kernel<Tin, RBF><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(X), static_cast<const Tin*>(W), b, T, P, Q,
      N, D, L, M, act, ntiles);
}

}  // namespace

// X/W operand dtype: x_bf16 = 0 for f32, 1 for bf16. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int elm_stats_launch(const void* X, const void* W, const float* b,
                                const float* T, float* P, float* Q, int V,
                                int N, int D, int L, int M, int act,
                                int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rbf = act == ACT_RBF;
  if (x_bf16) {
    if (rbf) launch<__nv_bfloat16, true>(X, W, b, T, P, Q, V, N, D, L, M, act, s);
    else launch<__nv_bfloat16, false>(X, W, b, T, P, Q, V, N, D, L, M, act, s);
  } else {
    if (rbf) launch<float, true>(X, W, b, T, P, Q, V, N, D, L, M, act, s);
    else launch<float, false>(X, W, b, T, P, Q, V, N, D, L, M, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}
