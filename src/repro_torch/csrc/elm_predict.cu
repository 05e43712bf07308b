// Fused predict kernel Y = g(X W + b) @ beta (kernel B4 of the port).
//
// Replaces the Pallas TPU kernel ``elm_predict_pallas`` of
// src/repro/kernels/elm_predict.py (body ``_elm_predict_kernel``, hidden
// tile ``hidden_tile`` of elm_stats.py). The (N, L) hidden matrix is
// never written to device memory.
//
// Layout: X (N, D) and W (D, L) in the operand dtype (f32 or bf16),
// b (L,) f32 (gamma for rbf, with W = centers^T), beta (L, M) f32 (the
// wrapper widens a bf16 readout, which is exact), Y (N, M) f32.
//
// Design. One block owns a BN x BM tile of Y and loops over L in chunks
// of TLC hidden columns: it builds the hidden chunk g(X_tile W_chunk + b)
// (BN x TLC) in shared memory from staged X and W slices, rounds it to
// the operand dtype, and adds its product with the matching beta chunk
// into a 4 x 4 register tile per thread. Rows past N are masked to exact
// zeros and never written.
//
// Known cost: a block that owns only an M tile recomputes the hidden
// chunk for every M tile. At the flagship readout (L = 128, M = V * 8 =
// 8192, D = 64) that is M / BM = 128 recomputations of the feature
// product, about as many operations as the readout itself; sharing the
// hidden tile across M tiles is left for a later change.
//
// Bound on the H100: operations. The readout alone is 2 N L M flops
// (8.6 GFLOP at the flagship) on the f32 FMA units, against the
// ~139 MB the function must move (mostly Y).
#include "elm_common.cuh"

namespace {

constexpr int BN = 64;        // rows per block
constexpr int BM = 64;        // outputs per block
constexpr int TLC = 32;       // hidden columns per chunk
constexpr int BD = 32;        // input columns per staged slice
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename Tin, bool RBF>
__global__ void __launch_bounds__(THREADS)
elm_predict_kernel(const Tin* __restrict__ X, const Tin* __restrict__ W,
                   const float* __restrict__ b,
                   const float* __restrict__ beta, float* __restrict__ Y,
                   int N, int D, int L, int M, int act) {
  __shared__ float xs[BN][BD + 1];
  __shared__ float ws[BD][TLC];
  __shared__ float hs[BN][TLC + 1];
  __shared__ __align__(16) float bs[TLC][BM];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;     // Y register tile
  const int hr = tid / 4, hc = (tid % 4) * 8;  // hidden chunk: row, 8 cols
  const bool row_ok = n0 + hr < N;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;

  for (int l0 = 0; l0 < L; l0 += TLC) {
    float s[8], cs[8], xsq = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = cs[k] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += BD) {
      for (int e = tid; e < BN * BD; e += THREADS) {
        const int r = e / BD, d = e % BD;
        const int n = n0 + r, dd = d0 + d;
        xs[r][d] = (n < N && dd < D) ? to_f32(X[(size_t)n * D + dd]) : 0.0f;
      }
      for (int e = tid; e < BD * TLC; e += THREADS) {
        const int d = e / TLC, c = e % TLC;
        const int dd = d0 + d;
        ws[d][c] = (dd < D && l0 + c < L)
                       ? to_f32(W[(size_t)dd * L + l0 + c]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < BD; ++d) {
        const float x = xs[hr][d];
        if (RBF) xsq += x * x;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float wv = ws[d][hc + k];
          s[k] += x * wv;
          if (RBF) cs[k] += wv * wv;
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = hc + k;
      float h = 0.0f;
      if (row_ok && l0 + c < L) {
        const float bb = b[l0 + c];
        h = RBF ? expf(-bb * fmaxf(xsq - 2.0f * s[k] + cs[k], 0.0f))
                : elm_activation(act, s[k] + bb);
      }
      hs[hr][c] = round_to<Tin>(h);
    }
    for (int e = tid; e < TLC * BM; e += THREADS) {
      const int k = e / BM, c = e % BM;
      bs[k][c] = (l0 + k < L && m0 + c < M)
                     ? beta[(size_t)(l0 + k) * M + m0 + c] : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < TLC; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float h = hs[ty * 4 + a][k];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(h, b4[c], acc[a][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = n0 + ty * 4 + a;
    if (row >= N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = m0 + tx * 4 + c;
      if (col < M) Y[(size_t)row * M + col] = acc[a][c];
    }
  }
}

template <typename Tin, bool RBF>
void launch(const void* X, const void* W, const float* b, const float* beta,
            float* Y, int N, int D, int L, int M, int act,
            cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  elm_predict_kernel<Tin, RBF><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(X), static_cast<const Tin*>(W), b, beta, Y, N,
      D, L, M, act);
}

}  // namespace

// X/W operand dtype: x_bf16 = 0 for f32, 1 for bf16. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int elm_predict_launch(const void* X, const void* W,
                                  const float* b, const float* beta, float* Y,
                                  int N, int D, int L, int M, int act,
                                  int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rbf = act == ACT_RBF;
  if (x_bf16) {
    if (rbf) launch<__nv_bfloat16, true>(X, W, b, beta, Y, N, D, L, M, act, s);
    else launch<__nv_bfloat16, false>(X, W, b, beta, Y, N, D, L, M, act, s);
  } else {
    if (rbf) launch<float, true>(X, W, b, beta, Y, N, D, L, M, act, s);
    else launch<float, false>(X, W, b, beta, Y, N, D, L, M, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}
