// Fused consensus round over padded neighbor lists (kernel B2 of the port).
//
// Replaces the state arm of the Pallas TPU kernel ``elm_gossip_pallas``
// of src/repro/kernels/elm_gossip.py (body ``_round_kernel``, with
// ``_lap_tile`` and ``_apply_omega``). One launch is one eq. (20) round:
//
//     lap_v  = sum_s w[v,s] p(beta[idx[v,s]]) - deg_v p(beta_v)   (L, M)
//     out_v  = beta_v + scale * Omega_v @ lap_v
//
// where p() is the payload cast: identity, or a round to bf16 and back
// (``bf16`` = 1) applied to the gathered neighbors and the self term
// alike, as ``_lap_tile`` does; the Laplacian accumulates in f32.
//
// Layout: beta/out (V, L, M) f32, omega (V, L, L) f32, idx (V, d_max)
// int32, w (V, d_max) f32, deg (V,) f32; the wrapper passes the round's
// snapshot. The TPU kernel kept a (V, M, L) lane layout for its 128-wide
// vector unit; here the public (V, L, M) layout is kept, since a block
// reads each neighbor's L*M state as one contiguous run.
//
// Design. One block per node. The block first forms lap_v in shared
// memory (coalesced reads of each neighbor's contiguous state; the whole
// state is small enough to stay in L2 across the gathers), then streams
// Omega_v through shared memory in TR-row tiles and writes each output
// row. The update reads the old state of every neighbor, so ``out`` must
// not alias ``beta``: the wrapper ping-pongs two buffers between rounds.
// Padded neighbor slots (weight 0, index 0) are used only through their
// weight, as in the reference.
//
// Bound on the H100: memory. Each round must read Omega (V L^2 f32,
// 64 MiB at the flagship) and the state, against ~0.3 GFLOP of work.
#include "elm_common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float payload(float x, int bf16) {
  return bf16 ? round_to<__nv_bfloat16>(x) : x;
}

__global__ void __launch_bounds__(THREADS)
elm_gossip_round_kernel(const float* __restrict__ beta,
                        const float* __restrict__ omega,
                        const int* __restrict__ idx,
                        const float* __restrict__ w,
                        const float* __restrict__ deg,
                        float* __restrict__ out, int L, int M, int d_max,
                        float scale, int bf16, int tr) {
  extern __shared__ float smem[];
  float* lap = smem;               // (L, M)
  float* om = smem + (size_t)L * M;  // (tr, L + 1), padded rows

  const int v = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t LM = (size_t)L * M;
  const float* bv = beta + (size_t)v * LM;
  const int* iv = idx + (size_t)v * d_max;
  const float* wv = w + (size_t)v * d_max;
  const float dv = deg[v];

  for (size_t e = tid; e < LM; e += THREADS) {
    float acc = -dv * payload(bv[e], bf16);
    for (int s = 0; s < d_max; ++s)
      acc += wv[s] * payload(beta[(size_t)iv[s] * LM + e], bf16);
    lap[e] = acc;
  }
  __syncthreads();

  const float* ov = omega + (size_t)v * L * L;
  float* outv = out + (size_t)v * LM;
  for (int l0 = 0; l0 < L; l0 += tr) {
    const int rows = min(tr, L - l0);
    for (int e = tid; e < rows * L; e += THREADS) {
      const int r = e / L, k = e % L;
      om[r * (L + 1) + k] = ov[(size_t)(l0 + r) * L + k];
    }
    __syncthreads();
    for (int e = tid; e < rows * M; e += THREADS) {
      const int r = e / M, m = e % M;
      const float* orow = om + r * (L + 1);
      float u = 0.0f;
      for (int k = 0; k < L; ++k) u = fmaf(orow[k], lap[k * M + m], u);
      const size_t o = (size_t)(l0 + r) * M + m;
      outv[o] = bv[o] + scale * u;
    }
    __syncthreads();
  }
}

}  // namespace

// Shared memory the kernel needs at L, M with tr Omega rows per tile.
static size_t gossip_smem_bytes(int L, int M, int tr) {
  return sizeof(float) * ((size_t)L * M + (size_t)tr * (L + 1));
}

// One round: out = round(beta). Returns the CUDA error code of the launch
// (0 on success); cudaErrorInvalidValue when even one Omega row per tile
// does not fit the shared memory of a block.
extern "C" int elm_gossip_round_launch(const float* beta, const float* omega,
                                       const int* idx, const float* w,
                                       const float* deg, float* out, int V,
                                       int L, int M, int d_max, float scale,
                                       int bf16, void* stream) {
  constexpr size_t kMaxSmem = 227 * 1024;
  int tr = 32;
  while (tr > 1 && gossip_smem_bytes(L, M, tr) > 48 * 1024) tr /= 2;
  const size_t smem = gossip_smem_bytes(L, M, tr);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        elm_gossip_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  elm_gossip_round_kernel<<<V, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      beta, omega, idx, w, deg, out, L, M, d_max, scale, bf16, tr);
  return static_cast<int>(cudaGetLastError());
}
