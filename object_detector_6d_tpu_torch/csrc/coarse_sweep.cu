// K6: sparse full-grid coarse sweep.
//
//   out[b,t,r,c] = sum_{f < nfeat[t]} D[b, plane[t,f], r+dr[t,f], c+dc[t,f]]
//
// for r < out_h, c < out_w; a read outside the plane (or of a plane
// outside 0..P-1) is zero. D [B,P,Hp,Wp] int8 decimated level-1 responses
// (both modalities stacked along P); plane/dr/dc [nT,F] int32; nfeat [nT]
// int32; out [B,nT,out_h,out_w] int32.
//
// Replaces object_detector_6d_tpu/ops/refine_pallas.py coarse_sweep
// (_coarse_kernel), which the TPU keeps experimental: there each grid step
// holds a frame's planes in VMEM and rolls whole rows per feature, so it
// needs power-of-two planes and wraps columns. Here the reads outside the
// plane are zero, which is the zero padding of the reference main path's
// int8 conv over the one-hot kernels_low: the raw grid equals that conv's.
//
// Bound on the H100: load issue, from L1/L2. A 480x640 frame's D is
// 1024 planes x 30 x 40 = 1.2 MB and a B=32 batch stays in the 50 MB L2;
// each (frame, template) reads ~62 windows of 30x40 bytes and adds them,
// with no reuse across templates to exploit without a redesign. The
// simple design: one block per (template, frame, chunk of outputs), the
// template's feature table staged in shared memory, 256 threads each
// owning up to PER outputs (row, col and int32 sum in registers),
// neighbouring threads on neighbouring columns so each warp's byte
// loads of one feature hit one or two rows of the plane.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER = 8;                     // outputs per thread
constexpr int CHUNK = THREADS * PER;       // outputs per block
constexpr int MAX_F = 256;                 // features per template
constexpr int FAR = -(1 << 28);            // row of an unused output slot

__global__ void coarse_sweep_kernel(const int8_t* __restrict__ D,
                                    const int32_t* __restrict__ plane,
                                    const int32_t* __restrict__ dr,
                                    const int32_t* __restrict__ dc,
                                    const int32_t* __restrict__ nfeat,
                                    int32_t* __restrict__ out, int P, int Hp,
                                    int Wp, int nT, int F, int out_h,
                                    int out_w) {
  __shared__ int32_t s_p[MAX_F];
  __shared__ int32_t s_r[MAX_F];
  __shared__ int32_t s_c[MAX_F];
  const int t = blockIdx.x, b = blockIdx.y;
  const int base = blockIdx.z * CHUNK;
  const int n_out = out_h * out_w;
  const int n = min(max(nfeat[t], 0), F);
  for (int f = threadIdx.x; f < n; f += THREADS) {
    s_p[f] = plane[(size_t)t * F + f];
    s_r[f] = dr[(size_t)t * F + f];
    s_c[f] = dc[(size_t)t * F + f];
  }
  __syncthreads();

  int row[PER], col[PER];
  int32_t acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = base + k * THREADS + threadIdx.x;
    row[k] = i < n_out ? i / out_w : FAR;
    col[k] = i < n_out ? i % out_w : 0;
    acc[k] = 0;
  }
  const int8_t* Db = D + (size_t)b * P * Hp * Wp;
  for (int f = 0; f < n; ++f) {
    const int p = s_p[f];
    if (p < 0 || p >= P) continue;  // the same for the whole block
    const int8_t* Dp = Db + (size_t)p * Hp * Wp;
    const int fr = s_r[f], fc = s_c[f];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int r = row[k] + fr, c = col[k] + fc;
      if (r >= 0 && r < Hp && c >= 0 && c < Wp) acc[k] += (int32_t)Dp[r * Wp + c];
    }
  }
  int32_t* ob = out + ((size_t)b * nT + t) * n_out;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = base + k * THREADS + threadIdx.x;
    if (i < n_out) ob[i] = acc[k];
  }
}

}  // namespace

extern "C" int odc_coarse_sweep(const void* D, const void* plane, const void* dr,
                                const void* dc, const void* nfeat, void* out,
                                int B, int P, int Hp, int Wp, int nT, int F,
                                int out_h, int out_w, void* stream) {
  if (F > MAX_F) return (int)cudaErrorInvalidValue;
  if (B == 0 || nT == 0 || out_h == 0 || out_w == 0) return 0;
  const dim3 grid(nT, B, odc::ceil_div(out_h * out_w, CHUNK));
  coarse_sweep_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)D, (const int32_t*)plane, (const int32_t*)dr,
      (const int32_t*)dc, (const int32_t*)nfeat, (int32_t*)out, P, Hp, Wp,
      nT, F, out_h, out_w);
  return (int)cudaGetLastError();
}
