// K4: sparse 16x16 local-refinement sweep.
//
//   out[b,k,ty,tx] = sum_{f < nfeat[b,k]} D[b, plane[b,k,f], r0[b,k,f]+ty, c0[b,k,f]+tx]
//
// D [B,P,Hp,Wp] int8 decimated level-0 responses; plane/r0/c0 [B,K,F]
// int32; nfeat [B,K] int32; out [B,K,16,16] int32.
//
// Replaces object_detector_6d_tpu/ops/refine_pallas.py
// refine_sweep_batched (_refine_kernel_batched): there the frame's whole D
// sits in VMEM and one grid step loops over all candidates and features
// with dynamic 32-row windows and lane rotates.
//
// Bound on the H100: latency. Each feature reads one 16x16 int8 tile
// (256 bytes, 16 rows of 16 bytes) from a D that stays in the 50 MB L2
// (a 480x640 frame's D is 6.6 MB), and adds it; there are ~K*F = 1000
// dependent tile reads per frame and almost no arithmetic. The simple
// design: one block per (b, k), 256 threads = the 16x16 tile, each thread
// walking the candidate's features and accumulating its pixel in a
// register; the feature tables of the candidate are staged in shared
// memory once. Candidates with nfeat == 0 write zeros. A tile that would
// leave the plane reads zero (the wrapper rejects such inputs first).
#include "common.cuh"

namespace {

constexpr int MAX_F = 256;

__global__ void refine_sweep_kernel(const int8_t* __restrict__ D,
                                    const int32_t* __restrict__ plane,
                                    const int32_t* __restrict__ r0,
                                    const int32_t* __restrict__ c0,
                                    const int32_t* __restrict__ nfeat,
                                    int32_t* __restrict__ out, int P, int Hp,
                                    int Wp, int K, int F) {
  __shared__ int32_t s_off[MAX_F];
  __shared__ int32_t s_r[MAX_F];
  __shared__ int32_t s_c[MAX_F];
  const int bk = blockIdx.x;  // b * K + k
  const int b = bk / K;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int n = min(max(nfeat[bk], 0), F);
  const size_t fbase = (size_t)bk * F;
  for (int f = tid; f < n; f += blockDim.x) {
    s_off[f] = plane[fbase + f];
    s_r[f] = r0[fbase + f];
    s_c[f] = c0[fbase + f];
  }
  __syncthreads();
  const int8_t* Db = D + (size_t)b * P * Hp * Wp;
  int32_t acc = 0;
  for (int f = 0; f < n; ++f) {
    const int p = s_off[f];
    const int r = s_r[f] + ty;
    const int c = s_c[f] + tx;
    if (p >= 0 && p < P && r >= 0 && r < Hp && c >= 0 && c < Wp)
      acc += (int32_t)Db[((size_t)p * Hp + r) * Wp + c];
  }
  out[(size_t)bk * 256 + tid] = acc;
}

}  // namespace

extern "C" int odc_refine_sweep(const void* D, const void* plane,
                                const void* r0, const void* c0,
                                const void* nfeat, void* out, int B, int P,
                                int Hp, int Wp, int K, int F, void* stream) {
  if (F > MAX_F || B * K == 0) return B * K == 0 ? 0 : (int)cudaErrorInvalidValue;
  refine_sweep_kernel<<<B * K, 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)D, (const int32_t*)plane, (const int32_t*)r0,
      (const int32_t*)c0, (const int32_t*)nfeat, (int32_t*)out, P, Hp, Wp, K,
      F);
  return (int)cudaGetLastError();
}
