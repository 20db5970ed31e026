// K3: fused OR-spread + response maps, [B,H,W] u8 -> [B,8,H,W] u8.
//
// Replaces object_detector_6d_tpu/ops/response_pallas.py
// response_spread_batched (_make_kernel): the forward T x T OR-spread of
// the one-hot orientation byte (zero beyond the frame), then for each of
// the 8 orientations the best similarity 4 - circular distance against
// any bit of the spread byte, by the rotate-and-priority rule.
//
// Bound on the H100: memory. Per pixel it reads 1 byte and writes 8, with
// a few dozen integer operations; a 480x640 frame moves 2.8 MB. The
// simple design: one thread per output pixel over a shared-memory tile
// with the spread's forward (T-1)-pixel halo, so each input byte is read
// from device memory about once and the T*T window taps hit shared
// memory; the eight output planes are written coalesced, one byte per
// thread per plane.
#include "common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int HALO = 15;  // T <= 16

__global__ void response_spread_kernel(const uint8_t* __restrict__ q,
                                       uint8_t* __restrict__ out, int H, int W,
                                       int T, int v4, int v3, int v2, int v1,
                                       int v0) {
  __shared__ uint8_t tile[TY + HALO][TX + HALO];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const uint8_t* qb = q + (size_t)b * H * W;
  const int th = TY + T - 1, tw = TX + T - 1;
  for (int i = threadIdx.y * TX + threadIdx.x; i < th * tw; i += TX * TY) {
    const int ty = i / tw, tx = i % tw;
    const int y = y0 + ty, x = x0 + tx;
    tile[ty][tx] = (y < H && x < W) ? qb[(size_t)y * W + x] : (uint8_t)0;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  int s = 0;
  for (int r = 0; r < T; ++r)
    for (int c = 0; c < T; ++c) s |= tile[threadIdx.y + r][threadIdx.x + c];

  const size_t plane = (size_t)H * W;
  uint8_t* ob = out + (size_t)b * 8 * plane + (size_t)y * W + x;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // rotate so orientation i sits at bit 0; the nearest set bit wins
    const int r = ((s >> i) | (s << (8 - i))) & 0xFF;
    int v = 0;
    if (r & (1 << 4)) v = v4;
    if (r & ((1 << 3) | (1 << 5))) v = v3;
    if (r & ((1 << 2) | (1 << 6))) v = v2;
    if (r & ((1 << 1) | (1 << 7))) v = v1;
    if (r & 1) v = v0;
    ob[(size_t)i * plane] = (uint8_t)v;
  }
}

}  // namespace

extern "C" int odc_response_spread(const void* q, void* out, int B, int H,
                                   int W, int T, int v4, int v3, int v2,
                                   int v1, int v0, void* stream) {
  if (T < 1 || T > HALO + 1) return (int)cudaErrorInvalidValue;
  const dim3 block(TX, TY);
  const dim3 grid(odc::ceil_div(W, TX), odc::ceil_div(H, TY), B);
  response_spread_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)q, (uint8_t*)out, H, W, T, v4, v3, v2, v1, v0);
  return (int)cudaGetLastError();
}
