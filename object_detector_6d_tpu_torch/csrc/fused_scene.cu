// K5: fused geometry, [B,H,W] int32 depth (mm) -> [B,8,H,W] f32 planes:
// cloud xyz (NaN-invalid), FALS normal xyz (NaN-invalid), validity, zero.
//
// Replaces object_detector_6d_tpu/ops/geometry_pallas.py FusedScene.__call__
// (_make_kernel): z = d*0.001, x = z*(u-cx)*rfx, y = z*(v-cy)*rfy,
// inv_r = 1/|cloud|, b = 5x5 box sum of unit_ray*inv_r (rows then columns,
// each left to right, zero fill), n = M^-1 b with the host-built per-pixel
// M^-1, normalize, flip when n . unit_ray > 0, NaN-mask.
//
// NUMERICS: M is near-singular, so M^-1 amplifies a 1-ulp change of b into
// degree-level normal errors. Every float step is therefore one
// separately rounded operation in the reference's order: __f*_rn
// intrinsics, and the library is built with -fmad=false so no
// multiply-add is contracted. The reference kernel writes z*(u-cx)/fx
// with fx a compile-time constant, which XLA executes as a multiply by
// the float32 reciprocal rfx = 1/fx; the wrapper passes rfx, rfy, and
// this kernel multiplies by them, which keeps the cloud planes bit-exact
// with the reference (its normals agree to the test_geom bound, and
// bitwise with the plain twin in ops/geometry.py).
//
// Bound on the H100: memory. Per pixel it reads 4 bytes of depth plus 56
// bytes of constant rays and M^-1 and writes 32 bytes; a B=32 batch of
// 480x640 frames moves ~1 GB. The simple design: one thread per pixel,
// a shared-memory tile of the three unit_ray*inv_r components with the
// box sum's 2-pixel halo (each computed once per tile), a second tile of
// the row sums, then the column sums, the 3x3 solve and the 8 plane
// writes, all coalesced along W.
#include "common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int R = 2;  // box-sum radius (window 5)

__global__ void fused_scene_kernel(const int32_t* __restrict__ depth,
                                   const float* __restrict__ rays,
                                   const float* __restrict__ minv,
                                   float* __restrict__ out, int H, int W,
                                   float rfx, float rfy) {
  __shared__ float comp[3][TY + 2 * R][TX + 2 * R];
  __shared__ float rows[3][TY][TX + 2 * R];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const size_t plane = (size_t)H * W;
  const int32_t* db = depth + (size_t)b * plane;
  const int tid = threadIdx.y * TX + threadIdx.x;

  // unit_ray * inv_r over the tile and its halo; zero outside the frame
  for (int i = tid; i < (TY + 2 * R) * (TX + 2 * R); i += TX * TY) {
    const int ty = i / (TX + 2 * R), tx = i % (TX + 2 * R);
    const int y = y0 + ty - R, x = x0 + tx - R;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const size_t p = (size_t)y * W + x;
      const int32_t d = db[p];
      if (d > 0) {
        const float z = __fmul_rn(__int2float_rn(d), 0.001f);
        const float xx = __fmul_rn(__fmul_rn(z, rays[p]), rfx);
        const float yy = __fmul_rn(__fmul_rn(z, rays[plane + p]), rfy);
        const float rr = __fsqrt_rn(__fadd_rn(
            __fadd_rn(__fmul_rn(xx, xx), __fmul_rn(yy, yy)), __fmul_rn(z, z)));
        const float inv_r = __fdiv_rn(1.0f, rr);
        c0 = __fmul_rn(rays[2 * plane + p], inv_r);
        c1 = __fmul_rn(rays[3 * plane + p], inv_r);
        c2 = __fmul_rn(rays[4 * plane + p], inv_r);
      } else {
        // invalid pixels contribute ray * 0
        c0 = __fmul_rn(rays[2 * plane + p], 0.0f);
        c1 = __fmul_rn(rays[3 * plane + p], 0.0f);
        c2 = __fmul_rn(rays[4 * plane + p], 0.0f);
      }
    }
    comp[0][ty][tx] = c0;
    comp[1][ty][tx] = c1;
    comp[2][ty][tx] = c2;
  }
  __syncthreads();

  // row sums over comp[r-2..r+2], left to right
  for (int i = tid; i < TY * (TX + 2 * R); i += TX * TY) {
    const int ty = i / (TX + 2 * R), tx = i % (TX + 2 * R);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s = comp[c][ty][tx];
#pragma unroll
      for (int k = 1; k <= 2 * R; ++k) s = __fadd_rn(s, comp[c][ty + k][tx]);
      rows[c][ty][tx] = s;
    }
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t p = (size_t)y * W + x;

  // column sums over rows[c-2..c+2], left to right
  float bs[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = rows[c][threadIdx.y][threadIdx.x];
#pragma unroll
    for (int k = 1; k <= 2 * R; ++k) s = __fadd_rn(s, rows[c][threadIdx.y][threadIdx.x + k]);
    bs[c] = s;
  }

  float n[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float m0 = minv[(size_t)(3 * i) * plane + p];
    const float m1 = minv[(size_t)(3 * i + 1) * plane + p];
    const float m2 = minv[(size_t)(3 * i + 2) * plane + p];
    n[i] = __fadd_rn(__fadd_rn(__fmul_rn(m0, bs[0]), __fmul_rn(m1, bs[1])),
                     __fmul_rn(m2, bs[2]));
  }
  const float norm = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(n[0], n[0]), __fmul_rn(n[1], n[1])), __fmul_rn(n[2], n[2])));
  const bool norm_ok = norm > 0.0f && isfinite(norm);
  n[0] = __fdiv_rn(n[0], norm);
  n[1] = __fdiv_rn(n[1], norm);
  n[2] = __fdiv_rn(n[2], norm);
  const float ux = rays[2 * plane + p], uy = rays[3 * plane + p], uz = rays[4 * plane + p];
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(n[0], ux), __fmul_rn(n[1], uy)),
                              __fmul_rn(n[2], uz));
  if (dot > 0.0f) {
    n[0] = -n[0];
    n[1] = -n[1];
    n[2] = -n[2];
  }

  const int32_t d = db[p];
  const bool vc = d > 0;
  const bool bad = !vc || !norm_ok;
  const float nan = __int_as_float(0x7fc00000);
  float* ob = out + (size_t)b * 8 * plane + p;
  float xx = nan, yy = nan, zz = nan;
  if (vc) {
    zz = __fmul_rn(__int2float_rn(d), 0.001f);
    xx = __fmul_rn(__fmul_rn(zz, rays[p]), rfx);
    yy = __fmul_rn(__fmul_rn(zz, rays[plane + p]), rfy);
  }
  ob[0] = xx;
  ob[plane] = yy;
  ob[2 * plane] = zz;
  ob[3 * plane] = bad ? nan : n[0];
  ob[4 * plane] = bad ? nan : n[1];
  ob[5 * plane] = bad ? nan : n[2];
  ob[6 * plane] = bad ? 0.0f : 1.0f;
  ob[7 * plane] = 0.0f;
}

}  // namespace

extern "C" int odc_fused_scene(const void* depth, const void* rays,
                               const void* minv, void* out, int B, int H,
                               int W, float rfx, float rfy, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid(odc::ceil_div(W, TX), odc::ceil_div(H, TY), B);
  fused_scene_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)depth, (const float*)rays, (const float*)minv,
      (float*)out, H, W, rfx, rfy);
  return (int)cudaGetLastError();
}
