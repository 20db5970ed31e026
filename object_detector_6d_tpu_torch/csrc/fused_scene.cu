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
// bitwise with the plain twin in ops/geometry.py). The box sum is NOT a
// sliding window: each of its two passes adds its five terms in order
// from the first, as the reference does.
//
// Bound on the H100: memory. Per pixel and frame it must read 4 bytes of
// depth and write 32; the 56 bytes of rays and M^-1 a pixel are the same
// for every frame. So a block owns one 32 x TY tile of the image and walks
// over G frames of the batch: a thread keeps its pixel's 5 ray and 9 M^-1
// constants in registers (and the 5 rays of the one halo entry it also
// computes), which cuts the constants' traffic by G. Per frame: each
// thread computes unit_ray*inv_r of its own pixel (whose cloud it writes
// later, computed once) and of its halo entry into a shared tile; a
// barrier; the five-term sums down the rows into a second tile; a
// barrier; the five-term sums along the columns, the 3x3 solve and the 8
// plane stores, coalesced along W. The next frame's depth is loaded
// before this frame's arithmetic. Two barriers a frame suffice: a tile is
// rewritten only after the barrier that follows its last read.
#include "common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int R = 2;                     // box-sum radius (window 5)
constexpr int G = 16;                    // frames a block walks over
constexpr int NT = TX * TY;              // threads a block
constexpr int CW = TX + 2 * R;           // the tile with its halo
constexpr int CH = TY + 2 * R;
constexpr int NH = CW * CH - NT;         // halo entries: one each for threads 0..NH-1
constexpr int NX = TY * 2 * R;           // row sums left and right of the tile's columns
static_assert(NH <= NT && NX <= NT, "one halo entry and one extra row sum a thread");

struct Rays {
  float r0, r1, ux, uy, uz;  // u - cx, v - cy, unit ray
};

__device__ __forceinline__ Rays load_rays(const float* __restrict__ rays, size_t plane, size_t p) {
  Rays r;
  r.r0 = rays[p];
  r.r1 = rays[plane + p];
  r.ux = rays[2 * plane + p];
  r.uy = rays[3 * plane + p];
  r.uz = rays[4 * plane + p];
  return r;
}

// unit_ray * inv_r of a pixel inside the frame (an invalid pixel
// contributes ray * 0), and its cloud point where valid
__device__ __forceinline__ void comp_of(int32_t d, const Rays& r, float rfx, float rfy,
                                        float& xx, float& yy, float& z, float c[3]) {
  if (d > 0) {
    z = __fmul_rn(__int2float_rn(d), 0.001f);
    xx = __fmul_rn(__fmul_rn(z, r.r0), rfx);
    yy = __fmul_rn(__fmul_rn(z, r.r1), rfy);
    const float rr = __fsqrt_rn(__fadd_rn(
        __fadd_rn(__fmul_rn(xx, xx), __fmul_rn(yy, yy)), __fmul_rn(z, z)));
    const float inv_r = __fdiv_rn(1.0f, rr);
    c[0] = __fmul_rn(r.ux, inv_r);
    c[1] = __fmul_rn(r.uy, inv_r);
    c[2] = __fmul_rn(r.uz, inv_r);
  } else {
    c[0] = __fmul_rn(r.ux, 0.0f);
    c[1] = __fmul_rn(r.uy, 0.0f);
    c[2] = __fmul_rn(r.uz, 0.0f);
  }
}

__global__ void __launch_bounds__(NT)
fused_scene_kernel(const int32_t* __restrict__ depth, const float* __restrict__ rays,
                   const float* __restrict__ minv, float* __restrict__ out, int B, int H,
                   int W, float rfx, float rfy) {
  __shared__ float comp[3][CH][CW];  // unit_ray * inv_r; zero outside the frame
  __shared__ float rows[3][TY][CW];  // its five-term sums down the rows
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int b0 = blockIdx.z * G, b1 = min(b0 + G, B);
  const size_t plane = (size_t)H * W;

  // the thread's own pixel and its constants
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const size_t p = inside ? (size_t)y * W + x : 0;
  Rays ray = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = 0.0f;
  if (inside) {
    ray = load_rays(rays, plane, p);
#pragma unroll
    for (int i = 0; i < 9; ++i) m[i] = minv[(size_t)i * plane + p];
  }

  // its halo entry of the tile: the R rows above, the R rows below, then
  // the R columns left and right of the TY rows between
  int hy = 0, hx = 0;
  if (tid < R * CW) {
    hy = tid / CW;
    hx = tid % CW;
  } else if (tid < 2 * R * CW) {
    hy = TY + R + (tid - R * CW) / CW;
    hx = (tid - R * CW) % CW;
  } else {
    const int h = tid - 2 * R * CW, q = h % (2 * R);
    hy = R + h / (2 * R);
    hx = q < R ? q : TX + q;
  }
  const int gy = y0 + hy - R, gx = x0 + hx - R;
  const bool halo = tid < NH;
  const bool halo_inside = halo && gy >= 0 && gy < H && gx >= 0 && gx < W;
  const size_t hp = halo_inside ? (size_t)gy * W + gx : 0;
  Rays hray = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (halo_inside) hray = load_rays(rays, plane, hp);

  // its extra row sum: the R columns left and right of the tile
  const int ey = tid / (2 * R), eq = tid % (2 * R);
  const int ex = eq < R ? eq : TX + eq;

  int32_t d_next = inside ? depth[(size_t)b0 * plane + p] : 0;
  int32_t dh_next = halo_inside ? depth[(size_t)b0 * plane + hp] : 0;
  for (int b = b0; b < b1; ++b) {
    const int32_t d = d_next, dh = dh_next;
    if (b + 1 < b1) {
      if (inside) d_next = depth[(size_t)(b + 1) * plane + p];
      if (halo_inside) dh_next = depth[(size_t)(b + 1) * plane + hp];
    }

    float xx = 0.0f, yy = 0.0f, zz = 0.0f;
    float c[3] = {0.0f, 0.0f, 0.0f};
    if (inside) comp_of(d, ray, rfx, rfy, xx, yy, zz, c);
#pragma unroll
    for (int i = 0; i < 3; ++i) comp[i][ty + R][tx + R] = c[i];
    if (halo) {
      float hc[3] = {0.0f, 0.0f, 0.0f};
      float t0, t1, t2;
      if (halo_inside) comp_of(dh, hray, rfx, rfy, t0, t1, t2, hc);
#pragma unroll
      for (int i = 0; i < 3; ++i) comp[i][hy][hx] = hc[i];
    }
    __syncthreads();

    // sums over comp rows r-2..r+2, in order from the first
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float s = comp[i][ty][tx + R];
#pragma unroll
      for (int k = 1; k <= 2 * R; ++k) s = __fadd_rn(s, comp[i][ty + k][tx + R]);
      rows[i][ty][tx + R] = s;
    }
    if (tid < NX) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float s = comp[i][ey][ex];
#pragma unroll
        for (int k = 1; k <= 2 * R; ++k) s = __fadd_rn(s, comp[i][ey + k][ex]);
        rows[i][ey][ex] = s;
      }
    }
    __syncthreads();
    if (!inside) continue;

    // sums over row-sum columns c-2..c+2, in order from the first
    float bs[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float s = rows[i][ty][tx];
#pragma unroll
      for (int k = 1; k <= 2 * R; ++k) s = __fadd_rn(s, rows[i][ty][tx + k]);
      bs[i] = s;
    }

    float n[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      n[i] = __fadd_rn(__fadd_rn(__fmul_rn(m[3 * i], bs[0]), __fmul_rn(m[3 * i + 1], bs[1])),
                       __fmul_rn(m[3 * i + 2], bs[2]));
    const float norm = __fsqrt_rn(__fadd_rn(
        __fadd_rn(__fmul_rn(n[0], n[0]), __fmul_rn(n[1], n[1])), __fmul_rn(n[2], n[2])));
    const bool norm_ok = norm > 0.0f && isfinite(norm);
    n[0] = __fdiv_rn(n[0], norm);
    n[1] = __fdiv_rn(n[1], norm);
    n[2] = __fdiv_rn(n[2], norm);
    const float dot = __fadd_rn(__fadd_rn(__fmul_rn(n[0], ray.ux), __fmul_rn(n[1], ray.uy)),
                                __fmul_rn(n[2], ray.uz));
    if (dot > 0.0f) {
      n[0] = -n[0];
      n[1] = -n[1];
      n[2] = -n[2];
    }

    const bool vc = d > 0;
    const bool bad = !vc || !norm_ok;
    const float nan = __int_as_float(0x7fc00000);
    float* ob = out + (size_t)b * 8 * plane + p;
    ob[0] = vc ? xx : nan;
    ob[plane] = vc ? yy : nan;
    ob[2 * plane] = vc ? zz : nan;
    ob[3 * plane] = bad ? nan : n[0];
    ob[4 * plane] = bad ? nan : n[1];
    ob[5 * plane] = bad ? nan : n[2];
    ob[6 * plane] = bad ? 0.0f : 1.0f;
    ob[7 * plane] = 0.0f;
  }
}

}  // namespace

extern "C" int odc_fused_scene(const void* depth, const void* rays,
                               const void* minv, void* out, int B, int H,
                               int W, float rfx, float rfy, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const dim3 block(TX, TY);
  const dim3 grid(odc::ceil_div(W, TX), odc::ceil_div(H, TY), odc::ceil_div(B, G));
  fused_scene_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)depth, (const float*)rays, (const float*)minv,
      (float*)out, B, H, W, rfx, rfy);
  return (int)cudaGetLastError();
}
