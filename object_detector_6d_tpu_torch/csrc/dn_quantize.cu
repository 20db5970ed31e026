// K2: depth-normal quantize, [B,H,W] int32 depth -> [B,H,W] u8 one-hot bins.
//
// Replaces object_detector_6d_tpu/ops/quantize_pallas.py
// dn_quantize_batched (_make_dn_kernel): ring least-squares depth gradient
// (8 samples at radius 5, bilateral-gated), normal (1150 ddx, 1150 ddy,
// -det d), normalize, x10+10 truncation, octant rule, validity, then the
// 5x5 numeric median over the one-hot bytes. Bit-identical to
// quant/depth_normal.py.
//
// Bound on the H100: integer operations. A pixel reads 4 bytes and writes
// 1 (49 MB for a B=32 batch of 480x640 frames: 15 us at 3.35 TB/s), but the
// algorithm needs ~123 int32 operations a pixel (8 gated differences and
// their normal equations, the solve, the octant rule, the median's packed
// counts) and ~29 float ones: ~0.07 ms for the batch at 16.7 T int32
// operations a second. So the design is one launch that reads every depth
// word about once, keeps the one-hot plane out of global memory, and spends
// as few instructions a pixel as it can, with no block-wide barrier:
//
// - Each warp owns a strip of 128 columns, 4 adjacent ones a lane (one
//   16-byte load a row, prefetched a row ahead), and walks down RH rows of
//   it. 112 of the columns are outputs; 8 on each side are halo (the
//   median reaches 2 columns, the ring 5 more). Rows and columns past the
//   frame load as zero, the ring's zero padding.
// - The ring needs rows y-5, y, y+5 and the median the one-hot rows y-2 ..
//   y+2, so a lane keeps its 4 columns of the last 11 depth rows and the
//   last 5 one-hot rows. They live in shared memory that only the lane
//   itself reads back (16-byte accesses, conflict-free, no barrier): a
//   register ring would need the walk unrolled 11 times, and the body
//   (~200 instructions a pixel, 4 pixels a lane) would outgrow the
//   instruction cache. Neighbours at +-5 and +-1, +-2 columns come by warp
//   shuffles.
// - A pixel's one-hot bin is kept as a word of eight 4-bit fields. The
//   median's 5x5 counts are separable: a sliding sum down the walk (counts
//   <= 5), then across 5 columns after a split into two words of four
//   8-bit fields (counts <= 25). The running counts of all 8 bins come from
//   one multiply by 0x01010101; the first bin whose running count, started
//   from the zero code's 25 - total, reaches 13 is found with one
//   find-first-set. 14 steps of a walk are warm-up, of which 10 only load
//   and 4 stop after the one-hot row; rows outside the ring's interior skip
//   the arithmetic.
//
// The int32 normal equations wrap modulo 2^32 as XLA's do (unsigned
// arithmetic); since sdx, sdy are -5, 0 or 5 they reduce to counts and
// signed sums of the gated differences, equal modulo 2^32 to the
// reference's sums of products. Float steps are spelled as __f*_rn
// intrinsics in the reference's order (and the library is built
// -fmad=false); sqrt and 1/norm are IEEE, float -> int truncates.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int CPL = 4;                    // adjacent columns a lane
constexpr int HALO = 8;                   // halo columns on each side of a strip (2 lanes)
constexpr int SW = 32 * CPL - 2 * HALO;   // output columns of a warp's strip
constexpr int RING = 5;                   // radius of the ring samples
constexpr int DROWS = 2 * RING + 1;       // depth rows a lane keeps
constexpr int MED = 2;                    // radius of the median
constexpr int QROWS = 2 * MED + 1;        // one-hot rows a lane keeps
constexpr unsigned FULL = 0xFFFFFFFFu;

// What a lane knows of its strip for the whole walk.
struct Strip {
  const int32_t* depth;
  uint8_t* out;
  int H, W, cx0;         // cx0: the lane's first column (may lie outside the frame)
  bool vec_in, vec_out;  // 16-byte loads / 4-byte stores are aligned
  int distance_threshold, difference_threshold;
};

// the lane's 4 columns of depth row y; zero past the frame
__device__ __forceinline__ int4 load_row(const Strip& t, int y) {
  int4 v = make_int4(0, 0, 0, 0);
  if (y < 0 || y >= t.H) return v;
  const int32_t* row = t.depth + (size_t)y * t.W;
  if (t.vec_in && t.cx0 >= 0 && t.cx0 + CPL <= t.W)
    return __ldg(reinterpret_cast<const int4*>(row + t.cx0));
  if (t.cx0 + 0 >= 0 && t.cx0 + 0 < t.W) v.x = __ldg(row + t.cx0 + 0);
  if (t.cx0 + 1 >= 0 && t.cx0 + 1 < t.W) v.y = __ldg(row + t.cx0 + 1);
  if (t.cx0 + 2 >= 0 && t.cx0 + 2 < t.W) v.z = __ldg(row + t.cx0 + 2);
  if (t.cx0 + 3 >= 0 && t.cx0 + 3 < t.W) v.w = __ldg(row + t.cx0 + 3);
  return v;
}

// the values 5 columns to the left (l) and right (r) of the lane's 4
// columns: column 4L+c+5 is lane L+1's c+1, or lane L+2's 0 for c = 3.
// The strip's first and last two lanes get their own values back where
// no lane holds the column; their outputs are never used.
__device__ __forceinline__ void shift5(const int4& v, int32_t l[CPL], int32_t r[CPL]) {
  r[0] = __shfl_down_sync(FULL, v.y, 1);
  r[1] = __shfl_down_sync(FULL, v.z, 1);
  r[2] = __shfl_down_sync(FULL, v.w, 1);
  r[3] = __shfl_down_sync(FULL, v.x, 2);
  l[0] = __shfl_up_sync(FULL, v.w, 2);
  l[1] = __shfl_up_sync(FULL, v.x, 1);
  l[2] = __shfl_up_sync(FULL, v.y, 1);
  l[3] = __shfl_up_sync(FULL, v.z, 1);
}

// One ring sample: the difference to the centre, gated by the bilateral
// threshold. Returns the gate (0 or 1) and leaves the gated difference in g.
__device__ __forceinline__ uint32_t gate(int32_t v, int32_t dc, int thr, uint32_t& g) {
  const int32_t delta = odc::wsub(v, dc);
  const bool f = odc::wabs(delta) < thr;
  g = f ? (uint32_t)delta : 0u;
  return f ? 1u : 0u;
}

// The one-hot bin of a pixel as a word of eight 4-bit fields (1 << 4*bin),
// 0 where the pixel is invalid. u*, m*, d*: rows y-5, y, y+5 at columns
// x-5 (l), x (c) and x+5 (r).
__device__ __forceinline__ uint32_t normal_word(const Strip& t, bool interior, int32_t dc,
                                                int32_t ul, int32_t uc, int32_t ur,
                                                int32_t ml, int32_t mr, int32_t dl,
                                                int32_t dm, int32_t dr) {
  const int thr = t.difference_threshold;
  uint32_t gul, guc, gur, gml, gmr, gdl, gdm, gdr;
  const uint32_t ful = gate(ul, dc, thr, gul), fuc = gate(uc, dc, thr, guc);
  const uint32_t fur = gate(ur, dc, thr, gur), fml = gate(ml, dc, thr, gml);
  const uint32_t fmr = gate(mr, dc, thr, gmr), fdl = gate(dl, dc, thr, gdl);
  const uint32_t fdm = gate(dm, dc, thr, gdm), fdr = gate(dr, dc, thr, gdr);
  // sum f sdx^2, sum f sdx sdy, sum f sdy^2, sum f sdx delta, sum f sdy delta
  // with sdx, sdy in {-5, 0, 5}; row y-5 is sdy = -5
  const uint32_t corners = ful + fur + fdl + fdr;
  const uint32_t A0 = 25u * (corners + fml + fmr);
  const uint32_t A3 = 25u * (corners + fuc + fdm);
  const uint32_t A1 = 25u * (ful + fdr - fur - fdl);
  const uint32_t b0 = 5u * ((gur + gmr + gdr) - (gul + gml + gdl));
  const uint32_t b1 = 5u * ((gdl + gdm + gdr) - (gul + guc + gur));
  const uint32_t det = A0 * A3 - A1 * A1;
  const uint32_t ddx = A3 * b0 - A1 * b1;
  const uint32_t ddy = A0 * b1 - A1 * b0;

  const float nx = __int2float_rn((int32_t)(1150u * ddx));
  const float ny = __int2float_rn((int32_t)(1150u * ddy));
  const float nz = __int2float_rn((int32_t)((0u - det) * (uint32_t)dc));
  const float norm = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)),
                                          __fmul_rn(nz, nz)));
  const float inv = __fdiv_rn(1.0f, norm);
  // truncation toward zero; saturating, so a masked NaN is not UB
  const int vx = __float2int_rz(__fadd_rn(__fmul_rn(__fmul_rn(nx, inv), 10.0f), 10.0f));
  const int vy = __float2int_rz(__fadd_rn(__fmul_rn(__fmul_rn(ny, inv), 10.0f), 10.0f));

  // arithmetic octant rule == the oracle's NORMAL_LUT (ops/lut.py)
  const float fcx = __int2float_rn(vx - 10);
  const float fcy = __int2float_rn(vy - 10);
  const float tan22 = 0.41421356f;
  const float acx = fabsf(fcx), acy = fabsf(fcy);
  const bool horiz = acy <= __fmul_rn(tan22, acx);
  const bool vert = acx <= __fmul_rn(tan22, acy);
  const int bin_h = fcx >= 0.0f ? 0 : 4;
  const int bin_v = fcy >= 0.0f ? 2 : 6;
  const int bin_d = fcy >= 0.0f ? (fcx >= 0.0f ? 1 : 3) : (fcx >= 0.0f ? 7 : 5);
  const int bin = horiz ? bin_h : (vert ? bin_v : bin_d);

  const bool valid = interior && dc < t.distance_threshold && norm > 0.0f;
  return valid ? 1u << (4 * bin) : 0u;
}

// The median code of a 5x5 window from its per-bin counts: lo holds the
// counts of bins 0, 2, 4, 6 and hi those of bins 1, 3, 5, 7 as 8-bit
// fields. The median is the first code, in the order 0, 1<<0 .. 1<<7,
// whose running count reaches 13 of 25.
__device__ __forceinline__ uint8_t median_code(uint32_t lo, uint32_t hi) {
  const uint32_t pairs = (lo + hi) * 0x01010101u;    // field j: bins 0 .. 2j+1
  const uint32_t zeros = 25u - (pairs >> 24);        // the count of code 0
  const uint32_t run_odd = pairs + zeros * 0x01010101u;  // through bins 1, 3, 5, 7
  const uint32_t run_even = run_odd - hi;                // through bins 0, 2, 4, 6
  // a field >= 13 sets its top bit after adding 128 - 13
  const uint32_t ge_even = (run_even + 0x73737373u) & 0x80808080u;
  const uint32_t ge_odd = (run_odd + 0x73737373u) & 0x80808080u;
  const uint32_t ge = (ge_even >> 1) | ge_odd;  // bits 8j+6: bin 2j, 8j+7: bin 2j+1
  if (zeros >= 13u) return 0;
  const int p = __ffs(ge) - 1;  // ge != 0: the last running count is 25
  return (uint8_t)(1u << (2 * (p >> 3) + (p & 1)));
}

// RH output rows of a strip (fewer at the frame's end): input rows y0-7 ..
// y_end+6, one step each
__global__ void __launch_bounds__(32 * WARPS)
dn_quantize_kernel(const int32_t* __restrict__ depth, uint8_t* __restrict__ out, int H,
                   int W, int RH, int distance_threshold, int difference_threshold,
                   int vec_in, int vec_out) {
  __shared__ int4 s_depth[WARPS][DROWS][32];
  __shared__ uint4 s_word[WARPS][QROWS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = (blockIdx.x * WARPS + warp) * SW;
  if (x0 >= W) return;  // the whole warp
  Strip t;
  t.depth = depth + (size_t)blockIdx.z * H * W;
  t.out = out + (size_t)blockIdx.z * H * W;
  t.H = H;
  t.W = W;
  t.cx0 = x0 - HALO + CPL * lane;
  t.vec_in = vec_in != 0;
  t.vec_out = vec_out != 0;
  t.distance_threshold = distance_threshold;
  t.difference_threshold = difference_threshold;
  const int y0 = blockIdx.y * RH;
  const int y_end = min(y0 + RH, H);
  bool col_interior[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    col_interior[c] = t.cx0 + c >= RING && t.cx0 + c < W - RING - 1;
  const bool col_out = lane >= HALO / CPL && lane < 32 - HALO / CPL && t.cx0 < W;

  int4(*dring)[32] = s_depth[warp];
  uint4(*qring)[32] = s_word[warp];
#pragma unroll
  for (int k = 0; k < QROWS; ++k) qring[k][lane] = make_uint4(0u, 0u, 0u, 0u);
  uint32_t vs[CPL] = {0u, 0u, 0u, 0u};  // one-hot words summed over the last 5 rows

  const int yi0 = y0 - RING - MED;
  int4 next = load_row(t, yi0);
  int dslot = 0;  // slot of input row yi in the depth ring: (yi - yi0) % DROWS
  int qslot = 0;  // slot of one-hot row yq: (yq - (y0 - MED)) % QROWS
  for (int yi = yi0; yi < y_end + RING + MED; ++yi) {
    const int4 dn = next;
    next = load_row(t, yi + 1);
    dring[dslot][lane] = dn;
    const int yq = yi - RING;  // the one-hot row this step completes
    if (yq >= y0 - MED) {
      uint32_t w[CPL] = {0u, 0u, 0u, 0u};
      // the oracle's interior: asymmetric -1 on the far edges
      if (yq >= RING && yq < H - RING - 1) {
        // rows yq-5 = yi-10 and yq = yi-5 of the lane's own columns
        const int4 up = dring[dslot + 1 < DROWS ? dslot + 1 : 0][lane];
        const int4 mid = dring[dslot + 6 < DROWS ? dslot + 6 : dslot + 6 - DROWS][lane];
        int32_t ul[CPL], ur[CPL], ml[CPL], mr[CPL], dl[CPL], dr[CPL];
        shift5(up, ul, ur);
        shift5(mid, ml, mr);
        shift5(dn, dl, dr);
        const int32_t uc[CPL] = {up.x, up.y, up.z, up.w};
        const int32_t mc[CPL] = {mid.x, mid.y, mid.z, mid.w};
        const int32_t dm[CPL] = {dn.x, dn.y, dn.z, dn.w};
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          w[c] = normal_word(t, col_interior[c], mc[c], ul[c], uc[c], ur[c], ml[c], mr[c],
                             dl[c], dm[c], dr[c]);
      }
      // slide the 5-row sums: the slot holds row yq-5, which leaves
      const uint4 old = qring[qslot][lane];
      qring[qslot][lane] = make_uint4(w[0], w[1], w[2], w[3]);
      vs[0] += w[0] - old.x;
      vs[1] += w[1] - old.y;
      vs[2] += w[2] - old.z;
      vs[3] += w[3] - old.w;
      qslot = qslot + 1 < QROWS ? qslot + 1 : 0;

      const int yo = yq - MED;  // the output row whose window is complete
      if (yo >= y0) {  // warp-uniform, so every lane takes part in the shuffles
        // the 8 column sums x-2 .. x+5 around the lane's 4 columns, split
        // into even and odd bins as 8-bit fields
        uint32_t s[CPL + 2 * MED];
        s[0] = __shfl_up_sync(FULL, vs[2], 1);
        s[1] = __shfl_up_sync(FULL, vs[3], 1);
        s[2] = vs[0];
        s[3] = vs[1];
        s[4] = vs[2];
        s[5] = vs[3];
        s[6] = __shfl_down_sync(FULL, vs[0], 1);
        s[7] = __shfl_down_sync(FULL, vs[1], 1);
        uint32_t lo[CPL + 2 * MED], hi[CPL + 2 * MED];
#pragma unroll
        for (int k = 0; k < CPL + 2 * MED; ++k) {
          lo[k] = s[k] & 0x0F0F0F0Fu;
          hi[k] = (s[k] >> 4) & 0x0F0F0F0Fu;
        }
        uint32_t cl = lo[0] + lo[1] + lo[2] + lo[3] + lo[4];
        uint32_t ch = hi[0] + hi[1] + hi[2] + hi[3] + hi[4];
        uint8_t code[CPL];
        code[0] = median_code(cl, ch);
#pragma unroll
        for (int c = 1; c < CPL; ++c) {
          cl += lo[c + 4] - lo[c - 1];
          ch += hi[c + 4] - hi[c - 1];
          code[c] = median_code(cl, ch);
        }
        if (col_out) {
          uint8_t* orow = t.out + (size_t)yo * W + t.cx0;
          if (t.vec_out && t.cx0 + CPL <= W) {
            *reinterpret_cast<uint32_t*>(orow) =
                code[0] | (code[1] << 8) | (code[2] << 16) | ((uint32_t)code[3] << 24);
          } else {
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              if (t.cx0 + c < W) orow[c] = code[c];
          }
        }
      }
    }
    dslot = dslot + 1 < DROWS ? dslot + 1 : 0;
  }
}

}  // namespace

extern "C" int odc_dn_quantize(const void* depth, void* out, int B, int H, int W,
                               int distance_threshold, int difference_threshold,
                               void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const int strips = odc::ceil_div(W, SW);
  // rows per warp: long walks amortise the warm-up (14 more rows loaded, 4
  // more computed), but the kernel needs warps to hide its latencies: at
  // B=32 x 480x640 on an H100, walks of 40 rows (17 warps an SM) took 0.18
  // ms, 60 rows 0.20 ms and 120 rows 0.31 ms. So the walk shortens until
  // the grid holds 16 warps per SM
  auto warps = [&](int rh) { return (long long)strips * odc::ceil_div(H, rh) * B; };
  int rh = 120;
  if (warps(rh) < 132 * 16) rh = 60;
  if (warps(rh) < 132 * 16) rh = 40;
  if (warps(rh) < 132 * 16) rh = 20;
  if (warps(rh) < 132 * 16) rh = 10;
  const dim3 grid(odc::ceil_div(strips, WARPS), odc::ceil_div(H, rh), B);
  const int vec_in = W % 4 == 0 && (reinterpret_cast<uintptr_t>(depth) & 15) == 0;
  const int vec_out = W % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  dn_quantize_kernel<<<grid, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)depth, (uint8_t*)out, H, W, rh, distance_threshold,
      difference_threshold, vec_in, vec_out);
  return (int)cudaGetLastError();
}
