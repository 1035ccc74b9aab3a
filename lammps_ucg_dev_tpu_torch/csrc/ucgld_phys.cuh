// The table_ucgld pair physics of one queued pair on the tile walk
// (colspan::tile_walk): K1's (ucgld_pair.cu) in every variant, K7's level
// 4 (ucgld_ablation.cu), which is K1 without scores and must stay
// bit-identical to it, so both compile this one definition, and K8's
// (ucgld_cluster.cu), which is K1 full on its cluster-list walk.
//
// For a pair (i, j) with 0 < rsq < cutsq, u = max(rsq*uscale + uoff, -1)
// (lower clamp only) and the D-form channels of the pair's rows:
//   f += (fA + li fB + lj fC + li lj fD) * dr,  λ-force -= eB + lj eD,
//   scores -= eA + sj eC and (eA+eB) + sj (eC+eD) (SCORES),
//   pe, the 6 virial sums and the count below the inner cutoff (OBSERVE).

#pragma once

#include "colspan.cuh"

namespace colspan {

// Values a pair adds, in order: fx fy fz lamf, then s0 s1 (SCORES), then
// pe, the six virial sums and the inner-cutoff count (OBSERVE).  Per-owner
// data odata[o] = [λ_i, type_i, 0, 0].  MULTI: the D-form rows
// [eA eB eC eD fA fB fC fD] of each ordered type pair (ti, tj); otherwise
// those 8 rows, or [eB eD fA fB fC fD] without observables and scores.
// The candidate's attribute a is cols[jc + a*czp] (K1's columns; K8 reads
// its slot rows with czp 1).  CLIP: u is also clipped at 1 from above (K8's
// u map; K1's clamps below only).
template <bool OBSERVE, bool SCORES, bool MULTI, bool CLIP = false>
struct UcgldPair {
  static constexpr int NR = (MULTI || OBSERVE || SCORES) ? 8 : 6;
  static constexpr int NF = SCORES ? 6 : 4;
  static constexpr int NV = NF + (OBSERVE ? 8 : 0);

  const float* c;          // coefficient rows in shared memory
  const float* cols;
  const float4* odata;     // the warp's per-owner data in shared memory
  int degree, czp, ntypes1;
  float uscale, uoff, innersq;

  __device__ __forceinline__ void operator()(int o, int jc, float dx,
                                             float dy, float dz, float rsq,
                                             float (&v)[NV]) const {
    const float4 od = odata[o];
    const float li = od.x;
    const float lj = cols[jc + 3 * czp];
    const int ti = MULTI ? static_cast<int>(od.y) : 0;
    const int tj = MULTI ? static_cast<int>(cols[jc + 7 * czp]) : 0;
    float u = fmaxf(rsq * uscale + uoff, -1.f);
    if constexpr (CLIP) u = fminf(u, 1.f);
    float acc[NR];
    series<NR>(pair_rows<MULTI>(c, degree, ntypes1, ti, tj), degree, u, acc);
    const Channels ch = channels<NR>(acc);

    const float wD = li * lj;
    const float fmix = ch.fA + li * ch.fB + lj * ch.fC + wD * ch.fD;
    v[0] = fmix * dx;
    v[1] = fmix * dy;
    v[2] = fmix * dz;
    v[3] = -(ch.eB + lj * ch.eD);
    if constexpr (SCORES) {
      const float sj = cols[jc + 4 * czp];
      v[4] = -(ch.eA + sj * ch.eC);
      v[5] = -((ch.eA + ch.eB) + sj * (ch.eC + ch.eD));
    }
    if constexpr (OBSERVE) {
      v[NF] = ch.eA + li * ch.eB + lj * ch.eC + wD * ch.eD;
      v[NF + 1] = fmix * dx * dx;
      v[NF + 2] = fmix * dy * dy;
      v[NF + 3] = fmix * dz * dz;
      v[NF + 4] = fmix * dx * dy;
      v[NF + 5] = fmix * dx * dz;
      v[NF + 6] = fmix * dy * dz;
      v[NF + 7] = rsq < innersq ? 1.f : 0.f;
    }
  }
};

// The kernel side of K1 and K7 L4 on the tile walk: the pair physics of
// ``a`` (rows ``c`` staged in shared memory), the owner data of cluster
// ``cl`` (lanes 0..7) and the walk; lanes 0..7 then hold their i-slot's
// sums in ``r`` (zero for a slot without a real atom).
template <bool OBSERVE, bool SCORES, bool MULTI, bool OPEN = false>
__device__ __forceinline__ void ucgld_tile(
    const PairArgs& a, const float* c, int cl,
    TileShared<UcgldPair<OBSERVE, SCORES, MULTI>::NV>& sh,
    float (&r)[UcgldPair<OBSERVE, SCORES, MULTI>::NV]) {
  using Phys = UcgldPair<OBSERVE, SCORES, MULTI>;
  const int lane = threadIdx.x & 31;
  if (lane < 8) {
    float4 ia, ib;
    tile_owner(a.ipack, cl, sh, ia, ib);
    sh.odata[lane] = make_float4(ia.w, ib.w, 0.f, 0.f);
  }
  const Phys phys{c, a.cols, sh.odata, a.degree, a.czp, a.ntypes1,
                  a.scal[4], a.scal[5], a.scal[3]};
  for_each_pair_tile<OBSERVE, OPEN>(a, cl, sh, phys);
  if (lane < 8) {
#pragma unroll
    for (int k = 0; k < Phys::NV; ++k) r[k] = tile_sum(sh, lane, k);
  }
}

}  // namespace colspan
