// Shared device code of the column-span pair kernels (K1 ucgld_pair.cu,
// K2 bethe_pair.cu): the walk over a cluster's nine candidate spans, the
// Chebyshev series of the table channels and the 2x2 state block in D-form.
// It is the counterpart of the split in lammps_ucg_dev_tpu/ops/pallas_pair.py
// between the span scaffolding (_kernel_colspan) and the per-candidate
// physics (_phys_tile), which each style fills in.
//
// Layout (ops/colpack.py):
//   scal   (8,) f32 [Lx Ly cutsq innersq uscale uoff kT 0]
//   z0, L  (ncol, cz/8, 9) int32 candidate span of each (column, cluster,
//          stencil column)
//   ipack  (n_slots, 8) f32 i-slot rows [x y z a3 state valid a6 typ]
//   cols   (ncol, 8, czp) f32 the same attributes over the extended slots,
//          attribute-major
//   coef   (rows, degree) Chebyshev rows (see channels())
//   cls    (T+1, T+1, 4) int32 raw row of each (00, 01, 10, 11) state pair
//          per ordered type pair (multi-type systems only)
//   out    (n_slots, 8) per-slot tallies; part (n_slots, 8) per-slot
//          [pe vxx vyy vzz vxy vxz vyz oob] (observing variants)
// One thread owns one i-slot and writes only its own rows: no atomics.

#pragma once

#include <cuda_runtime.h>

namespace colspan {

constexpr int kNsten = 9;
constexpr int kMaxRows = 16;   // raw rows of up to 8 tables (multi-type)
constexpr int kMaxDeg = 24;
constexpr int kBlock = 128;

struct PairArgs {
  const float* scal;
  const int* span_z0;
  const int* span_len;
  const float* ipack;
  const float* cols;
  const float* coef;
  const int* cls;
  float* out;
  float* part;
  int n_slots, mx, my, cz, czp, degree, ntab, ntypes1;
  int ucg_mask;   // bit t set: actual type t is a 2-state UCG type (K2)
};

// acc[id] without a dynamic register index (id < 0 gives 0)
template <int NR>
__device__ __forceinline__ float pick(const float (&acc)[NR], int id) {
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < NR; ++r) v = (r == id) ? acc[r] : v;
  return v;
}

// Copy the block's coefficient rows into shared memory.
__device__ __forceinline__ void stage_coef(float* c, const float* coef,
                                           int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) c[k] = coef[k];
  __syncthreads();
}

// acc[r] = sum_k c[r*degree+k] T_k(u) by the explicit recurrence
// T_k = 2u T_{k-1} - T_{k-2} (the TPU kernel's form, not Clenshaw).
template <int NR>
__device__ __forceinline__ void series(const float* c, int degree, float u,
                                       float (&acc)[NR]) {
  const float u2 = u + u;
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = c[r * degree] + c[r * degree + 1] * u;
  float tm2 = 1.f, tm1 = u;
  for (int k = 2; k < degree; ++k) {
    const float tk = u2 * tm1 - tm2;
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] += c[r * degree + k] * tk;
    tm2 = tm1;
    tm1 = tk;
  }
}

// The 2x2 state block in D-form: A = 00, B = 10-00, C = 01-00,
// D = (11-01)-(10-00), for energies (e) and f(r)/r (f).
struct Channels {
  float eA, eB, eC, eD, fA, fB, fC, fD;
};

// MULTI: raw rows [e_0..e_{T-1} f_0..f_{T-1}] and the row table `cls`;
// otherwise D-form rows [eA eB eC eD fA fB fC fD] (NR 8) or, without the
// energy-side A and C rows, [eB eD fA fB fC fD] (NR 6; eA = eC = 0).
template <bool MULTI, int NR>
__device__ __forceinline__ Channels channels(const float (&acc)[NR],
                                             const int* cls, int ti, int tj,
                                             int ntypes1, int ntab) {
  Channels ch;
  if constexpr (MULTI) {
    const int* row = cls + (ti * ntypes1 + tj) * 4;
    const float e00 = pick(acc, row[0]), e01 = pick(acc, row[1]);
    const float e10 = pick(acc, row[2]), e11 = pick(acc, row[3]);
    const float f00 = pick(acc, row[0] < 0 ? -1 : ntab + row[0]);
    const float f01 = pick(acc, row[1] < 0 ? -1 : ntab + row[1]);
    const float f10 = pick(acc, row[2] < 0 ? -1 : ntab + row[2]);
    const float f11 = pick(acc, row[3] < 0 ? -1 : ntab + row[3]);
    ch.eA = e00; ch.eB = e10 - e00; ch.eC = e01 - e00;
    ch.eD = (e11 - e01) - (e10 - e00);
    ch.fA = f00; ch.fB = f10 - f00; ch.fC = f01 - f00;
    ch.fD = (f11 - f01) - (f10 - f00);
  } else if constexpr (NR == 8) {
    ch.eA = acc[0]; ch.eB = acc[1]; ch.eC = acc[2]; ch.eD = acc[3];
    ch.fA = acc[4]; ch.fB = acc[5]; ch.fC = acc[6]; ch.fD = acc[7];
  } else {
    ch.eA = 0.f; ch.eB = acc[0]; ch.eC = 0.f; ch.eD = acc[1];
    ch.fA = acc[2]; ch.fB = acc[3]; ch.fC = acc[4]; ch.fD = acc[5];
  }
  return ch;
}

// Walk every candidate j of i-slot t at (xi, yi, zi): its 8-slot cluster
// owns nine spans [z0, z0+L), one per column of the 3x3 x-y stencil, each
// with that column's periodic image shift (colpack.stencil).  visit(cj, j,
// dx, dy, dz, rsq) runs for 0 < rsq < cutsq (and a valid j-slot when
// CHECK_VALID); cj[a*czp + j] is attribute a of the candidate.  The cutoff
// test is a branch, so the poisoned pad slots (1e17) never reach a tally.
// `visit` is a tally struct whose __forceinline__ operator() holds the
// style's physics, so its accumulators stay in registers.
template <bool CHECK_VALID, class Visit>
__device__ __forceinline__ void for_each_pair(const PairArgs& a, int t,
                                              float xi, float yi, float zi,
                                              Visit& visit) {
  const float* __restrict__ cols = a.cols;
  const float Lx = a.scal[0], Ly = a.scal[1], cutsq = a.scal[2];
  const int czp = a.czp, mx = a.mx, my = a.my;
  const int cpc = a.cz >> 3;
  const int col = t / a.cz;
  const int b = (t - col * a.cz) >> 3;
  const int cx = col / my;
  const int cy = col - cx * my;
  const size_t sbase = (static_cast<size_t>(col) * cpc + b) * kNsten;

  for (int s = 0; s < kNsten; ++s) {
    const int len = a.span_len[sbase + s];
    if (len <= 0) continue;
    const int ax = cx + s / 3 - 1 + mx;
    const int ay = cy + s % 3 - 1 + my;
    const float shx = static_cast<float>(ax / mx - 1) * Lx;
    const float shy = static_cast<float>(ay / my - 1) * Ly;
    const float* cj =
        cols + static_cast<size_t>((ax % mx) * my + ay % my) * 8 * czp;
    const int j0 = a.span_z0[sbase + s];
    for (int j = j0; j < j0 + len; ++j) {
      const float dx = xi - (cj[j] + shx);
      const float dy = yi - (cj[czp + j] + shy);
      const float dz = zi - cj[2 * czp + j];
      const float rsq = dx * dx + dy * dy + dz * dz;
      if (!(rsq < cutsq && rsq > 0.f)) continue;
      if (CHECK_VALID && !(cj[5 * czp + j] > 0.5f)) continue;
      visit(cj, j, dx, dy, dz, rsq);
    }
  }
}

// pe, virial and inner-cutoff count of one i-slot (observing variants).
struct Observed {
  float pe = 0.f, v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f, v4 = 0.f,
        v5 = 0.f, oob = 0.f;

  __device__ __forceinline__ void add(float emix, float fmix, float dx,
                                      float dy, float dz, bool inner) {
    pe += emix;
    v0 += fmix * dx * dx;
    v1 += fmix * dy * dy;
    v2 += fmix * dz * dz;
    v3 += fmix * dx * dy;
    v4 += fmix * dx * dz;
    v5 += fmix * dy * dz;
    if (inner) oob += 1.f;
  }

  __device__ __forceinline__ void store(float* part, int t) const {
    float4* p = reinterpret_cast<float4*>(part) + 2 * t;
    p[0] = make_float4(pe, v0, v1, v2);
    p[1] = make_float4(v3, v4, v5, oob);
  }
};

__device__ __forceinline__ void store_out(float* out, int t, float4 lo,
                                          float4 hi) {
  float4* o = reinterpret_cast<float4*>(out) + 2 * t;
  o[0] = lo;
  o[1] = hi;
}

inline int grid_of(int n_slots) { return (n_slots + kBlock - 1) / kBlock; }

}  // namespace colspan
