// K2 — the table_ucg_bethe pair kernel over column spans, for Hopper
// (sm_90a); beside it, on the compacting walk, K3 (the
// table_ucg_bethe_density pair pass) and K4 (the table_rleucg_interface
// pair pass).
//
// K2 replaces the TPU kernel in lammps_ucg_dev_tpu/ops/pallas_pair.py:
// _kernel_colspan (:719, and its window twin _kernel, :430) with
// style="bethe", as compute_bethe (:1433) calls it; the per-candidate
// physics is that file's _phys_tile (:260-283 closed form, :340-370
// scores).  Its plain PyTorch twin is
// lammps_ucg_dev_tpu_torch/ops/hopper_bethe.py:bethe_pair_reference, which
// takes the same arguments and returns the same outputs.  The tile walk,
// the Chebyshev series and the D-form channels are K1's (colspan.cuh).
//
// Inputs as K1's, with ipack attr 6 = pi1 (i-role prior, from ucgl), attr 3
// of the candidate columns = pj1 (j-role prior, from ucgp), attr 4 = the
// candidate's discrete state, scal[6] = kT.  Coefficients are always D-form
// rows: the 8 rows, or for several actual types the 8 rows of each ordered
// type pair.  For every real i-slot and candidate j with 0 < rsq < cutsq,
// in f32:
//   xk = min(-eD/kT, 40); bb = exp(xk); aa = bb - 1     (the TPU kernel's
//                                        f32 clamp and form, not expm1)
//   Q = (pi1 + pj1) aa + 1; D = max(Q^2 - 4 aa bb pi1 pj1, 0)
//   p11 = Q < 0 ? (Q - sqrt D) / (2 aa) : 2 bb pi1 pj1 / (Q + sqrt D),
//         pi1 pj1 when |aa| < 1e-5 or with MF (method mf)
//   f += (fA + pi1 fB + pj1 fC + p11 fD) * dr
//   scores: pseudolikelihood at the partner's state, s0 -= eA + sj eC,
//   s1 -= (eA+eB) + sj (eC+eD); or with SCE the conditional expectations
//   s0 -= c00 eA + c01 (eA+eC), s1 -= c10 (eA+eB) + c11 (eA+eB+eC+eD) with
//   c(sj|si) = p(si, sj) / max(p(si), 1e-6), where a partner of a plain
//   (1-state) type takes eA and eA+eB (ucg_mask says which types are UCG);
//   with OBSERVE also pe (eA + pi1 eB + pj1 eC + p11 eD), the virial and
//   the count of pairs below the table's inner cutoff.
// Outputs: out [fx fy fz 0 s0 s1 0 0] (no λ-force column: the Bethe style
// has none), part (observe).  Invalid i-slots write zero rows.
//
// Bound: as K1, FMA throughput — the closed form adds one exp, one sqrt and
// one division per in-cutoff pair (plus four divisions with SCE) to K1's
// ~10*degree+60 flops, against 32 bytes of broadcast j attributes.
// Design as K1: the tile walk (colspan::for_each_pair_tile), one warp per
// 8-slot i-cluster, each candidate loaded once per cluster and tested
// against its 8 i-slots, the in-cutoff pairs run 32 at a time on full
// warps with the owner's prior, SCE denominators and type from shared
// memory (odata); every variant (OBSERVE x MF x SCE x MULTI) on this one
// walk, no atomics, bit-identical over two launches.  expf, sqrtf and the
// divisions stay IEEE (no fast-math), with the f32 edges as they were: the
// exp clamp at 40, the |aa| < 1e-5 and Q < 0 branches (ROADMAP F3).
//
// K3 (STYLE kDBethe) replaces the same TPU kernels with style="dbethe",
// pass 2 of compute_density (:1633; physics :260-316, scores :366-370):
// K2's closed form on the density priors (attr 6 = pi1, candidates' attr 3
// = pj1, both the density prior P(state 1)), pseudolikelihood scores when
// SCORES, and the prior-force tallies of the i-slot:
//   lr = ln(p11/p01), stable: E = bb (pj1 - pi1) + (1 - pi1 - pj1),
//        Ds = sqrt(E^2 + 4 bb pi1 (1 - pi1)),
//        lr = E >= 0 ? xk + ln max(2 pi1, 1e-12) - ln max(E + Ds, 1e-12)
//                    : ln max(Ds - E, 1e-12) - ln max(2 (1 - pi1), 1e-12)
//        (MF: ln max(pi1, 1e-12) - ln max(1 - pi1, 1e-12))
//   UCG partner (ucg_mask bit of its type): pf1 -= (eB + eD) + kT lr
//   plain partner: pf0 -= eA + kT lp0, pf1 -= (eA + eB) + kT lp1, with
//        lp0 = ln max(1 - pi1, 1e-12), lp1 = ln max(pi1, 1e-12) per i-slot.
// Outputs: out [fx fy fz pf0 s0 s1 pf1 0], part (observe).
// K4 (STYLE kRleucg) replaces them with style="rleucg", pass 2 of
// compute_rleucg (:1844; :265-268, :317-320): mean-field p11 = pi1 pj1
// over the substate types (attr 6/3 = P(substate 1), always MULTI with
// the per-substate-type-pair rows), and with FEEDBACK pf0 += eB + pj1 eD.
// Outputs: out [fx fy fz pf0 0 0 0 0], part (observe).
//
// What bounds K3 and K4: operations.  At 2^20 beads on the density
// systems ~3.1e9 of their ~6-9e9 operations are the distance tests of
// 3.1e8 candidates; ~3e7 pairs (~10%) pass the cutoff and pay the series
// over their D-form rows, the closed form (one exp, a sqrt, a divide; K3
// one more sqrt and a log) and the tallies.  Both density systems have
// several actual types, so the design gives them what one type gets: the
// host changes basis to D-form per ordered type pair
// (ops/hopper_pair.kernel_rows), the block stages those rows in shared
// memory (<= 12.1 KB, T+1 <= 4) and each pair evaluates the rows of its
// own (ti, tj), with no per-pair select among raw table rows.  And as one
// thread per i-slot would run the pair body in ~97% of a warp's candidate
// steps for ~3 active lanes, the compacting walk of colspan.cuh queues
// in-cutoff pairs per warp and runs their physics 32 at a time, on full
// warps, each owner adding its entries back in walk order (deterministic,
// no atomics).  Tensor cores do not serve this kernel: the series is
// degree 6 in f32 per pair, and TF32's 10-bit mantissa would break the
// 2e-5 gate against the twin, so the FMA pipe is the resource.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_lib.py).  Plain C entry point, loaded
// with ctypes; it returns cudaGetLastError() of the launch.

#include "colspan.cuh"

namespace {

using colspan::kBlock;
using colspan::kFull;
using colspan::kMaxDeg;
using colspan::kMaxTypes1;
using colspan::PairArgs;
using colspan::Tile;

// The pair style: K2, K3 or K4.
enum Style : int { kBethe = 0, kDBethe = 1, kRleucg = 2 };

// The Bethe closed form (K2, K3): p11 of one pair, with xk and bb, which
// K3's log ratio reads (MF: p11 = pi1 pj1, xk = 0, bb = 1).
template <bool MF>
__device__ __forceinline__ float bethe_p11(float eD, float pi1, float pj1,
                                           float kT, float& xk, float& bb) {
  const float pipj = pi1 * pj1;
  xk = 0.f;
  bb = 1.f;
  if constexpr (MF) return pipj;
  // J = u11 + u00 - u01 - u10 is the D channel
  xk = fminf(-eD / kT, 40.f);
  bb = expf(xk);
  const float aa = bb - 1.f;
  const float Q = (pi1 + pj1) * aa + 1.f;
  const float D = fmaxf(Q * Q - 4.f * aa * bb * pipj, 0.f);
  const float sqD = sqrtf(D);
  if (fabsf(aa) < 1e-5f) return pipj;
  if (Q < 0.f) return (Q - sqD) / (2.f * aa);
  return 2.f * bb * pipj / (Q + sqD);
}

// K2: the physics of one queued pair on the tile walk.  Values: fx fy fz
// s0 s1, then with OBSERVE pe, the six virial sums and the inner-cutoff
// count.  Per-owner data odata[o] = [pi1, p0e, p1e, type_i] with the
// full-SCE denominators p0e = max(1 - pi1, 1e-6), p1e = max(pi1, 1e-6).
// MF: mean-field p11 = pi1 pj1.  SCE: full-SCE conditional-expectation
// scores (else pseudolikelihood).  MULTI: the D-form rows of each ordered
// type pair (ti, tj).
template <bool OBSERVE, bool MF, bool SCE, bool MULTI>
struct BethePair {
  static constexpr int NF = 5;
  static constexpr int NV = NF + (OBSERVE ? 8 : 0);

  const float* c;          // coefficient rows in shared memory
  const float* cols;
  const float4* odata;     // the warp's per-owner data in shared memory
  int degree, czp, ntypes1, ucg_mask;
  float kT, uscale, uoff, innersq;

  __device__ __forceinline__ void operator()(int o, int jc, float dx,
                                             float dy, float dz, float rsq,
                                             float (&v)[NV]) const {
    const float4 od = odata[o];
    const float pi1 = od.x;
    const float pj1 = cols[jc + 3 * czp];
    const int ti = MULTI ? static_cast<int>(od.w) : 0;
    const int tj = MULTI ? static_cast<int>(cols[jc + 7 * czp]) : 0;
    float acc[8];
    colspan::series<8>(colspan::pair_rows<MULTI>(c, degree, ntypes1, ti, tj),
                       degree, fmaxf(rsq * uscale + uoff, -1.f), acc);
    const colspan::Channels ch = colspan::channels<8>(acc);

    float xk, bb;
    const float p11 = bethe_p11<MF>(ch.eD, pi1, pj1, kT, xk, bb);
    const float fmix = ch.fA + pi1 * ch.fB + pj1 * ch.fC + p11 * ch.fD;
    v[0] = fmix * dx;
    v[1] = fmix * dy;
    v[2] = fmix * dz;
    if constexpr (SCE) {
      const float p00 = 1.f + p11 - pi1 - pj1;
      const float p01 = pj1 - p11;
      const float p10 = pi1 - p11;
      const float c00 = p00 / od.y, c01 = p01 / od.y;
      const float c10 = p10 / od.z, c11 = p11 / od.z;
      float sc0 = c00 * ch.eA + c01 * (ch.eA + ch.eC);
      float sc1 = c10 * (ch.eA + ch.eB)
                  + c11 * ((ch.eA + ch.eB) + (ch.eC + ch.eD));
      if (MULTI && !((ucg_mask >> tj) & 1)) {
        // a plain partner: the pseudolikelihood form at sj = 0
        sc0 = ch.eA;
        sc1 = ch.eA + ch.eB;
      }
      v[3] = -sc0;
      v[4] = -sc1;
    } else {
      const float sj = cols[jc + 4 * czp];
      v[3] = -(ch.eA + sj * ch.eC);
      v[4] = -((ch.eA + ch.eB) + sj * (ch.eC + ch.eD));
    }
    if constexpr (OBSERVE) {
      v[NF] = ch.eA + pi1 * ch.eB + pj1 * ch.eC + p11 * ch.eD;
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

// The fast variants at most 64 registers (8 blocks of 128 threads an SM).
template <bool OBSERVE, bool MF, bool SCE, bool MULTI, bool OPEN>
__global__ void __launch_bounds__(
    Tile<BethePair<OBSERVE, MF, SCE, MULTI>::NV>::kThreads, OBSERVE ? 1 : 8)
bethe_pair_kernel(const __grid_constant__ PairArgs a) {
  using Phys = BethePair<OBSERVE, MF, SCE, MULTI>;
  constexpr int NV = Phys::NV;
  __shared__ float one[MULTI ? 1 : 8 * kMaxDeg];
  extern __shared__ float pairs[];
  __shared__ colspan::TileShared<NV> tiles[Tile<NV>::kWarps];
  const float* c = colspan::stage_rows<MULTI>(one, pairs, a, 8);

  const int cl = blockIdx.x * Tile<NV>::kWarps + (threadIdx.x >> 5);
  if (cl >= (a.n_slots >> 3)) return;     // whole warps
  colspan::TileShared<NV>& sh = tiles[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  if (lane < 8) {
    float4 ia, ib;
    colspan::tile_owner(a.ipack, cl, sh, ia, ib);
    sh.odata[lane] = make_float4(ib.z, fmaxf(1.f - ib.z, 1e-6f),
                                 fmaxf(ib.z, 1e-6f), ib.w);
  }
  const Phys phys{c, a.cols, sh.odata, a.degree, a.czp, a.ntypes1,
                  a.ucg_mask, a.scal[6], a.scal[4], a.scal[5], a.scal[3]};
  colspan::for_each_pair_tile<OBSERVE, OPEN>(a, cl, sh, phys);
  if (lane >= 8) return;
  const int t = cl * 8 + lane;
  const auto r = [&](int k) { return colspan::tile_sum(sh, lane, k); };
  colspan::store_out(a.out, t, make_float4(r(0), r(1), r(2), 0.f),
                     make_float4(r(3), r(4), 0.f, 0.f));
  if constexpr (OBSERVE) {
    constexpr int o = Phys::NF;
    float4* p = reinterpret_cast<float4*>(a.part) + 2 * t;
    p[0] = make_float4(r(o), r(o + 1), r(o + 2), r(o + 3));
    p[1] = make_float4(r(o + 4), r(o + 5), r(o + 6), r(o + 7));
  }
}

// K3 and K4: the physics of one queued pair and the owner's tallies, for
// colspan::for_each_pair_compact.  Tallies: fx fy fz, then K3 pf0 pf1
// (and s0 s1 with SCORES), K4 pf0 with FEEDBACK; with OBSERVE then pe,
// the six virial sums and the inner-cutoff count.
template <bool OBSERVE, bool MF, bool MULTI, int STYLE, bool SCORES,
          bool FEEDBACK>
struct DensityPair {
  static constexpr int NF =
      STYLE == kDBethe ? (SCORES ? 7 : 5) : (FEEDBACK ? 4 : 3);
  static constexpr int NV = NF + (OBSERVE ? 8 : 0);

  // the owner's i-slot: its prior and type; K3 also lp0, lp1 and the
  // logs its closed-form log ratio takes of the prior alone,
  // l2p = ln max(2 pi1, 1e-12) and l2q = ln max(2 (1 - pi1), 1e-12)
  struct Owner {
    float pi1, lp0, lp1, l2p, l2q;
    int ti;
  };

  const float* c;      // coefficient rows in shared memory
  const float* cols;
  int degree, czp, ntypes1, ucg_mask;
  float kT, uscale, uoff, innersq;
  Owner own;           // this lane's i-slot
  float tally[NV];

  __device__ __forceinline__ Owner owner_of(int src) const {
    Owner o;
    o.pi1 = __shfl_sync(kFull, own.pi1, src);
    o.lp0 = STYLE == kDBethe ? __shfl_sync(kFull, own.lp0, src) : 0.f;
    o.lp1 = STYLE == kDBethe ? __shfl_sync(kFull, own.lp1, src) : 0.f;
    const bool ratio = STYLE == kDBethe && !MF;
    o.l2p = ratio ? __shfl_sync(kFull, own.l2p, src) : 0.f;
    o.l2q = ratio ? __shfl_sync(kFull, own.l2q, src) : 0.f;
    o.ti = MULTI ? __shfl_sync(kFull, own.ti, src) : 0;
    return o;
  }

  __device__ __forceinline__ void operator()(const Owner& o, int jc,
                                             float dx, float dy, float dz,
                                             float rsq,
                                             float (&v)[NV]) const {
    const float pi1 = o.pi1;
    const float pj1 = cols[jc + 3 * czp];
    const int tj = MULTI ? static_cast<int>(cols[jc + 7 * czp]) : 0;
    float acc[8];
    colspan::series<8>(colspan::pair_rows<MULTI>(c, degree, ntypes1, o.ti, tj),
                       degree, fmaxf(rsq * uscale + uoff, -1.f), acc);
    const colspan::Channels ch = colspan::channels<8>(acc);

    float xk, bb;
    const float p11 = bethe_p11<MF || STYLE == kRleucg>(ch.eD, pi1, pj1, kT,
                                                       xk, bb);
    const float fmix = ch.fA + pi1 * ch.fB + pj1 * ch.fC + p11 * ch.fD;
    v[0] = fmix * dx;
    v[1] = fmix * dy;
    v[2] = fmix * dz;
    if constexpr (STYLE == kDBethe) {
      float lr;
      if constexpr (MF) {
        lr = o.lp1 - o.lp0;
      } else {
        const float Est = bb * (pj1 - pi1) + (1.f - pi1 - pj1);
        const float Dst = sqrtf(Est * Est + (4.f * bb) * (pi1 * (1.f - pi1)));
        const float L = logf(fmaxf(Est >= 0.f ? Est + Dst : Dst - Est, 1e-12f));
        lr = Est >= 0.f ? xk + o.l2p - L : L - o.l2q;
      }
      if (!MULTI || ((ucg_mask >> tj) & 1)) {
        v[3] = 0.f;                                   // UCG partner
        v[4] = -((ch.eB + ch.eD) + kT * lr);
      } else {
        v[3] = -(ch.eA + kT * o.lp0);                 // plain partner
        v[4] = -((ch.eA + ch.eB) + kT * o.lp1);
      }
      if constexpr (SCORES) {
        const float sj = cols[jc + 4 * czp];
        v[5] = -(ch.eA + sj * ch.eC);
        v[6] = -((ch.eA + ch.eB) + sj * (ch.eC + ch.eD));
      }
    } else if constexpr (FEEDBACK) {
      v[3] = ch.eB + pj1 * ch.eD;
    }
    if constexpr (OBSERVE) {
      v[NF] = ch.eA + pi1 * ch.eB + pj1 * ch.eC + p11 * ch.eD;
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

// The fast variants (nine launches of a path's ten a block) at most 64
// registers, so 8 blocks of 128 threads fit an SM (half its threads); the
// observing ones at most 102, which they need without spilling.
template <bool OBSERVE, bool MF, bool MULTI, int STYLE, bool SCORES,
          bool FEEDBACK, bool OPEN>
__global__ void __launch_bounds__(kBlock, OBSERVE ? 5 : 8)
density_pair_kernel(const __grid_constant__ PairArgs a) {
  using Phys = DensityPair<OBSERVE, MF, MULTI, STYLE, SCORES, FEEDBACK>;
  __shared__ float one[MULTI ? 1 : 8 * kMaxDeg];
  extern __shared__ float pairs[];
  __shared__ colspan::PairQueue queue[kBlock / 32];
  const float* c = colspan::stage_rows<MULTI>(one, pairs, a, 8);

  // every lane of the block walks (the compacting walk needs whole warps);
  // lanes past the last slot walk nothing and store nothing
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = t < a.n_slots;
  float4 ia = make_float4(0.f, 0.f, 0.f, 0.f), ib = ia;
  if (in) {
    ia = reinterpret_cast<const float4*>(a.ipack)[2 * t];
    ib = reinterpret_cast<const float4*>(a.ipack)[2 * t + 1];
  }
  Phys ph;
  ph.c = c;
  ph.cols = a.cols;
  ph.degree = a.degree;
  ph.czp = a.czp;
  ph.ntypes1 = a.ntypes1;
  ph.ucg_mask = a.ucg_mask;
  ph.kT = a.scal[6];
  ph.innersq = a.scal[3];
  ph.uscale = a.scal[4];
  ph.uoff = a.scal[5];
  ph.own.pi1 = ib.z;
  ph.own.ti = static_cast<int>(ib.w);
  ph.own.lp0 = ph.own.lp1 = ph.own.l2p = ph.own.l2q = 0.f;
  if constexpr (STYLE == kDBethe) {
    ph.own.lp0 = logf(fmaxf(1.f - ib.z, 1e-12f));
    ph.own.lp1 = logf(fmaxf(ib.z, 1e-12f));
    if constexpr (!MF) {
      ph.own.l2p = logf(fmaxf(2.f * ib.z, 1e-12f));
      ph.own.l2q = logf(fmaxf(2.f * (1.f - ib.z), 1e-12f));
    }
  }
#pragma unroll
  for (int k = 0; k < Phys::NV; ++k) ph.tally[k] = 0.f;
  colspan::for_each_pair_compact<OBSERVE, OPEN>(
      a, t, in && ib.y > 0.5f, ia.x, ia.y, ia.z, queue[threadIdx.x >> 5],
      ph);
  if (!in) return;

  const float* r = ph.tally;
  if constexpr (STYLE == kDBethe) {
    colspan::store_out(a.out, t, make_float4(r[0], r[1], r[2], r[3]),
                       make_float4(SCORES ? r[5] : 0.f, SCORES ? r[6] : 0.f,
                                   r[4], 0.f));
  } else {
    colspan::store_out(a.out, t,
                       make_float4(r[0], r[1], r[2], FEEDBACK ? r[3] : 0.f),
                       make_float4(0.f, 0.f, 0.f, 0.f));
  }
  if constexpr (OBSERVE) {
    constexpr int o = Phys::NF;
    float4* p = reinterpret_cast<float4*>(a.part) + 2 * t;
    p[0] = make_float4(r[o], r[o + 1], r[o + 2], r[o + 3]);
    p[1] = make_float4(r[o + 4], r[o + 5], r[o + 6], r[o + 7]);
  }
}

template <bool O, bool F, bool S, bool M, bool OPEN>
void launch_o(const PairArgs& a, cudaStream_t stream) {
  constexpr int NV = BethePair<O, F, S, M>::NV;
  bethe_pair_kernel<O, F, S, M, OPEN><<<colspan::tile_grid<NV>(a.n_slots),
                                        Tile<NV>::kThreads,
                                        colspan::dyn_bytes<M>(a), stream>>>(
      a);
}

template <bool O, bool F, bool S, bool M>
void launch(const PairArgs& a, cudaStream_t stream) {
  if (a.periodic == 3) launch_o<O, F, S, M, false>(a, stream);
  else launch_o<O, F, S, M, true>(a, stream);
}

template <bool O, bool F, bool S>
void launch_m(bool multi, const PairArgs& a, cudaStream_t st) {
  if (multi) launch<O, F, S, true>(a, st);
  else launch<O, F, S, false>(a, st);
}

template <bool O, bool F>
void launch_sm(bool sce, bool multi, const PairArgs& a, cudaStream_t st) {
  if (sce) launch_m<O, F, true>(multi, a, st);
  else launch_m<O, F, false>(multi, a, st);
}

template <bool O>
void launch_fsm(bool mf, bool sce, bool multi, const PairArgs& a,
                cudaStream_t st) {
  if (mf) launch_sm<O, true>(sce, multi, a, st);
  else launch_sm<O, false>(sce, multi, a, st);
}

template <bool O, bool F, bool M, int STYLE, bool SC, bool FB>
void launch_density(const PairArgs& a, cudaStream_t stream) {
  if (a.periodic == 3) {
    density_pair_kernel<O, F, M, STYLE, SC, FB, false>
        <<<colspan::grid_of(a.n_slots), kBlock, colspan::dyn_bytes<M>(a),
           stream>>>(a);
  } else {
    density_pair_kernel<O, F, M, STYLE, SC, FB, true>
        <<<colspan::grid_of(a.n_slots), kBlock, colspan::dyn_bytes<M>(a),
           stream>>>(a);
  }
}

// K3: scores only with observe (checked by the entry point)
template <bool O, bool SC>
void launch_dbethe(bool mf, bool multi, const PairArgs& a, cudaStream_t st) {
  if (mf) {
    if (multi) launch_density<O, true, true, kDBethe, SC, false>(a, st);
    else launch_density<O, true, false, kDBethe, SC, false>(a, st);
  } else {
    if (multi) launch_density<O, false, true, kDBethe, SC, false>(a, st);
    else launch_density<O, false, false, kDBethe, SC, false>(a, st);
  }
}

// K4: mean-field, always MULTI, no scores
template <bool O>
void launch_rleucg(bool feedback, const PairArgs& a, cudaStream_t st) {
  if (feedback) launch_density<O, true, true, kRleucg, false, true>(a, st);
  else launch_density<O, true, true, kRleucg, false, false>(a, st);
}

// The checks both entry points share: degree, the slot layout, and for
// several actual types a row block that fits the shared memory.
bool bad_args(int n_slots, int cz, int czp, int mx, int my, int degree,
              int ntypes1, int multi) {
  return degree < 2 || degree > kMaxDeg || n_slots <= 0 || (cz & 7) != 0
         || static_cast<long long>(mx) * my * 8 * czp >= (1LL << 31)
         || (multi && (ntypes1 < 2 || ntypes1 > kMaxTypes1));
}

}  // namespace

// Returns 0 on success, else a cudaError_t code.  Variants: observe=1
// (full: forces, scores, pe, virial, oob) or observe=0 (fast: forces and
// scores), each with mf (method mf), sce (pseudo no) and multi (several
// actual types: coef holds the (ntypes1, ntypes1, 8, degree) rows, at most
// 4 x 4 pairs).  periodic, after the stream: bit 0 x, bit 1 y
// (colspan::PairArgs).
extern "C" int bethe_pair_launch(
    const float* scal, const int* span_z0, const int* span_len,
    const float* ipack, const float* cols, const float* coef, float* out,
    float* part, int n_slots, int mx, int my, int cz, int czp, int degree,
    int ntypes1, int ucg_mask, int observe, int mf, int sce, int multi,
    void* stream, int periodic) {
  if (bad_args(n_slots, cz, czp, mx, my, degree, ntypes1, multi)
      || !colspan::tile_fits(mx, my, czp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PairArgs a{scal, span_z0, span_len, ipack, cols, coef, out, part,
                   n_slots, mx, my, cz, czp, degree, multi ? ntypes1 : 0,
                   ucg_mask, periodic};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (observe) launch_fsm<true>(mf, sce, multi, a, st);
  else launch_fsm<false>(mf, sce, multi, a, st);
  return static_cast<int>(cudaGetLastError());
}

// K3 (style 1) and K4 (style 2).  Returns 0 on success, else a cudaError_t
// code.  K3 variants: observe=1 with scores (full), observe=0 with or
// without scores (fast, fast without scores), each with mf and multi.  K4:
// observe=1 (full) or 0 (fast), with or without feedback; multi required.
// periodic as for bethe_pair_launch.
extern "C" int density_pair_launch(
    const float* scal, const int* span_z0, const int* span_len,
    const float* ipack, const float* cols, const float* coef, float* out,
    float* part, int n_slots, int mx, int my, int cz, int czp, int degree,
    int ntypes1, int ucg_mask, int style, int observe, int mf, int scores,
    int feedback, int multi, void* stream, int periodic) {
  if (bad_args(n_slots, cz, czp, mx, my, degree, ntypes1, multi)
      || (style == kDBethe && observe && !scores)
      || (style == kRleucg && (!multi || scores))
      || (style != kDBethe && style != kRleucg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PairArgs a{scal, span_z0, span_len, ipack, cols, coef, out, part,
                   n_slots, mx, my, cz, czp, degree, multi ? ntypes1 : 0,
                   ucg_mask, periodic};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (style == kDBethe) {
    if (observe) launch_dbethe<true, true>(mf, multi, a, st);
    else if (scores) launch_dbethe<false, true>(mf, multi, a, st);
    else launch_dbethe<false, false>(mf, multi, a, st);
  } else {
    if (observe) launch_rleucg<true>(feedback, a, st);
    else launch_rleucg<false>(feedback, a, st);
  }
  return static_cast<int>(cudaGetLastError());
}
