// K2 — the table_ucg_bethe pair kernel over column spans, for Hopper
// (sm_90a); with it, as two more styles of the same tally, K3 (the
// table_ucg_bethe_density pair pass) and K4 (the table_rleucg_interface
// pair pass).
//
// Replaces the TPU kernel in lammps_ucg_dev_tpu/ops/pallas_pair.py:
// _kernel_colspan (:719, and its window twin _kernel, :430) with
// style="bethe", as compute_bethe (:1433) calls it; the per-candidate
// physics is that file's _phys_tile (:260-283 closed form, :340-370
// scores).  Its plain PyTorch twin is
// lammps_ucg_dev_tpu_torch/ops/hopper_bethe.py:bethe_pair_reference, which
// takes the same arguments and returns the same outputs.  The span walk,
// the Chebyshev series and the D-form channels are K1's (colspan.cuh).
//
// Inputs as K1's, with ipack attr 6 = pi1 (i-role prior, from ucgl), attr 3
// of the candidate columns = pj1 (j-role prior, from ucgp), attr 4 = the
// candidate's discrete state, scal[6] = kT.  Coefficients are always the 8
// D-form rows (or the raw rows with `cls` for several actual types).
// For every real i-slot and candidate j with 0 < rsq < cutsq, in f32:
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
// Design as K1: one thread per i-slot, no atomics, plain expf/sqrtf and
// IEEE division (no fast-math); making it fast is later work.
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
// the substate-type row table), and with FEEDBACK pf0 += eB + pj1 eD.
// Outputs: out [fx fy fz pf0 0 0 0 0], part (observe).  Both bound and
// built as K2; K3 adds per in-cutoff pair one sqrt and two logs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_lib.py).  Plain C entry point, loaded
// with ctypes; it returns cudaGetLastError() of the launch.

#include "colspan.cuh"

namespace {

using colspan::kBlock;
using colspan::kMaxDeg;
using colspan::kMaxRows;
using colspan::PairArgs;

// The pair style a tally computes: K2, K3 or K4.
enum Style : int { kBethe = 0, kDBethe = 1, kRleucg = 2 };

// The per-candidate physics of one i-slot and its tallies.  OBSERVE: also
// tally pe/virial/oob.  MF: mean-field p11 = pi1 pj1.  SCE: full-SCE
// conditional-expectation scores (else pseudolikelihood; K2 only).
// MULTI: raw channel rows + per-(ti, tj) row table `cls`.  STYLE: K2, K3
// or K4.  SCORES: K3 tallies scores.  FEEDBACK: K4 tallies pf0.
template <bool OBSERVE, bool MF, bool SCE, bool MULTI, int STYLE = kBethe,
          bool SCORES = true, bool FEEDBACK = false>
struct BetheTally {
  static constexpr int NR = MULTI ? kMaxRows : 8;
  const float* c;      // coefficient rows in shared memory
  const int* cls;
  int degree, czp, ntypes1, ntab, ti, ucg_mask;
  float pi1, p0e, p1e, kT, uscale, uoff, innersq;
  float lp0, lp1;      // K3: ln max(1 - pi1, 1e-12), ln max(pi1, 1e-12)
  float fx = 0.f, fy = 0.f, fz = 0.f, s0 = 0.f, s1 = 0.f, pf0 = 0.f,
        pf1 = 0.f;
  colspan::Observed obs;

  __device__ __forceinline__ void operator()(const float* cj, int j, float dx,
                                             float dy, float dz, float rsq) {
    const float pj1 = cj[3 * czp + j];
    float acc[NR];
    colspan::series<NR>(c, degree, fmaxf(rsq * uscale + uoff, -1.f), acc);
    const int tj = MULTI ? static_cast<int>(cj[7 * czp + j]) : 0;
    const colspan::Channels ch =
        colspan::channels<MULTI, NR>(acc, cls, ti, tj, ntypes1, ntab);

    const float pipj = pi1 * pj1;
    float p11, xk = 0.f, bb = 1.f;
    if constexpr (MF) {
      p11 = pipj;
    } else {
      // J = u11 + u00 - u01 - u10 is the D channel
      xk = fminf(-ch.eD / kT, 40.f);
      bb = expf(xk);
      const float aa = bb - 1.f;
      const float Q = (pi1 + pj1) * aa + 1.f;
      const float D = fmaxf(Q * Q - 4.f * aa * bb * pipj, 0.f);
      const float sqD = sqrtf(D);
      if (fabsf(aa) < 1e-5f) {
        p11 = pipj;
      } else if (Q < 0.f) {
        p11 = (Q - sqD) / (2.f * aa);
      } else {
        p11 = 2.f * bb * pipj / (Q + sqD);
      }
    }

    const float fmix = ch.fA + pi1 * ch.fB + pj1 * ch.fC + p11 * ch.fD;
    fx += fmix * dx;
    fy += fmix * dy;
    fz += fmix * dz;
    if constexpr (OBSERVE) {
      obs.add(ch.eA + pi1 * ch.eB + pj1 * ch.eC + p11 * ch.eD, fmix, dx, dy,
              dz, rsq < innersq);
    }
    if constexpr (STYLE == kDBethe) {
      float lr;
      if constexpr (MF) {
        lr = lp1 - lp0;
      } else {
        const float Est = bb * (pj1 - pi1) + (1.f - pi1 - pj1);
        const float Dst = sqrtf(Est * Est + (4.f * bb) * (pi1 * (1.f - pi1)));
        lr = Est >= 0.f
                 ? xk + logf(fmaxf(2.f * pi1, 1e-12f))
                       - logf(fmaxf(Est + Dst, 1e-12f))
                 : logf(fmaxf(Dst - Est, 1e-12f))
                       - logf(fmaxf(2.f * (1.f - pi1), 1e-12f));
      }
      if (!MULTI || ((ucg_mask >> tj) & 1)) {
        pf1 -= (ch.eB + ch.eD) + kT * lr;    // UCG partner
      } else {
        pf0 -= ch.eA + kT * lp0;             // plain partner
        pf1 -= (ch.eA + ch.eB) + kT * lp1;
      }
      if constexpr (SCORES) {
        const float sj = cj[4 * czp + j];
        s0 -= ch.eA + sj * ch.eC;
        s1 -= (ch.eA + ch.eB) + sj * (ch.eC + ch.eD);
      }
    } else if constexpr (STYLE == kRleucg) {
      if constexpr (FEEDBACK) pf0 += ch.eB + pj1 * ch.eD;
    } else if constexpr (SCE) {
      const float p00 = 1.f + p11 - pi1 - pj1;
      const float p01 = pj1 - p11;
      const float p10 = pi1 - p11;
      const float c00 = p00 / p0e, c01 = p01 / p0e;
      const float c10 = p10 / p1e, c11 = p11 / p1e;
      float sc0 = c00 * ch.eA + c01 * (ch.eA + ch.eC);
      float sc1 = c10 * (ch.eA + ch.eB)
                  + c11 * ((ch.eA + ch.eB) + (ch.eC + ch.eD));
      if (MULTI && !((ucg_mask >> tj) & 1)) {
        // a plain partner: the pseudolikelihood form at sj = 0
        sc0 = ch.eA;
        sc1 = ch.eA + ch.eB;
      }
      s0 -= sc0;
      s1 -= sc1;
    } else {
      const float sj = cj[4 * czp + j];
      s0 -= ch.eA + sj * ch.eC;
      s1 -= (ch.eA + ch.eB) + sj * (ch.eC + ch.eD);
    }
  }
};

template <bool OBSERVE, bool MF, bool SCE, bool MULTI, int STYLE = kBethe,
          bool SCORES = true, bool FEEDBACK = false>
__global__ void __launch_bounds__(kBlock)
bethe_pair_kernel(const __grid_constant__ PairArgs a) {
  using Tally =
      BetheTally<OBSERVE, MF, SCE, MULTI, STYLE, SCORES, FEEDBACK>;
  __shared__ float c[Tally::NR * kMaxDeg];
  colspan::stage_coef(c, a.coef, Tally::NR * a.degree);

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.n_slots) return;

  const float4 ia = reinterpret_cast<const float4*>(a.ipack)[2 * t];
  const float4 ib = reinterpret_cast<const float4*>(a.ipack)[2 * t + 1];
  Tally tal;
  if (ib.y > 0.5f) {   // i-slot holds a real atom
    tal.c = c;
    tal.cls = a.cls;
    tal.degree = a.degree;
    tal.czp = a.czp;
    tal.ntypes1 = a.ntypes1;
    tal.ntab = a.ntab;
    tal.ti = static_cast<int>(ib.w);
    tal.ucg_mask = a.ucg_mask;
    tal.pi1 = ib.z;
    tal.p0e = fmaxf(1.f - ib.z, 1e-6f);
    tal.p1e = fmaxf(ib.z, 1e-6f);
    tal.kT = a.scal[6];
    tal.innersq = a.scal[3];
    tal.uscale = a.scal[4];
    tal.uoff = a.scal[5];
    if constexpr (STYLE == kDBethe) {
      tal.lp0 = logf(fmaxf(1.f - ib.z, 1e-12f));
      tal.lp1 = logf(fmaxf(ib.z, 1e-12f));
    }
    colspan::for_each_pair<OBSERVE>(a, t, ia.x, ia.y, ia.z, tal);
  }

  // K2 leaves pf0 and pf1 at 0, K4 s0, s1 and pf1
  colspan::store_out(a.out, t, make_float4(tal.fx, tal.fy, tal.fz, tal.pf0),
                     make_float4(tal.s0, tal.s1, tal.pf1, 0.f));
  if constexpr (OBSERVE) tal.obs.store(a.part, t);
}

template <bool O, bool F, bool S, bool M, int STYLE = kBethe,
          bool SC = true, bool FB = false>
void launch(const PairArgs& a, cudaStream_t stream) {
  bethe_pair_kernel<O, F, S, M, STYLE, SC, FB>
      <<<colspan::grid_of(a.n_slots), kBlock, 0, stream>>>(a);
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

// K3: scores only with observe (checked by the entry point)
template <bool O, bool SC>
void launch_dbethe(bool mf, bool multi, const PairArgs& a, cudaStream_t st) {
  if (mf) {
    if (multi) launch<O, true, false, true, kDBethe, SC>(a, st);
    else launch<O, true, false, false, kDBethe, SC>(a, st);
  } else {
    if (multi) launch<O, false, false, true, kDBethe, SC>(a, st);
    else launch<O, false, false, false, kDBethe, SC>(a, st);
  }
}

// K4: mean-field, always MULTI, no scores
template <bool O>
void launch_rleucg(bool feedback, const PairArgs& a, cudaStream_t st) {
  if (feedback) launch<O, true, false, true, kRleucg, false, true>(a, st);
  else launch<O, true, false, true, kRleucg, false, false>(a, st);
}

}  // namespace

// Returns 0 on success, else a cudaError_t code.  Variants: observe=1
// (full: forces, scores, pe, virial, oob) or observe=0 (fast: forces and
// scores), each with mf (method mf), sce (pseudo no) and multi (several
// actual types, raw rows + cls).
extern "C" int bethe_pair_launch(
    const float* scal, const int* span_z0, const int* span_len,
    const float* ipack, const float* cols, const float* coef, const int* cls,
    float* out, float* part, int n_slots, int mx, int my, int cz, int czp,
    int degree, int ntab, int ntypes1, int ucg_mask, int observe, int mf,
    int sce, int multi, void* stream) {
  if (degree < 2 || degree > kMaxDeg || n_slots <= 0 || (cz & 7) != 0
      || (multi && (cls == nullptr || ntypes1 < 2 || ntypes1 > 31))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PairArgs a{scal, span_z0, span_len, ipack, cols, coef, cls, out,
                   part, n_slots, mx, my, cz, czp, degree, ntab, ntypes1,
                   ucg_mask};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (observe) launch_fsm<true>(mf, sce, multi, a, st);
  else launch_fsm<false>(mf, sce, multi, a, st);
  return static_cast<int>(cudaGetLastError());
}

// K3 (style 1) and K4 (style 2).  Returns 0 on success, else a cudaError_t
// code.  K3 variants: observe=1 with scores (full), observe=0 with or
// without scores (fast, fast without scores), each with mf and multi.  K4:
// observe=1 (full) or 0 (fast), with or without feedback; multi required.
extern "C" int density_pair_launch(
    const float* scal, const int* span_z0, const int* span_len,
    const float* ipack, const float* cols, const float* coef, const int* cls,
    float* out, float* part, int n_slots, int mx, int my, int cz, int czp,
    int degree, int ntab, int ntypes1, int ucg_mask, int style, int observe,
    int mf, int scores, int feedback, int multi, void* stream) {
  if (degree < 2 || degree > kMaxDeg || n_slots <= 0 || (cz & 7) != 0
      || (multi && (cls == nullptr || ntypes1 < 2 || ntypes1 > 31))
      || (style == kDBethe && observe && !scores)
      || (style == kRleucg && (!multi || scores))
      || (style != kDBethe && style != kRleucg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PairArgs a{scal, span_z0, span_len, ipack, cols, coef, cls, out,
                   part, n_slots, mx, my, cz, czp, degree, ntab, ntypes1,
                   ucg_mask};
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
