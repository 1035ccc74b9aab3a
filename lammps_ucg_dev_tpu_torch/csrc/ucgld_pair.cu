// K1 — the table_ucgld pair kernel over column spans, for Hopper (sm_90a).
//
// Replaces the TPU kernel in lammps_ucg_dev_tpu/ops/pallas_pair.py:
// _kernel_colspan (and its window twin _kernel) with style="ucgld"; the
// per-candidate physics is that file's _phys_tile.  Its plain PyTorch twin
// is lammps_ucg_dev_tpu_torch/ops/hopper_pair.py:ucgld_pair_reference, which
// takes the same arguments and returns the same outputs.  The span walk,
// the Chebyshev series and the D-form channels live in colspan.cuh, shared
// with K2–K4 (bethe_pair.cu).
//
// What it computes, for every real i-slot of the column list
// (ops/colpack.py), over each candidate j with 0 < rsq < cutsq:
//   u = max(rsq*uscale + uoff, -1)        (lower clamp only)
//   D-form 2x2 state mix: f += (fA + li fB + lj fC + li lj fD) * dr,
//   λ-force -= eB + lj eD, scores -= eA + sj eC and (eA+eB) + sj (eC+eD);
//   with OBSERVE also pe, the 6 virial components and the count of pairs
//   below the table's inner cutoff.
// Invalid i-slots (pads and ghost-top copies in the real region) write zero
// rows.  Outputs: out [fx fy fz lamf s0 s1 0 0], part (observe).
//
// Bound: FMA throughput.  A candidate inside the cutoff costs ~10*degree+60
// flops against 32 bytes of j attributes, and those bytes are a broadcast:
// the 8 threads of a cluster read the same addresses, and the column array
// (~50 MB at 2^20 atoms) mostly stays in L2.  wgmma and TMA do not apply:
// the work is a variable-length candidate loop with gathers, not a tiled
// matrix product.  Making it fast — staging a cluster's spans in shared
// memory, one warp per cluster, skipping the series for the ~90% of
// candidates outside the cutoff warp-wide — is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_lib.py).  Plain C entry point, loaded
// with ctypes; it returns cudaGetLastError() of the launch.

#include "colspan.cuh"

namespace {

using colspan::kBlock;
using colspan::kMaxDeg;
using colspan::PairArgs;

// The per-candidate physics of one i-slot and its tallies.  OBSERVE: also
// tally pe/virial/oob.  SCORES: tally the two score channels.  MULTI: the
// D-form rows [eA eB eC eD fA fB fC fD] of each ordered type pair (ti, tj)
// (up to 3 actual types); otherwise the host passes those 8 rows (or
// [eB eD fA fB fC fD] without scores).
template <bool OBSERVE, bool SCORES, bool MULTI>
struct UcgldTally {
  static constexpr int NR = (MULTI || OBSERVE || SCORES) ? 8 : 6;
  const float* c;      // coefficient rows in shared memory
  int degree, czp, ntypes1, ti;
  float li, uscale, uoff, innersq;
  float fx = 0.f, fy = 0.f, fz = 0.f, lamf = 0.f, s0 = 0.f, s1 = 0.f;
  colspan::Observed obs;

  __device__ __forceinline__ void operator()(const float* cj, int j, float dx,
                                             float dy, float dz, float rsq) {
    const float lj = cj[3 * czp + j];
    const int tj = MULTI ? static_cast<int>(cj[7 * czp + j]) : 0;
    float acc[NR];
    colspan::series<NR>(colspan::pair_rows<MULTI>(c, degree, ntypes1, ti, tj),
                        degree, fmaxf(rsq * uscale + uoff, -1.f), acc);
    const colspan::Channels ch = colspan::channels<NR>(acc);

    const float wD = li * lj;
    const float fmix = ch.fA + li * ch.fB + lj * ch.fC + wD * ch.fD;
    fx += fmix * dx;
    fy += fmix * dy;
    fz += fmix * dz;
    lamf -= ch.eB + lj * ch.eD;
    if constexpr (OBSERVE) {
      obs.add(ch.eA + li * ch.eB + lj * ch.eC + wD * ch.eD, fmix, dx, dy, dz,
              rsq < innersq);
    }
    if constexpr (SCORES) {
      const float sj = cj[4 * czp + j];
      s0 -= ch.eA + sj * ch.eC;
      s1 -= (ch.eA + ch.eB) + sj * (ch.eC + ch.eD);
    }
  }
};

template <bool OBSERVE, bool SCORES, bool MULTI>
__global__ void __launch_bounds__(kBlock)
ucgld_pair_kernel(const __grid_constant__ PairArgs a) {
  using Tally = UcgldTally<OBSERVE, SCORES, MULTI>;
  __shared__ float one[MULTI ? 1 : Tally::NR * kMaxDeg];
  extern __shared__ float pairs[];
  const float* c = colspan::stage_rows<MULTI>(one, pairs, a, Tally::NR);

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.n_slots) return;

  const float4 ia = reinterpret_cast<const float4*>(a.ipack)[2 * t];
  const float4 ib = reinterpret_cast<const float4*>(a.ipack)[2 * t + 1];
  Tally tal;
  if (ib.y > 0.5f) {   // i-slot holds a real atom
    tal.c = c;
    tal.degree = a.degree;
    tal.czp = a.czp;
    tal.ntypes1 = a.ntypes1;
    tal.ti = static_cast<int>(ib.w);
    tal.li = ia.w;
    tal.innersq = a.scal[3];
    tal.uscale = a.scal[4];
    tal.uoff = a.scal[5];
    colspan::for_each_pair<OBSERVE>(a, t, ia.x, ia.y, ia.z, tal);
  }

  colspan::store_out(a.out, t, make_float4(tal.fx, tal.fy, tal.fz, tal.lamf),
                     make_float4(tal.s0, tal.s1, 0.f, 0.f));
  if constexpr (OBSERVE) tal.obs.store(a.part, t);
}

template <bool O, bool S, bool M>
void launch(const PairArgs& a, cudaStream_t stream) {
  ucgld_pair_kernel<O, S, M><<<colspan::grid_of(a.n_slots), kBlock,
                               colspan::dyn_bytes<M>(a), stream>>>(a);
}

}  // namespace

// Returns 0 on success, else a cudaError_t code.  Variants: observe=1 with
// scores=1 (full), observe=0 with scores=1 (fast), observe=0 with scores=0
// (fast without scores); multi: several actual types, coef holds the
// (ntypes1, ntypes1, 8, degree) rows, at most 4 x 4 pairs.
extern "C" int ucgld_pair_launch(
    const float* scal, const int* span_z0, const int* span_len,
    const float* ipack, const float* cols, const float* coef, float* out,
    float* part, int n_slots, int mx, int my, int cz, int czp, int degree,
    int ntypes1, int observe, int scores, int multi, void* stream) {
  if (degree < 2 || degree > kMaxDeg || (observe && !scores) || n_slots <= 0
      || (cz & 7) != 0
      || (multi && (ntypes1 < 2 || ntypes1 > colspan::kMaxTypes1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PairArgs a{scal, span_z0, span_len, ipack, cols, coef, out, part,
                   n_slots, mx, my, cz, czp, degree, multi ? ntypes1 : 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (multi) {
    if (observe) launch<true, true, true>(a, st);
    else if (scores) launch<false, true, true>(a, st);
    else launch<false, false, true>(a, st);
  } else {
    if (observe) launch<true, true, false>(a, st);
    else if (scores) launch<false, true, false>(a, st);
    else launch<false, false, false>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}
