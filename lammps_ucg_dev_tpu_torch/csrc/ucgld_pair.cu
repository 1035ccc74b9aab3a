// K1 — the table_ucgld pair kernel over column spans, for Hopper (sm_90a).
//
// Replaces the TPU kernel in lammps_ucg_dev_tpu/ops/pallas_pair.py:
// _kernel_colspan (and its window twin _kernel) with style="ucgld"; the
// per-candidate physics is that file's _phys_tile.  Its plain PyTorch twin
// is lammps_ucg_dev_tpu_torch/ops/hopper_pair.py:ucgld_pair_reference, which
// takes the same arguments and returns the same outputs.  The tile walk,
// the Chebyshev series and the D-form channels live in colspan.cuh, shared
// with K2–K7; the pair physics in ucgld_phys.cuh, shared with K7's level 4.
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
// flops against 32 bytes of j attributes; ~90% of the candidates fail the
// cutoff test after ~10 flops.  wgmma and TMA do not apply: the work is a
// variable-length candidate loop with gathers, not a tiled matrix product.
// Design: the tile walk (colspan::for_each_pair_tile), one warp per 8-slot
// i-cluster.  Each candidate is loaded once per cluster, by coalesced
// loads, and tested against the cluster's 8 i-slots; the in-cutoff pairs
// queue in shared memory and their series and mix run 32 at a time, on
// full warps, so the ~90% of candidates outside the cutoff skip the series
// warp-wide.  Sums are taken in queue order: no atomics, and two launches
// on the same inputs give bit-identical outputs.  The fast variants stay
// at 64 registers (8 blocks of 128 threads an SM).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_lib.py).  Plain C entry point, loaded
// with ctypes; it returns cudaGetLastError() of the launch.

#include "ucgld_phys.cuh"

namespace {

using colspan::kMaxDeg;
using colspan::PairArgs;
using colspan::Tile;
using colspan::UcgldPair;

template <bool OBSERVE, bool SCORES, bool MULTI, bool OPEN>
__global__ void __launch_bounds__(
    Tile<UcgldPair<OBSERVE, SCORES, MULTI>::NV>::kThreads, OBSERVE ? 1 : 8)
ucgld_pair_kernel(const __grid_constant__ PairArgs a) {
  using Phys = UcgldPair<OBSERVE, SCORES, MULTI>;
  constexpr int NV = Phys::NV;
  __shared__ float one[MULTI ? 1 : Phys::NR * kMaxDeg];
  extern __shared__ float pairs[];
  __shared__ colspan::TileShared<NV> tiles[Tile<NV>::kWarps];
  const float* c = colspan::stage_rows<MULTI>(one, pairs, a, Phys::NR);

  const int cl = blockIdx.x * Tile<NV>::kWarps + (threadIdx.x >> 5);
  if (cl >= (a.n_slots >> 3)) return;     // whole warps
  float r[NV];
  colspan::ucgld_tile<OBSERVE, SCORES, MULTI, OPEN>(
      a, c, cl, tiles[threadIdx.x >> 5], r);
  const int lane = threadIdx.x & 31;
  if (lane >= 8) return;
  const int t = cl * 8 + lane;
  colspan::store_out(a.out, t, make_float4(r[0], r[1], r[2], r[3]),
                     make_float4(SCORES ? r[4] : 0.f, SCORES ? r[5] : 0.f,
                                 0.f, 0.f));
  if constexpr (OBSERVE) {
    constexpr int o = Phys::NF;
    float4* p = reinterpret_cast<float4*>(a.part) + 2 * t;
    p[0] = make_float4(r[o], r[o + 1], r[o + 2], r[o + 3]);
    p[1] = make_float4(r[o + 4], r[o + 5], r[o + 6], r[o + 7]);
  }
}

template <bool O, bool S, bool M, bool OPEN>
void launch_o(const PairArgs& a, cudaStream_t stream) {
  constexpr int NV = UcgldPair<O, S, M>::NV;
  ucgld_pair_kernel<O, S, M, OPEN><<<colspan::tile_grid<NV>(a.n_slots),
                                     Tile<NV>::kThreads,
                                     colspan::dyn_bytes<M>(a), stream>>>(a);
}

template <bool O, bool S, bool M>
void launch(const PairArgs& a, cudaStream_t stream) {
  if (a.periodic == 3) launch_o<O, S, M, false>(a, stream);
  else launch_o<O, S, M, true>(a, stream);
}

}  // namespace

// Returns 0 on success, else a cudaError_t code.  Variants: observe=1 with
// scores=1 (full), observe=0 with scores=1 (fast), observe=0 with scores=0
// (fast without scores); multi: several actual types, coef holds the
// (ntypes1, ntypes1, 8, degree) rows, at most 4 x 4 pairs.  periodic
// (after the stream, so builds without it ignore it): bit 0 x, bit 1 y
// (colspan::PairArgs).
extern "C" int ucgld_pair_launch(
    const float* scal, const int* span_z0, const int* span_len,
    const float* ipack, const float* cols, const float* coef, float* out,
    float* part, int n_slots, int mx, int my, int cz, int czp, int degree,
    int ntypes1, int observe, int scores, int multi,
    void* stream, int periodic) {
  if (degree < 2 || degree > kMaxDeg || (observe && !scores) || n_slots <= 0
      || (cz & 7) != 0 || !colspan::tile_fits(mx, my, czp)
      || (multi && (ntypes1 < 2 || ntypes1 > colspan::kMaxTypes1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PairArgs a{scal, span_z0, span_len, ipack, cols, coef, out, part,
                   n_slots, mx, my, cz, czp, degree, multi ? ntypes1 : 0, 0,
                   periodic};
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
