// K7 — the K1 ablation microbench kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel _abl_kernel of tools/kbench.py: K1's work at
// increasing physics levels, timed bare (inputs staged once), so the gap
// between K1's measured time and its bound can be split by level.  The
// plain PyTorch twins are in lammps_ucg_dev_tpu_torch/ops/hopper_ablation.py
// (ablation_reference), with the same arguments and outputs.
//
// Inputs are K1's without scores (colspan.cuh): scal [Lx Ly cutsq innersq
// uscale uoff 0 0], the (z0, L) spans, ipack, cols and the six single-type
// D-form rows [eB eD fA fB fC fD].  One thread owns one i-slot; invalid
// i-slots write zero rows.  Output (n_slots, 8), per level:
//   L0  Σ over every candidate of the span walk of x_j + its column's
//       image shift (column 0).  The TPU's L0 timed its window DMAs and
//       the xy shift; the port has no windows, so its L0 is the floor of
//       the span walk itself: the span reads, one load and one add per
//       candidate, no cutoff test.
//   L1  + geometry: Σ rsq over 0 < rsq < cutsq (column 0).
//   L2  + the u map and the Chebyshev recurrence: Σ T_{degree-1}(u).
//   L3  + the six D-form accumulators: Σ (row 0 + row 5).
//   L4  + the D-form mix: fx fy fz lamf, K1's no-scores variant.
// Self is excluded by rsq > 0 (the span walk's test), so L1–L4 are sums
// over pairs whatever the slot geometry.
//
// Bound: as K1 — operations from L2 on; L0/L1 are the walk's loads.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_lib.py).  Plain C entry point, loaded
// with ctypes; it returns cudaGetLastError() of the launch.

#include "colspan.cuh"

namespace {

using colspan::kBlock;
using colspan::kMaxDeg;
using colspan::kNsten;
using colspan::PairArgs;

constexpr int kRows = 6;

// L0: every candidate of the nine spans, no cutoff test.
__device__ __forceinline__ float walk_floor(const PairArgs& a, int t) {
  const int czp = a.czp, mx = a.mx, my = a.my;
  const int cpc = a.cz >> 3;
  const int col = t / a.cz;
  const int b = (t - col * a.cz) >> 3;
  const int cx = col / my;
  const int cy = col - cx * my;
  const size_t sbase = (static_cast<size_t>(col) * cpc + b) * kNsten;
  const float Lx = a.scal[0];
  float acc = 0.f;
  for (int s = 0; s < kNsten; ++s) {
    const int len = a.span_len[sbase + s];
    if (len <= 0) continue;
    const int ax = cx + s / 3 - 1 + mx;
    const int ay = cy + s % 3 - 1 + my;
    const float shx = static_cast<float>(ax / mx - 1) * Lx;
    const float* cj =
        a.cols + static_cast<size_t>((ax % mx) * my + ay % my) * 8 * czp;
    const int j0 = a.span_z0[sbase + s];
    for (int j = j0; j < j0 + len; ++j) acc += cj[j] + shx;
  }
  return acc;
}

template <int LEVEL>
struct AblationTally {
  const float* c;      // coefficient rows in shared memory
  int degree, czp;
  float li, uscale, uoff;
  float fx = 0.f, fy = 0.f, fz = 0.f, lamf = 0.f;

  __device__ __forceinline__ void operator()(const float* cj, int j, float dx,
                                             float dy, float dz, float rsq) {
    if constexpr (LEVEL == 1) {
      fx += rsq;
    } else {
      const float u = fmaxf(rsq * uscale + uoff, -1.f);
      if constexpr (LEVEL == 2) {
        const float u2 = u + u;
        float tm2 = 1.f, tm1 = u;
        for (int k = 2; k < degree; ++k) {
          const float tk = u2 * tm1 - tm2;
          tm2 = tm1;
          tm1 = tk;
        }
        fx += tm1;
      } else {
        float acc[kRows];
        colspan::series<kRows>(c, degree, u, acc);
        if constexpr (LEVEL == 3) {
          fx += acc[0] + acc[5];
        } else {
          // [eB eD fA fB fC fD]: K1's no-scores D-form
          const float lj = cj[3 * czp + j];
          const float fmix = acc[2] + li * acc[3] + lj * acc[4]
                             + (li * lj) * acc[5];
          fx += fmix * dx;
          fy += fmix * dy;
          fz += fmix * dz;
          lamf -= acc[0] + lj * acc[1];
        }
      }
    }
  }
};

template <int LEVEL>
__global__ void __launch_bounds__(kBlock)
ucgld_ablation_kernel(const __grid_constant__ PairArgs a) {
  __shared__ float c[kRows * kMaxDeg];
  colspan::stage_coef(c, a.coef, kRows * a.degree);

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.n_slots) return;
  const float4 ia = reinterpret_cast<const float4*>(a.ipack)[2 * t];
  const float4 ib = reinterpret_cast<const float4*>(a.ipack)[2 * t + 1];
  AblationTally<LEVEL> tal;
  if (ib.y > 0.5f) {   // i-slot holds a real atom
    if constexpr (LEVEL == 0) {
      tal.fx = walk_floor(a, t);
    } else {
      tal.c = c;
      tal.degree = a.degree;
      tal.czp = a.czp;
      tal.li = ia.w;
      tal.uscale = a.scal[4];
      tal.uoff = a.scal[5];
      colspan::for_each_pair<false>(a, t, ia.x, ia.y, ia.z, tal);
    }
  }
  colspan::store_out(a.out, t, make_float4(tal.fx, tal.fy, tal.fz, tal.lamf),
                     make_float4(0.f, 0.f, 0.f, 0.f));
}

template <int LEVEL>
void launch(const PairArgs& a, cudaStream_t stream) {
  ucgld_ablation_kernel<LEVEL>
      <<<colspan::grid_of(a.n_slots), kBlock, 0, stream>>>(a);
}

}  // namespace

// Returns 0 on success, else a cudaError_t code.  level in 0..4.
extern "C" int ucgld_ablation_launch(
    const float* scal, const int* span_z0, const int* span_len,
    const float* ipack, const float* cols, const float* coef, float* out,
    int n_slots, int mx, int my, int cz, int czp, int degree, int level,
    void* stream) {
  if (degree < 2 || degree > kMaxDeg || n_slots <= 0 || (cz & 7) != 0
      || level < 0 || level > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PairArgs a{scal, span_z0, span_len, ipack, cols, coef, out, nullptr,
                   n_slots, mx, my, cz, czp, degree, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (level) {
    case 0: launch<0>(a, st); break;
    case 1: launch<1>(a, st); break;
    case 2: launch<2>(a, st); break;
    case 3: launch<3>(a, st); break;
    default: launch<4>(a, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
