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
// D-form rows [eB eD fA fB fC fD].  Every level runs on K1's tile walk (one
// warp per 8-slot cluster, colspan::for_each_pair_tile); slots without a
// real atom write zero rows.  Output (n_slots, 8), per level:
//   L0  Σ over every candidate of the cluster's spans of x_j + its
//       column's image shift (column 0): the walk's span table and one
//       coalesced load per candidate and cluster, no test, no queue.  The
//       TPU's L0 timed its window DMAs; the port has no windows.
//   L1  + geometry, the test against the cluster's 8 i-slots, the queue
//       and the per-owner sums of full-warp batches: Σ rsq over
//       0 < rsq < cutsq (column 0).
//   L2  + the u map and the Chebyshev recurrence: Σ T_{degree-1}(u).
//   L3  + the six D-form accumulators: Σ (row 0 + row 5).
//   L4  + the D-form mix: fx fy fz lamf, K1's no-scores variant, from the
//       same definition (ucgld_phys.cuh), so bit-identical to it.
// Self is excluded by rsq > 0 (the walk's test), so L1–L4 are sums over
// pairs whatever the slot geometry.
//
// Bound: as K1 — operations from L2 on; L0/L1 are the walk's loads.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_lib.py).  Plain C entry point, loaded
// with ctypes; it returns cudaGetLastError() of the launch.

#include "ucgld_phys.cuh"

namespace {

using colspan::kFull;
using colspan::kMaxDeg;
using colspan::PairArgs;
using colspan::Tile;
using colspan::TileShared;

constexpr int kRows = 6;

// L1–L3: one value a pair.  odata unused.
template <int LEVEL>
struct AblationPair {
  static constexpr int NV = 1;
  const float* c;      // coefficient rows in shared memory
  int degree;
  float uscale, uoff;

  __device__ __forceinline__ void operator()(int, int, float, float, float,
                                             float rsq, float (&v)[1]) const {
    if constexpr (LEVEL == 1) {
      v[0] = rsq;
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
        v[0] = tm1;
      } else {
        float acc[kRows];
        colspan::series<kRows>(c, degree, u, acc);
        v[0] = acc[0] + acc[5];
      }
    }
  }
};

// L0: cluster cl's candidate sum, on every lane.
__device__ __forceinline__ float walk_floor(const PairArgs& a, int cl,
                                            int4* span) {
  const int lane = threadIdx.x & 31;
  const int total = colspan::tile_spans(a, cl, span);
  __syncwarp();
  float acc = 0.f;
  int s = 0;
  for (int k = lane; k < total; k += 32) {
    float shx, shy;
    const int jc = colspan::tile_offset(span, k, s, shx, shy);
    acc += a.cols[jc] + shx;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(kFull, acc, d);
  return acc;
}

template <int LEVEL>
struct Level {
  static constexpr int NV = LEVEL == 4 ? 4 : 1;
};

template <int LEVEL>
__global__ void __launch_bounds__(Tile<Level<LEVEL>::NV>::kThreads, 8)
ucgld_ablation_kernel(const __grid_constant__ PairArgs a) {
  constexpr int NV = Level<LEVEL>::NV;
  __shared__ float c[kRows * kMaxDeg];
  __shared__ TileShared<NV> tiles[Tile<NV>::kWarps];
  colspan::stage_coef(c, a.coef, kRows * a.degree);

  const int cl = blockIdx.x * Tile<NV>::kWarps + (threadIdx.x >> 5);
  if (cl >= (a.n_slots >> 3)) return;     // whole warps
  TileShared<NV>& sh = tiles[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (LEVEL == 4) {
    colspan::ucgld_tile<false, false, false>(a, c, cl, sh, r);
  } else {
    bool real = false;
    if (lane < 8) {
      float4 ia, ib;
      real = colspan::tile_owner(a.ipack, cl, sh, ia, ib);
    }
    if constexpr (LEVEL == 0) {
      const float sum = walk_floor(a, cl, sh.span);
      r[0] = real ? sum : 0.f;
    } else {
      const AblationPair<LEVEL> phys{c, a.degree, a.scal[4], a.scal[5]};
      colspan::for_each_pair_tile<false>(a, cl, sh, phys);
      if (lane < 8) r[0] = colspan::tile_sum(sh, lane, 0);
    }
  }
  if (lane >= 8) return;
  colspan::store_out(a.out, cl * 8 + lane,
                     make_float4(r[0], r[1], r[2], r[3]),
                     make_float4(0.f, 0.f, 0.f, 0.f));
}

template <int LEVEL>
void launch(const PairArgs& a, cudaStream_t stream) {
  constexpr int NV = Level<LEVEL>::NV;
  ucgld_ablation_kernel<LEVEL><<<colspan::tile_grid<NV>(a.n_slots),
                                 Tile<NV>::kThreads, 0, stream>>>(a);
}

}  // namespace

// Returns 0 on success, else a cudaError_t code.  level in 0..4.
extern "C" int ucgld_ablation_launch(
    const float* scal, const int* span_z0, const int* span_len,
    const float* ipack, const float* cols, const float* coef, float* out,
    int n_slots, int mx, int my, int cz, int czp, int degree, int level,
    void* stream) {
  if (degree < 2 || degree > kMaxDeg || n_slots <= 0 || (cz & 7) != 0
      || level < 0 || level > 4 || !colspan::tile_fits(mx, my, czp)) {
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
