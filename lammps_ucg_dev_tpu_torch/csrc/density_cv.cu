// K5 and K6 — the geometry-only density-CV pair kernels over column spans,
// for Hopper (sm_90a).
//
// Replace the TPU kernels in lammps_ucg_dev_tpu/ops/pallas_pair.py:
// _kernel_cv_colspan (:944, and its window twin _kernel_cv, :795), whose
// per-candidate physics is _phys_cv_tile (:892-941), as compute_density
// (:1633) and compute_rleucg (:1844) call them in passes 1 and 3.  Their
// plain PyTorch twins are lammps_ucg_dev_tpu_torch/ops/hopper_cv.py:
// cv_rho_reference and cv_force_reference, which take the same arguments
// and return the same outputs.  Their walks are in colspan.cuh.
//
// Inputs as K1's (no coefficient rows): scal [Lx Ly cutsq ...], the spans,
// ipack rows [x y z c state valid c typ] and the extended columns; c is
// the per-atom CV weight cvf in pass 3 (attr 3 of the candidates, attr 6
// of the i-slot), typ (attr 7) the type that indexes `rad`, the proximity
// radius R per type (PERTYPE; K6 at most kMaxRad entries, K5 any number)
// or one radius rad[0] for every atom.
// For every real i-slot and candidate j with 0 < rsq < cutsq, in f32, with
// r = sqrt(rsq) and t_a = tanh((r - R_a) / (0.1 R_a)):
//   K5 (rho): rho += 0.5 (1 - t_i); n += 1            out (n_slots, 2)
//   K6 (cv):  g_a = -0.5 (1 - t_a^2) / (0.1 R_a)       (GFORM mder, -dw/dr)
//                   +0.5 (1 - t_a^2) / (0.1 R_a)       (GFORM pder, +dw/dr)
//                   0.5 (1 - t_a)                      (GFORM w)
//             fcv = (c_i g_i + c_j g_j) / r;  F += fcv dr   out (n_slots, 4)
//             [Fx Fy Fz 0]; with OBSERVE also the per-slot virial row in
//             [pe vxx vyy vzz vxy vxz vyz oob] layout (pe and oob 0), valid j
//             only.
// A plain type's radius is floored at 1e-12, so (r - R)/(0.1 R) ~ 1e13 and
// tanhf gives exactly 1: w = 0 and g = 0, as on the TPU.  Invalid i-slots
// write zero rows.
//
// Bound: FMA/SFU throughput — per in-cutoff pair one sqrt, one or two tanh
// and two or three divisions against 12-20 bytes of j attributes; ~90% of
// the candidates fail the cutoff test after 10 flops.  Both kernels run on
// the tile walk (colspan::for_each_pair_tile): one warp per 8-slot cluster,
// each candidate loaded once per cluster and tested against its 8 i-slots
// (K5 reads no attribute of j beyond x y z, and no validity), the in-cutoff
// pairs run 32 at a time on full warps, each lane's values summed into its
// own column of per-owner partial sums, added in a fixed order at the end
// (no atomics; two launches give the same bits).  Per pair one rsqrtf
// gives 1/r and r = rsq (1/r), and the divisions by 0.1 R become products
// with 1/(0.1 R), taken once per i-slot (the owner) and, in K6, once per
// type (the partner, a table in shared memory).  K5's count is a sum of
// ones in f32, exact below 2^24.  tanhf stays as the twin takes it; no
// fast-math flag.  K5's physics is so cheap that the walk sets its pace:
// two other ways of getting the hits to the physics (one prefix sum of the
// lanes' hit masks a step; no queue, each lane running its own hits) were
// slower on it (PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_lib.py).  Plain C entry point, loaded
// with ctypes; it returns cudaGetLastError() of the launch.

#include "colspan.cuh"

namespace {

using colspan::PairArgs;
using colspan::Tile;

constexpr int kMaxRad = 16;   // K6: entries of the per-type radius table

enum GForm : int { kMder = 0, kPder = 1, kW = 2 };

struct CvArgs {
  PairArgs p;          // coef unused; ntypes1 = entries of rad
  const float* rad;    // (ntypes1,) proximity radius per type
};

template <bool PERTYPE>
__device__ __forceinline__ float radius_of(const CvArgs& a, float tv) {
  if constexpr (PERTYPE) {
    const int t = min(max(static_cast<int>(tv), 0), a.p.ntypes1 - 1);
    return a.rad[t];
  } else {
    return a.rad[0];
  }
}

// K5: the physics of one hit on the tile walk.  Per-owner data odata[o] =
// [R_i, 1/(0.1 R_i), 0, 0].  Values: the weight w and 1 (the count).
struct RhoPair {
  static constexpr int NV = 2;

  const float4* odata;    // the warp's per-owner data in shared memory

  __device__ __forceinline__ void operator()(int o, int, float, float, float,
                                             float rsq,
                                             float (&v)[NV]) const {
    const float4 od = odata[o];
    const float r = rsq * rsqrtf(rsq);
    v[0] = 0.5f * (1.f - tanhf((r - od.x) * od.y));
    v[1] = 1.f;
  }
};

// K6: the physics of one queued pair on the tile walk.  Per-owner data
// odata[o] = [c_i, R_i, 1/(0.1 R_i), 0]; rad1[t] = [R_t, 1/(0.1 R_t)] per
// type (PERTYPE).  Values: Fx Fy Fz, then with OBSERVE the six virial sums.
template <int GFORM, bool OBSERVE, bool PERTYPE>
struct CvPair {
  static constexpr int NV = OBSERVE ? 9 : 3;

  const float* cols;
  const float4* odata;    // the warp's per-owner data in shared memory
  const float2* rad1;     // the per-type radii in shared memory
  int czp, ntypes1;

  // g of proximity weight tanh t at radius R, inv = 1/(0.1 R)
  __device__ __forceinline__ static float g(float t, float inv) {
    if constexpr (GFORM == kW) {
      return 0.5f * (1.f - t);
    } else {
      constexpr float sgn = GFORM == kMder ? -0.5f : 0.5f;
      return sgn * (1.f - t * t) * inv;
    }
  }

  __device__ __forceinline__ void operator()(int o, int jc, float dx,
                                             float dy, float dz, float rsq,
                                             float (&v)[NV]) const {
    const float4 od = odata[o];
    const float rinv = rsqrtf(rsq);
    const float r = rsq * rinv;
    const float gi = g(tanhf((r - od.y) * od.z), od.z);
    float gj = gi;
    if constexpr (PERTYPE) {
      const int t = min(max(static_cast<int>(cols[jc + 7 * czp]), 0),
                        ntypes1 - 1);
      const float2 rj = rad1[t];
      gj = g(tanhf((r - rj.x) * rj.y), rj.y);
    }
    const float fcv = (od.x * gi + cols[jc + 3 * czp] * gj) * rinv;
    v[0] = fcv * dx;
    v[1] = fcv * dy;
    v[2] = fcv * dz;
    if constexpr (OBSERVE) {
      v[3] = fcv * dx * dx;
      v[4] = fcv * dy * dy;
      v[5] = fcv * dz * dz;
      v[6] = fcv * dx * dy;
      v[7] = fcv * dx * dz;
      v[8] = fcv * dy * dz;
    }
  }
};

// K5: 56 registers, 4 warps a block (2 and 8 are slower, and so is
// capping the registers for more blocks: PERF.md §6).
template <bool PERTYPE, bool OPEN>
__global__ void __launch_bounds__(Tile<RhoPair::NV>::kThreads)
cv_rho_kernel(const __grid_constant__ CvArgs a) {
  constexpr int NV = RhoPair::NV;
  __shared__ colspan::TileShared<NV> tiles[Tile<NV>::kWarps];
  const int cl = blockIdx.x * Tile<NV>::kWarps + (threadIdx.x >> 5);
  if (cl >= (a.p.n_slots >> 3)) return;   // whole warps
  colspan::TileShared<NV>& sh = tiles[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  if (lane < 8) {
    float4 ia, ib;
    colspan::tile_owner(a.p.ipack, cl, sh, ia, ib);
    const float ri = radius_of<PERTYPE>(a, ib.w);
    sh.odata[lane] = make_float4(ri, 1.f / (0.1f * ri), 0.f, 0.f);
  }
  colspan::for_each_pair_tile<false, OPEN>(a.p, cl, sh, RhoPair{sh.odata});
  if (lane >= 8) return;
  reinterpret_cast<float2*>(a.p.out)[cl * 8 + lane] = make_float2(
      colspan::tile_sum(sh, lane, 0), colspan::tile_sum(sh, lane, 1));
}

// The fast variants at most 64 registers (8 blocks of 128 threads an SM).
template <int GFORM, bool OBSERVE, bool PERTYPE, bool OPEN>
__global__ void __launch_bounds__(
    Tile<CvPair<GFORM, OBSERVE, PERTYPE>::NV>::kThreads, OBSERVE ? 1 : 8)
cv_force_kernel(const __grid_constant__ CvArgs a) {
  using Phys = CvPair<GFORM, OBSERVE, PERTYPE>;
  constexpr int NV = Phys::NV;
  __shared__ colspan::TileShared<NV> tiles[Tile<NV>::kWarps];
  __shared__ float2 rad1[kMaxRad];
  const int nrad = PERTYPE ? a.p.ntypes1 : 1;
  for (int k = threadIdx.x; k < nrad; k += blockDim.x) {
    rad1[k] = make_float2(a.rad[k], 1.f / (0.1f * a.rad[k]));
  }
  __syncthreads();

  const int cl = blockIdx.x * Tile<NV>::kWarps + (threadIdx.x >> 5);
  if (cl >= (a.p.n_slots >> 3)) return;   // whole warps
  colspan::TileShared<NV>& sh = tiles[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  if (lane < 8) {
    float4 ia, ib;
    colspan::tile_owner(a.p.ipack, cl, sh, ia, ib);
    const int t = PERTYPE ? min(max(static_cast<int>(ib.w), 0), nrad - 1) : 0;
    sh.odata[lane] = make_float4(ib.z, rad1[t].x, rad1[t].y, 0.f);
  }
  const Phys phys{a.p.cols, sh.odata, rad1, a.p.czp, nrad};
  colspan::for_each_pair_tile<OBSERVE, OPEN>(a.p, cl, sh, phys);
  if (lane >= 8) return;
  const int t = cl * 8 + lane;
  const auto r = [&](int k) { return colspan::tile_sum(sh, lane, k); };
  reinterpret_cast<float4*>(a.p.out)[t] = make_float4(r(0), r(1), r(2), 0.f);
  if constexpr (OBSERVE) {
    float4* p = reinterpret_cast<float4*>(a.p.part) + 2 * t;
    p[0] = make_float4(0.f, r(3), r(4), r(5));
    p[1] = make_float4(r(6), r(7), r(8), 0.f);
  }
}

template <int G, bool O, bool OPEN>
void launch_cv_o(bool pertype, const CvArgs& a, cudaStream_t st) {
  constexpr int NV = CvPair<G, O, false>::NV;
  const int grid = colspan::tile_grid<NV>(a.p.n_slots);
  if (pertype) {
    cv_force_kernel<G, O, true, OPEN><<<grid, Tile<NV>::kThreads, 0, st>>>(
        a);
  } else {
    cv_force_kernel<G, O, false, OPEN><<<grid, Tile<NV>::kThreads, 0, st>>>(
        a);
  }
}

template <int G, bool O>
void launch_cv(bool pertype, const CvArgs& a, cudaStream_t st) {
  if (a.p.periodic == 3) launch_cv_o<G, O, false>(pertype, a, st);
  else launch_cv_o<G, O, true>(pertype, a, st);
}

template <bool OPEN>
void launch_rho(bool pertype, const CvArgs& a, cudaStream_t st) {
  constexpr int NV = RhoPair::NV;
  const int grid = colspan::tile_grid<NV>(a.p.n_slots);
  if (pertype) {
    cv_rho_kernel<true, OPEN><<<grid, Tile<NV>::kThreads, 0, st>>>(a);
  } else {
    cv_rho_kernel<false, OPEN><<<grid, Tile<NV>::kThreads, 0, st>>>(a);
  }
}

template <bool O>
void launch_cv_g(int gform, bool pertype, const CvArgs& a, cudaStream_t st) {
  if (gform == kMder) launch_cv<kMder, O>(pertype, a, st);
  else if (gform == kPder) launch_cv<kPder, O>(pertype, a, st);
  else launch_cv<kW, O>(pertype, a, st);
}

}  // namespace

// Returns 0 on success, else a cudaError_t code.  mode 0: K5 (rho; out
// (n_slots, 2), no part, observe must be 0); mode 1: K6 (cv; out
// (n_slots, 4), part (n_slots, 8) when observe) with gform 0 mder,
// 1 pder, 2 w.  pertype: the radius comes from rad[typ] (nrad entries, at
// most kMaxRad for K6, any number for K5), else rad[0] for every atom.
// Both walk the tile walk, so every cols offset shifted left by 3 must fit
// an int (colspan::tile_fits).  periodic, after the stream: bit 0 x, bit 1
// y (colspan::PairArgs).
extern "C" int density_cv_launch(
    const float* scal, const int* span_z0, const int* span_len,
    const float* ipack, const float* cols, const float* rad, float* out,
    float* part, int n_slots, int mx, int my, int cz, int czp, int nrad,
    int mode, int gform, int observe, int pertype,
    void* stream, int periodic) {
  if (n_slots <= 0 || (cz & 7) != 0 || nrad < 1 || rad == nullptr
      || mode < 0 || mode > 1 || gform < 0 || gform > 2
      || (mode == 0 && observe) || (observe && part == nullptr)
      || !colspan::tile_fits(mx, my, czp)
      || (mode == 1 && pertype && nrad > kMaxRad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CvArgs a{PairArgs{scal, span_z0, span_len, ipack, cols, nullptr, out,
                          part, n_slots, mx, my, cz, czp, 0, nrad, 0,
                          periodic},
                 rad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    if (periodic == 3) launch_rho<false>(pertype, a, st);
    else launch_rho<true>(pertype, a, st);
  } else if (observe) {
    launch_cv_g<true>(gform, pertype, a, st);
  } else {
    launch_cv_g<false>(gform, pertype, a, st);
  }
  return static_cast<int>(cudaGetLastError());
}
