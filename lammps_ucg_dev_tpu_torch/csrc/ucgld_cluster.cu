// K8 — the table_ucgld pair kernel over cluster lists, for Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel of attic/pallas_ucgld.py (the JAX
// package's round-1 cluster-list kernel).  Its plain PyTorch twin is
// lammps_ucg_dev_tpu_torch/ops/hopper_cluster.py:ucgld_cluster_reference,
// which takes the same arguments and returns the same outputs.
//
// Inputs (ops/clusters.py, ops/hopper_cluster.py):
//   scal   (8,) f32 [Lx Ly Lz cutsq innersq lo hi 0]
//   apack  (n_slots, 8) f32 slot rows [x y z λ state valid gid 0]
//   jcl    (n_icl, kc) int32 candidate j-clusters per i-cluster, each row's
//          real entries first, then pads (n_icl) (clusters.build)
//   coef   (8, degree) Chebyshev rows [e00 e01 e10 e11 f00 f01 f10 f11]
//   occupied (n_occ,) int32 the i-clusters that hold atoms, ascending
// Outputs: out (n_slots, 8) [fx fy fz lamf s0 s1 0 0] and part (n_slots, 8)
// [pe vxx vyy vzz vxy vxz vyz oob] per i-slot.
//
// What it computes, for every real i-slot over the 8 slots of each of its
// cluster's j-cluster entries: the min-image displacement
// d - L*rint(d/L) (rint rounds half to even, as jnp.round), and for a pair
// with rsq < cutsq, both slots real, a real jcl entry and distinct slot ids:
//   u = clip(2(rsq - lo)/(hi - lo) - 1, -1, 1), the eight table series,
//   the λ-weighted energy and force mix w_ss' = w_i[s] w_j[s'], the
//   forces, pe, virial, inner-cutoff count, the λ-force
//   -(lj (e11 - e01) + (1 - lj)(e10 - e00)) and the pseudolikelihood scores
//   at the partner's discrete state.  That is K1 full's function on the
//   D-form rows A = c00, B = c10 - c00, C = c01 - c00,
//   D = (c11 - c01) - (c10 - c00), which each block takes from the raw
//   rows in float64 as it stages them, so the physics is K1 full's
//   (ucgld_phys.cuh), with u clipped at 1 as well.
//
// Design: the tile walk of colspan.cuh (colspan::tile_walk), one warp per
// i-cluster that holds atoms: the grid covers `occupied` only (about a
// third of the i-clusters at 2^20, where a cell of 48 slots holds ~15
// atoms), and the warp of occupied[w] writes the zero rows of the empty
// i-clusters up to occupied[w+1].  The walk's source is the cluster's jcl
// row: it stops at the row's first pad (found by one ballot per 32
// entries, so the stop is warp-uniform), and each step takes 4 j-clusters,
// 32 candidate slots, one per lane, loaded coalesced from apack.  Each lane
// tests its candidate against the cluster's 8 i-slots, whose coordinates
// sit in registers (NaN for a slot without a real atom), with the minimum
// image taken once per candidate against a reference i-slot where that
// gives the per-pair image's bits (RowSource), by products with 1/L, not
// divisions; a pad slot gets NaN
// coordinates (F2: K8's pad slots are zeros with valid 0, not poisoned, so
// the validity test stays in the hit test), and the slot-id test keeps the
// pair rule gj != t.  The in-cutoff pairs queue and run 32 at a time on
// full warps; each owner's sums are added in a fixed order, so two
// launches on the same inputs give identical bits.
//
// Bound: operations — ~17 per (candidate, i-slot) test against ~140 per
// in-cutoff pair (K1 full's), and ~10% of the candidates pass.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_lib.py).  Plain C entry point, loaded
// with ctypes; it returns cudaGetLastError() of the launch.

#include "ucgld_phys.cuh"

namespace {

using colspan::kFull;
using colspan::kMaxDeg;
using colspan::Tile;
using colspan::TileShared;

constexpr int kCL = 8;         // slots per cluster

struct ClusterArgs {
  const float* scal;
  const float* apack;
  const int* jcl;
  const int* occupied;
  const float* coef;
  float* out;
  float* part;
  int n_icl, n_occ, kc, degree;
};

// K1 full's physics, on slot rows (czp 1), with K8's two-sided u clip.
using Phys = colspan::UcgldPair<true, true, false, true>;
constexpr int NV = Phys::NV;
constexpr int kWarps = Tile<NV>::kWarps;

// The tile walk's source over one jcl row of i-cluster `self`: candidate k
// is slot k & 7 of the row's entry k >> 3.  Its offset is the slot's row
// start in apack (8 gj), which is what Phys reads λ and the state from.
//
// The minimum image, d - L*rint(d/L) per axis as the twin takes it (L*rint
// is exact, so one rounding; d*(1/L) and d/L round to different integers
// only at |d| ~ L/2, where no image of the pair is within the cutoff).
// NEAR: the image k = rint((x_ref - x_j)/L) is taken once per candidate,
// against a reference i-slot x_ref of the cluster, and d = (x_o - x_j) - kL
// per pair.  When every real i-slot lies within 0.49 L - rc of x_ref on
// each axis (cluster_is_near), k equals the per-pair rint of every pair
// within the cutoff (|x_ref - x_j - kL| < rc + 0.49 L - rc), and a pair
// whose image differs has |d| >= L/2 > rc on that axis, so both forms keep
// the same pairs with the same bits.  Otherwise (a cluster spread over
// half the box) the image is taken per pair.
template <bool NEAR>
struct RowSource {
  const float* __restrict__ apack;
  const int* __restrict__ row;
  int self, total, selfo = -1;
  float Lx, Ly, Lz, iLx, iLy, iLz;
  float rx, ry, rz;                     // x_ref (NEAR)
  float kx = 0.f, ky = 0.f, kz = 0.f;   // the candidate's image (NEAR)

  // The row's entries up to its first pad, found 32 at a time (uniform).
  __device__ __forceinline__ RowSource(const ClusterArgs& a, int cl,
                                       float4 ref)
      : apack(a.apack), row(a.jcl + static_cast<size_t>(cl) * a.kc),
        self(cl), Lx(a.scal[0]), Ly(a.scal[1]), Lz(a.scal[2]),
        iLx(1.f / a.scal[0]), iLy(1.f / a.scal[1]), iLz(1.f / a.scal[2]),
        rx(ref.x), ry(ref.y), rz(ref.z) {
    const int lane = threadIdx.x & 31;
    int len = a.kc;
    for (int m = 0; m < a.kc; m += 32) {
      const int e = m + lane;
      const unsigned pad = __ballot_sync(kFull, e < a.kc && row[e] >= a.n_icl);
      if (pad) {
        len = m + __ffs(pad) - 1;
        break;
      }
    }
    total = len * kCL;
  }

  __device__ __forceinline__ int fetch(int k, float& xj, float& yj,
                                       float& zj) {
    const int jid = row[k >> 3];
    const int jl = k & 7;
    const int gj = jid * kCL + jl;
    const float4 p = reinterpret_cast<const float4*>(apack)[2 * gj];
    xj = p.x;
    yj = p.y;
    zj = p.z;
    if (!(apack[gj * 8 + 5] > 0.5f)) xj = __int_as_float(0x7fffffff);
    selfo = jid == self ? jl : -1;
    if constexpr (NEAR) {
      kx = rintf((rx - xj) * iLx);
      ky = rintf((ry - yj) * iLy);
      kz = rintf((rz - zj) * iLz);
    }
    return gj * 8;
  }

  __device__ __forceinline__ void disp(float ox, float oy, float oz,
                                       float xj, float yj, float zj,
                                       float& dx, float& dy,
                                       float& dz) const {
    dx = ox - xj;
    dy = oy - yj;
    dz = oz - zj;
    if constexpr (NEAR) {
      dx = fmaf(-Lx, kx, dx);
      dy = fmaf(-Ly, ky, dy);
      dz = fmaf(-Lz, kz, dz);
    } else {
      dx = fmaf(-Lx, rintf(dx * iLx), dx);
      dy = fmaf(-Ly, rintf(dy * iLy), dy);
      dz = fmaf(-Lz, rintf(dz * iLz), dz);
    }
  }

  // distinct slot ids: the candidate is i-slot o itself
  __device__ __forceinline__ bool keep(int o, float) const {
    return o != selfo;
  }
};

// The cluster's reference i-slot (its first real one; owner[0] when none)
// and whether every real i-slot lies within 0.49 L - rc of it on each
// axis (RowSource<true> then applies).  Uniform over the warp.
template <int NV>
__device__ __forceinline__ bool cluster_is_near(const ClusterArgs& a,
                                                const TileShared<NV>& sh,
                                                float4& ref) {
  const int lane = threadIdx.x & 31;
  const float4 o = sh.owner[lane & 7];
  const bool real = lane < 8 && o.x == o.x;    // NaN: no atom
  const unsigned m = __ballot_sync(kFull, real);
  ref = sh.owner[m ? __ffs(m) - 1 : 0];
  const float rc = sqrtf(a.scal[3]);
  const bool far = real && (fabsf(o.x - ref.x) >= 0.49f * a.scal[0] - rc
                            || fabsf(o.y - ref.y) >= 0.49f * a.scal[1] - rc
                            || fabsf(o.z - ref.z) >= 0.49f * a.scal[2] - rc);
  return __ballot_sync(kFull, far) == 0;
}

// The D-form rows [eA eB eC eD fA fB fC fD] of the raw rows
// [e00 e01 e10 e11 f00 f01 f10 f11], taken in float64 (dform_rows of
// ops/hopper_pair.py), into shared memory.
__device__ __forceinline__ void stage_dform(float* c, const float* coef,
                                            int degree) {
  for (int k = threadIdx.x; k < 8 * degree; k += blockDim.x) {
    const int r = k / degree;
    const int j = k - r * degree;
    const float* raw = coef + (r & 4) * degree + j;
    const double c00 = raw[0], c01 = raw[degree], c10 = raw[2 * degree],
                 c11 = raw[3 * degree];
    double v;
    switch (r & 3) {
      case 0: v = c00; break;
      case 1: v = c10 - c00; break;
      case 2: v = c01 - c00; break;
      default: v = (c11 - c01) - (c10 - c00); break;
    }
    c[k] = static_cast<float>(v);
  }
  __syncthreads();
}

// Zero rows (out and part) of i-clusters [c0, c1): one float4 a lane.
__device__ __forceinline__ void zero_rows(const ClusterArgs& a, int c0,
                                          int c1) {
  const int lane = threadIdx.x & 31;
  float4* dst = reinterpret_cast<float4*>(lane < 16 ? a.out : a.part);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = c0; c < c1; ++c) dst[c * 16 + (lane & 15)] = z;
}

__global__ void __launch_bounds__(Tile<NV>::kThreads, 1)
ucgld_cluster_kernel(const __grid_constant__ ClusterArgs a) {
  __shared__ float c[8 * kMaxDeg];
  __shared__ TileShared<NV> tiles[kWarps];
  stage_dform(c, a.coef, a.degree);

  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= a.n_occ) return;                // whole warps
  const int cl = a.occupied[w];
  if (w == 0) zero_rows(a, 0, cl);
  zero_rows(a, cl + 1, w + 1 < a.n_occ ? a.occupied[w + 1] : a.n_icl);

  TileShared<NV>& sh = tiles[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  if (lane < 8) {
    float4 ia, ib;
    colspan::tile_owner(a.apack, cl, sh, ia, ib);
    sh.odata[lane] = make_float4(ia.w, 0.f, 0.f, 0.f);
  }
  const float lo = a.scal[5], hi = a.scal[6];
  const float uscale = 2.f / (hi - lo);
  const Phys phys{c, a.apack, sh.odata, a.degree, 1, 0, uscale,
                  -1.f - lo * uscale, a.scal[4]};
  __syncwarp();                            // the owners
  float4 ref;
  if (cluster_is_near(a, sh, ref)) {
    RowSource<true> src(a, cl, ref);
    colspan::tile_walk(src, a.scal[3], sh, phys);
  } else {
    RowSource<false> src(a, cl, ref);
    colspan::tile_walk(src, a.scal[3], sh, phys);
  }
  if (lane >= 8) return;
  float r[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) r[k] = colspan::tile_sum(sh, lane, k);
  const int t = cl * kCL + lane;
  colspan::store_out(a.out, t, make_float4(r[0], r[1], r[2], r[3]),
                     make_float4(r[4], r[5], 0.f, 0.f));
  constexpr int o = Phys::NF;
  float4* p = reinterpret_cast<float4*>(a.part) + 2 * t;
  p[0] = make_float4(r[o], r[o + 1], r[o + 2], r[o + 3]);
  p[1] = make_float4(r[o + 4], r[o + 5], r[o + 6], r[o + 7]);
}

}  // namespace

// Returns 0 on success, else a cudaError_t code.  occupied and n_occ come
// after the stream, where builds of the entry point before them (which
// covered every i-cluster and take neither) ignore them, so
// tools/abtime.py can time both.
extern "C" int ucgld_cluster_launch(const float* scal, const float* apack,
                                    const int* jcl, const float* coef,
                                    float* out, float* part, int n_icl,
                                    int kc, int degree, void* stream,
                                    const int* occupied, int n_occ) {
  if (degree < 2 || degree > kMaxDeg || n_icl <= 0 || kc <= 0
      || n_occ <= 0 || n_occ > n_icl
      || static_cast<long long>(n_icl) * kCL * 8 >= (1LL << 28)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ClusterArgs a{scal, apack, jcl, occupied, coef, out, part,
                      n_icl, n_occ, kc, degree};
  const int grid = (n_occ + kWarps - 1) / kWarps;
  ucgld_cluster_kernel<<<grid, Tile<NV>::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
