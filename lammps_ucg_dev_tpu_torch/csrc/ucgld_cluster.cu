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
//   jcl    (n_icl, kc) int32 candidate j-clusters per i-cluster (pad n_icl)
//   coef   (8, degree) Chebyshev rows [e00 e01 e10 e11 f00 f01 f10 f11]
// Outputs: out (n_slots, 8) [fx fy fz lamf s0 s1 0 0] and part (n_slots, 8)
// [pe vxx vyy vzz vxy vxz vyz oob] per i-slot.
//
// What it computes, for every real i-slot over the 8 slots of each of its
// cluster's kc j-cluster entries: the min-image displacement
// d - L*rint(d/L) (rint rounds half to even, as jnp.round), and for a pair
// with rsq < cutsq, both slots real, a real jcl entry and distinct slot ids:
//   u = clip(2(rsq - lo)/(hi - lo) - 1, -1, 1), the eight table series by
//   Clenshaw, the λ-weighted energy and force mix w_ss' = w_i[s] w_j[s'],
//   the forces, pe, virial, inner-cutoff count, the λ-force
//   -(lj (e11 - e01) + (1 - lj)(e10 - e00)) and the pseudolikelihood scores
//   at the partner's discrete state.
// The pair test is a branch before the series, so nothing outside it
// reaches a tally (ROADMAP F2).
//
// Design: one thread per i-slot; a block holds 16 i-clusters (128 slots).
// The j-cluster rows are staged through shared memory 8 j-clusters per
// i-cluster at a time (the TPU kernel's jbuf), so the 8 threads of an
// i-cluster read each candidate row from shared memory, not from device
// memory.  Bound: operations — ~24 per candidate (3 IEEE divides, 3 rints)
// and ~24*degree + 60 per pair in the cutoff, against 32 bytes a candidate
// that is shared by 8 threads.  The sphere-pruned list still holds ~20
// candidates per pair; cutting that waste (smaller cells, a cutoff test
// per warp before the series) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_lib.py).  Plain C entry point, loaded
// with ctypes; it returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kCL = 8;         // slots per cluster
constexpr int kBI = 16;        // i-clusters per block
constexpr int kJC = 8;         // j-clusters staged per i-cluster per round
constexpr int kBlock = kBI * kCL;
constexpr int kMaxDeg = 24;
constexpr int kRows = 8;

__global__ void __launch_bounds__(kBlock)
ucgld_cluster_kernel(const float* __restrict__ scal,
                     const float* __restrict__ apack,
                     const int* __restrict__ jcl,
                     const float* __restrict__ coef, float* __restrict__ out,
                     float* __restrict__ part, int n_icl, int kc,
                     int degree) {
  // staged j rows: [x y z λ] and [state valid 0 gid-bits] per slot
  __shared__ float4 js[kBI * kJC * kCL * 2];
  __shared__ float c[kRows * kMaxDeg];
  for (int k = threadIdx.x; k < kRows * degree; k += kBlock) c[k] = coef[k];

  const int tid = threadIdx.x;
  const int ic = tid / kCL;
  const int icl = blockIdx.x * kBI + ic;
  const int t = icl * kCL + (tid % kCL);
  const bool active = icl < n_icl;
  const float4* ap = reinterpret_cast<const float4*>(apack);
  float4 ia = make_float4(0.f, 0.f, 0.f, 0.f), ib = ia;
  if (active) {
    ia = ap[2 * t];
    ib = ap[2 * t + 1];
  }
  const bool vi = active && ib.y > 0.5f;
  const float Lx = scal[0], Ly = scal[1], Lz = scal[2], cutsq = scal[3];
  const float innersq = scal[4], lo = scal[5], hi = scal[6];
  const float li = ia.w, mi = 1.f - li;

  float fx = 0.f, fy = 0.f, fz = 0.f, lamf = 0.f, s0 = 0.f, s1 = 0.f;
  float pe = 0.f, v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f, v4 = 0.f,
        v5 = 0.f, oob = 0.f;

  for (int k0 = 0; k0 < kc; k0 += kJC) {
    __syncthreads();   // the coefficients are in; the last round is read
    for (int e = tid; e < kBI * kJC * kCL; e += kBlock) {
      const int bi = e / (kJC * kCL);
      const int tt = (e / kCL) % kJC;
      const int lane = e % kCL;
      const int icl2 = blockIdx.x * kBI + bi;
      const int jid = icl2 < n_icl ? jcl[static_cast<size_t>(icl2) * kc
                                         + k0 + tt]
                                   : n_icl;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 b = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
      if (jid < n_icl) {
        const int g = jid * kCL + lane;
        a = ap[2 * g];
        b = ap[2 * g + 1];
        b.w = __int_as_float(g);
      }
      js[2 * e] = a;
      js[2 * e + 1] = b;
    }
    __syncthreads();
    if (!vi) continue;
    const float4* mine = js + 2 * ic * kJC * kCL;
#pragma unroll 1
    for (int q = 0; q < kJC * kCL; ++q) {
      const float4 b = mine[2 * q + 1];
      const int gj = __float_as_int(b.w);
      if (gj < 0 || gj == t || !(b.y > 0.5f)) continue;
      const float4 a = mine[2 * q];
      float dx = ia.x - a.x;
      dx -= Lx * rintf(dx / Lx);
      float dy = ia.y - a.y;
      dy -= Ly * rintf(dy / Ly);
      float dz = ia.z - a.z;
      dz -= Lz * rintf(dz / Lz);
      const float rsq = dx * dx + dy * dy + dz * dz;
      if (!(rsq < cutsq)) continue;

      const float u = fminf(fmaxf(2.f * (rsq - lo) / (hi - lo) - 1.f, -1.f),
                            1.f);
      const float u2 = u + u;
      float b1[kRows], b2[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) b1[r] = b2[r] = 0.f;
      for (int k = degree - 1; k > 0; --k) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float nb = u2 * b1[r] - b2[r] + c[r * degree + k];
          b2[r] = b1[r];
          b1[r] = nb;
        }
      }
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = u * b1[r] - b2[r] + c[r * degree];
      const float e00 = s[0], e01 = s[1], e10 = s[2], e11 = s[3];
      const float f00 = s[4], f01 = s[5], f10 = s[6], f11 = s[7];

      const float lj = a.w, mj = 1.f - lj;
      const float w00 = mi * mj, w01 = mi * lj, w10 = li * mj, w11 = li * lj;
      const float emix = w00 * e00 + w01 * e01 + w10 * e10 + w11 * e11;
      const float fmix = w00 * f00 + w01 * f01 + w10 * f10 + w11 * f11;
      fx += fmix * dx;
      fy += fmix * dy;
      fz += fmix * dz;
      pe += emix;
      v0 += fmix * dx * dx;
      v1 += fmix * dy * dy;
      v2 += fmix * dz * dz;
      v3 += fmix * dx * dy;
      v4 += fmix * dx * dz;
      v5 += fmix * dy * dz;
      if (rsq < innersq) oob += 1.f;
      lamf -= lj * (e11 - e01) + mj * (e10 - e00);
      const bool sj1 = b.x > 0.5f;
      s0 -= sj1 ? e01 : e00;
      s1 -= sj1 ? e11 : e10;
    }
  }

  if (!active) return;
  float4* o = reinterpret_cast<float4*>(out) + 2 * t;
  o[0] = make_float4(fx, fy, fz, lamf);
  o[1] = make_float4(s0, s1, 0.f, 0.f);
  float4* p = reinterpret_cast<float4*>(part) + 2 * t;
  p[0] = make_float4(pe, v0, v1, v2);
  p[1] = make_float4(v3, v4, v5, oob);
}

}  // namespace

// Returns 0 on success, else a cudaError_t code.
extern "C" int ucgld_cluster_launch(const float* scal, const float* apack,
                                    const int* jcl, const float* coef,
                                    float* out, float* part, int n_icl,
                                    int kc, int degree, void* stream) {
  if (degree < 2 || degree > kMaxDeg || n_icl <= 0 || kc <= 0
      || kc % kJC != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (n_icl + kBI - 1) / kBI;
  ucgld_cluster_kernel<<<grid, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      scal, apack, jcl, coef, out, part, n_icl, kc, degree);
  return static_cast<int>(cudaGetLastError());
}
