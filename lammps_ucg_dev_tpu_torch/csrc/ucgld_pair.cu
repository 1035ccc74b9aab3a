// K1 — the table_ucgld pair kernel over column spans, for Hopper (sm_90a).
//
// Replaces the TPU kernel in lammps_ucg_dev_tpu/ops/pallas_pair.py:
// _kernel_colspan (and its window twin _kernel) with style="ucgld"; the
// per-candidate physics is that file's _phys_tile.  Its plain PyTorch twin
// is lammps_ucg_dev_tpu_torch/ops/hopper_pair.py:ucgld_pair_reference, which
// takes the same arguments and returns the same outputs.
//
// What it computes, for every real i-slot of the column list
// (ops/colpack.py): the i-slot's 8-slot cluster owns nine candidate spans
// [z0, z0+L), one per stencil column of the 3x3 x-y column stencil.  For
// each candidate j with 0 < rsq < cutsq:
//   u = max(rsq*uscale + uoff, -1)        (lower clamp only)
//   channel rows by the explicit Chebyshev recurrence
//     acc = c0 + c1*u;  T_k = 2u*T_{k-1} - T_{k-2};  acc += c_k*T_k
//   D-form 2x2 state mix: f += (fA + li fB + lj fC + li lj fD) * dr,
//   λ-force -= eB + lj eD, scores -= eA + sj eC and (eA+eB) + sj (eC+eD);
//   with OBSERVE also pe, the 6 virial components and the count of pairs
//   below the table's inner cutoff.
// Each thread owns one i-slot and writes its own output rows, so there are
// no atomics and the result is deterministic.  Invalid i-slots (pads and
// ghost-top copies in the real region) write zero rows.
//
// Pad slots hold positions at 1e17 (colpack._PAD_POISON); the cutoff test
// is a branch, so their never-evaluated series cannot leak inf/NaN into a
// tally.
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

#include <cuda_runtime.h>

namespace {

constexpr int kNsten = 9;
constexpr int kMaxRows = 16;   // raw rows of up to 8 tables (multi-type)
constexpr int kMaxDeg = 24;
constexpr int kBlock = 128;

template <int NR>
__device__ __forceinline__ float pick(const float (&acc)[NR], int id) {
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < NR; ++r) v = (r == id) ? acc[r] : v;
  return v;
}

// OBSERVE: also tally pe/virial/oob.  SCORES: tally the two score channels.
// MULTI: raw channel rows + per-(ti, tj) row table `cls` (up to 3 actual
// types); otherwise the host passes the D-form rows
// [eA eB eC eD fA fB fC fD] (or [eB eD fA fB fC fD] without scores).
template <bool OBSERVE, bool SCORES, bool MULTI>
__global__ void __launch_bounds__(kBlock)
ucgld_pair_kernel(const float* __restrict__ scal,
                  const int* __restrict__ span_z0,
                  const int* __restrict__ span_len,
                  const float* __restrict__ ipack,
                  const float* __restrict__ cols,
                  const float* __restrict__ coef,
                  const int* __restrict__ cls,
                  float* __restrict__ out,
                  float* __restrict__ part,
                  int n_slots, int mx, int my, int cz, int czp, int degree,
                  int ntab, int ntypes1) {
  constexpr int NR = MULTI ? kMaxRows : ((OBSERVE || SCORES) ? 8 : 6);
  __shared__ float c[NR * kMaxDeg];
  for (int k = threadIdx.x; k < NR * degree; k += blockDim.x) c[k] = coef[k];
  __syncthreads();

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_slots) return;

  const float4 ia = reinterpret_cast<const float4*>(ipack)[2 * t];
  const float4 ib = reinterpret_cast<const float4*>(ipack)[2 * t + 1];
  float fx = 0.f, fy = 0.f, fz = 0.f, lamf = 0.f, s0 = 0.f, s1 = 0.f;
  float pe = 0.f, v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f, v4 = 0.f,
        v5 = 0.f, oob = 0.f;

  if (ib.y > 0.5f) {   // i-slot holds a real atom
    const float xi = ia.x, yi = ia.y, zi = ia.z, li = ia.w;
    const int ti = static_cast<int>(ib.w);
    const float Lx = scal[0], Ly = scal[1], cutsq = scal[2];
    const float innersq = scal[3], uscale = scal[4], uoff = scal[5];
    const int cpc = cz >> 3;
    const int col = t / cz;
    const int b = (t - col * cz) >> 3;
    const int cx = col / my;
    const int cy = col - cx * my;
    const size_t sbase = (static_cast<size_t>(col) * cpc + b) * kNsten;

    for (int s = 0; s < kNsten; ++s) {
      const int len = span_len[sbase + s];
      if (len <= 0) continue;
      // stencil column and its periodic image shift (colpack.stencil)
      const int ax = cx + s / 3 - 1 + mx;
      const int ay = cy + s % 3 - 1 + my;
      const float shx = static_cast<float>(ax / mx - 1) * Lx;
      const float shy = static_cast<float>(ay / my - 1) * Ly;
      const float* cj =
          cols + static_cast<size_t>((ax % mx) * my + ay % my) * 8 * czp;
      const int j0 = span_z0[sbase + s];
      for (int j = j0; j < j0 + len; ++j) {
        const float dx = xi - (cj[j] + shx);
        const float dy = yi - (cj[czp + j] + shy);
        const float dz = zi - cj[2 * czp + j];
        const float rsq = dx * dx + dy * dy + dz * dz;
        if (!(rsq < cutsq && rsq > 0.f)) continue;
        if (OBSERVE && !(cj[5 * czp + j] > 0.5f)) continue;
        const float lj = cj[3 * czp + j];

        const float u = fmaxf(rsq * uscale + uoff, -1.f);
        const float u2 = u + u;
        float acc[NR];
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

        float eA, eB, eC = 0.f, eD, fA, fB, fC, fD;
        if constexpr (MULTI) {
          const int tj = static_cast<int>(cj[7 * czp + j]);
          const int* row = cls + (ti * ntypes1 + tj) * 4;
          const float e00 = pick(acc, row[0]), e01 = pick(acc, row[1]);
          const float e10 = pick(acc, row[2]), e11 = pick(acc, row[3]);
          const float f00 = pick(acc, row[0] < 0 ? -1 : ntab + row[0]);
          const float f01 = pick(acc, row[1] < 0 ? -1 : ntab + row[1]);
          const float f10 = pick(acc, row[2] < 0 ? -1 : ntab + row[2]);
          const float f11 = pick(acc, row[3] < 0 ? -1 : ntab + row[3]);
          eA = e00; eB = e10 - e00; eC = e01 - e00;
          eD = (e11 - e01) - (e10 - e00);
          fA = f00; fB = f10 - f00; fC = f01 - f00;
          fD = (f11 - f01) - (f10 - f00);
        } else if constexpr (OBSERVE || SCORES) {
          eA = acc[0]; eB = acc[1]; eC = acc[2]; eD = acc[3];
          fA = acc[4]; fB = acc[5]; fC = acc[6]; fD = acc[7];
        } else {
          eA = 0.f; eB = acc[0]; eD = acc[1];
          fA = acc[2]; fB = acc[3]; fC = acc[4]; fD = acc[5];
        }

        const float wD = li * lj;
        const float fmix = fA + li * fB + lj * fC + wD * fD;
        fx += fmix * dx;
        fy += fmix * dy;
        fz += fmix * dz;
        lamf -= eB + lj * eD;
        if constexpr (OBSERVE) {
          pe += eA + li * eB + lj * eC + wD * eD;
          v0 += fmix * dx * dx;
          v1 += fmix * dy * dy;
          v2 += fmix * dz * dz;
          v3 += fmix * dx * dy;
          v4 += fmix * dx * dz;
          v5 += fmix * dy * dz;
          if (rsq < innersq) oob += 1.f;
        }
        if constexpr (SCORES) {
          const float sj = cj[4 * czp + j];
          s0 -= eA + sj * eC;
          s1 -= (eA + eB) + sj * (eC + eD);
        }
      }
    }
  }

  float4* o = reinterpret_cast<float4*>(out) + 2 * t;
  o[0] = make_float4(fx, fy, fz, lamf);
  o[1] = make_float4(s0, s1, 0.f, 0.f);
  if constexpr (OBSERVE) {
    float4* p = reinterpret_cast<float4*>(part) + 2 * t;
    p[0] = make_float4(pe, v0, v1, v2);
    p[1] = make_float4(v3, v4, v5, oob);
  }
}

template <bool O, bool S, bool M>
void launch(const float* scal, const int* z0, const int* len,
            const float* ipack, const float* cols, const float* coef,
            const int* cls, float* out, float* part, int n_slots, int mx,
            int my, int cz, int czp, int degree, int ntab, int ntypes1,
            cudaStream_t stream) {
  const int grid = (n_slots + kBlock - 1) / kBlock;
  ucgld_pair_kernel<O, S, M><<<grid, kBlock, 0, stream>>>(
      scal, z0, len, ipack, cols, coef, cls, out, part, n_slots, mx, my, cz,
      czp, degree, ntab, ntypes1);
}

}  // namespace

// Returns 0 on success, else a cudaError_t code.  Variants: observe=1 with
// scores=1 (full), observe=0 with scores=1 (fast), observe=0 with scores=0
// (fast without scores).
extern "C" int ucgld_pair_launch(
    const float* scal, const int* span_z0, const int* span_len,
    const float* ipack, const float* cols, const float* coef, const int* cls,
    float* out, float* part, int n_slots, int mx, int my, int cz, int czp,
    int degree, int ntab, int ntypes1, int observe, int scores, int multi,
    void* stream) {
  if (degree < 2 || degree > kMaxDeg || (observe && !scores) || n_slots <= 0
      || (cz & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UCG_LAUNCH(O, S, M)                                                  \
  launch<O, S, M>(scal, span_z0, span_len, ipack, cols, coef, cls, out,      \
                  part, n_slots, mx, my, cz, czp, degree, ntab, ntypes1, st)
  if (multi) {
    if (observe) UCG_LAUNCH(true, true, true);
    else if (scores) UCG_LAUNCH(false, true, true);
    else UCG_LAUNCH(false, false, true);
  } else {
    if (observe) UCG_LAUNCH(true, true, false);
    else if (scores) UCG_LAUNCH(false, true, false);
    else UCG_LAUNCH(false, false, false);
  }
#undef UCG_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
