// Shared device code of the column-span pair kernels (K1 ucgld_pair.cu,
// K2–K4 bethe_pair.cu, and the walk of K5/K6 density_cv.cu and K7
// ucgld_ablation.cu): the walk over a cluster's nine candidate spans, the
// Chebyshev series of the table channels and the 2x2 state block in
// D-form, and the compacting walk of K3/K4.  It is the counterpart of the
// split in lammps_ucg_dev_tpu/ops/pallas_pair.py between the span
// scaffolding (_kernel_colspan) and the per-candidate physics (_phys_tile),
// which each style fills in.
//
// Layout (ops/colpack.py):
//   scal   (8,) f32 [Lx Ly cutsq innersq uscale uoff kT 0]
//   z0, L  (ncol, cz/8, 9) int32 candidate span of each (column, cluster,
//          stencil column)
//   ipack  (n_slots, 8) f32 i-slot rows [x y z a3 state valid a6 typ]
//   cols   (ncol, 8, czp) f32 the same attributes over the extended slots,
//          attribute-major
//   coef   Chebyshev rows (degree values each) in D-form, see channels():
//          one actual type, the 8 rows [eA eB eC eD fA fB fC fD] (or 6);
//          several, (T+1, T+1, 8, degree): the 8 rows of each ordered type
//          pair (ti, tj), zero where a state pair has no table
//   out    (n_slots, 8) per-slot tallies; part (n_slots, 8) per-slot
//          [pe vxx vyy vzz vxy vxz vyz oob] (observing variants)
// One thread owns one i-slot and writes only its own rows: no atomics.

#pragma once

#include <cuda_runtime.h>

namespace colspan {

constexpr int kNsten = 9;
constexpr int kMaxDeg = 24;
constexpr int kMaxTypes1 = 4;  // T+1 of the per-type-pair rows (3 types)
constexpr int kBlock = 128;

struct PairArgs {
  const float* scal;
  const int* span_z0;
  const int* span_len;
  const float* ipack;
  const float* cols;
  const float* coef;
  float* out;
  float* part;
  int n_slots, mx, my, cz, czp, degree;
  int ntypes1;    // T+1 of the per-type-pair rows (0: one actual type)
  int ucg_mask;   // bit t set: actual type t is a 2-state UCG type (K2–K4)
};

// The per-type-pair rows in shared memory: the 8 rows of pair (ti, tj)
// start at (ti (T+1) + tj) * pair_stride, an odd stride, so the rows of
// different pairs that the lanes of a warp read at once fall in different
// banks.  Dynamic shared memory of dyn_bytes, <= 12.1 KB.
__host__ __device__ constexpr int pair_stride(int degree) {
  return 8 * degree + 1;
}

// The dynamic shared memory of a launch: the per-type-pair rows (MULTI).
template <bool MULTI>
inline size_t dyn_bytes(const PairArgs& a) {
  return MULTI ? sizeof(float) * a.ntypes1 * a.ntypes1 * pair_stride(a.degree)
               : 0;
}

// The coefficient rows of ordered type pair (ti, tj) among the staged rows
// (MULTI: the per-type-pair rows; else the one set of rows).
template <bool MULTI>
__device__ __forceinline__ const float* pair_rows(const float* c, int degree,
                                                  int ntypes1, int ti,
                                                  int tj) {
  if constexpr (MULTI) return c + (ti * ntypes1 + tj) * pair_stride(degree);
  return c;
}

// Copy the block's coefficient rows into shared memory.
__device__ __forceinline__ void stage_coef(float* c, const float* coef,
                                           int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) c[k] = coef[k];
  __syncthreads();
}

// Copy the (T+1, T+1, 8, degree) rows into shared memory at pair_stride.
__device__ __forceinline__ void stage_pair_rows(float* c, const float* coef,
                                                int ntypes1, int degree) {
  const int per = 8 * degree;
  for (int k = threadIdx.x; k < ntypes1 * ntypes1 * per; k += blockDim.x) {
    const int p = k / per;
    c[p * (per + 1) + (k - p * per)] = coef[k];
  }
  __syncthreads();
}

// The coefficient rows of a kernel in shared memory: the one set of NR
// rows in `one` (static), or the per-type-pair rows in `pairs` (dynamic).
template <bool MULTI>
__device__ __forceinline__ float* stage_rows(float* one, float* pairs,
                                             const PairArgs& a, int nr) {
  if constexpr (MULTI) {
    stage_pair_rows(pairs, a.coef, a.ntypes1, a.degree);
    return pairs;
  }
  stage_coef(one, a.coef, nr * a.degree);
  return one;
}

// acc[r] = sum_k c[r*degree+k] T_k(u) by the explicit recurrence
// T_k = 2u T_{k-1} - T_{k-2} (the TPU kernel's form, not Clenshaw).
template <int NR>
__device__ __forceinline__ void series(const float* c, int degree, float u,
                                       float (&acc)[NR]) {
  const float u2 = u + u;
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
}

// The 2x2 state block in D-form: A = 00, B = 10-00, C = 01-00,
// D = (11-01)-(10-00), for energies (e) and f(r)/r (f).
struct Channels {
  float eA, eB, eC, eD, fA, fB, fC, fD;
};

// The rows of one ordered type pair: D-form rows [eA eB eC eD fA fB fC fD]
// (NR 8) or, without the energy-side A and C rows, [eB eD fA fB fC fD]
// (NR 6; eA = eC = 0).  The host takes the basis change in float64, so
// nothing is picked per pair; a variant's unused channels cost nothing
// (the compiler drops their accumulators).
template <int NR>
__device__ __forceinline__ Channels channels(const float (&acc)[NR]) {
  Channels ch;
  if constexpr (NR == 8) {
    ch.eA = acc[0]; ch.eB = acc[1]; ch.eC = acc[2]; ch.eD = acc[3];
    ch.fA = acc[4]; ch.fB = acc[5]; ch.fC = acc[6]; ch.fD = acc[7];
  } else {
    ch.eA = 0.f; ch.eB = acc[0]; ch.eC = 0.f; ch.eD = acc[1];
    ch.fA = acc[2]; ch.fB = acc[3]; ch.fC = acc[4]; ch.fD = acc[5];
  }
  return ch;
}

// Walk every candidate j of i-slot t at (xi, yi, zi): its 8-slot cluster
// owns nine spans [z0, z0+L), one per column of the 3x3 x-y stencil, each
// with that column's periodic image shift (colpack.stencil).  visit(cj, j,
// dx, dy, dz, rsq) runs for 0 < rsq < cutsq (and a valid j-slot when
// CHECK_VALID); cj[a*czp + j] is attribute a of the candidate.  The cutoff
// test is a branch, so the poisoned pad slots (1e17) never reach a tally.
// `visit` is a tally struct whose __forceinline__ operator() holds the
// style's physics, so its accumulators stay in registers.
template <bool CHECK_VALID, class Visit>
__device__ __forceinline__ void for_each_pair(const PairArgs& a, int t,
                                              float xi, float yi, float zi,
                                              Visit& visit) {
  const float* __restrict__ cols = a.cols;
  const float Lx = a.scal[0], Ly = a.scal[1], cutsq = a.scal[2];
  const int czp = a.czp, mx = a.mx, my = a.my;
  const int cpc = a.cz >> 3;
  const int col = t / a.cz;
  const int b = (t - col * a.cz) >> 3;
  const int cx = col / my;
  const int cy = col - cx * my;
  const size_t sbase = (static_cast<size_t>(col) * cpc + b) * kNsten;

  for (int s = 0; s < kNsten; ++s) {
    const int len = a.span_len[sbase + s];
    if (len <= 0) continue;
    const int ax = cx + s / 3 - 1 + mx;
    const int ay = cy + s % 3 - 1 + my;
    const float shx = static_cast<float>(ax / mx - 1) * Lx;
    const float shy = static_cast<float>(ay / my - 1) * Ly;
    const float* cj =
        cols + static_cast<size_t>((ax % mx) * my + ay % my) * 8 * czp;
    const int j0 = a.span_z0[sbase + s];
    for (int j = j0; j < j0 + len; ++j) {
      const float dx = xi - (cj[j] + shx);
      const float dy = yi - (cj[czp + j] + shy);
      const float dz = zi - cj[2 * czp + j];
      const float rsq = dx * dx + dy * dy + dz * dz;
      if (!(rsq < cutsq && rsq > 0.f)) continue;
      if (CHECK_VALID && !(cj[5 * czp + j] > 0.5f)) continue;
      visit(cj, j, dx, dy, dz, rsq);
    }
  }
}

// ---- the compacting walk (K3, K4) ------------------------------------------
//
// for_each_pair runs a pair's physics in the lane that owns the i-slot, so
// a warp runs it whenever any of its 32 lanes passes the cutoff test: ~97%
// of candidate steps when ~10% of candidates pass, with ~3 lanes active.
// Here each lane still walks its own i-slot's nine spans, but a lane that
// passes appends the pair to its warp's queue in shared memory (at the
// __popc prefix of the step's __ballot_sync), and whenever 32 pairs wait,
// each of the 32 lanes runs the physics of one of them.  Each owner lane
// then adds, in queue order (that is, in its own walk order), the
// contributions of the entries that are its own: a deterministic sum in
// the order for_each_pair takes.  Lanes whose walk ends early (shorter
// spans, invalid or absent i-slots) step on with a false test, so every
// _sync intrinsic sees all 32 lanes.  Only pairs that pass the test enter
// the queue (F2: the poisoned pad slots never do).  A lane tests two
// candidates a step, so the loop, the queue's bookkeeping and the batch
// test are paid once for two.  An entry is two words (one 8-byte store):
// the candidate's offset in cols and the owner lane with the stencil
// column's image shift, from which the batch takes the pair's geometry
// again, as the walk computed it.

constexpr int kQueue = 128;  // <= 31 waiting + <= 64 appended a step
constexpr unsigned kFull = 0xffffffffu;

// One warp's in-cutoff pairs waiting for a full warp: (offset of the
// candidate in cols, owner lane | x image code << 5 | y image code << 7),
// an image code being the shift in box lengths plus 1.
struct PairQueue {
  int2 entry[kQueue];
};

// The pair geometry of candidate jc from (xi, yi, zi) under image shift
// (shx, shy), as both the walk and the batch compute it.
struct Geometry {
  float dx, dy, dz, rsq;
};

__device__ __forceinline__ Geometry geometry(const float* __restrict__ cols,
                                             int czp, int jc, float xi,
                                             float yi, float zi, float shx,
                                             float shy) {
  Geometry g;
  g.dx = xi - (cols[jc] + shx);
  g.dy = yi - (cols[jc + czp] + shy);
  g.dz = zi - cols[jc + 2 * czp];
  g.rsq = g.dx * g.dx + g.dy * g.dy + g.dz * g.dz;
  return g;
}

// The physics of n <= 32 queued pairs from `head`, one per lane, summed
// into the owners' tallies.  `phys` holds the owner lane's i-slot data
// (Phys::Owner, fetched for the pair by shuffle), its tallies
// (tally[Phys::NV]) and the per-pair physics phys(owner, jc, dx, dy, dz,
// rsq, v) writing the pair's NV contributions.
template <class Phys>
__device__ __forceinline__ void run_batch(const PairArgs& a,
                                          const PairQueue& q, int head,
                                          int n, int lane, float xi,
                                          float yi, float zi, Phys& phys) {
  const bool has = lane < n;
  // a lane without a pair computes on candidate 0 of its own slot (any
  // slot's attributes are finite) and its result is never taken
  const int2 en = has ? q.entry[(head + lane) & (kQueue - 1)]
                      : make_int2(0, lane | (1 << 5) | (1 << 7));
  const int owner = en.y & 31;
  const Geometry g = geometry(
      a.cols, a.czp, en.x, __shfl_sync(kFull, xi, owner),
      __shfl_sync(kFull, yi, owner), __shfl_sync(kFull, zi, owner),
      static_cast<float>(((en.y >> 5) & 3) - 1) * a.scal[0],
      static_cast<float>(((en.y >> 7) & 3) - 1) * a.scal[1]);
  const typename Phys::Owner own = phys.owner_of(owner);
  float v[Phys::NV];
  phys(own, en.x, g.dx, g.dy, g.dz, g.rsq, v);
  // lane o's entries: the lanes whose owner id equals o, bit by bit
  unsigned mine = __ballot_sync(kFull, has);
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const unsigned ob = __ballot_sync(kFull, (owner >> b) & 1);
    mine &= ((lane >> b) & 1) ? ob : ~ob;
  }
  while (__any_sync(kFull, mine != 0)) {
    const bool take = mine != 0;
    const int src = take ? __ffs(mine) - 1 : lane;
#pragma unroll
    for (int k = 0; k < Phys::NV; ++k) {
      const float x = __shfl_sync(kFull, v[k], src);
      if (take) phys.tally[k] += x;
    }
    mine &= mine - 1;
  }
}

// Walk every candidate j of i-slot t at (xi, yi, zi) (none when !real) as
// for_each_pair does, and run `phys` on the pairs with 0 < rsq < cutsq
// (and a valid j-slot when CHECK_VALID) in full warps.  Every lane of the
// warp must call it.
template <bool CHECK_VALID, class Phys>
__device__ __forceinline__ void for_each_pair_compact(
    const PairArgs& a, int t, bool real, float xi, float yi, float zi,
    PairQueue& q, Phys& phys) {
  const float* __restrict__ cols = a.cols;
  const float Lx = a.scal[0], Ly = a.scal[1], cutsq = a.scal[2];
  const int czp = a.czp, mx = a.mx, my = a.my;
  const int lane = threadIdx.x & 31;
  int cx = 0, cy = 0, total = 0;
  size_t sbase = 0;
  if (real) {
    const int col = t / a.cz;
    const int b = (t - col * a.cz) >> 3;
    cx = col / my;
    cy = col - cx * my;
    sbase = (static_cast<size_t>(col) * (a.cz >> 3) + b) * kNsten;
    for (int s = 0; s < kNsten; ++s) total += max(a.span_len[sbase + s], 0);
  }
  const int steps = __reduce_max_sync(kFull, total);
  // the current span: stencil column (sx, sy) in {0,1,2}^2, its image
  // codes, its base offset in cols and the slot range left
  int sx = 0, sy = -1, code = 0, base = 0, j = 0, jend = 0;
  float shx = 0.f, shy = 0.f;
  // the next candidate of the walk: its offset in cols, its entry code
  // and whether it passes the test
  const auto next = [&](int& jc, int& cc) {
    while (j == jend) {                      // on to the next nonempty span
      if (++sy == 3) {
        sy = 0;
        ++sx;
      }
      const int s = sx * 3 + sy;
      const int len = a.span_len[sbase + s];
      if (len <= 0) continue;
      // the neighbour column and its periodic image, without division
      // (cx + sx - 1 lies in [-1, mx])
      int ax = cx + sx - 1, ay = cy + sy - 1;
      const int kx = ax < 0 ? 0 : (ax >= mx ? 2 : 1);
      const int ky = ay < 0 ? 0 : (ay >= my ? 2 : 1);
      ax += (1 - kx) * mx;
      ay += (1 - ky) * my;
      shx = static_cast<float>(kx - 1) * Lx;
      shy = static_cast<float>(ky - 1) * Ly;
      code = lane | (kx << 5) | (ky << 7);
      base = (ax * my + ay) * 8 * czp;
      j = a.span_z0[sbase + s];
      jend = j + len;
    }
    jc = base + j;
    cc = code;
    ++j;
    const Geometry g = geometry(cols, czp, jc, xi, yi, zi, shx, shy);
    bool hit = g.rsq < cutsq && g.rsq > 0.f;
    if (CHECK_VALID && hit) hit = cols[jc + 5 * czp] > 0.5f;
    return hit;
  };
  // two candidates a step: their entries go to the queue in walk order
  int head = 0, count = 0;
  for (int step = 0;; step += 2) {
    const bool more = step < steps;          // warp-uniform
    if (more) {
      int ja = 0, ca = 0, jb = 0, cb = 0;
      const bool ha = step < total && next(ja, ca);
      const bool hb = step + 1 < total && next(jb, cb);
      const unsigned ma = __ballot_sync(kFull, ha);
      const unsigned mb = __ballot_sync(kFull, hb);
      const unsigned lt = (1u << lane) - 1u;
      if (ha) {
        q.entry[(head + count + __popc(ma & lt)) & (kQueue - 1)] =
            make_int2(ja, ca);
      }
      if (hb) {
        q.entry[(head + count + __popc(ma) + __popc(mb & lt))
                & (kQueue - 1)] = make_int2(jb, cb);
      }
      count += __popc(ma) + __popc(mb);
    }
    while (count >= 32 || (!more && count > 0)) {
      __syncwarp();                          // the appends, for every lane
      run_batch(a, q, head, min(count, 32), lane, xi, yi, zi, phys);
      head = (head + 32) & (kQueue - 1);
      count = max(count - 32, 0);
      __syncwarp();                          // reads done before reuse
    }
    if (!more) break;
  }
}

// pe, virial and inner-cutoff count of one i-slot (observing variants).
struct Observed {
  float pe = 0.f, v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f, v4 = 0.f,
        v5 = 0.f, oob = 0.f;

  __device__ __forceinline__ void add(float emix, float fmix, float dx,
                                      float dy, float dz, bool inner) {
    pe += emix;
    v0 += fmix * dx * dx;
    v1 += fmix * dy * dy;
    v2 += fmix * dz * dz;
    v3 += fmix * dx * dy;
    v4 += fmix * dx * dz;
    v5 += fmix * dy * dz;
    if (inner) oob += 1.f;
  }

  __device__ __forceinline__ void store(float* part, int t) const {
    float4* p = reinterpret_cast<float4*>(part) + 2 * t;
    p[0] = make_float4(pe, v0, v1, v2);
    p[1] = make_float4(v3, v4, v5, oob);
  }
};

__device__ __forceinline__ void store_out(float* out, int t, float4 lo,
                                          float4 hi) {
  float4* o = reinterpret_cast<float4*>(out) + 2 * t;
  o[0] = lo;
  o[1] = hi;
}

inline int grid_of(int n_slots) { return (n_slots + kBlock - 1) / kBlock; }

}  // namespace colspan
