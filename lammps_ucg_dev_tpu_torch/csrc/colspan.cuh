// Shared device code of the column-span pair kernels (K1 ucgld_pair.cu,
// K2–K4 bethe_pair.cu, K5/K6 density_cv.cu and K7 ucgld_ablation.cu) and
// of the cluster-list kernel K8 (ucgld_cluster.cu): the Chebyshev series
// of the table channels and the 2x2 state block in D-form, the compacting
// walk of K3/K4 (one thread per i-slot over its cluster's nine candidate
// spans) and the tile walk of K1, K2, K5, K6, K7 and K8 (one warp per
// 8-slot cluster, over a source of candidates).  It is the counterpart of the
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
// One thread of the compacting walk owns one i-slot, one warp of the tile
// walk one 8-slot cluster, and each writes only its own rows: no atomics.

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
  int periodic = 3;  // bit 0 x, bit 1 y: on an axis that is not periodic (a
                     // spatial driver's virtual box, whose images come from
                     // halos) a neighbour column outside the grid is empty
};

// Whether the stencil column with image codes (kx, ky) (1: inside the
// grid) holds candidates: always on a periodic axis.  The walks ask only
// in their OPEN instantiations (some axis not periodic), which the
// launchers pick when a.periodic is not 3, so a fully periodic launch runs
// the walk without the test.
__device__ __forceinline__ bool stencil_live(int periodic, int kx, int ky) {
  return (kx == 1 || (periodic & 1)) && (ky == 1 || (periodic & 2));
}

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

// ---- the compacting walk (K3, K4) ------------------------------------------
//
// Each lane walks the candidates of its own i-slot t: t's 8-slot cluster
// owns nine spans [z0, z0+L), one per column of the 3x3 x-y stencil, each
// with that column's periodic image shift (colpack.stencil).  A lane that
// ran a pair's physics itself would hold its warp in the physics whenever
// any of its 32 lanes passes the cutoff test: ~97% of candidate steps when
// ~10% of candidates pass, with ~3 lanes active.  So a lane that passes
// appends the pair to its warp's queue in shared memory (at the __popc
// prefix of the step's __ballot_sync), and whenever 32 pairs wait, each of
// the 32 lanes runs the physics of one of them.  Each owner lane then adds,
// in queue order (that is, in its own walk order), the contributions of
// the entries that are its own: a sum in an order the inputs alone fix.
// Lanes whose walk ends early (shorter spans, invalid or absent i-slots)
// step on with a false test, so every _sync intrinsic sees all 32 lanes.
// Only pairs that pass the test enter the queue (F2: the poisoned pad
// slots, at 1e17, never do).  A lane tests two candidates a step, so the
// loop, the queue's bookkeeping and the batch test are paid once for two.
// An entry is two words (one 8-byte store): the candidate's offset in cols
// and the owner lane with the stencil column's image shift, from which the
// batch takes the pair's geometry again, as the walk computed it.

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

// Walk every candidate j of i-slot t at (xi, yi, zi) (none when !real), the
// nine spans in stencil order, and run `phys` on the pairs with
// 0 < rsq < cutsq (and a valid j-slot when CHECK_VALID) in full warps;
// OPEN as in tile_spans.  Every lane of the warp must call it.
template <bool CHECK_VALID, bool OPEN = false, class Phys>
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
      if constexpr (OPEN) {
        if (!stencil_live(a.periodic, kx, ky)) continue;
      }
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

// ---- the tile walk (K1, K2, K5, K6, K7, K8) --------------------------------
//
// One warp per 8-slot i-cluster.  The cluster's candidates form one
// sequence of `total`, and each step takes the next 32 of them, one per
// lane, by coalesced loads: once per cluster instead of once per i-slot.
// Where the sequence comes from is the walk's source: the cluster's nine
// column spans laid end to end (SpanSource: K1, K2, K5, K6, K7), or the
// 8-slot j-clusters of a cluster-list row (K8, ucgld_cluster.cu).  Each
// lane tests its candidate against the cluster's 8 i-slots (their
// coordinates held in registers by every lane; NaN for a slot without a
// real atom, which then passes no test): rsq < cutsq and the source's own
// pair rule (SpanSource: rsq > 0 and, with CHECK_VALID, a valid j).  A hit
// (dx, dy, dz, candidate offset << 3 | owner) goes to the warp's queue at
// the __popc prefix of that owner's ballot, owner by owner, two owners'
// ballots at a time.  After every second owner, while 32 hits wait, each
// lane runs the physics of one (Phys, on full warps) and adds its NV values
// to its own column of per-owner partial sums in shared memory; at the end
// each owner's 32 columns are added in a fixed order.  The step count,
// ceil(total / 32), is warp-uniform: no lane idles on a shorter cluster,
// and every _sync intrinsic sees all 32 lanes.  Every sum runs in an order
// the inputs alone fix, so two launches on the same inputs give
// bit-identical outputs.  Only hits enter the queue (F2); a lane without
// one computes on a finite dummy entry whose result is never taken.
//
// A source holds `total` (warp-uniform) and
//   int fetch(k, xj, yj, zj)      candidate k < total: its offset (what
//                                 Phys reads its attributes by) and its
//                                 coordinates, NaN when it is no partner;
//   void disp(ox, oy, oz, xj, yj, zj, dx, dy, dz)
//                                 the displacement from i-slot (ox, oy, oz);
//   bool keep(o, rsq)             its pair rule beyond rsq < cutsq.

constexpr int kTileQueue = 128;  // <= 31 waiting + <= 64 appended per check

// One warp's shared memory.  Phys reads its per-owner data (odata, which
// the kernel fills) by the owner index of the pair.
template <int NV>
struct TileShared {
  float4 owner[8];             // x y z of the cluster's i-slots (NaN: none)
  float4 odata[8];             // the kernel's per-owner data
  int4 span[kNsten + 1];       // [first index, offset - first, shx, shy]
  float4 queue[kTileQueue];    // [dx dy dz (offset << 3 | owner)]
  float acc[8 * NV * 32];      // partial sums, [owner][value][lane]
};

// Warps per block: 4, or 2 where the partial sums of a variant with many
// tallies would take a block of 4 past 48 KB of static shared memory.
template <int NV>
struct Tile {
  static constexpr int kWarps = NV > 8 ? 2 : 4;
  static constexpr int kThreads = 32 * kWarps;
};

template <int NV>
inline int tile_grid(int n_slots) {
  return ((n_slots >> 3) + Tile<NV>::kWarps - 1) / Tile<NV>::kWarps;
}

// Lanes 0..7: the rows (ipack layout, 8 floats a slot) of i-slot
// 8c + lane, whose coordinates go to owner[lane] (NaN unless the slot
// holds a real atom).  Returns whether it does.
template <int NV>
__device__ __forceinline__ bool tile_owner(const float* ipack, int c,
                                           TileShared<NV>& sh, float4& ia,
                                           float4& ib) {
  const int lane = threadIdx.x & 31;
  const int t = c * 8 + lane;
  ia = reinterpret_cast<const float4*>(ipack)[2 * t];
  ib = reinterpret_cast<const float4*>(ipack)[2 * t + 1];
  const bool real = ib.y > 0.5f;
  const float nan = __int_as_float(0x7fffffff);
  sh.owner[lane] = real ? make_float4(ia.x, ia.y, ia.z, 0.f)
                        : make_float4(nan, nan, nan, 0.f);
  return real;
}

// The nine spans of cluster c laid end to end: span[s] = [index of its
// first candidate in the sequence, its cols offset minus that index, its
// image shift]; span[kNsten].x = the total, which is returned (uniform).
// OPEN: some axis is not periodic (a.periodic), and a neighbour column
// outside the grid there is empty.
template <bool OPEN = false>
__device__ __forceinline__ int tile_spans(const PairArgs& a, int c,
                                          int4* span) {
  const int lane = threadIdx.x & 31;
  const int mx = a.mx, my = a.my;
  const int col = c / (a.cz >> 3);
  const int cx = col / my;
  const int cy = col - cx * my;
  int len = 0, off = 0;
  float shx = 0.f, shy = 0.f;
  if (lane < kNsten) {
    const size_t sb = static_cast<size_t>(c) * kNsten + lane;
    len = max(a.span_len[sb], 0);
    // the neighbour column and its periodic image, as the compacting walk
    // takes them (cx + sx - 1 lies in [-1, mx])
    int ax = cx + lane / 3 - 1, ay = cy + lane % 3 - 1;
    const int kx = ax < 0 ? 0 : (ax >= mx ? 2 : 1);
    const int ky = ay < 0 ? 0 : (ay >= my ? 2 : 1);
    if constexpr (OPEN) {
      if (!stencil_live(a.periodic, kx, ky)) len = 0;
    }
    ax += (1 - kx) * mx;
    ay += (1 - ky) * my;
    shx = static_cast<float>(kx - 1) * a.scal[0];
    shy = static_cast<float>(ky - 1) * a.scal[1];
    off = (ax * my + ay) * 8 * a.czp + a.span_z0[sb];
  }
  int incl = len;                            // inclusive prefix sum
#pragma unroll
  for (int d = 1; d < 16; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int total = __shfl_sync(kFull, incl, kNsten - 1);
  if (lane < kNsten) {
    span[lane] = make_int4(incl - len, off - (incl - len),
                           __float_as_int(shx), __float_as_int(shy));
  } else if (lane == kNsten) {
    span[kNsten] = make_int4(total, 0, 0, 0);
  }
  return total;
}

// The cols offset of candidate k (< total) and its image shift; s is the
// lane's span cursor, which only moves forward.
__device__ __forceinline__ int tile_offset(const int4* span, int k, int& s,
                                           float& shx, float& shy) {
  while (k >= span[s + 1].x) ++s;
  const int4 sp = span[s];
  shx = __int_as_float(sp.z);
  shy = __int_as_float(sp.w);
  return sp.y + k;
}

// The tile walk's source over cluster c's nine column spans (span: the
// warp's table, which the constructor fills).  Candidates carry their
// column's image shift, so the displacement is a plain difference.
template <bool CHECK_VALID, bool OPEN = false>
struct SpanSource {
  const float* __restrict__ cols;
  const int4* span;
  int czp, total, s = 0;

  __device__ __forceinline__ SpanSource(const PairArgs& a, int c, int4* sp)
      : cols(a.cols), span(sp), czp(a.czp),
        total(tile_spans<OPEN>(a, c, sp)) {}

  __device__ __forceinline__ int fetch(int k, float& xj, float& yj,
                                       float& zj) {
    float shx, shy;
    const int jc = tile_offset(span, k, s, shx, shy);
    xj = cols[jc] + shx;
    yj = cols[jc + czp] + shy;
    zj = cols[jc + 2 * czp];
    if (CHECK_VALID && !(cols[jc + 5 * czp] > 0.5f)) {
      xj = __int_as_float(0x7fffffff);
    }
    return jc;
  }

  __device__ __forceinline__ static void disp(float ox, float oy, float oz,
                                              float xj, float yj, float zj,
                                              float& dx, float& dy,
                                              float& dz) {
    dx = ox - xj;
    dy = oy - yj;
    dz = oz - zj;
  }

  __device__ __forceinline__ static bool keep(int, float rsq) {
    return rsq > 0.f;
  }
};

// The physics of n <= 32 queued hits from `head`, one per lane, added to
// the lanes' columns of partial sums.  phys(owner, jc, dx, dy, dz, rsq, v)
// writes a pair's NV values.
template <class Phys>
__device__ __forceinline__ void tile_batch(TileShared<Phys::NV>& sh,
                                           int head, int n, int lane,
                                           const Phys& phys) {
  constexpr int NV = Phys::NV;
  const bool has = lane < n;
  const float4 e = has ? sh.queue[(head + lane) & (kTileQueue - 1)]
                       : make_float4(1.f, 0.f, 0.f, 0.f);
  const int code = __float_as_int(e.w);
  const int o = code & 7;
  float v[NV];
  phys(o, code >> 3, e.x, e.y, e.z, e.x * e.x + e.y * e.y + e.z * e.z, v);
  if (has) {
    float* acc = sh.acc + o * (NV * 32) + lane;
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k * 32] += v[k];
  }
}

// Walk the candidates of `src` against the cluster's 8 i-slots (owner[],
// which lanes 0..7 have written, tile_owner) and run `phys` on the pairs
// with rsq < cutsq that the source keeps, in full warps.  Afterwards
// tile_sum(sh, o, k) is value k of owner o.  Every lane of the warp must
// call it.
template <class Src, class Phys>
__device__ __forceinline__ void tile_walk(Src& src, float cutsq,
                                          TileShared<Phys::NV>& sh,
                                          const Phys& phys) {
  constexpr int NV = Phys::NV;
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const float nan = __int_as_float(0x7fffffff);
  const int total = src.total;
#pragma unroll 4
  for (int i = lane; i < 8 * NV * 32; i += 32) sh.acc[i] = 0.f;
  __syncwarp();                  // the owners, the source and the sums
  int head = 0, tail = 0;            // the queue holds [head, tail)
  float ox[8], oy[8], oz[8];         // the i-slots, in registers
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const float4 w = sh.owner[o];
    ox[o] = w.x;
    oy[o] = w.y;
    oz[o] = w.z;
  }
  for (int k0 = 0; k0 < total; k0 += 32) {
    const int k = k0 + lane;
    int jc = 0;
    float xj = nan, yj = nan, zj = nan;   // past the end: no hit
    if (k < total) jc = src.fetch(k, xj, yj, zj);
    const int jc8 = jc << 3;
#pragma unroll
    for (int o = 0; o < 8; o += 2) {
      float ax, ay, az, bx, by, bz;
      src.disp(ox[o], oy[o], oz[o], xj, yj, zj, ax, ay, az);
      src.disp(ox[o + 1], oy[o + 1], oz[o + 1], xj, yj, zj, bx, by, bz);
      const float ra = ax * ax + ay * ay + az * az;
      const float rb = bx * bx + by * by + bz * bz;
      const bool ha = ra < cutsq && src.keep(o, ra);
      const bool hb = rb < cutsq && src.keep(o + 1, rb);
      const unsigned ma = __ballot_sync(kFull, ha);
      const unsigned mb = __ballot_sync(kFull, hb);
      const int na = __popc(ma);
      if (ha) {
        sh.queue[(tail + __popc(ma & lt)) & (kTileQueue - 1)] =
            make_float4(ax, ay, az, __int_as_float(jc8 | o));
      }
      if (hb) {
        sh.queue[(tail + na + __popc(mb & lt)) & (kTileQueue - 1)] =
            make_float4(bx, by, bz, __int_as_float(jc8 | (o + 1)));
      }
      tail += na + __popc(mb);
      while (tail - head >= 32) {
        __syncwarp();            // the appends, for every lane
        tile_batch(sh, head, 32, lane, phys);
        head += 32;
        __syncwarp();            // reads done before reuse
      }
    }
  }
  const int count = tail - head;
  if (count > 0) {
    __syncwarp();
    tile_batch(sh, head, count, lane, phys);
  }
  __syncwarp();
  // each owner's 32 columns, added from a lane-rotated start (no bank
  // conflicts) in a fixed order; the sum lands in the row's first entry
  for (int p = lane; p < 8 * NV; p += 32) {
    float* row = sh.acc + p * 32;
    float sum = 0.f;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) sum += row[(i + lane) & 31];
    row[0] = sum;
  }
  __syncwarp();
}

// The tile walk over cluster c's nine column spans (K1, K2, K5, K6, K7),
// with 0 < rsq < cutsq and, when CHECK_VALID, a valid j-slot; OPEN as in
// tile_spans (the launchers take it from a.periodic).
template <bool CHECK_VALID, bool OPEN = false, class Phys>
__device__ __forceinline__ void for_each_pair_tile(const PairArgs& a, int c,
                                                   TileShared<Phys::NV>& sh,
                                                   const Phys& phys) {
  SpanSource<CHECK_VALID, OPEN> src(a, c, sh.span);
  tile_walk(src, a.scal[2], sh, phys);
}

template <int NV>
__device__ __forceinline__ float tile_sum(const TileShared<NV>& sh, int o,
                                          int k) {
  return sh.acc[(o * NV + k) * 32];
}

// The launchers' check of the tile walk's entry code: every cols offset
// shifted left by 3 fits an int.
inline bool tile_fits(int mx, int my, int czp) {
  return static_cast<long long>(mx) * my * 8 * czp <= (1LL << 28);
}

__device__ __forceinline__ void store_out(float* out, int t, float4 lo,
                                          float4 hi) {
  float4* o = reinterpret_cast<float4*>(out) + 2 * t;
  o[0] = lo;
  o[1] = hi;
}

inline int grid_of(int n_slots) { return (n_slots + kBlock - 1) / kBlock; }

}  // namespace colspan
