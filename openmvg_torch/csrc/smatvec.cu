// Kernel K3: the fused S-matvec of the bundle adjuster's Schur-CG solve,
// for sm_90a.
//
// Replaces openmvg_tpu/ops/pallas_smatvec.py::s_matvec_halves (Pallas
// bodies `_kernel_a` and `_kernel_b`): for the reduced camera system
// S = B - E Hpp^-1 E^T it returns the two camera halves
//
//   (sp, si) = Jc^T e,   e = u - Jx Hpp^-1 Jx^T u,   u = Jc v,  v = (vp, vi)
//
// over the point-major observation layout (each point's slots form rows
// of R consecutive slots, a point's rows consecutive; ops/smatvec.py and
// sfm/ba.py::build_pt_obs), everything except the O(P) terms lam D v and
// Hprior v, which the caller adds.  Per slot o: Jp (2 x 6), Ji (2 x 8),
// Jx (2 x 3), a pose and an intrinsic id: 136 B of float32 and 8 B of ids.
//
// The TPU kernel expanded v and reduced the pose/intrinsic sums with
// one-hot matrix-unit products, padded pose and intrinsic counts to 128
// lanes and ran per-point vectors transposed; those were TPU layout
// workarounds and are not carried over.  What matters here is that the
// result repeats bit for bit (the adjuster is held to repeatable runs) and
// that no float atomics are used.
//
// Bound: bytes.  One call must read the slot record once (144 B a slot),
// the point blocks and v, and write (P, 6) and (I, 8): at the main path's
// final GLOBAL bundle adjustment (354,256 slots) some 52 MB, about 16 us at
// 3.35 TB/s, against about 48 MFLOP (0.7 us at the float32 rate outside the
// tensor cores).  Two launches, both from one call of omt_smatvec_f32:
//
//   smatvec_tiles   the point-owned pass.  The plan (ops/smatvec.py::
//                   tile_plan) cuts the rows into tiles at point boundaries,
//                   at most kTile = 1024 slots each, so that one block
//                   finishes its points alone: thread t of 256 owns slots
//                   t, t + 256, t + 512, t + 768 of its tile.  It loads each
//                   slot's record once (Jp as 3 and Ji as 4 16-byte
//                   vectors, Jx as 3 8-byte pairs; neighbouring threads on
//                   neighbouring records, so a warp's loads cover whole
//                   lines), gathers vp[pose] and vi[intr] and forms
//                   u = Jp vp + Ji vi in registers.  Jx^T u is summed over
//                   the R lanes of each row by a fixed shuffle tree (R is a
//                   power of two up to 32 and tiles start at row boundaries,
//                   so a row never straddles a warp) into shared memory; one
//                   thread a point adds its rows in row order and applies
//                   its Hpp^-1; then every thread forms e = u - Jx y from
//                   the u and Jx it still holds and writes e (8 B a slot).
//                   Row sums and y never reach device memory.  A point of
//                   more than kTile slots gets a tile of its own, whose
//                   block walks it in kTile pieces twice: row sums first
//                   (thread 0 adds them in row order), then u again and e.
//   smatvec_camera_sums
//                   K2's camera-sum kernel (seg_sum.cuh, mode 0) on u = e:
//                   sp = sum Jp^T e over the pose segments, si = sum Ji^T e
//                   over the intrinsic segments, one block a chunk of K2's
//                   plans, pose and intrinsic chunks in one launch, chunk
//                   partials folded by the segment's last block to arrive
//                   (int32 arrival counters), empty segments zeroed.
//
// Every output element is one fixed sequence of operations, decided by the
// plans and the layout alone, so two calls are bitwise equal.
//
// Why the record is read twice.  The pose sums cannot be taken in the
// point-owned pass: a tile's slots touch any of the P poses, so each block
// would need its own (P x 14) partials, which grow with blocks x poses, or
// float atomics, which do not repeat.  So launch 1 writes e and launch 2
// reads Jp or Ji again (sorted by camera through K2's perm) beside e: about
// 152 + 136 = 288 B a slot against the bound's 144, a design floor of about
// 0.031 ms at the final GLOBAL BA.  Jp and Ji together (about 40 MB there)
// fit in the 50 MB L2, so launch 1 reads Jx and the ids as streaming loads
// and leaves Jp and Ji to stay in L2 for launch 2 where they can.  The
// card's times are in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -I csrc (see ops/smatvec.py::build), loaded with ctypes.

#include "seg_sum.cuh"

// What a call needs besides the per-call vectors: the plan's tables and
// scratch, built once per solve (mirrors ops/smatvec.py::_Tables).  Outside
// the unnamed namespace: a parameter type of internal linkage would take
// the exported entry point out of the library's symbols.
struct K3Tables {
  const int32_t* pose_ids;  // (O,)
  const int32_t* intr_ids;  // (O,)
  const int32_t* pt_row0;   // (L + 1,) first row of each point
  const int32_t* tiles;     // (n_tiles, 4) first row, end row, first point, end point
  float* e;                 // (O, 2) launch 1 -> launch 2
  float* part_p;            // (max(p_n_chunks, 1), 6) chunk partials
  float* part_i;            // (max(i_n_chunks, 1), 8)
  const int32_t *p_perm, *p_start, *p_end, *p_seg, *p_off, *p_empty;
  int32_t* p_counters;
  const int32_t *i_perm, *i_start, *i_end, *i_seg, *i_off, *i_empty;
  int32_t* i_counters;
  int32_t O, R, L1, L, n_tiles, n_pose, n_intr;
  int32_t p_n_chunks, p_n_empty, i_n_chunks, i_n_empty;
};

namespace {

constexpr int kTileThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kTile = kTileThreads * kSlotsPerThread;  // slots a tile holds in registers

struct TileArgs {
  const float* jp;
  const float* ji;
  const float* jx;
  const int32_t* pose_ids;
  const int32_t* intr_ids;
  const float* vp;
  const float* vi;
  const float* hpp_inv;
  const int32_t* pt_row0;
  const int4* tiles;
  float* e;
  int n_pose, n_intr, lg_r;
};

// Slot o's u = Jp vp[pose] + Ji vi[intr] (an id outside its range adds
// nothing) and its Jx.
__device__ __forceinline__ void load_slot(const TileArgs& a, int64_t o, float& u0, float& u1,
                                          float (&x)[6]) {
  const float4* p4 = reinterpret_cast<const float4*>(a.jp + o * 12);
  const float4* i4 = reinterpret_cast<const float4*>(a.ji + o * 16);
  const float2* x2 = reinterpret_cast<const float2*>(a.jx + o * 6);
  float jp[12], ji[16];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 v = __ldg(p4 + i);
    jp[4 * i] = v.x;
    jp[4 * i + 1] = v.y;
    jp[4 * i + 2] = v.z;
    jp[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(i4 + i);
    ji[4 * i] = v.x;
    ji[4 * i + 1] = v.y;
    ji[4 * i + 2] = v.z;
    ji[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float2 v = __ldcs(x2 + i);
    x[2 * i] = v.x;
    x[2 * i + 1] = v.y;
  }
  const int p = __ldcs(a.pose_ids + o);
  const int q = __ldcs(a.intr_ids + o);
  u0 = 0.f;
  u1 = 0.f;
  if (p >= 0 && p < a.n_pose) {
    const float* v = a.vp + static_cast<int64_t>(p) * 6;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const float vc = __ldg(v + c);
      u0 = fmaf(jp[c], vc, u0);
      u1 = fmaf(jp[6 + c], vc, u1);
    }
  }
  if (q >= 0 && q < a.n_intr) {
    const float* v = a.vi + static_cast<int64_t>(q) * 8;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float vc = __ldg(v + c);
      u0 = fmaf(ji[c], vc, u0);
      u1 = fmaf(ji[8 + c], vc, u1);
    }
  }
}

// The sum over the 2^lg_r lanes of a row lands in its first lane, by a
// fixed tree.  Every lane of the warp takes part.
__device__ __forceinline__ float row_sum(float v, int lg_r) {
  for (int off = (1 << lg_r) >> 1; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Slots [s0, s0 + m) of a tile, thread t holding t, t + 256, ...: u and Jx
// into registers (zero past m) and, with `rows`, each row's Jx^T u into
// rs[row - s0 / R].
__device__ __forceinline__ void tile_pass(const TileArgs& a, int64_t s0, int m,
                                          float (&u0)[kSlotsPerThread],
                                          float (&u1)[kSlotsPerThread],
                                          float (&x)[kSlotsPerThread][6], float (*rs)[3],
                                          bool rows) {
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int i = threadIdx.x + k * kTileThreads;
    u0[k] = 0.f;
    u1[k] = 0.f;
#pragma unroll
    for (int c = 0; c < 6; ++c) x[k][c] = 0.f;
    if (i < m) load_slot(a, s0 + i, u0[k], u1[k], x[k]);
  }
  if (!rows) return;
  const int r_mask = (1 << a.lg_r) - 1;
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int i = threadIdx.x + k * kTileThreads;
    const float w0 = row_sum(fmaf(x[k][3], u1[k], x[k][0] * u0[k]), a.lg_r);
    const float w1 = row_sum(fmaf(x[k][4], u1[k], x[k][1] * u0[k]), a.lg_r);
    const float w2 = row_sum(fmaf(x[k][5], u1[k], x[k][2] * u0[k]), a.lg_r);
    if (i < m && (i & r_mask) == 0) {
      float* r = rs[i >> a.lg_r];
      r[0] = w0;
      r[1] = w1;
      r[2] = w2;
    }
  }
}

// e = u - Jx y for the slots of a tile_pass, y = ys[point of the slot's row]
// (ys[0] for every slot when the tile is one point).
__device__ __forceinline__ void write_e(const TileArgs& a, int64_t s0, int m,
                                        const float (&u0)[kSlotsPerThread],
                                        const float (&u1)[kSlotsPerThread],
                                        const float (&x)[kSlotsPerThread][6],
                                        const float (*ys)[3], const int* rowq) {
  float2* e2 = reinterpret_cast<float2*>(a.e);
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int i = threadIdx.x + k * kTileThreads;
    if (i < m) {
      const float* y = ys[rowq != nullptr ? rowq[i >> a.lg_r] : 0];
      const float e0 = u0[k] - fmaf(x[k][2], y[2], fmaf(x[k][1], y[1], x[k][0] * y[0]));
      const float e1 = u1[k] - fmaf(x[k][5], y[2], fmaf(x[k][4], y[1], x[k][3] * y[0]));
      e2[s0 + i] = make_float2(e0, e1);
    }
  }
}

__device__ __forceinline__ void apply_hinv(const float* __restrict__ h, float w0, float w1,
                                           float w2, float* y) {
  y[0] = fmaf(__ldg(h + 2), w2, fmaf(__ldg(h + 1), w1, __ldg(h + 0) * w0));
  y[1] = fmaf(__ldg(h + 5), w2, fmaf(__ldg(h + 4), w1, __ldg(h + 3) * w0));
  y[2] = fmaf(__ldg(h + 8), w2, fmaf(__ldg(h + 7), w1, __ldg(h + 6) * w0));
}

// Launch 1: one block a tile of the plan.
__global__ void __launch_bounds__(kTileThreads) smatvec_tiles(TileArgs a) {
  __shared__ float rs[kTile][3];  // row sums of the tile (R >= 1: at most kTile rows)
  __shared__ float ys[kTile][3];  // y of the tile's points (each owns >= 1 row)
  __shared__ int rowq[kTile];     // tile-local point of each row
  const int4 t = a.tiles[blockIdx.x];
  const int r0 = t.x, l0 = t.z, np = t.w - t.z;
  const int64_t s0 = static_cast<int64_t>(r0) << a.lg_r;
  const int n = (t.y - r0) << a.lg_r;
  float u0[kSlotsPerThread], u1[kSlotsPerThread], x[kSlotsPerThread][6];
  if (n <= kTile) {
    tile_pass(a, s0, n, u0, u1, x, rs, true);
    __syncthreads();
    for (int q = threadIdx.x; q < np; q += kTileThreads) {
      const int l = l0 + q;
      const int ra = __ldg(a.pt_row0 + l) - r0, rb = __ldg(a.pt_row0 + l + 1) - r0;
      float w0 = 0.f, w1 = 0.f, w2 = 0.f;
      for (int r = ra; r < rb; ++r) {
        w0 += rs[r][0];
        w1 += rs[r][1];
        w2 += rs[r][2];
        rowq[r] = q;
      }
      apply_hinv(a.hpp_inv + static_cast<int64_t>(l) * 9, w0, w1, w2, ys[q]);
    }
    __syncthreads();
    write_e(a, s0, n, u0, u1, x, ys, rowq);
    return;
  }
  // one point of more than kTile slots: row sums piece by piece, added in
  // row order by thread 0, then u again and e
  float w0 = 0.f, w1 = 0.f, w2 = 0.f;
  for (int c0 = 0; c0 < n; c0 += kTile) {
    const int m = min(kTile, n - c0);
    tile_pass(a, s0 + c0, m, u0, u1, x, rs, true);
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < (m >> a.lg_r); ++r) {
        w0 += rs[r][0];
        w1 += rs[r][1];
        w2 += rs[r][2];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) apply_hinv(a.hpp_inv + static_cast<int64_t>(l0) * 9, w0, w1, w2, ys[0]);
  __syncthreads();
  for (int c0 = 0; c0 < n; c0 += kTile) {
    const int m = min(kTile, n - c0);
    tile_pass(a, s0 + c0, m, u0, u1, x, rs, false);
    write_e(a, s0 + c0, m, u0, u1, x, ys, nullptr);
  }
}

// Launch 2: K2's camera sums (mode 0) with u = e.
__global__ void __launch_bounds__(kThreads)
smatvec_camera_sums(const float* __restrict__ jp, const float* __restrict__ ji,
                    const float* __restrict__ e, Plan pp, Plan pi, float* __restrict__ part_p,
                    float* __restrict__ part_i, float* __restrict__ sp, float* __restrict__ si) {
  camera_sums_body<float, 0>(jp, ji, e, pp, pi, part_p, part_i, sp, si);
}

}  // namespace

extern "C" {

// The tile size the plan must cut to, and the size of K3Tables, for the
// wrapper to check against its own.
int omt_smatvec_tile_slots() { return kTile; }
int omt_smatvec_tables_bytes() { return static_cast<int>(sizeof(K3Tables)); }

// jp (O, 12), ji (O, 16), jx (O, 6) float32 row-major, 16-byte aligned;
// vp (n_pose, 6), vi (n_intr, 8), hpp_inv (L, 3, 3); sp (n_pose, 6), si
// (n_intr, 8) out; everything else in *t.  Two launches on `stream`
// (either is skipped when it has nothing to do); returns
// cudaGetLastError().
int omt_smatvec_f32(const K3Tables* t, const float* jp, const float* ji, const float* jx,
                    const float* vp, const float* vi, const float* hpp_inv, float* sp, float* si,
                    void* stream) {
  const int R = t->R;
  if (t->O < 0 || R < 1 || R > 32 || (R & (R - 1)) || t->n_tiles < 0 || t->n_pose < 0 ||
      t->n_intr < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pp{t->p_perm, t->p_start, t->p_end, t->p_seg, t->p_off, t->p_empty,
                t->p_counters, t->p_n_chunks, t->p_n_empty, t->n_pose};
  const Plan pi{t->i_perm, t->i_start, t->i_end, t->i_seg, t->i_off, t->i_empty,
                t->i_counters, t->i_n_chunks, t->i_n_empty, t->n_intr};
  if (!plan_ok(pp) || !plan_ok(pi)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t->n_tiles > 0) {
    const TileArgs a{jp, ji, jx, t->pose_ids, t->intr_ids, vp, vi, hpp_inv, t->pt_row0,
                     reinterpret_cast<const int4*>(t->tiles), t->e, t->n_pose, t->n_intr,
                     __builtin_ctz(static_cast<unsigned>(R))};
    smatvec_tiles<<<t->n_tiles, kTileThreads, 0, st>>>(a);
  }
  const int blocks = camera_blocks(pp, pi);
  if (blocks > 0)
    smatvec_camera_sums<<<blocks, kThreads, 0, st>>>(jp, ji, t->e, pp, pi, t->part_p,
                                                     t->part_i, sp, si);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
