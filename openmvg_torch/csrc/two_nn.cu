// K1: fused exact squared-L2 2-NN descriptor matching for Hopper (sm_90a).
//
// Replaces the TPU kernel openmvg_tpu/ops/pallas_matching.py::two_nn_fused
// (Pallas body `_kernel`).  For every row of A it finds, over the valid rows
// of B, the smallest squared L2 distance d1 and its index i1 (ties to the
// lowest index) and the second smallest d2, taken over every column except
// i1 (so d2 == d1 when two columns tie).  The N x M distance matrix never
// leaves registers.  One launch covers a whole batch of image pairs: the
// descriptor stack (V, Nmax, D), per-view counts (the validity of A and B
// rows) and a (P, 2) pair list; the grid runs over (A tiles, pairs).
//
// uint8 descriptors: the products on the tensor cores.  Bytes are shifted
// by -128 into int8 (x ^ 0x80; L2 distances do not change under a common
// shift) and the cross term a'.b' is taken with
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (inline PTX, s8 operands,
// exact int32 sums), so d = |a'|^2 + |b'|^2 - 2 a'.b' is an exact integer
// below 2^24 and its float32 value is exact: d1, d2 and i1 equal the plain
// PyTorch version bit for bit.
//
//   tiles    a block of 256 threads (8 warps) owns 128 rows of A and walks B
//            in tiles of 256 columns.  Warp w takes A rows 32 (w % 4) ..
//            +31 and tile columns 128 (w / 4) .. +127.  The A tile is shifted
//            once into shared memory and its fragments stay in registers for
//            the whole walk (2 m16 tiles x 4 k-steps of 32, D = 128; shorter
//            descriptors are zero-padded to 128).  B tiles are
//            double-buffered: cp.async (16-byte copies; 4-byte copies when
//            D % 16 != 0) brings tile t + 1 while tile t multiplies.  One pass
//            over the arrived tile shifts it in place (bytes past D become
//            0) and takes each column's |b'|^2 with __dp4a.  Fragments come
//            from shared memory with ldmatrix (rows padded to 144 bytes, so
//            the eight rows of each 8x8 matrix fall in distinct banks).
//   epilogue on the accumulator fragments: each thread holds 2 rows x 2
//            adjacent columns of every m16n8 tile.  Column c of the tile
//            gives the key (|b'|^2 - 2 a'.b') * 256 + c, one IMAD from the
//            accumulator and a per-column constant; it fits int32 because
//            |b'|^2 - 2 a'.b' lies in [-2^22, 6.26e6].  Per owned row the
//            thread keeps the tile's two smallest keys with three
//            branch-free min/max (t = max(k1, key); k2 = min(k2, t);
//            k1 = min(k1, key)), so ties go to the lower column.  After the
//            tile the keys join the row's running (d1, i1, d2) (a later tile
//            wins only on a strictly smaller distance); at the end the four
//            threads of a quad and then the two warps that split the columns
//            merge with the order-free rule (lower (d, index) wins, the
//            loser's d joins d2), so the result does not depend on how B was
//            split.  |a'|^2 is added once per row when writing.  A tile with
//            an invalid column (past the view's count, or masked by valid_b)
//            takes the same epilogue with one more max per key that lifts
//            those columns above every valid key.
//
// Bound on the H100: 2 N M D int8 operations at 1,979 TOP/s (dense), e.g.
// 2.2 us for a 4096 x 4096 x 128 pair, against about 1 MB of operands.  The
// epilogue is the next limit: four integer instructions per distance (the
// IMAD and three IMNMX, the three on the integer pipe at 64 a clock per SM),
// which chip_smoke.py reports as the epilogue floor beside the bound.
//
// float32 descriptors take an FMA path on the CUDA cores with the same
// contract, clamped at 0 like the plain version (64 x 64 tiles, 4 x 4
// micro-tiles a thread; off the main path, whose SIFT descriptors are u8).

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TILE_A = 64;
constexpr int TILE_B = 64;
constexpr int THREADS = 256;
constexpr int MAX_D = 128;
constexpr int ROW_F = MAX_D + 4;      // f32 tile row in floats: 132 (16 B aligned)

struct Best {
  float d1;
  int i1;
  float d2;
};

__device__ __forceinline__ void push(Best& b, float d, int j) {
  if (d < b.d1) {
    b.d2 = b.d1;
    b.d1 = d;
    b.i1 = j;
  } else if (d < b.d2) {
    b.d2 = d;
  }
}

// float32 kernel: merge the states of the 16 threads (one half-warp) that
// share a row.
__device__ __forceinline__ void merge_half_warp(Best& b) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) {
    float od1 = __shfl_xor_sync(0xffffffffu, b.d1, off);
    int oi1 = __shfl_xor_sync(0xffffffffu, b.i1, off);
    float od2 = __shfl_xor_sync(0xffffffffu, b.d2, off);
    bool other = (od1 < b.d1) || (od1 == b.d1 && oi1 < b.i1);
    float lose = other ? b.d1 : od1;
    b.d1 = other ? od1 : b.d1;
    b.i1 = other ? oi1 : b.i1;
    b.d2 = fminf(lose, fminf(b.d2, od2));
  }
}

struct PairView {
  int na, nb;
  long long a_off, b_off;
};

__device__ __forceinline__ PairView pair_view(const int* pairs, const int* counts_a,
                                              const int* counts_b, int va_n, int vb_n,
                                              int nmax_a, int nmax_b, long long stride_a,
                                              long long stride_b, int p) {
  const int va = pairs[2 * p], vb = pairs[2 * p + 1];
  PairView v;
  bool ok_a = va >= 0 && va < va_n, ok_b = vb >= 0 && vb < vb_n;
  v.na = ok_a ? min(max(counts_a[va], 0), nmax_a) : 0;
  v.nb = ok_b ? min(max(counts_b[vb], 0), nmax_b) : 0;
  v.a_off = ok_a ? va * stride_a : 0;
  v.b_off = ok_b ? vb * stride_b : 0;
  return v;
}

// Rows of this block at or past na get the "no match" value (FLT_MAX,
// FLT_MAX, 0); the others the merged state.  Writes by lanes tx == 0.
__device__ __forceinline__ void write_rows(Best (&best)[4], int a0, int ty, int tx, int na,
                                           int n_out, long long out_off, float* d1_out,
                                           float* d2_out, int* i1_out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) merge_half_warp(best[i]);
  if (tx != 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = a0 + ty * 4 + i;
    if (row >= n_out) continue;
    bool ok = row < na;
    d1_out[out_off + row] = ok ? best[i].d1 : FLT_MAX;
    d2_out[out_off + row] = ok ? best[i].d2 : FLT_MAX;
    i1_out[out_off + row] = ok ? best[i].i1 : 0;
  }
}

// ---------------------------------------------------------------------------
// uint8: int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_A = 128;             // A rows a block
constexpr int TC_B = 256;             // B columns a tile (the key's 8-bit column)
constexpr int TC_ROW = MAX_D + 16;    // shared row stride in bytes
constexpr int E_NONE = 0x7FFFFFFF >> 8;  // "no column": above every valid distance
constexpr size_t TC_SMEM = (size_t)(TC_A + 2 * TC_B) * TC_ROW + 2 * TC_B * sizeof(int) +
                           TC_A * sizeof(int);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// B rows b0 .. b0 + TC_B - 1 of this pair into `dst` (raw bytes; rows past
// nb and bytes past D are filled with zeros).
__device__ __forceinline__ void load_b_tile(uint8_t* dst, const uint8_t* __restrict__ Bb,
                                            int b0, int nb, int D) {
  if (D % 16 == 0) {
    for (int e = threadIdx.x; e < TC_B * (MAX_D / 16); e += THREADS) {
      const int r = e >> 3, q = e & 7, row = b0 + r;
      const bool ok = row < nb && q * 16 < D;
      cp_async16(dst + r * TC_ROW + q * 16, ok ? Bb + (long long)row * D + q * 16 : Bb,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < TC_B * (MAX_D / 4); e += THREADS) {
      const int r = e >> 5, w = e & 31, row = b0 + r;
      const bool ok = row < nb && w * 4 < D;
      cp_async4(dst + r * TC_ROW + w * 4, ok ? Bb + (long long)row * D + w * 4 : Bb,
                ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// Two smallest keys of a row within a tile.
__device__ __forceinline__ void push_key(int& k1, int& k2, int key) {
  const int t = max(k1, key);
  k2 = min(k2, t);
  k1 = min(k1, key);
}

// Merge a rival (d1, i1, d2) into a row's state: lower (d, index) wins, the
// loser's d joins d2.
__device__ __forceinline__ void merge_state(int& d1, int& i1, int& d2, int od1, int oi1,
                                            int od2) {
  const bool other = od1 < d1 || (od1 == d1 && oi1 < i1);
  const int lose = other ? d1 : od1;
  d1 = other ? od1 : d1;
  i1 = other ? oi1 : i1;
  d2 = min(lose, min(d2, od2));
}

// One B tile through the tensor cores and the key epilogue.  afr: this
// warp's A fragments [m-tile][k-step]; Bs: the shifted tile; bias: per
// column |b'|^2 * 256 + c; floor_s (MASKED only): INT_MIN for a valid
// column, INT_MAX for an invalid one.
template <bool MASKED>
__device__ __forceinline__ void tile_keys(const uint32_t (&afr)[2][4][4], const uint8_t* Bs,
                                          const int* bias, const int* floor_s, int wc, int lane,
                                          int (&k1)[4], int (&k2)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) k1[q] = k2[q] = 0x7FFFFFFF;
  const int t4 = lane & 3;
#pragma unroll 4
  for (int nt = 0; nt < 16; ++nt) {
    const int n0 = wc * 128 + nt * 8;
    uint32_t bf[2][4];  // [k-step pair][b0(ks), b1(ks), b0(ks + 1), b1(ks + 1)]
    const uint8_t* brow = Bs + (n0 + (lane & 7)) * TC_ROW + (lane >> 3) * 16;
    ldsm_x4(bf[0], brow);
    ldsm_x4(bf[1], brow + 64);
    int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma_s8(acc[mt], afr[mt][ks], bf[ks >> 1][(ks & 1) * 2], bf[ks >> 1][(ks & 1) * 2 + 1]);
    const int c0 = n0 + 2 * t4;
    const int2 bb = *reinterpret_cast<const int2*>(bias + c0);
    int2 fl = make_int2(0, 0);
    if (MASKED) fl = *reinterpret_cast<const int2*>(floor_s + c0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int key0 = acc[mt][2 * h] * -512 + bb.x;
        int key1 = acc[mt][2 * h + 1] * -512 + bb.y;
        if (MASKED) {
          key0 = max(key0, fl.x);
          key1 = max(key1, fl.y);
        }
        push_key(k1[mt * 2 + h], k2[mt * 2 + h], key0);
        push_key(k1[mt * 2 + h], k2[mt * 2 + h], key1);
      }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
two_nn_u8_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                 const int* __restrict__ pairs, const int* __restrict__ counts_a,
                 const int* __restrict__ counts_b, const uint8_t* __restrict__ valid_b,
                 int va_n, int vb_n, int nmax_a, int nmax_b, int D, int n_out,
                 float* __restrict__ d1_out, float* __restrict__ d2_out,
                 int* __restrict__ i1_out) {
  extern __shared__ __align__(128) uint8_t tc_smem[];
  uint8_t* As = tc_smem;                               // TC_A x TC_ROW
  uint8_t* Bbuf = tc_smem + TC_A * TC_ROW;             // 2 x TC_B x TC_ROW
  int* bias_s = reinterpret_cast<int*>(Bbuf + 2 * TC_B * TC_ROW);  // TC_B
  int* floor_s = bias_s + TC_B;                        // TC_B
  int* an_s = floor_s + TC_B;                          // TC_A

  const int p = blockIdx.y;
  const int a0 = blockIdx.x * TC_A;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wc = warp >> 2;
  const long long stride_a = (long long)nmax_a * D, stride_b = (long long)nmax_b * D;
  const PairView pv = pair_view(pairs, counts_a, counts_b, va_n, vb_n, nmax_a, nmax_b,
                                stride_a, stride_b, p);
  const long long out_off = (long long)p * n_out;

  if (a0 >= pv.na) {  // uniform across the block: every row is "no match"
    const int row = a0 + tid;
    if (tid < TC_A && row < n_out) {
      d1_out[out_off + row] = FLT_MAX;
      d2_out[out_off + row] = FLT_MAX;
      i1_out[out_off + row] = 0;
    }
    return;
  }
  const uint8_t* Bb = B + pv.b_off;
  const int kw = D / 4;
  const int ntiles = (pv.nb + TC_B - 1) / TC_B;
  if (ntiles > 0) load_b_tile(Bbuf, Bb, 0, pv.nb, D);

  // the A tile, shifted and zero-padded to 128 bytes a row, and |a'|^2
  const uint32_t* Aw = reinterpret_cast<const uint32_t*>(A + pv.a_off);
  for (int e = tid; e < TC_A * (MAX_D / 4); e += THREADS) {
    const int r = e >> 5, w = e & 31, row = a0 + r;
    const uint32_t v = (row < pv.na && w < kw) ? (Aw[(long long)row * kw + w] ^ 0x80808080u) : 0u;
    *reinterpret_cast<uint32_t*>(As + r * TC_ROW + w * 4) = v;
  }
  __syncthreads();
  if (tid < TC_A) {
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(As + tid * TC_ROW);
    int s = 0;
#pragma unroll
    for (int w = 0; w < MAX_D / 4; ++w) s = __dp4a((int)rw[w], (int)rw[w], s);
    an_s[tid] = s;
  }
  uint32_t afr[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4(afr[mt][ks], As + (wr * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_ROW +
                               ks * 32 + (lane >> 4) * 16);

  // per owned row q = 2 m + h (local row wr*32 + 16 m + 8 h + lane/4): the
  // distance part |b'|^2 - 2 a'.b' of d1 and d2, and i1
  int d1[4], i1[4], d2[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    d1[q] = d2[q] = E_NONE;
    i1[q] = 0;
  }
  for (int t = 0; t < ntiles; ++t) {
    const int b0 = t * TC_B;
    uint8_t* Bs = Bbuf + (t & 1) * TC_B * TC_ROW;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < ntiles) load_b_tile(Bbuf + ((t + 1) & 1) * TC_B * TC_ROW, Bb, b0 + TC_B, pv.nb, D);
    // shift column tid's row in place (bytes past D to 0) and take |b'|^2
    const int col = b0 + tid;
    const bool ok = col < pv.nb && (valid_b == nullptr || valid_b[col]);
    {
      uint4* rw = reinterpret_cast<uint4*>(Bs + tid * TC_ROW);
      int s = 0;
#pragma unroll
      for (int q = 0; q < MAX_D / 16; ++q) {
        uint4 v = rw[q];
        v.x = 4 * q + 0 < kw ? v.x ^ 0x80808080u : 0u;
        v.y = 4 * q + 1 < kw ? v.y ^ 0x80808080u : 0u;
        v.z = 4 * q + 2 < kw ? v.z ^ 0x80808080u : 0u;
        v.w = 4 * q + 3 < kw ? v.w ^ 0x80808080u : 0u;
        s = __dp4a((int)v.x, (int)v.x, s);
        s = __dp4a((int)v.y, (int)v.y, s);
        s = __dp4a((int)v.z, (int)v.z, s);
        s = __dp4a((int)v.w, (int)v.w, s);
        rw[q] = v;
      }
      bias_s[tid] = ok ? s * 256 + tid : 0;
      floor_s[tid] = ok ? INT_MIN : 0x7FFFFFFF;
    }
    const bool all_ok = __syncthreads_and(ok) != 0;
    int k1[4], k2[4];
    if (all_ok)
      tile_keys<false>(afr, Bs, bias_s, floor_s, wc, lane, k1, k2);
    else
      tile_keys<true>(afr, Bs, bias_s, floor_s, wc, lane, k1, k2);
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // the tile's keys join the running state
      const int e1 = k1[q] >> 8, e2 = k2[q] >> 8;
      const bool win = e1 < d1[q];
      d2[q] = min(d2[q], min(e2, max(d1[q], e1)));
      i1[q] = win ? b0 + (k1[q] & 255) : i1[q];
      d1[q] = min(d1[q], e1);
    }
  }
  // the four threads of a quad share their rows
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const int od1 = __shfl_xor_sync(0xffffffffu, d1[q], off);
      const int oi1 = __shfl_xor_sync(0xffffffffu, i1[q], off);
      const int od2 = __shfl_xor_sync(0xffffffffu, d2[q], off);
      merge_state(d1[q], i1[q], d2[q], od1, oi1, od2);
    }
  // then the two warps that split the columns, through shared memory
  __syncthreads();  // the B buffers are free
  int* xs = reinterpret_cast<int*>(Bbuf);  // TC_A x 3
  if (wc == 1 && (lane & 3) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lr = wr * 32 + (q >> 1) * 16 + (q & 1) * 8 + (lane >> 2);
      xs[lr * 3 + 0] = d1[q];
      xs[lr * 3 + 1] = i1[q];
      xs[lr * 3 + 2] = d2[q];
    }
  }
  __syncthreads();
  if (wc == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lr = wr * 32 + (q >> 1) * 16 + (q & 1) * 8 + (lane >> 2);
      merge_state(d1[q], i1[q], d2[q], xs[lr * 3 + 0], xs[lr * 3 + 1], xs[lr * 3 + 2]);
      const int row = a0 + lr;
      if (row >= n_out) continue;
      const bool ok = row < pv.na;
      const int an = an_s[lr];
      d1_out[out_off + row] = ok && d1[q] < E_NONE ? (float)(d1[q] + an) : FLT_MAX;
      d2_out[out_off + row] = ok && d2[q] < E_NONE ? (float)(d2[q] + an) : FLT_MAX;
      i1_out[out_off + row] = ok && d1[q] < E_NONE ? i1[q] : 0;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
two_nn_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  const int* __restrict__ pairs, const int* __restrict__ counts_a,
                  const int* __restrict__ counts_b, const uint8_t* __restrict__ valid_b,
                  int va_n, int vb_n, int nmax_a, int nmax_b, int D, int n_out,
                  float* __restrict__ d1_out, float* __restrict__ d2_out,
                  int* __restrict__ i1_out) {
  extern __shared__ __align__(16) float smem[];
  float(*As)[ROW_F] = reinterpret_cast<float(*)[ROW_F]>(smem);
  float(*Bs)[ROW_F] = reinterpret_cast<float(*)[ROW_F]>(smem + TILE_A * ROW_F);
  float* an_s = smem + (TILE_A + TILE_B) * ROW_F;
  float* bn_s = an_s + TILE_A;
  uint8_t* bok_s = reinterpret_cast<uint8_t*>(bn_s + TILE_B);

  const int p = blockIdx.y;
  const int a0 = blockIdx.x * TILE_A;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kp = (D + 3) / 4 * 4;  // zero-padded depth
  const long long stride_a = (long long)nmax_a * D, stride_b = (long long)nmax_b * D;
  const PairView pv = pair_view(pairs, counts_a, counts_b, va_n, vb_n, nmax_a, nmax_b,
                                stride_a, stride_b, p);
  const long long out_off = (long long)p * n_out;

  Best best[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) best[i] = Best{FLT_MAX, 0, FLT_MAX};
  if (a0 >= pv.na) {
    write_rows(best, a0, ty, tx, pv.na, n_out, out_off, d1_out, d2_out, i1_out);
    return;
  }

  const float* Ab = A + pv.a_off;
  const float* Bb = B + pv.b_off;
  for (int e = tid; e < TILE_A * kp; e += THREADS) {
    int r = e / kp, k = e % kp, row = a0 + r;
    As[r][k] = (row < pv.na && k < D) ? Ab[(long long)row * D + k] : 0.f;
  }
  __syncthreads();
  if (tid < TILE_A) {
    float s = 0.f;
    for (int k = 0; k < D; ++k) s = fmaf(As[tid][k], As[tid][k], s);
    an_s[tid] = s;
  }
  __syncthreads();
  float an[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) an[i] = an_s[ty * 4 + i];

  for (int b0 = 0; b0 < pv.nb; b0 += TILE_B) {
    for (int e = tid; e < TILE_B * kp; e += THREADS) {
      int r = e / kp, k = e % kp, row = b0 + r;
      Bs[r][k] = (row < pv.nb && k < D) ? Bb[(long long)row * D + k] : 0.f;
    }
    __syncthreads();
    if (tid < TILE_B) {
      float s = 0.f;
      for (int k = 0; k < D; ++k) s = fmaf(Bs[tid][k], Bs[tid][k], s);
      bn_s[tid] = s;
      int col = b0 + tid;
      bok_s[tid] = (col < pv.nb) && (valid_b == nullptr || valid_b[col]);
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < kp; k += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(&As[ty * 4 + i][k]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(&Bs[tx + 16 * j][k]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = acc[i][j];
          a = fmaf(av[i].x, bv[j].x, a);
          a = fmaf(av[i].y, bv[j].y, a);
          a = fmaf(av[i].z, bv[j].z, a);
          a = fmaf(av[i].w, bv[j].w, a);
          acc[i][j] = a;
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int c = tx + 16 * j;
      if (!bok_s[c]) continue;
      float bn = bn_s[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float d = an[i] + bn - 2.f * acc[i][j];
        push(best[i], d > 0.f ? d : 0.f, b0 + c);
      }
    }
    __syncthreads();
  }
  write_rows(best, a0, ty, tx, pv.na, n_out, out_off, d1_out, d2_out, i1_out);
}

constexpr size_t F32_SMEM = (size_t)(TILE_A + TILE_B) * ROW_F * sizeof(float) +
                            (TILE_A + TILE_B) * sizeof(float) + TILE_B;

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; the
// stream is a cudaStream_t.  Returns the cudaError_t of the launch.
// Preconditions checked by the Python wrapper: 0 < D <= 128 (D % 4 == 0
// for uint8), n_out >= 1, 1 <= P <= 65535.
extern "C" int omt_two_nn_u8(const void* A, const void* B, const void* pairs,
                             const void* counts_a, const void* counts_b, const void* valid_b,
                             int va_n, int vb_n, int nmax_a, int nmax_b, int D, int n_out,
                             int P, void* d1, void* d2, void* i1, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(two_nn_u8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_out + TC_A - 1) / TC_A, P);
  two_nn_u8_kernel<<<grid, THREADS, TC_SMEM, (cudaStream_t)stream>>>(
      (const uint8_t*)A, (const uint8_t*)B, (const int*)pairs, (const int*)counts_a,
      (const int*)counts_b, (const uint8_t*)valid_b, va_n, vb_n, nmax_a, nmax_b, D, n_out,
      (float*)d1, (float*)d2, (int*)i1);
  return (int)cudaGetLastError();
}

extern "C" int omt_two_nn_f32(const void* A, const void* B, const void* pairs,
                              const void* counts_a, const void* counts_b, const void* valid_b,
                              int va_n, int vb_n, int nmax_a, int nmax_b, int D, int n_out,
                              int P, void* d1, void* d2, void* i1, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(two_nn_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)F32_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_out + TILE_A - 1) / TILE_A, P);
  two_nn_f32_kernel<<<grid, THREADS, F32_SMEM, (cudaStream_t)stream>>>(
      (const float*)A, (const float*)B, (const int*)pairs, (const int*)counts_a,
      (const int*)counts_b, (const uint8_t*)valid_b, va_n, vb_n, nmax_a, nmax_b, D, n_out,
      (float*)d1, (float*)d2, (int*)i1);
  return (int)cudaGetLastError();
}
