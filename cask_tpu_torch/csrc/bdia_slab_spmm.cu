// Slab SpMM on Hopper (sm_90a): Y = A·X for a BdiaSlabs plan, one dense
// (g·br × W) @ (W × k) product per tile of g block rows, X and Y dense and
// row-major, for any k >= 1.
//
// Replaces the TPU kernels (cask_tpu/ops/pallas/bdia_slab.py)
//   :290  bdia_spmm_slab_padded  (B5: one BlockSpec fetch per window segment)
//   :518  _slab_ring_call        (B6: a revolving VMEM bank ring; the entries
//                                 bdia_spmm_slab_ring :505 and
//                                 bdia_spmm_slab_ring_padded :494)
// Both compute, for body tile t and slab row q = g·br + r,
//   Y[t·gb_r + q, :] = Σ_w slabs[t·gb_r + q, w] · Xwin_t[w, :],
// where the window Xwin_t stacks, in this order (bdia_slab.py:466-491):
//   the bc X rows before the tile's core (pre-halo), the bc rows after it
//   (post-halo), the gb_c core rows, then one gb_c segment per far offset d
//   starting at X row (t·g + d)·bc.
// They differ only in how the TPU delivers the window into VMEM; here every
// window row is read from X directly, rows outside the frame as zero (the
// ring's bank fill, :429-431).  Far offsets are arbitrary (no g | d).  The
// COO remainder is added outside the kernel.
//
// Two frames, one kernel: the natural frame (x_rows = n, tile0 = 0, y_rows =
// m) and the padded chain layout of BdiaSlabs.to_padded (x_rows = the
// frame's rows, tile0 = pad_tiles; the wrapper zeroes the pad tiles of Y).
//
// What bounds it: bytes, once the product runs on the tensor cores.  The
// shear inflates the value stream to W slab columns per row (about 10x the
// stored entries for the FEM band): at k = 128 on fem_blocks(512, dof=4)
// that is 53.7 GFLOP against 1.9 GB of slabs, X and Y, so even all 67
// TFLOP/s of FP32 outside the tensor cores (801 µs) would stay above the
// byte bound (571 µs at 3.35 TB/s).
//
// What the design does about it (f32, the main path):
// - The product runs on the tensor cores in 4xTF32: each operand splits
//   into hi = tf32(a) and lo = tf32(a - hi) (both rounded), and
//   D += lo·lo + lo·hi + hi·lo + hi·hi with mma.sync m16n8k8 (FP32
//   accumulation), exact but for the splits' remainders (each within 2^-22
//   of its operand): f32-class, the card's counterpart of the reference's
//   precision="highest" (ops/spmm.py:208).
//   Plain 1xTF32 (2^-11) is never used.  Without lo·lo, or with lo cut
//   toward zero, the dropped terms can share one sign over a whole sum
//   (see split_tf32).  4 × 53.7 GFLOP at 495 TFLOP/s of dense TF32 is
//   about 434 µs, under the byte bound.  The split is integer and FP32
//   arithmetic at the full instruction rate.
// - Work items are (tile, 64 slab rows, 128 columns); a CTA of 8 warps,
//   each a 32 × 32 block of D in registers, holds two per SM.  W is walked
//   in chunks of 32 window rows through a 3-stage cp.async ring (16-byte
//   copies, zero-filled past the frame, the window and k), so chunk i + 2
//   loads while chunk i multiplies.  The grid is two CTAs per SM, each
//   taking a strided list of items as one chunk stream: the ring runs on
//   across items, so a short item (7 chunks at W = 200) pays no pipeline
//   fill, and its stores overlap the next item's loads.
// - The slab stream carries an L2 evict-first hint (it is read once); X
//   windows, which neighbouring tiles share, stay in L2.  Each window
//   row's X offset from the tile's core is worked out once per block into
//   a shared table (per row where W exceeds kTableMax), not per element.
//   Where W or k is not a multiple of 4, or a base pointer is off the
//   16-byte grid, the copies are 4 bytes wide.
// - Shared rows are padded (slab rows to 40 floats, window rows to 132), so
//   the mma fragment loads meet no bank conflict; a thread's slab values
//   come as 8-byte loads.
// bf16 slabs or X (the reference's bf16 slab option, run at its
// precision="highest", so exact-class in the f32 operand): the same kernel,
// templated on the slab, X and Y types.  A bf16 value is a TF32 value as it
// stands (8 exponent bits, 7 of TF32's 10 mantissa bits), so its lo part is
// zero: bf16 slabs with f32 X take two passes, A·X_hi + A·X_lo, f32 slabs
// with bf16 X take A_lo·X + A_hi·X, and bf16 with bf16 one pass.  X is never
// rounded to bf16.  The fragment loads turn a bf16 into its TF32 bit
// pattern by a 16-bit shift, exactly, with no cvt.  bf16 operands sit in
// shared memory as bf16 (window rows padded to 136, 16-byte aligned) and
// are copied in 16-byte runs of 8 where W or k and the base pointer allow,
// else in 4-byte runs of 2 (W is even for every g the auto route picks),
// else one element at a time by the thread itself; no copy reads past a
// row and the packed slabs stay unpadded.  Y is f32, or bf16 rounded once
// at the store (the reference's fully-bf16 chain).
// f16 slabs or X (the reference's f16 slab option) take the same passes as
// bf16: an f16 value is a TF32 value as it stands too (5 exponent bits
// within TF32's 8, 10 mantissa bits, and its subnormals, down to 2^-24, are
// normal TF32 values), so f16 with f16 is one exact pass and f16 with f32
// two.  The fragment loads widen an f16 with __half2float (exact) and take
// the f32 bits; f16 sits in shared memory with bf16's layout, and Y is f32
// or f16 rounded once at the store.
// f64, and f32 in with f64 sums (accum_dtype=float64), keep the plain FMA
// kernel below: a register-blocked product, 16 window rows per shared chunk.
// The far offsets ride in a by-value parameter (at most kMaxFar).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "value_types.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;   // slab rows per CTA
constexpr int kBN = 128;  // columns per CTA
constexpr int kBK = 16;   // window rows per shared-memory chunk
constexpr int kTM = 4;    // rows per thread
constexpr int kTN = 8;    // columns per thread (two runs of 4)
constexpr int kPad = 4;   // keeps the transposed slab stores off one bank
constexpr int kMaxFar = 64;

struct FarOffsets {
  int d[kMaxFar];
};

__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// four consecutive shared-memory values (16-byte aligned) as two vector
// loads
__device__ __forceinline__ void lds4(const double* p, double (&o)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// X row of window row w for a tile whose core starts at X row row0
__device__ __forceinline__ int64_t window_row(int w, int64_t row0, int bc, int gb_c,
                                              const FarOffsets& far) {
  if (w < bc) return row0 - bc + w;             // pre-halo
  if (w < 2 * bc) return row0 + gb_c + (w - bc);  // post-halo
  w -= 2 * bc;
  if (w < gb_c) return row0 + w;                // core
  w -= gb_c;
  const int f = w / gb_c;                       // far segment
  return row0 + static_cast<int64_t>(far.d[f]) * bc + (w - f * gb_c);
}

// ---- f32, bf16 and f16: split TF32 products on the tensor cores ---------

constexpr int kTcBM = 64;        // slab rows per CTA
constexpr int kTcBN = 128;       // columns per CTA
constexpr int kWarpsN = 4;       // warps along the columns; 2 along the rows
constexpr int kTcThreads = 64 * kWarpsN;
constexpr int kJ = kTcBN / kWarpsN / 8;  // n8 fragments of a warp's 32 × (8·kJ) block
constexpr int kTcBK = 32;        // window rows per stage
constexpr int kTcStages = 3;
// Within each step of 8 window rows, mma's k index tq is window row 2·tq and
// k index tq + 4 is row 2·tq + 1 (any one-to-one map of the 8 rows gives
// the same sum), so a thread's two a values of one fragment row are
// neighbours: one 8-byte (bf16: 4-byte) shared load.  The row strides put
// the 32 lanes of each fragment load on 32 different banks (bf16 window
// rows: two lanes share a word) and keep every row 16-byte aligned.
constexpr int kAStride = kTcBK + 8;
template <typename T>
constexpr int kBStride = kTcBN + 16 / static_cast<int>(sizeof(T));
constexpr int kAStage = kTcBM * kAStride;
template <typename T>
constexpr int kBStage = kTcBK * kBStride<T>;
template <typename S, typename X>
constexpr int kTcSmem = kTcStages * (kAStage * static_cast<int>(sizeof(S)) +
                                     kBStage<X> * static_cast<int>(sizeof(X)));
constexpr int kTableMax = 2048;  // windows up to this many rows keep their X offsets in a table

// E elements of T global -> shared (E·sizeof(T) of 4, 8 or 16 bytes, as one
// cp.async; `ok` false fills zeros and reads nothing); 2 bytes (one bf16)
// are copied by the thread itself.  The slab stream is read once: its
// 16-byte copies carry an L2 evict-first policy, so X windows, which
// neighbouring tiles share, stay.
template <typename T, int E, bool kOnce = false>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, bool ok, uint64_t policy) {
  constexpr int kBytes = E * static_cast<int>(sizeof(T));
  if constexpr (kBytes == 2) {
    *reinterpret_cast<unsigned short*>(dst) =
        ok ? __ldg(reinterpret_cast<const unsigned short*>(src)) : static_cast<unsigned short>(0);
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = ok ? kBytes : 0;
    if constexpr (kBytes == 16 && kOnce) {
      asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(d),
                   "l"(src), "r"(n), "l"(policy) : "memory");
    } else if constexpr (kBytes == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                   : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                   "n"(kBytes), "r"(n) : "memory");
    }
  }
}

// a ≈ hi + lo, each a TF32 value (10 explicit mantissa bits): hi is a
// rounded to nearest (ties away from zero, as cvt.rna.tf32.f32).  lo, the
// rest (exact in f32), is rounded the same way for f32 × f32 (kRound), so
// |a - hi - lo| <= 2^-22·|a|; else it is cut toward zero, within 2^-21·|a|
// (the two-pass kernels with one bf16 operand).  A cut lo leaves a
// remainder of one sign, which on values with every low mantissa bit set
// adds up over a sum: there the 4-pass kernel's error is 4.01x the plain
// FP32 twin's with lo cut, 2.27x with lo rounded (kernel_probe.py --slab,
// an H100 80GB HBM3 at 700 W).  Integer and FP32 operations at the full
// instruction rate, where cvt runs on the slower conversion pipe.
template <bool kRound>
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(a - __uint_as_float(hi)) + (kRound ? 0x1000u : 0u)) & 0xffffe000u;
}

// An operand's TF32 parts: an f32 splits into hi + lo; a bf16 (8 exponent
// and 7 mantissa bits) is a TF32 value as it stands, its f32 bit pattern the
// bf16 bits shifted up by 16, exactly (its lo part is zero and is skipped);
// so is an f16, its f32 bit pattern that of __half2float (exact: the shift
// does not hold for f16's 5-bit exponent).
template <bool kRound>
__device__ __forceinline__ void tf32_parts(float a, uint32_t& hi, uint32_t& lo) {
  split_tf32<kRound>(a, hi, lo);
}
template <bool kRound>
__device__ __forceinline__ void tf32_parts(__nv_bfloat16 a, uint32_t& hi, uint32_t&) {
  hi = static_cast<uint32_t>(__bfloat16_as_ushort(a)) << 16;
}
template <bool kRound>
__device__ __forceinline__ void tf32_parts(__half a, uint32_t& hi, uint32_t&) {
  hi = __float_as_uint(__half2float(a));
}
// an A fragment's four values: two neighbouring shared values in row g (at
// p) and in row g + 8 (at p + 8 rows), in mma's register order
template <bool kRound>
__device__ __forceinline__ void tf32_frag(const float* p, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 top = *reinterpret_cast<const float2*>(p);
  const float2 bot = *reinterpret_cast<const float2*>(p + 8 * kAStride);
  split_tf32<kRound>(top.x, hi[0], lo[0]);
  split_tf32<kRound>(bot.x, hi[1], lo[1]);
  split_tf32<kRound>(top.y, hi[2], lo[2]);
  split_tf32<kRound>(bot.y, hi[3], lo[3]);
}
template <bool kRound>
__device__ __forceinline__ void tf32_frag(const __nv_bfloat16* p, uint32_t (&hi)[4],
                                          uint32_t (&)[4]) {
  const uint32_t top = *reinterpret_cast<const uint32_t*>(p);
  const uint32_t bot = *reinterpret_cast<const uint32_t*>(p + 8 * kAStride);
  hi[0] = top << 16;
  hi[1] = bot << 16;
  hi[2] = top & 0xffff0000u;
  hi[3] = bot & 0xffff0000u;
}
template <bool kRound>
__device__ __forceinline__ void tf32_frag(const __half* p, uint32_t (&hi)[4], uint32_t (&)[4]) {
  const float2 top = __half22float2(*reinterpret_cast<const __half2*>(p));
  const float2 bot = __half22float2(*reinterpret_cast<const __half2*>(p + 8 * kAStride));
  hi[0] = __float_as_uint(top.x);
  hi[1] = __float_as_uint(bot.x);
  hi[2] = __float_as_uint(top.y);
  hi[3] = __float_as_uint(bot.y);
}

// not volatile: the compiler interleaves the independent products of a step
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two neighbouring sums of a Y row: one 8-byte (f32) or 4-byte (bf16 or
// f16, rounded to nearest even) store where `vec`, else one or two scalar
// ones
__device__ __forceinline__ void store_pair(float* y, int col, int k, bool vec, float v0,
                                           float v1) {
  if (vec && col + 1 < k) {
    *reinterpret_cast<float2*>(y + col) = make_float2(v0, v1);
  } else {
    if (col < k) y[col] = v0;
    if (col + 1 < k) y[col + 1] = v1;
  }
}
template <typename H>
__device__ __forceinline__ void store_pair(H* y, int col, int k, bool vec, float v0, float v1) {
  if (vec && col + 1 < k) {
    *reinterpret_cast<uint32_t*>(y + col) = cask::pack_half2<H>(v0, v1);
  } else {
    if (col < k) y[col] = cask::narrow<H>(v0);
    if (col + 1 < k) y[col + 1] = cask::narrow<H>(v1);
  }
}

// A block's place in its stream of chunks: the work item (body tile, 64 slab
// rows, 128 columns; the column block fastest) and the chunk of W within it.
// It steps forward one chunk at a time, and divides only when the item
// changes.
struct Cursor {
  int item, kt;
  int64_t t;   // body tile
  int r0, c0;  // first slab row and column
  __device__ __forceinline__ void at(int i, int per_tile, int col_blocks) {
    item = i;
    kt = 0;
    t = i / per_tile;
    const int rc = i - static_cast<int>(t) * per_tile;
    r0 = (rc / col_blocks) * kTcBM;
    c0 = (rc % col_blocks) * kTcBN;
  }
  __device__ __forceinline__ void next(int nk, int per_tile, int col_blocks) {
    if (++kt == nk) at(item + static_cast<int>(gridDim.x), per_tile, col_blocks);
  }
};

// S: slab type; X: X type (each f32 or one half type, bf16 or f16); O:
// output type (f32, or the half type rounded at the store).  The products an
// exact-class f32 result needs: lo·lo + lo·hi + hi·lo + hi·hi when both are
// f32 (4xTF32); hi·lo + hi·hi when one is a half (its lo is zero); one hi·hi
// pass when both are.
//
// Block b takes items b, b + gridDim.x, ... as one stream of W chunks, so
// the ring runs on across item boundaries and the next item's first chunks
// load while this item's last ones multiply and its sums are stored.  At
// any time the blocks work on a band of neighbouring tiles, whose windows
// overlap (halos, and far segments a far offset apart).
//
// s_chunk / x_chunk: elements per copy of a slab and an X row (16 bytes,
// else 4 bytes, else one element), the widest that W or k and the base
// pointer's alignment allow.
template <typename S, typename X, typename O>
__global__ void __launch_bounds__(kTcThreads, 2)
slab_spmm_tc_kernel(const S* __restrict__ Sm, const X* __restrict__ Xm, O* __restrict__ Y,
                    const FarOffsets far, int bc, int gb_r, int gb_c, int W, int64_t x_rows,
                    int64_t tile0, int64_t y_rows, int k, int items, int row_blocks,
                    int col_blocks, int s_chunk, int x_chunk, bool y_vec) {
  constexpr bool kSplitA = sizeof(S) == 4, kSplitB = sizeof(X) == 4;
  constexpr int kBS = kBStride<X>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S* As = reinterpret_cast<S*>(smem_raw);                       // [stage][slab row][w]
  X* Bs = reinterpret_cast<X*>(As + kTcStages * kAStage);       // [stage][w][column]
  int64_t* woff = reinterpret_cast<int64_t*>(Bs + kTcStages * kBStage<X>);  // [w]
  const bool table = W <= kTableMax;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = (warp / kWarpsN) * 32, wc = (warp % kWarpsN) * (8 * kJ);  // its block of D
  const int g = lane >> 2, tq = lane & 3;                 // mma fragment coordinates
  const int nk = (W + kTcBK - 1) / kTcBK;                 // chunks per item
  const int per_tile = row_blocks * col_blocks;
  const int my_items = (items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int nq = my_items * nk;                           // chunks of this block
  uint64_t once;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(once));

  // each window row's X row relative to the tile's core, worked out once
  if (table) {
    for (int w = tid; w < W; w += kTcThreads) woff[w] = window_row(w, 0, bc, gb_c, far);
  }
  __syncthreads();

  // half slabs or X: the slab chunk, 64 rows × 32 window columns in runs of E
  auto load_slab = [&](auto elems, S* a, const S* St, const Cursor& cu, int w0) {
    constexpr int E = decltype(elems)::value;
    constexpr int kRuns = kTcBK / E;  // runs a row
#pragma unroll 4
    for (int p = 0; p < kTcBM * kRuns / kTcThreads; ++p) {
      const int e = tid + p * kTcThreads;
      const int m = e / kRuns, kk = (e % kRuns) * E;
      const bool ok = cu.r0 + m < gb_r && w0 + kk < W;
      copy_chunk<S, E, true>(a + m * kAStride + kk,
                             ok ? St + static_cast<int64_t>(cu.r0 + m) * W + w0 + kk : Sm, ok,
                             once);
    }
  };
  // the window chunk: 32 window rows × 128 columns in runs of E (a run of
  // 16 bytes: a warp copies whole rows)
  auto load_window = [&](auto elems, X* b, const Cursor& cu, int w0, int64_t row0) {
    constexpr int E = decltype(elems)::value;
    constexpr int kRuns = kTcBN / E;
#pragma unroll 4
    for (int p = 0; p < kTcBK * kRuns / kTcThreads; ++p) {
      const int e = tid + p * kTcThreads;
      const int kk = e / kRuns, cq = (e % kRuns) * E;
      const int w = w0 + kk;
      int64_t xr = -1;  // -1 past the window
      if (w < W) xr = table ? row0 + woff[w] : window_row(w, row0, bc, gb_c, far);
      const bool ok = xr >= 0 && xr < x_rows && cu.c0 + cq < k;
      copy_chunk<X, E>(b + kk * kBS + cq, ok ? Xm + xr * k + cu.c0 + cq : Xm, ok, once);
    }
  };
  constexpr int kS16 = 16 / sizeof(S), kS4 = 4 / sizeof(S);
  constexpr int kX16 = 16 / sizeof(X), kX4 = 4 / sizeof(X);
  auto load_stage = [&](int stage, const Cursor& cu) {
    const int w0 = cu.kt * kTcBK;
    const S* St = Sm + cu.t * gb_r * static_cast<int64_t>(W);
    const int64_t row0 = (tile0 + cu.t) * gb_c;
    S* a = As + stage * kAStage;
    X* b = Bs + stage * kBStage<X>;
    if constexpr (sizeof(S) == 4 && sizeof(X) == 4) {
      // f32 slabs and X: loops of their own, 16- or 4-byte copies (through
      // the generic loops above the f32 kernel takes 108 registers, not 98,
      // and measured 3.7 % slower on an H100: kernel_probe --slab)
      if (s_chunk == 4) {  // 64 rows × 8 runs of 4
#pragma unroll
        for (int p = 0; p < kTcBM * kTcBK / 4 / kTcThreads; ++p) {
          const int e = tid + p * kTcThreads;
          const int m = e >> 3, kk = (e & 7) * 4;
          const bool ok = cu.r0 + m < gb_r && w0 + kk < W;
          copy_chunk<S, 4, true>(a + m * kAStride + kk,
                                 ok ? St + static_cast<int64_t>(cu.r0 + m) * W + w0 + kk : Sm,
                                 ok, once);
        }
      } else {
#pragma unroll 4
        for (int p = 0; p < kTcBM * kTcBK / kTcThreads; ++p) {
          const int e = tid + p * kTcThreads;
          const int m = e >> 5, kk = e & 31;
          const bool ok = cu.r0 + m < gb_r && w0 + kk < W;
          copy_chunk<S, 1, true>(a + m * kAStride + kk,
                                 ok ? St + static_cast<int64_t>(cu.r0 + m) * W + w0 + kk : Sm,
                                 ok, once);
        }
      }
      auto xrow = [&](int w) -> int64_t {  // -1 past the window
        if (w >= W) return -1;
        return table ? row0 + woff[w] : window_row(w, row0, bc, gb_c, far);
      };
      if (x_chunk == 4) {  // 32 window rows × 32 runs of 4: a warp copies whole rows
        const int cq = (tid & 31) * 4;
#pragma unroll
        for (int p = 0; p < kTcBK * kTcBN / 4 / kTcThreads; ++p) {
          const int kk = (tid >> 5) + p * (kTcThreads / 32);
          const int64_t xr = xrow(w0 + kk);
          const bool ok = xr >= 0 && xr < x_rows && cu.c0 + cq < k;
          copy_chunk<X, 4>(b + kk * kBS + cq, ok ? Xm + xr * k + cu.c0 + cq : Xm, ok, once);
        }
      } else {  // one column a thread
        const int col = tid % kTcBN;
        for (int p = 0; p < kTcBK * kTcBN / kTcThreads; ++p) {
          const int kk = tid / kTcBN + p * (kTcThreads / kTcBN);
          const int64_t xr = xrow(w0 + kk);
          const bool ok = xr >= 0 && xr < x_rows && cu.c0 + col < k;
          copy_chunk<X, 1>(b + kk * kBS + col, ok ? Xm + xr * k + cu.c0 + col : Xm, ok, once);
        }
      }
    } else {
      // a 4-byte run of an f32 operand is one element: one path, not two
      if (s_chunk == kS16) {
        load_slab(std::integral_constant<int, kS16>{}, a, St, cu, w0);
      } else if (kS4 > 1 && s_chunk == kS4) {
        load_slab(std::integral_constant<int, kS4>{}, a, St, cu, w0);
      } else {
        load_slab(std::integral_constant<int, 1>{}, a, St, cu, w0);
      }
      if (x_chunk == kX16) {
        load_window(std::integral_constant<int, kX16>{}, b, cu, w0, row0);
      } else if (kX4 > 1 && x_chunk == kX4) {
        load_window(std::integral_constant<int, kX4>{}, b, cu, w0, row0);
      } else {
        load_window(std::integral_constant<int, 1>{}, b, cu, w0, row0);
      }
    }
  };

  float acc[2][kJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  Cursor ld, cu;  // the next chunk to load, the chunk to multiply
  ld.at(blockIdx.x, per_tile, col_blocks);
  cu = ld;
#pragma unroll
  for (int p = 0; p < kTcStages - 1; ++p) {
    if (p < nq) {
      load_stage(p, ld);
      ld.next(nk, per_tile, col_blocks);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  int stage = 0;  // q % kTcStages
  for (int q = 0; q < nq; ++q) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kTcStages - 2) : "memory");
    __syncthreads();  // chunk q is in for all; chunk q - 1's stage is free
    if (q + kTcStages - 1 < nq) {
      load_stage(stage == 0 ? kTcStages - 1 : stage - 1, ld);
      ld.next(nk, per_tile, col_blocks);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    // warps whose rows or columns all lie past the edge skip the products
    const bool live = cu.r0 + wr < gb_r && cu.c0 + wc < k;
    const int kk_end = min(kTcBK, W - cu.kt * kTcBK);  // rows of W in this chunk
    if (live) {
      const S* a = As + stage * kAStage;
      const X* b = Bs + stage * kBStage<X>;
#pragma unroll
      for (int kk = 0; kk < kTcBK; kk += 8) {
        if (kk >= kk_end) break;
        uint32_t ahi[2][4], alo[2][4], bhi[kJ][2], blo[kJ][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tf32_frag<kSplitA && kSplitB>(a + (wr + i * 16 + g) * kAStride + kk + 2 * tq, ahi[i],
                                        alo[i]);
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const X* p = b + (kk + 2 * tq) * kBS + wc + j * 8 + g;
          tf32_parts<kSplitA && kSplitB>(p[0], bhi[j][0], blo[j][0]);
          tf32_parts<kSplitA && kSplitB>(p[kBS], bhi[j][1], blo[j][1]);
        }
        // the small terms first; each pass is 8 independent products
        if constexpr (kSplitA && kSplitB) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < kJ; ++j) mma_tf32(acc[i][j], alo[i], blo[j]);
        }
        if constexpr (kSplitA) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < kJ; ++j) mma_tf32(acc[i][j], alo[i], bhi[j]);
        }
        if constexpr (kSplitB) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < kJ; ++j) mma_tf32(acc[i][j], ahi[i], blo[j]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < kJ; ++j) mma_tf32(acc[i][j], ahi[i], bhi[j]);
      }
    }
    stage = stage + 1 == kTcStages ? 0 : stage + 1;
    if (cu.kt == nk - 1) {
      // the item's last chunk: store its block of Y and start the next one
      if (live) {
        const int64_t frame_tile = tile0 + cu.t;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // fragment rows g and g + 8
            const int row = cu.r0 + wr + i * 16 + g + h * 8;
            const int64_t yr = frame_tile * gb_r + row;
            if (row >= gb_r || yr >= y_rows) continue;
            O* y = Y + yr * k;
#pragma unroll
            for (int j = 0; j < kJ; ++j) {
              store_pair(y, cu.c0 + wc + j * 8 + 2 * tq, k, y_vec, acc[i][j][2 * h],
                         acc[i][j][2 * h + 1]);
            }
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    cu.next(nk, per_tile, col_blocks);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the widest copy (elements of T) that rows of `len` elements at `p` allow:
// 16 bytes, else 4 bytes, else one element
template <typename T>
int chunk_elems(const T* p, int64_t len) {
  const auto fits = [&](int bytes) {
    const int e = bytes / static_cast<int>(sizeof(T));
    return e >= 1 && len % e == 0 && reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  if (fits(16)) return 16 / static_cast<int>(sizeof(T));
  if (fits(4)) return 4 / static_cast<int>(sizeof(T));
  return 1;
}

template <typename S, typename X, typename O>
int launch_tc(const S* Sm, const X* Xm, O* Y, const int* far_offsets, int nfar, int bc,
              int gb_r, int gb_c, int W, int64_t ntiles, int64_t x_rows, int64_t tile0,
              int64_t y_rows, int k, void* stream) {
  if (nfar < 0 || nfar > kMaxFar || bc < 1 || gb_r < 1 || gb_c < 1 || k < 1 ||
      W != 2 * bc + gb_c * (1 + nfar) || ntiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_blocks = (gb_r + kTcBM - 1) / kTcBM;
  const int col_blocks = (k + kTcBN - 1) / kTcBN;
  const int64_t items = ntiles * row_blocks * col_blocks;
  const int64_t nk = (W + kTcBK - 1) / kTcBK;
  if (items * nk > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  FarOffsets far = {};
  for (int f = 0; f < nfar; ++f) far.d[f] = far_offsets[f];
  const int s_chunk = chunk_elems(Sm, W);
  const int x_chunk = chunk_elems(Xm, k);
  const bool y_vec = k % 2 == 0 && reinterpret_cast<uintptr_t>(Y) % (2 * sizeof(O)) == 0;
  constexpr int kSmem = kTcSmem<S, X>;
  const int smem = kSmem + (W <= kTableMax ? W * static_cast<int>(sizeof(int64_t)) : 0);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(slab_spmm_tc_kernel<S, X, O>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem + kTableMax * static_cast<int>(sizeof(int64_t)));
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = items < 2LL * sms ? items : 2LL * sms;  // two resident per SM
  slab_spmm_tc_kernel<S, X, O><<<static_cast<unsigned>(blocks), kTcThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      Sm, Xm, Y, far, bc, gb_r, gb_c, W, x_rows, tile0, y_rows, k, static_cast<int>(items),
      row_blocks, col_blocks, s_chunk, x_chunk, y_vec);
  return static_cast<int>(cudaGetLastError());
}

// ---- f64 and f32 -> f64: plain FMAs -------------------------------------
// One CTA of 256 threads per (tile, 64 slab rows, 128 columns), each thread
// a 4 × 8 micro-tile of sums in registers.  W is covered in chunks of kBK =
// 16: per chunk the CTA stages the slab chunk (transposed, so a thread's 4
// rows are one 16-byte load) and the matching window rows in shared memory,
// whose size does not grow with the window count.  A thread's 8 columns are
// two runs of 4 (tx·4 and 64 + tx·4): 16-byte shared loads without bank
// conflicts, and contiguous Y stores.

// T: slab and X type; O: output and accumulation type
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
slab_spmm_kernel(const T* __restrict__ S, const T* __restrict__ X, O* __restrict__ Y,
                 const FarOffsets far, int bc, int gb_r, int gb_c, int W,
                 int64_t x_rows, int64_t tile0, int64_t y_rows, int k) {
  __shared__ __align__(16) O As[kBK][kBM + kPad];  // slab chunk, As[w][row]
  __shared__ __align__(16) O Bs[kBK][kBN];         // window chunk, Bs[w][col]

  const int64_t t = blockIdx.x;
  const int r0 = blockIdx.y * kBM;
  const int c0 = blockIdx.z * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t frame_tile = tile0 + t;
  const int64_t row0 = frame_tile * gb_c;
  const T* St = S + t * gb_r * static_cast<int64_t>(W);

  O acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = O(0);

  for (int w0 = 0; w0 < W; w0 += kBK) {
#pragma unroll
    for (int q = 0; q < kBM * kBK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int kk = e % kBK, m = e / kBK;
      const int row = r0 + m, w = w0 + kk;
      As[kk][m] = (row < gb_r && w < W) ? O(__ldg(St + static_cast<int64_t>(row) * W + w))
                                        : O(0);
    }
#pragma unroll
    for (int q = 0; q < kBK * kBN / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int col = e % kBN, kk = e / kBN;
      const int w = w0 + kk;
      O v = O(0);
      if (w < W && c0 + col < k) {
        const int64_t xr = window_row(w, row0, bc, gb_c, far);
        if (xr >= 0 && xr < x_rows) v = O(__ldg(X + xr * k + c0 + col));
      }
      Bs[kk][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      O a[kTM], b0[4], b1[4];
      lds4(&As[kk][ty * kTM], a);
      lds4(&Bs[kk][tx * 4], b0);
      lds4(&Bs[kk][64 + tx * 4], b1);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][e] = fma_t(a[i], b0[e], acc[i][e]);
          acc[i][4 + e] = fma_t(a[i], b1[e], acc[i][4 + e]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = r0 + ty * kTM + i;
    const int64_t yr = frame_tile * gb_r + row;
    if (row >= gb_r || yr >= y_rows) continue;
    O* y = Y + yr * k;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col < k) y[col] = acc[i][j];
    }
  }
}

template <typename T, typename O>
int launch(const T* S, const T* X, O* Y, const int* far_offsets, int nfar, int bc,
           int gb_r, int gb_c, int W, int64_t ntiles, int64_t x_rows, int64_t tile0,
           int64_t y_rows, int k, void* stream) {
  if (nfar < 0 || nfar > kMaxFar || bc < 1 || gb_r < 1 || gb_c < 1 || k < 1 ||
      W != 2 * bc + gb_c * (1 + nfar) || ntiles < 1 || ntiles > 0x7fffffff ||
      (gb_r + kBM - 1) / kBM > 65535 || (k + kBN - 1) / kBN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FarOffsets far = {};
  for (int f = 0; f < nfar; ++f) far.d[f] = far_offsets[f];
  const dim3 grid(static_cast<unsigned>(ntiles), static_cast<unsigned>((gb_r + kBM - 1) / kBM),
                  static_cast<unsigned>((k + kBN - 1) / kBN));
  slab_spmm_kernel<T, O><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      S, X, Y, far, bc, gb_r, gb_c, W, x_rows, tile0, y_rows, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes
// (cask_tpu_torch/ops/kernels/bdia_slab_kernels.py).  S, X and Y are device
// pointers; `far_offsets` is a host array of nfar block offsets.  Body tile t
// reads the frame's X rows around (tile0 + t)·gb_c (rows outside [0, x_rows)
// read as zero) and writes Y rows (tile0 + t)·gb_r + q below y_rows.  The
// launch goes on `stream` and does not synchronise.  Returns the cudaError_t
// of the launch (0 = cudaSuccess).
extern "C" {

int cask_slab_spmm_f32(const float* S, const float* X, float* Y, const int* far_offsets,
                       int nfar, int bc, int gb_r, int gb_c, int W, long long ntiles,
                       long long x_rows, long long tile0, long long y_rows, int k,
                       void* stream) {
  return launch_tc(S, X, Y, far_offsets, nfar, bc, gb_r, gb_c, W, ntiles, x_rows, tile0,
                   y_rows, k, stream);
}

int cask_slab_spmm_f64(const double* S, const double* X, double* Y, const int* far_offsets,
                       int nfar, int bc, int gb_r, int gb_c, int W, long long ntiles,
                       long long x_rows, long long tile0, long long y_rows, int k,
                       void* stream) {
  return launch<double, double>(S, X, Y, far_offsets, nfar, bc, gb_r, gb_c, W, ntiles,
                                x_rows, tile0, y_rows, k, stream);
}

// f32 slabs and X, f64 output and sums (accum_dtype=float64)
int cask_slab_spmm_f32_f64(const float* S, const float* X, double* Y,
                           const int* far_offsets, int nfar, int bc, int gb_r, int gb_c,
                           int W, long long ntiles, long long x_rows, long long tile0,
                           long long y_rows, int k, void* stream) {
  return launch<float, double>(S, X, Y, far_offsets, nfar, bc, gb_r, gb_c, W, ntiles,
                               x_rows, tile0, y_rows, k, stream);
}

// Half slabs and/or X (the other of the same half type or f32) on the
// tensor cores, f32 sums; Y f32 or that half type.  The name gives the slab,
// X and Y types.
#define CASK_SLAB_SPMM(NAME, S_T, X_T, O_T)                                                  \
  int NAME(const S_T* S, const X_T* X, O_T* Y, const int* far_offsets, int nfar, int bc,     \
           int gb_r, int gb_c, int W, long long ntiles, long long x_rows, long long tile0,   \
           long long y_rows, int k, void* stream) {                                          \
    return launch_tc(S, X, Y, far_offsets, nfar, bc, gb_r, gb_c, W, ntiles, x_rows, tile0,   \
                     y_rows, k, stream);                                                     \
  }
CASK_SLAB_SPMM(cask_slab_spmm_bf16_bf16_f32, __nv_bfloat16, __nv_bfloat16, float)
CASK_SLAB_SPMM(cask_slab_spmm_bf16_bf16_bf16, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16)
CASK_SLAB_SPMM(cask_slab_spmm_bf16_f32_f32, __nv_bfloat16, float, float)
CASK_SLAB_SPMM(cask_slab_spmm_bf16_f32_bf16, __nv_bfloat16, float, __nv_bfloat16)
CASK_SLAB_SPMM(cask_slab_spmm_f32_bf16_f32, float, __nv_bfloat16, float)
CASK_SLAB_SPMM(cask_slab_spmm_f32_bf16_bf16, float, __nv_bfloat16, __nv_bfloat16)
CASK_SLAB_SPMM(cask_slab_spmm_f16_f16_f32, __half, __half, float)
CASK_SLAB_SPMM(cask_slab_spmm_f16_f16_f16, __half, __half, __half)
CASK_SLAB_SPMM(cask_slab_spmm_f16_f32_f32, __half, float, float)
CASK_SLAB_SPMM(cask_slab_spmm_f16_f32_f16, __half, float, __half)
CASK_SLAB_SPMM(cask_slab_spmm_f32_f16_f32, float, __half, float)
CASK_SLAB_SPMM(cask_slab_spmm_f32_f16_f16, float, __half, __half)
#undef CASK_SLAB_SPMM

const char* cask_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
