// Blocked (flash) attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces: seldon_core_tpu/ops/flash_attention.py:_flash_kernel (the
// Pallas TPU kernel behind flash_attention(), called from
// DecoderLM.prefill). Same function: softmax(q k^T / sqrt(Dh)) v with an
// optional causal mask (row i sees keys j <= i) and an optional key-length
// mask (keys j >= kv_len hidden), f32 online-softmax state, masking by the
// finite NEG_INF = -1e30, and an l == 0 guard on the final divide.
//
// Routes, by (dtype, head dim):
//   bfloat16, Dh % 8 == 0, Dh <= 256  -> wgmma (tensor cores, TMA loads):
//       Dh 8..64 on the DH 64 instance, 72..128 on DH 128, 136..256 on
//       DH 256; a head dim below its instance's width is padded by TMA
//   bfloat16, Dh % 8 != 0             -> mma (mma.sync bf16; a head stride
//       of Dh * 2 bytes is no multiple of 16, which TMA needs)
//   float32, every Dh <= 256          -> mma (3xTF32 on the tensor cores:
//       float32 is the exactness dtype, so no one-pass TF32)
//
// What bounds it on the H100: the work is 4 * T^2 * Dh FLOPs per (b, h)
// (halved by the causal mask) against 4 * T * Dh elements of q/k/v/o
// traffic, ~T/2 FLOPs per byte in bf16 -- above the card's ~295 FLOP/byte
// balance point from T ~ 600, so long prompts are bound by the tensor
// cores (989 TFLOP/s bf16, reached only through wgmma) and short ones by
// memory and by the latency of one block's chain of loads and products.
// Narrow heads (Dh 8-32) are latency-bound tiny grids at any T: their
// padded products cost 2x-8x the FLOPs they need, on tensor cores.
// float32 does three TF32 products per f32 product (495 / 3 = 165 TFLOP/s
// of f32 work at best) over twice the bytes, so its balance point is ~49
// FLOPs per byte against ~T/4 (compute-bound from T ~ 200); but at the
// grids the serving path gives it (B * H * T / 16 warps of 16 rows: 256
// at Dh 256, B=1, T=512) what bounds it first is latency and grid fill --
// one or two warps on each SM sub-partition -- and then the 3xTF32
// product rate.
//
// bfloat16, a warp-specialised wgmma kernel (WgmmaTile<DH, NC>):
//  * One block per (b*h, q tile of BLOCK_M = 64 or 128 rows), the longest
//    causal q tiles launched first. The block is one producer warpgroup and
//    BLOCK_M / 64 consumer warpgroups; the producer gives up registers
//    (setmaxnreg.dec), the consumers take them (setmaxnreg.inc) for their
//    64 x TILE_N score and 64 x DH output accumulators.
//  * One producer thread starts every load with TMA: the Q tile once, then
//    TILE_N-key K and V tiles through a ring of STAGES shared-memory
//    stages, each with a "full" mbarrier per operand (expect_tx carries the
//    bytes) and an "empty" mbarrier the consumer warps arrive on once the
//    P.V product that read the stage has completed. The tensor maps are 4-D
//    ([Dh, T, heads, B] with the views' own strides), so the ragged T edge
//    of each (b, h) loads as zeros, grouped K/V is read in place (kv head
//    h / rep) and head-transposed q/k/v views need no copy. Rows are 128
//    bytes (64 bf16) with the 128-byte swizzle, so DH is DH / 64 panels.
//  * Padded head dims: the maps' innermost extent is the real Dh while the
//    box stays 64 columns, so TMA fills the columns past Dh with zeros on
//    load (Q K^T is unchanged; expect_tx counts the whole box) and clips
//    them on the store of O; panels wholly past Dh are not stored. The
//    softmax scale is 1/sqrt(real Dh).
//  * Tiles per instance: DH 64 and 128 take 128-key tiles in 3 stages
//    (225 KB at DH 128, BLOCK_M 128). At DH 256 a 128-key K tile alone is
//    64 KB, so the instance takes 64-key tiles: 3 stages beside one
//    warpgroup's Q (225 KB), 2 beside two (193 KB).
//  * S = Q K^T: wgmma m64nTILE_Nk16 with both operands read from the
//    swizzled tiles through matrix descriptors (K-major), f32 accumulators,
//    DH / 16 k16 steps.
//  * Online softmax in registers: one FFMA per score folds 1/sqrt(Dh),
//    log2(e) and the row max, exponents are one ex2.approx each; only tiles
//    that cross the causal diagonal or the kv_len edge are masked; row max
//    reduces over the 4 threads of a quad, the row sum only once at the end.
//  * O += P V: wgmma m64nDHk16 with P packed to bf16 straight from the S
//    accumulators (their layout is wgmma's register-A layout, k16 slice by
//    k16 slice) and V read in its natural [key][d] layout as a transposed
//    (MN-major) B operand whose leading-byte offset steps over the DH / 64
//    panels: no copy of V is made. At DH 256 a consumer thread holds 128
//    O, 32 S and 16 packed-P registers.
//  * Epilogue: divide by the row sum, round to bf16, write the tile into the
//    warpgroup's own (now unused) Q stage in the swizzled layout and store
//    it with TMA, which clips the ragged Tq edge and the padded columns.
//  * Not yet (PERF.md): softmax of one tile overlapped with the products
//    of the next inside a warpgroup (ping-pong), a persistent grid.
//
// mma (float32 at every head dim, bfloat16 at head dims that are not a
// multiple of 8), flash_fwd_mma_kernel<T, DMAX, KSPLIT>:
//  * One block of 4 warps per (b*h, q tile), the longest causal q tiles
//    first; a warp runs mma.sync on 16 q rows (m16n8k8 tf32 for float32,
//    m16n8k16 bf16). KSPLIT 1: 64 rows a block, each warp over every key.
//    KSPLIT 2: 32 rows, the two warps of a row group each taking half of
//    every key tile with its own row max, sum and O, merged through shared
//    memory at the end -- twice the blocks and half the chain of products
//    a warp, which the caller takes below three waves of blocks (on the
//    H100 it is 23% faster at 256 blocks of 64 rows, 18-23% slower at 512).
//  * Tiles from the real head dim: shared-memory rows hold Dh rounded up
//    to the S product's k (8 at tf32, 16 at bf16), zero past Dh, padded by
//    16 bytes so that each fragment read hits 32 banks. S = Q K^T runs over
//    that width; O = P V over Dh rounded up to 8 below 32 columns (by
//    instance: DMAX 8, 16, 32) and to 32 above (a group of 4 n8 tiles
//    wholly past Dh is skipped), so Dh 8 does its own work, not 8x it.
//  * K/V through a 2-stage cp.async ring: tile i + 1 loads while tile i
//    computes. Copies are 16, 8 or 4 bytes wide, one width for the launch,
//    picked by the caller from the views' alignment (any stride is taken);
//    bfloat16 rows 2 bytes apart go by plain 2-byte loads. Rows past Tq or
//    kv_len are zero-filled and not read. Keys per tile: 64 up to DMAX
//    64, 32 above; shared memory at Dh 256 float32 is 166,400 B (32 rows)
//    or 199,680 B (64 rows), one block an SM; at Dh 128, two.
//  * float32 as 3xTF32 (the recipe of CUTLASS's OpMultiplyAddFastF32):
//    each operand splits into hi = rna(x) and lo = rna(x - hi), rounded to
//    nearest (ties away) with two integer operations each, bit for bit
//    cvt.rna.tf32.f32; a product is hi.hi + hi.lo + lo.hi with f32
//    accumulators (the small terms in their own accumulator: two chains of
//    products), both in S and in P V. P needs no shuffle: a k8 step's keys
//    are read in the order 2t, 2t + 1, so the S accumulators are P's A
//    fragment and V's B fragment comes from key rows 2t and 2t + 1.
//  * bfloat16: P packs to bf16 from the S accumulators of two n8 tiles
//    (the A fragment of k16); V's B fragment by ldmatrix.trans.
//  * Softmax as on the wgmma route: raw-score row max over the quad, one
//    FFMA per score folding 1/sqrt(Dh) * log2(e), ex2.approx, edge tiles
//    masked only; a warp skips a key range wholly past its causal rows.
//  * What it costs (H100, flash_variants.py): the splits are ~20% of
//    the float32 time and the two extra products 5-9%; the rest is the
//    latency of 1-2 warps a scheduler. Not yet: the 3xTF32 split done
//    once a block in shared memory instead of by every warp.
//
// Launch contract: the caller (ops/flash_attention.py) checks shapes,
// dtypes, strides and alignment (TMA needs a 16-byte aligned base and byte
// strides that are multiples of 16), allocates the output, and passes the
// current CUDA stream; the kernel allocates nothing. The C entry point
// returns cudaGetLastError() after the launch, or minus the CUresult when a
// tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper_ptx.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, t;  // element strides; the head dim is contiguous
};

// Sets the dynamic shared-memory opt-in (needed above 48 KB) once per
// kernel and device, so that a launch inside CUDA-graph capture makes no
// other CUDA call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// 2^x in one MUFU instruction (exp2f without fast-math is a longer
// sequence); 2^(-1e30) flushes to 0, as a masked score must
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// mma route: float32 at every head dim (3xTF32), bfloat16 at head dims that
// are not a multiple of 8; mma.sync warp by warp, K/V through a 2-stage
// cp.async ring
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;  // a block: 64 / block_m key splits x block_m / 16 row groups

// The instance for a head dim: its O registers hold DMAX columns (8, 16,
// 32, 64, 128 or 256; 0 above 256)
constexpr int mma_instance(int dh) {
  return dh <= 8 ? 8 : dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128
       : dh <= 256 ? 256 : 0;
}

// keys per K/V tile: 64 up to 64 columns, 32 above (a float32 stage of 64
// keys would take 2 x 66 KB at DMAX 256)
__host__ __device__ constexpr int mma_tile_n(int dmax) { return dmax <= 64 ? 64 : 32; }

// Columns a shared-memory row holds: the head dim rounded up to the S
// product's k (8 at tf32, 16 at bf16), zero past dh; the row stride adds
// 16 bytes, so that the fragment reads of 8 rows at once hit 32 banks.
__host__ __device__ constexpr int mma_width(int dh, int es) {
  return es == 4 ? (dh + 7) / 8 * 8 : (dh + 15) / 16 * 16;
}
__host__ __device__ constexpr int mma_ld(int dh, int es) { return mma_width(dh, es) + 16 / es; }

// Q (block_m rows) and two stages of K and V tiles; after the loop, with
// the keys split between two warps, the merge of their partial rows (32
// lanes x (DMAX / 2 + 4) floats a row group) reuses the space
constexpr int mma_smem_bytes(int dh, int es, int block_m) {
  const int tiles = (block_m + 4 * mma_tile_n(mma_instance(dh))) * mma_ld(dh, es) * es;
  const int merge = block_m == 32 ? (block_m / 16) * 32 * (mma_instance(dh) / 2 + 4) * 4 : 0;
  return tiles > merge ? tiles : merge;
}

// A thread's walk over the chunks (of VB bytes, cpr of them a row) of a
// tile's rows: chunk threadIdx.x first, then every blockDim.x-th. Set up
// once, with one divide; the same walk serves every tile.
struct Walk {
  int r, c, dr, dc, cpr;
};

// Rows [row0, row0 + rows) of one (b, head) of a [T, dh] view (row stride
// ld_g elements) into shared memory (row stride ld_s); rows at or past
// `limit` are zero-filled and not read. VB 16, 8 and 4 go by cp.async, 2
// (bfloat16 rows 2 bytes apart) by plain loads.
template <int VB, typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld_s, const T* src, long long ld_g,
                                          int row0, int rows, int limit, Walk w) {
  constexpr int E = VB / static_cast<int>(sizeof(T));
  for (int r = w.r, c = w.c; r < rows;) {
    const int row = row0 + r;
    const bool ok = row < limit;
    const T* g = src + (ok ? row * ld_g : 0) + c * E;
    T* s = dst + r * ld_s + c * E;
    if constexpr (VB == 2) {
      *reinterpret_cast<uint16_t*>(s) = ok ? *reinterpret_cast<const uint16_t*>(g) : 0;
    } else {
      hopper::cp_async<VB>(hopper::smem_u32(s), g, ok);
    }
    r += w.dr;
    c += w.dc;
    if (c >= w.cpr) {
      c -= w.cpr;
      ++r;
    }
  }
}

template <typename T>
__device__ __forceinline__ void copy_rows_any(int vb, T* dst, int ld_s, const T* src, long long ld_g,
                                              int row0, int rows, int limit, Walk w) {
  switch (vb) {
    case 16:
      copy_rows<16>(dst, ld_s, src, ld_g, row0, rows, limit, w);
      break;
    case 8:
      copy_rows<8>(dst, ld_s, src, ld_g, row0, rows, limit, w);
      break;
    case 4:
      copy_rows<4>(dst, ld_s, src, ld_g, row0, rows, limit, w);
      break;
    default:
      if constexpr (sizeof(T) == 2) copy_rows<2>(dst, ld_s, src, ld_g, row0, rows, limit, w);
      break;
  }
}

// x = hi + lo, both TF32: hi rounded to nearest, lo the rounded remainder
// (x - hi is exact in f32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = hopper::tf32_rna(x);
  lo = hopper::tf32_rna(x - __uint_as_float(hi));
}

// 3xTF32: D += A B as hi.hi + hi.lo + lo.hi (the lo.lo term is below f32's
// rounding); the small terms go to their own accumulator, so that the
// warp has two independent chains of products per tile
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  hopper::mma_m16n8k8_tf32(small, al, bh);
  hopper::mma_m16n8k8_tf32(small, ah, bl);
  hopper::mma_m16n8k8_tf32(big, ah, bh);
}

// T is float (3xTF32 products) or __nv_bfloat16 (bf16 products); f32
// accumulators and softmax either way, the output rounded to T at the
// store. DMAX bounds the head dim (O is DMAX / 8 n8 tiles a thread); the
// real head dim `dh` is a run-time argument: S runs over dh rounded up to
// the product's k, P.V over dh rounded up to 32 columns (8 below 32, by
// instance), and the columns past dh are zero in shared memory and never
// stored. The block's 4 warps are 4 / KSPLIT row groups of 16 q rows, and
// the KSPLIT warps of a row group share every key tile: warp `half` takes
// keys [half * BN / KSPLIT, (half + 1) * BN / KSPLIT) of each, with its own
// row max, sum and O; at the end the halves merge through shared memory.
template <typename T, int DMAX, int KSPLIT>
__global__ void __launch_bounds__(32 * MMA_WARPS)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     int H, int rep, int Tq, int kv_limit, int causal, int dh,
                     float scale_log2, Strides qs, Strides ks, Strides vs, Strides os,
                     int copy_bytes) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int BN = mma_tile_n(DMAX);          // keys a tile
  constexpr int KW = BN / KSPLIT;               // keys a warp takes of each tile
  constexpr int NT = KW / 8;                    // n8 tiles of S (keys)
  constexpr int NO = DMAX / 8;                  // n8 tiles of O (columns)
  constexpr int GJ = NO < 4 ? NO : 4;           // O tiles per P.V group
  constexpr int GROUPS = MMA_WARPS / KSPLIT;    // row groups
  constexpr int BM = 16 * GROUPS;               // q rows a block
  extern __shared__ __align__(16) uint8_t mma_smem[];

  const int ld = mma_ld(dh, sizeof(T));
  const int width = mma_width(dh, sizeof(T));
  T* Qs = reinterpret_cast<T*>(mma_smem);  // [BM][ld]
  T* Ks = Qs + BM * ld;                    // [2][BN][ld]
  T* Vs = Ks + 2 * BN * ld;                // [2][BN][ld]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int grp = warp % GROUPS, half = warp / GROUPS;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal tiles first
  const int wrow0 = q0 + 16 * grp;
  const int row0 = wrow0 + g, row1 = row0 + 8;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  T* op = o + b * os.b + h * os.h;

  int k_end = kv_limit;
  if (causal) k_end = min(k_end, min(q0 + BM, Tq));  // keys past the last row are masked
  const int n_tiles = (k_end + BN - 1) / BN;
  // this warp's rows see keys below w_end: a key range wholly past it is
  // skipped (the loads are the block's)
  const int w_end = causal ? min(kv_limit, wrow0 + 16) : kv_limit;
  const bool w_live = wrow0 < Tq;

  // the columns between dh and the row's width are zero for the whole run
  if (width > dh) {
    const int pad = width - dh;
    for (int i = tid; i < (BM + 4 * BN) * pad; i += blockDim.x) {
      const int r = i / pad;
      Qs[r * ld + dh + (i - r * pad)] = T(0.f);
    }
  }

  Walk w;
  w.cpr = dh * static_cast<int>(sizeof(T)) / copy_bytes;
  w.r = tid / w.cpr;
  w.c = tid - w.r * w.cpr;
  w.dr = blockDim.x / w.cpr;
  w.dc = blockDim.x - w.dr * w.cpr;
  copy_rows_any(copy_bytes, Qs, ld, qp, qs.t, q0, BM, Tq, w);
  copy_rows_any(copy_bytes, Ks, ld, kp, ks.t, 0, BN, kv_limit, w);
  copy_rows_any(copy_bytes, Vs, ld, vp, vs.t, 0, BN, kv_limit, w);
  hopper::cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // raw-score row max; partial row sums
  const int nk = F32 ? width / 8 : width / 16;  // k steps of S
  const int nn = (dh + 7) / 8;                   // O tiles holding a column below dh

  for (int i = 0; i < n_tiles; ++i) {
    const int n0 = i * BN + half * KW;  // this warp's first key of the tile
    if (i + 1 < n_tiles) {  // the next tile's loads fly while this one computes
      const int st = (i + 1) & 1;
      copy_rows_any(copy_bytes, Ks + st * BN * ld, ld, kp, ks.t, (i + 1) * BN, BN, kv_limit, w);
      copy_rows_any(copy_bytes, Vs + st * BN * ld, ld, vp, vs.t, (i + 1) * BN, BN, kv_limit, w);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // tile i (and Q) is in shared memory for every thread

    if (w_live && n0 < w_end) {
      const T* Kt = Ks + ((i & 1) * BN + half * KW) * ld;
      const T* Vt = Vs + ((i & 1) * BN + half * KW) * ld;
      const T* Qw = Qs + 16 * grp * ld;

      // S = Q K^T over dh rounded up to k
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      if constexpr (F32) {
        float sl[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) sl[j][0] = sl[j][1] = sl[j][2] = sl[j][3] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < nk; ++kk) {
          const int c = 8 * kk + t;
          uint32_t ah[4], al[4];
          split_tf32(Qw[g * ld + c], ah[0], al[0]);
          split_tf32(Qw[(g + 8) * ld + c], ah[1], al[1]);
          split_tf32(Qw[g * ld + c + 4], ah[2], al[2]);
          split_tf32(Qw[(g + 8) * ld + c + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const T* kr = Kt + (8 * j + g) * ld + c;
            uint32_t bh[2], bl[2];
            split_tf32(kr[0], bh[0], bl[0]);
            split_tf32(kr[4], bh[1], bl[1]);
            mma_3xtf32(sc[j], sl[j], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += sl[j][e];
      } else {
        const uint32_t* Qw32 = reinterpret_cast<const uint32_t*>(Qw);
        const uint32_t* Kt32 = reinterpret_cast<const uint32_t*>(Kt);
        const int ld32 = ld / 2;
#pragma unroll 2
        for (int kk = 0; kk < nk; ++kk) {
          const int c = 8 * kk + t;  // in bf16 pairs
          const uint32_t a[4] = {Qw32[g * ld32 + c], Qw32[(g + 8) * ld32 + c],
                                 Qw32[g * ld32 + c + 4], Qw32[(g + 8) * ld32 + c + 4]};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t* kr = Kt32 + (8 * j + g) * ld32 + c;
            const uint32_t bf[2] = {kr[0], kr[4]};
            hopper::mma_m16n8k16_bf16(sc[j], a, bf);
          }
        }
      }

      // online softmax, as the wgmma route does it; only edge tiles are
      // masked, the row max reduces over the quad, the row sum at the end
      const bool edge = n0 + KW > kv_limit || (causal && n0 + KW - 1 > wrow0);
      float mt0 = NEG_INF, mt1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (edge) {
            const int col = n0 + 8 * j + 2 * t + e;
            const bool hidden = col >= kv_limit;
            if (hidden || (causal && col > row0)) sc[j][e] = NEG_INF;
            if (hidden || (causal && col > row1)) sc[j][2 + e] = NEG_INF;
          }
          mt0 = fmaxf(mt0, sc[j][e]);
          mt1 = fmaxf(mt1, sc[j][2 + e]);
        }
      }
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
      const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
      const float alpha0 = exp2_approx((m0 - mn0) * scale_log2);
      const float alpha1 = exp2_approx((m1 - mn1) * scale_log2);
      m0 = mn0;
      m1 = mn1;
      const float mb0 = mn0 * scale_log2, mb1 = mn1 * scale_log2;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[j][e] = exp2_approx(fmaf(sc[j][e], scale_log2, -mb0));
          sc[j][2 + e] = exp2_approx(fmaf(sc[j][2 + e], scale_log2, -mb1));
          rs0 += sc[j][e];
          rs1 += sc[j][2 + e];
        }
      }
      l0 = l0 * alpha0 + rs0;  // alpha is uniform over the quad: reduce l at the end
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= alpha0;
        acc[j][1] *= alpha0;
        acc[j][2] *= alpha1;
        acc[j][3] *= alpha1;
      }

      // O += P V, GJ O tiles at a time; a group wholly past dh is skipped,
      // and a tile past dh inside a group reads the last live tile's
      // columns (in the row, where the next tile would run past it): its
      // products land in columns that are never stored
      if constexpr (F32) {
        // the S accumulators are P's A fragment once the keys of each k8
        // step are read in the order 2t, 2t + 1 (not t, t + 4): a0 = c0,
        // a1 = c2, a2 = c1, a3 = c3; V's B fragment then comes from key
        // rows 2t and 2t + 1
        uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          split_tf32(sc[kk][0], ph[kk][0], pl[kk][0]);
          split_tf32(sc[kk][2], ph[kk][1], pl[kk][1]);
          split_tf32(sc[kk][1], ph[kk][2], pl[kk][2]);
          split_tf32(sc[kk][3], ph[kk][3], pl[kk][3]);
        }
#pragma unroll
        for (int j0 = 0; j0 < NO; j0 += GJ) {
          if (NO > GJ && 8 * j0 >= dh) break;
          int col[GJ];
#pragma unroll
          for (int jj = 0; jj < GJ; ++jj) col[jj] = 8 * min(j0 + jj, nn - 1);
          float small[GJ][4];
#pragma unroll
          for (int jj = 0; jj < GJ; ++jj) small[jj][0] = small[jj][1] = small[jj][2] = small[jj][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < NT; ++kk) {
            const T* vr = Vt + (8 * kk + 2 * t) * ld + g;
#pragma unroll
            for (int jj = 0; jj < GJ; ++jj) {
              uint32_t bh[2], bl[2];
              split_tf32(vr[col[jj]], bh[0], bl[0]);
              split_tf32(vr[col[jj] + ld], bh[1], bl[1]);
              mma_3xtf32(acc[j0 + jj], small[jj], ph[kk], pl[kk], bh, bl);
            }
          }
#pragma unroll
          for (int jj = 0; jj < GJ; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j0 + jj][e] += small[jj][e];
        }
      } else {
        // bf16: the S accumulators of n8 tiles 2kk and 2kk + 1 are P's A
        // fragment for k16 step kk; V's B fragment by ldmatrix.trans
        uint32_t pa[NT / 2][4];
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          pa[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
          pa[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
          pa[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          pa[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        }
        const uint32_t v_lane = hopper::smem_u32(Vt + (lane & 15) * ld);
#pragma unroll
        for (int j0 = 0; j0 < NO; j0 += GJ) {
          if (NO > GJ && 8 * j0 >= dh) break;
          int col[GJ];
#pragma unroll
          for (int jj = 0; jj < GJ; ++jj) col[jj] = 8 * min(j0 + jj, nn - 1);
#pragma unroll
          for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
            for (int jj = 0; jj < GJ; ++jj) {
              uint32_t bf[2];
              hopper::ldmatrix_x2_trans(
                  bf, v_lane + (16 * kk * ld + col[jj]) * static_cast<int>(sizeof(T)));
              hopper::mma_m16n8k16_bf16(acc[j0 + jj], pa[kk], bf);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // epilogue: full row sums, divide (a row with no visible key keeps
  // l == 0: zeros, not 0/0), store the columns below dh
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if constexpr (KSPLIT == 2) {
    // the second half of each row group hands its row max, sum and O to the
    // first through the (now idle) shared memory, lane by lane; the first
    // rescales both to the larger max and adds them
    constexpr int F = 4 * NO + 4;
    float* xs = reinterpret_cast<float*>(mma_smem) + grp * F * 32 + lane;
    if (half == 1) {
      xs[0] = m0;
      xs[32] = m1;
      xs[64] = l0;
      xs[96] = l1;
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[(4 + 4 * j + e) * 32] = acc[j][e];
    }
    __syncthreads();
    if (half == 1) return;
    const float mo0 = xs[0], mo1 = xs[32];
    const float mn0 = fmaxf(m0, mo0), mn1 = fmaxf(m1, mo1);
    const float a0 = exp2_approx((m0 - mn0) * scale_log2), b0 = exp2_approx((mo0 - mn0) * scale_log2);
    const float a1 = exp2_approx((m1 - mn1) * scale_log2), b1 = exp2_approx((mo1 - mn1) * scale_log2);
    l0 = l0 * a0 + xs[64] * b0;
    l1 = l1 * a1 + xs[96] * b1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] = acc[j][0] * a0 + xs[(4 + 4 * j) * 32] * b0;
      acc[j][1] = acc[j][1] * a0 + xs[(5 + 4 * j) * 32] * b0;
      acc[j][2] = acc[j][2] * a1 + xs[(6 + 4 * j) * 32] * b1;
      acc[j][3] = acc[j][3] * a1 + xs[(7 + 4 * j) * 32] * b1;
    }
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      if (col >= dh) continue;
      if (row0 < Tq) op[row0 * os.t + col] = T(acc[j][e] * inv0);
      if (row1 < Tq) op[row1 * os.t + col] = T(acc[j][2 + e] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 path: warp-specialised wgmma kernel fed by TMA
// ---------------------------------------------------------------------------

constexpr int WG = 128;          // threads per warpgroup
constexpr int ROW_BYTES = 128;   // one swizzled row: 64 bf16
constexpr int PANEL_COLS = 64;

template <int DH, int NC>  // instance width (64, 128, 256), consumer warpgroups (BLOCK_M / 64)
struct WgmmaTile {
  static constexpr int BLOCK_M = 64 * NC;
  static constexpr int PANELS = DH / PANEL_COLS;
  // keys per K/V tile (the S product's N) and K/V ring depth: at DH 256 a
  // 128-key K tile is 64 KB, so 64 keys, 3 stages beside one warpgroup's
  // Q, 2 beside two; 128 keys in 3 stages below
  static constexpr int TILE_N = DH == 256 ? 64 : 128;
  static constexpr int STAGES = DH == 256 && NC == 2 ? 2 : 3;
  static constexpr int Q_PANEL = 64 * ROW_BYTES;       // one warpgroup's rows, one panel
  static constexpr int KV_PANEL = TILE_N * ROW_BYTES;
  static constexpr int Q_BYTES = NC * PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;   // one K (or V) tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 3 * STAGES;        // q_full, k_full[], v_full[], kv_empty[]
  static constexpr int SMEM = BAR_OFF + 8 * N_BARS + 1024;  // + slack to align to 1024
  static constexpr int THREADS = (NC + 1) * WG;
  static_assert(SMEM <= 232448, "a block may take at most 227 KB of shared memory");
  // registers per thread after the producer/consumer split: the SM's 64K
  // registers hold one block
  static constexpr int PRODUCER_REGS = NC == 1 ? 56 : 24;
  static constexpr int CONSUMER_REGS = NC == 1 ? 256 : 240;
};

// S (+)= Q K^T over one k16 step, N = the instance's TILE_N keys
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&s)[N / 2], uint64_t desc_q, uint64_t desc_k, int scale_d);

template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&s)[64], uint64_t desc_q, uint64_t desc_k, int scale_d) {
  hopper::wgmma_m64n128k16_ss(s, desc_q, desc_k, scale_d);
}

template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&s)[32], uint64_t desc_q, uint64_t desc_k, int scale_d) {
  hopper::wgmma_m64n64k16_ss(s, desc_q, desc_k, scale_d);
}

// O += P V over one k16 step, N = the instance's DH columns
template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4], uint64_t desc_v);

template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128], const uint32_t (&a)[4], uint64_t desc_v) {
  hopper::wgmma_m64n256k16_rs_tb(o, a, desc_v);
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t desc_v) {
  hopper::wgmma_m64n128k16_rs_tb(o, a, desc_v);
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t desc_v) {
  hopper::wgmma_m64n64k16_rs_tb(o, a, desc_v);
}

// `dh` is the real head dim (<= DH): the maps zero-fill the columns past it
// and the epilogue stores only the panels that hold some of it.
template <int DH, int NC>
__global__ void __launch_bounds__((NC + 1) * WG, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       int H, int rep, int Tq, int kv_limit, int causal, int dh, float scale_log2) {
  using T = WgmmaTile<DH, NC>;
  using namespace hopper;
  constexpr int TILE_N = T::TILE_N;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + T::BAR_OFF;
  const uint32_t k_full0 = q_full + 8;
  const uint32_t v_full0 = k_full0 + 8 * STAGES;
  const uint32_t kv_empty0 = v_full0 + 8 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::BLOCK_M;  // longest causal tiles first
  int k_end = kv_limit;
  if (causal) k_end = min(k_end, min(q0 + T::BLOCK_M, Tq));  // keys past the last row are masked
  const int n_tiles = (k_end + TILE_N - 1) / TILE_N;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full0 + 8 * s, 1);
      mbar_init(v_full0 + 8 * s, 1);
      mbar_init(kv_empty0 + 8 * s, NC * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer warpgroup: one thread starts every TMA load ----
    setmaxnreg_dec<T::PRODUCER_REGS>();
    if (threadIdx.x == NC * WG) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      prefetch_tensormap(&tm_o);
      // every panel loads, those past dh as zeros: the products read all
      mbar_arrive_expect_tx(q_full, T::Q_BYTES);
      for (int w = 0; w < NC; ++w)
        for (int p = 0; p < T::PANELS; ++p)
          tma_load_4d(base + (w * T::PANELS + p) * T::Q_PANEL, &tm_q, q_full,
                      p * PANEL_COLS, q0 + 64 * w, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t phase = (i / STAGES) & 1;
        mbar_wait(kv_empty0 + 8 * s, phase ^ 1);  // the first round passes at once
        const uint32_t ks = base + T::K_OFF + s * T::KV_BYTES;
        const uint32_t vs = base + T::V_OFF + s * T::KV_BYTES;
        mbar_arrive_expect_tx(k_full0 + 8 * s, T::KV_BYTES);
        for (int p = 0; p < T::PANELS; ++p)
          tma_load_4d(ks + p * T::KV_PANEL, &tm_k, k_full0 + 8 * s, p * PANEL_COLS, i * TILE_N, hk, b);
        mbar_arrive_expect_tx(v_full0 + 8 * s, T::KV_BYTES);
        for (int p = 0; p < T::PANELS; ++p)
          tma_load_4d(vs + p * T::KV_PANEL, &tm_v, v_full0 + 8 * s, p * PANEL_COLS, i * TILE_N, hk, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: 64 q rows ----
    setmaxnreg_inc<T::CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    const int qw0 = q0 + 64 * wg;
    const int row0 = qw0 + 16 * warp + g, row1 = row0 + 8;
    const uint32_t q_smem = base + wg * T::PANELS * T::Q_PANEL;

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // raw-score row max; partial row sums

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t phase = (i / STAGES) & 1;
      const uint32_t ks = base + T::K_OFF + s * T::KV_BYTES;
      const uint32_t vs = base + T::V_OFF + s * T::KV_BYTES;

      // S = Q K^T over DH in k16 steps; a step inside a 128-byte row adds
      // 32 bytes to both start addresses
      float sc[TILE_N / 2];
      mbar_wait(k_full0 + 8 * s, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t qa = q_smem + (kk / 4) * T::Q_PANEL + (kk % 4) * 32;
        const uint32_t kb = ks + (kk / 4) * T::KV_PANEL + (kk % 4) * 32;
        wgmma_qk<TILE_N>(sc, sw128_desc(qa, 16, 1024), sw128_desc(kb, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax; only edge tiles are masked. The row max is taken on
      // the raw scores (the scale is positive), and one FFMA per score
      // folds 1/sqrt(Dh) * log2(e) and the max into exp2's argument.
      const int n0 = i * TILE_N;
      const bool edge = n0 + TILE_N > kv_limit || (causal && n0 + TILE_N - 1 > qw0);
      float mt0 = NEG_INF, mt1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < TILE_N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (edge) {
            const int col = n0 + 8 * j + 2 * tq + e;
            const bool hidden = col >= kv_limit;
            if (hidden || (causal && col > row0)) sc[4 * j + e] = NEG_INF;
            if (hidden || (causal && col > row1)) sc[4 * j + 2 + e] = NEG_INF;
          }
          mt0 = fmaxf(mt0, sc[4 * j + e]);
          mt1 = fmaxf(mt1, sc[4 * j + 2 + e]);
        }
      }
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
      const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
      const float alpha0 = exp2_approx((m0 - mn0) * scale_log2);
      const float alpha1 = exp2_approx((m1 - mn1) * scale_log2);
      m0 = mn0;
      m1 = mn1;
      const float mb0 = mn0 * scale_log2, mb1 = mn1 * scale_log2;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < TILE_N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = exp2_approx(fmaf(sc[4 * j + e], scale_log2, -mb0));
          const float p1 = exp2_approx(fmaf(sc[4 * j + 2 + e], scale_log2, -mb1));
          sc[4 * j + e] = p0;
          sc[4 * j + 2 + e] = p1;
          rs0 += p0;
          rs1 += p1;
        }
      }
      l0 = l0 * alpha0 + rs0;  // alpha is uniform over the quad: reduce l at the end
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }
      // P as wgmma A operands: k16 slice kk is n8 blocks 2kk and 2kk+1
      uint32_t pa[TILE_N / 16][4];
#pragma unroll
      for (int kk = 0; kk < TILE_N / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V: V[key][d] is the MN-major B operand; a k16 step is 16 key
      // rows (2048 bytes); LBO steps between the DH / 64 column panels
      mbar_wait(v_full0 + 8 * s, phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE_N / 16; ++kk)
        wgmma_pv<DH>(o, pa[kk], sw128_desc(vs + kk * 16 * ROW_BYTES, T::KV_PANEL, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty0 + 8 * s);  // this warp is done with stage s
    }

    // epilogue: full row sums, divide (a row with no visible key keeps
    // l == 0: zeros, not 0/0), bf16 into this warpgroup's Q stage, TMA store
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    named_barrier_sync(1 + wg, WG);  // every warp's products have read Q
    const int r = 16 * warp + g;     // rows r and r + 8 share r % 8, so one swizzle
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const uint32_t addr = q_smem + (j / 8) * T::Q_PANEL + r * ROW_BYTES +
                            (((j % 8) ^ (r % 8)) * 16) + tq * 4;
      st_shared_u32(addr, pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0));
      st_shared_u32(addr + 8 * ROW_BYTES, pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1));
    }
    fence_async_smem();
    named_barrier_sync(1 + wg, WG);
    if (tid == 0 && qw0 < Tq) {
      for (int p = 0; p * PANEL_COLS < dh; ++p)  // the map clips columns past dh
        tma_store_4d(&tm_o, q_smem + p * T::Q_PANEL, p * PANEL_COLS, qw0, h, b);
      tma_store_wait_all();
    }
  }
}

// True when every copy of `vb` bytes from this view starts vb-aligned: the
// base and every stride, in bytes, are multiples of vb
bool copy_aligned(const void* p, Strides s, int es, int vb) {
  return reinterpret_cast<uintptr_t>(p) % vb == 0 && (s.b * es) % vb == 0 &&
         (s.h * es) % vb == 0 && (s.t * es) % vb == 0;
}

template <typename T, int DMAX, int KSPLIT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Tq, int kv_limit, int causal, int dh,
                       Strides qs, Strides ks, Strides vs, Strides os, int copy_bytes,
                       cudaStream_t stream) {
  constexpr int es = sizeof(T);
  constexpr int block_m = 64 / KSPLIT;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<T, DMAX, KSPLIT>,
                               mma_smem_bytes(DMAX, es, block_m), opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tq + block_m - 1) / block_m);
  // 1/sqrt(dh) * log2(e), folded into exp2's argument
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(dh)));
  flash_fwd_mma_kernel<T, DMAX, KSPLIT><<<grid, 32 * MMA_WARPS, mma_smem_bytes(dh, es, block_m), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, H / KV, Tq, kv_limit, causal, dh, scale_log2, qs, ks, vs, os,
      copy_bytes);
  return cudaGetLastError();
}

// block_m (64 or 32) is the q rows of a block: four warps of 16 rows each
// taking whole key tiles, or two row groups whose two warps split every
// key tile (twice the blocks, half the chain of products a warp); copy_bytes
// (16, 8, 4, or 2 for bfloat16) the width of every global-to-shared copy,
// which the caller picks from the views' alignment and this checks.
template <typename T>
cudaError_t launch_mma_any(const void* q, const void* k, const void* v, void* o,
                           int B, int H, int KV, int Tq, int kv_limit, int causal, int dh,
                           Strides qs, Strides ks, Strides vs, Strides os, int block_m,
                           int copy_bytes, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  const bool width_ok = copy_bytes == 16 || copy_bytes == 8 || copy_bytes == 4 ||
                        (copy_bytes == 2 && es == 2);
  if ((block_m != 32 && block_m != 64) || !width_ok || (dh * es) % copy_bytes != 0 ||
      !copy_aligned(q, qs, es, copy_bytes) || !copy_aligned(k, ks, es, copy_bytes) ||
      !copy_aligned(v, vs, es, copy_bytes))
    return cudaErrorInvalidValue;
#define SCT_LAUNCH_MMA(DMAX)                                                                   \
  case DMAX:                                                                                   \
    return block_m == 64 ? launch_mma<T, DMAX, 1>(q, k, v, o, B, H, KV, Tq, kv_limit, causal, \
                                                  dh, qs, ks, vs, os, copy_bytes, stream)     \
                         : launch_mma<T, DMAX, 2>(q, k, v, o, B, H, KV, Tq, kv_limit, causal, \
                                                  dh, qs, ks, vs, os, copy_bytes, stream)
  switch (mma_instance(dh)) {
    SCT_LAUNCH_MMA(8);
    SCT_LAUNCH_MMA(16);
    SCT_LAUNCH_MMA(32);
    SCT_LAUNCH_MMA(64);
    SCT_LAUNCH_MMA(128);
    SCT_LAUNCH_MMA(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef SCT_LAUNCH_MMA
}

// A 4-D tensor map over [dh, T, heads, B] (innermost first, dh the real
// head dim) with the view's own byte strides, boxes of 64 columns x `rows`
// rows of one (b, head), and the 128-byte swizzle the wgmma descriptors
// expect. A box reaching past dh (a head dim below 64, or the last panel
// of a padded one) loads zeros there and stores nothing there.
CUresult encode_map(CUtensorMap* map, const void* ptr, int dh, int t, int heads, int b,
                    Strides s, int rows) {
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(t),
                        static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(b)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.t) * 2, static_cast<cuuint64_t>(s.h) * 2,
                           static_cast<cuuint64_t>(s.b) * 2};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(PANEL_COLS), static_cast<cuuint32_t>(rows), 1, 1};
  cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH, int NC>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int B, int H, int KV, int Tq, int Tk, int kv_limit, int causal, int dh,
                 Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  using T = WgmmaTile<DH, NC>;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  CUresult res = encode_map(&tm_q, q, dh, Tq, H, B, qs, 64);
  if (res == CUDA_SUCCESS) res = encode_map(&tm_k, k, dh, Tk, KV, B, ks, T::TILE_N);
  if (res == CUDA_SUCCESS) res = encode_map(&tm_v, v, dh, Tk, KV, B, vs, T::TILE_N);
  if (res == CUDA_SUCCESS) res = encode_map(&tm_o, o, dh, Tq, H, B, os, 64);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = allow_smem(flash_fwd_wgmma_kernel<DH, NC>, T::SMEM, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (Tq + T::BLOCK_M - 1) / T::BLOCK_M);
  // 1/sqrt of the real head dim, not of the instance's padded width
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(dh)));
  flash_fwd_wgmma_kernel<DH, NC><<<grid, T::THREADS, T::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_o, H, H / KV, Tq, kv_limit, causal, dh, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma instance for a bfloat16 head dim: the next of 64, 128 and 256
// up for a multiple of 8, else 0 (the mma route).
constexpr int wgmma_tile(int dh) {
  return dh % 8 != 0 ? 0 : dh <= 64 ? 64 : dh <= 128 ? 128 : dh <= 256 ? 256 : 0;
}

template <int DH>
int launch_wgmma_bm(const void* q, const void* k, const void* v, void* o,
                    int B, int H, int KV, int Tq, int Tk, int kv_limit, int causal, int dh,
                    Strides qs, Strides ks, Strides vs, Strides os, int block_m,
                    cudaStream_t stream) {
  if (block_m == 64)
    return launch_wgmma<DH, 1>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, dh, qs, ks, vs, os, stream);
  if (block_m == 128)
    return launch_wgmma<DH, 2>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, dh, qs, ks, vs, os, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DH>
int wgmma_smem(int block_m) {
  return block_m == 64 ? WgmmaTile<DH, 1>::SMEM : block_m == 128 ? WgmmaTile<DH, 2>::SMEM : -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_len < 0 means "no key-length mask".
// Strides are in elements: [b, h, t] for each of q, k, v, o. block_m is the
// q rows per block: 64 or 128 on the wgmma route, 32 or 64 on the mma
// route; copy_bytes is the mma route's copy width (unused by wgmma).
// Returns 0, a cudaError_t, or minus a CUresult.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int KV, int Tq, int Tk, int Dh, int causal, int kv_len,
    long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost, int block_m, int copy_bytes, void* stream) {
  if (KV <= 0 || H % KV != 0 || Tq <= 0 || Tk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst}, os{osb, osh, ost};
  const int kv_limit = kv_len < 0 ? Tk : (kv_len < Tk ? kv_len : Tk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh < 1 || Dh > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    switch (wgmma_tile(Dh)) {
      case 64:
        return launch_wgmma_bm<64>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, Dh, qs, ks, vs, os, block_m, s);
      case 128:
        return launch_wgmma_bm<128>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, Dh, qs, ks, vs, os, block_m, s);
      case 256:
        return launch_wgmma_bm<256>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, Dh, qs, ks, vs, os, block_m, s);
      default:
        return static_cast<int>(launch_mma_any<__nv_bfloat16>(
            q, k, v, o, B, H, KV, Tq, kv_limit, causal, Dh, qs, ks, vs, os, block_m, copy_bytes, s));
    }
  }
  if (dtype == 0)
    return static_cast<int>(launch_mma_any<float>(q, k, v, o, B, H, KV, Tq, kv_limit, causal, Dh,
                                                  qs, ks, vs, os, block_m, copy_bytes, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the kernel instance flash_attention_fwd picks
// (-1 if none).
extern "C" int flash_attention_smem_bytes(int dtype, int Dh, int block_m) {
  if (Dh < 1 || Dh > 256 || (dtype != 0 && dtype != 1)) return -1;
  switch (dtype == 1 ? wgmma_tile(Dh) : 0) {
    case 64:
      return wgmma_smem<64>(block_m);
    case 128:
      return wgmma_smem<128>(block_m);
    case 256:
      return wgmma_smem<256>(block_m);
    default:
      if (block_m != 32 && block_m != 64) return -1;
      return mma_smem_bytes(Dh, dtype == 0 ? 4 : 2, block_m);
  }
}
