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
//   bfloat16, Dh % 8 != 0             -> SIMT (a head stride of Dh * 2
//       bytes is no multiple of 16, which TMA needs)
//   float32, every Dh <= 256          -> SIMT (f32 is the exactness dtype:
//       no TF32)
//
// What bounds it on the H100: the work is 4 * T^2 * Dh FLOPs per (b, h)
// (halved by the causal mask) against 4 * T * Dh elements of q/k/v/o
// traffic, ~T/2 FLOPs per byte in bf16 -- above the card's ~295 FLOP/byte
// balance point from T ~ 600, so long prompts are bound by the tensor
// cores (989 TFLOP/s bf16, reached only through wgmma) and short ones by
// memory and by the latency of one block's chain of loads and products.
// Narrow heads (Dh 8-32) are latency-bound tiny grids at any T: their
// padded products cost 2x-8x the FLOPs they need, on tensor cores.
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
// SIMT (float32 at every head dim, bfloat16 at head dims that are not a
// multiple of 8): one block of 128 threads per (64-row q tile, b*h) on the
// CUDA cores, f32 FMAs, each thread owning a 4 x 8 score patch and a
// 4 x (DHP/8) output patch, where the tile width DHP is the head dim
// rounded up to 64, 128 or 256 and the columns past the head dim are zero
// on load and skipped on store; Q and K rows are padded one word against
// bank conflicts. bfloat16 inputs are widened to f32 at the shared-memory
// load and the output rounded back at the store. At DHP 256 the tiles take
// 213,760 bytes of shared memory, one block per SM. A simple kernel, right
// first: bound by the CUDA cores' f32 rate (67 TFLOP/s) at best, and in
// practice by one 4-warp block per SM.
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

// SIMT path tiles
constexpr int BLOCK_M = 64;   // q rows per block
constexpr int BLOCK_N = 64;   // k/v rows per loop step
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
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


// ---------------------------------------------------------------------------
// SIMT path: CUDA-core FMAs, every head dim up to 256, float32 or bfloat16
// ---------------------------------------------------------------------------

// Q, K (rows padded one word), V and P tiles for a tile width of DHP
// columns (the head dim rounded up to 64, 128 or 256)
constexpr int f32_smem_bytes(int dhp) {
  return (BLOCK_M * (dhp + 1) + BLOCK_N * (dhp + 1) + BLOCK_N * dhp + BLOCK_M * (BLOCK_N + 1)) *
         static_cast<int>(sizeof(float));
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// T is the element type of q, k, v and o (float or __nv_bfloat16): values
// are converted to float32 at the shared-memory load, every product and
// the softmax run in float32, and the output is rounded to T at the store.
// DHP (64, 128 or 256) is the tile width; the head dim `dh` (<= DHP) is a
// run-time argument: columns dh..DHP-1 load as zeros, add nothing to the
// scores and are never stored.
template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      int H, int rep, int Tq, int Tk, int kv_limit, int causal, int dh,
                      float scale, Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int QK_LD = DHP + 1;      // padded row length for Q and K
  constexpr int P_LD = BLOCK_N + 1;   // padded row length for P
  constexpr int DJ = DHP / 8;         // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BLOCK_M][QK_LD]
  float* Ks = Qs + BLOCK_M * QK_LD;       // [BLOCK_N][QK_LD]
  float* Vs = Ks + BLOCK_N * QK_LD;       // [BLOCK_N][DHP]
  float* Ps = Vs + BLOCK_N * DHP;         // [BLOCK_M][P_LD]

  const int tid = threadIdx.x;
  const int tr = tid >> 3;  // row group: rows tr*4 .. tr*4+3
  const int tc = tid & 7;   // column group: columns tc + 8*j
  // longest causal tiles first
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int q0 = q_tile * BLOCK_M;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / rep;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  T* op = o + b * os.b + h * os.h;

  // Q tile, pre-scaled by 1/sqrt(dh); rows past Tq and columns past dh
  // load as zeros
  for (int idx = tid; idx < BLOCK_M * DHP; idx += THREADS) {
    const int r = idx / DHP, d = idx - r * DHP;
    const int row = q0 + r;
    Qs[r * QK_LD + d] = (row < Tq && d < dh) ? load_f32(qp + row * qs.t + d) * scale : 0.f;
  }

  float acc[4][DJ];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int k_end = kv_limit;
  if (causal) k_end = min(k_end, q0 + BLOCK_M);  // keys past the last row are masked
  const int n_tiles = (k_end + BLOCK_N - 1) / BLOCK_N;

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BLOCK_N;
    __syncthreads();  // previous tile's K/V/P reads are done
    for (int idx = tid; idx < BLOCK_N * DHP; idx += THREADS) {
      const int r = idx / DHP, d = idx - r * DHP;
      const int col = n0 + r;
      const bool ok = col < Tk && d < dh;
      Ks[r * QK_LD + d] = ok ? load_f32(kp + col * ks.t + d) : 0.f;
      Vs[r * DHP + d] = ok ? load_f32(vp + col * vs.t + d) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    // the zero columns past dh add nothing: the product stops at dh
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr * 4 + i) * QK_LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tc + 8 * j) * QK_LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr * 4 + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tc + 8 * j;
        if (col >= kv_limit || (causal && col > row)) s[i][j] = NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m_i[i], mt);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(tr * 4 + i) * P_LD + tc + 8 * j] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P tile complete

#pragma unroll 4
    for (int n = 0; n < BLOCK_N; ++n) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr * 4 + i) * P_LD + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[n * DHP + tc + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= Tq) continue;
    // a row with no visible key keeps l == 0: write zeros, not 0/0
    const float inv = l_i[i] > 0.f ? 1.f / l_i[i] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tc + 8 * j;
      if (d < dh) store_out(op + row * os.t + d, acc[i][j] * inv);
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one MUFU instruction (exp2f without fast-math is a longer
// sequence); 2^(-1e30) flushes to 0, as a masked score must
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

template <typename T, int DHP>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int Tq, int Tk, int kv_limit, int causal, int dh,
                        Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes(DHP);
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = allow_smem(flash_fwd_simt_kernel<T, DHP>, smem, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_simt_kernel<T, DHP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, H / KV, Tq, Tk, kv_limit, causal, dh,
      static_cast<float>(1.0 / sqrt(static_cast<double>(dh))), qs, ks, vs, os);
  return cudaGetLastError();
}

// The SIMT tile width for a head dim: 64, 128 or 256 (0 above 256).
constexpr int simt_tile(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 128 : dh <= 256 ? 256 : 0; }

template <typename T>
cudaError_t launch_simt_any(const void* q, const void* k, const void* v, void* o,
                            int B, int H, int KV, int Tq, int Tk, int kv_limit, int causal,
                            int dh, Strides qs, Strides ks, Strides vs, Strides os,
                            cudaStream_t stream) {
  switch (simt_tile(dh)) {
    case 64:
      return launch_simt<T, 64>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, dh, qs, ks, vs, os, stream);
    case 128:
      return launch_simt<T, 128>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, dh, qs, ks, vs, os, stream);
    case 256:
      return launch_simt<T, 256>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, dh, qs, ks, vs, os, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
// up for a multiple of 8, else 0 (the SIMT route).
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
// Strides are in elements: [b, h, t] for each of q, k, v, o. block_m (64 or
// 128) is the wgmma kernel's q rows per block; the SIMT kernel always
// takes 64. Returns 0, a cudaError_t, or minus a CUresult.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int KV, int Tq, int Tk, int Dh, int causal, int kv_len,
    long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost, int block_m, void* stream) {
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
        return launch_simt_any<__nv_bfloat16>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, Dh, qs, ks, vs, os, s);
    }
  }
  if (dtype == 0)
    return launch_simt_any<float>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, Dh, qs, ks, vs, os, s);
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
      return f32_smem_bytes(simt_tile(Dh));
  }
}
