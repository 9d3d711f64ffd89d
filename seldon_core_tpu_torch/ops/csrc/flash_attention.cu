// Blocked (flash) attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces: seldon_core_tpu/ops/flash_attention.py:_flash_kernel (the
// Pallas TPU kernel behind flash_attention(), called from
// DecoderLM.prefill). Same function: softmax(q k^T / sqrt(Dh)) v with an
// optional causal mask (row i sees keys j <= i) and an optional key-length
// mask (keys j >= kv_len hidden), f32 online-softmax state, masking by the
// finite NEG_INF = -1e30, and an l == 0 guard on the final divide.
//
// What bounds it on the H100: at the prefill shapes (Dh = 128, T up to
// 1024) the work is 4 * T^2 * Dh FLOPs per (b, h) against 4 * T * Dh
// elements of q/k/v/o traffic, ~T/2 FLOPs per byte in bf16 -- far above the
// card's ~295 FLOP/byte balance point, so the bound is arithmetic on the
// tensor cores (989 TFLOP/s bf16).
//
// What the design does about it:
//  * One block of 4 warps per (64-row q tile, b*h). A loop inside the block
//    streams 64-row K/V tiles through shared memory (the TPU's sequential
//    grid axis becomes this loop); scores and probabilities never leave the
//    SM, so device-memory traffic stays O(T * Dh).
//  * bfloat16 (the serving path): both products run on the tensor cores as
//    mma.sync m16n8k16 with f32 accumulation. Each warp owns 16 q rows: its
//    Q fragments stay in registers for the whole K/V loop, the score tile
//    and the output accumulator live in registers, the probabilities are
//    repacked from the score accumulators into the A operand of the P.V
//    product without a trip through shared memory, and row max / row sum
//    reduce with shuffles over the 4 threads of a quad. V is stored
//    transposed in shared memory so every fragment is a 32-bit load.
//  * float32 (exact parity runs): the same blocking on the CUDA cores,
//    f32 FMAs, each thread owning a 4 x 8 score patch and a 4 x (Dh/8)
//    output patch; Q and K rows are padded one word against bank conflicts.
//  * The causal loop stops at the tile holding the q tile's last row, and
//    q tiles are issued longest-first so the heavy tail does not trail.
//  * Grouped K/V (GQA) is read in place: q head h reads kv head
//    h / (H / KV), so the caller never materialises a repeated copy.
//  * Ragged Tq/Tk edges and kv_len are masked inside the kernel, so every
//    prompt length runs here; q/k/v/o are addressed through strides, so a
//    head-transposed view needs no copy.
//  * Not yet: wgmma, TMA-fed multi-stage shared-memory rings, warp
//    specialisation (later work; see PERF.md for how far from the bound).
//
// Launch contract: the caller (ops/flash_attention.py) checks shapes,
// dtypes, strides and alignment, allocates the output, and passes the
// current CUDA stream; the kernel allocates nothing. The C entry point
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;   // q rows per block
constexpr int BLOCK_N = 64;   // k/v rows per loop step
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, t;  // element strides; the head dim is contiguous
};

// ---------------------------------------------------------------------------
// float32 path: CUDA-core FMAs
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                 int H, int rep, int Tq, int Tk, int kv_limit, int causal,
                 float scale, Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int QK_LD = DH + 1;       // padded row length for Q and K
  constexpr int P_LD = BLOCK_N + 1;   // padded row length for P
  constexpr int DJ = DH / 8;          // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BLOCK_M][QK_LD]
  float* Ks = Qs + BLOCK_M * QK_LD;       // [BLOCK_N][QK_LD]
  float* Vs = Ks + BLOCK_N * QK_LD;       // [BLOCK_N][DH]
  float* Ps = Vs + BLOCK_N * DH;          // [BLOCK_M][P_LD]

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

  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  float* op = o + b * os.b + h * os.h;

  // Q tile, pre-scaled by 1/sqrt(Dh); rows past Tq load as zeros
  for (int idx = tid; idx < BLOCK_M * DH; idx += THREADS) {
    const int r = idx / DH, d = idx - r * DH;
    const int row = q0 + r;
    Qs[r * QK_LD + d] = row < Tq ? qp[row * qs.t + d] * scale : 0.f;
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
    for (int idx = tid; idx < BLOCK_N * DH; idx += THREADS) {
      const int r = idx / DH, d = idx - r * DH;
      const int col = n0 + r;
      const bool ok = col < Tk;
      Ks[r * QK_LD + d] = ok ? kp[col * ks.t + d] : 0.f;
      Vs[r * DH + d] = ok ? vp[col * vs.t + d] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
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
        const float vv = Vs[n * DH + tc + 8 * j];
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
    for (int j = 0; j < DJ; ++j) op[row * os.t + tc + 8 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 path: the two products on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;  // 16 q rows per warp, 64 per block

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8 "col":      b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16x8 f32:        c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// S = Q K^T takes B[k=d][n=key] = K[key][d]: b0 is two neighbouring d of
// one K row, a 32-bit shared load. O += P V takes B[k=key][n=d] = V[key][d],
// so V is stored transposed (Vt[d][key]) to make b0 a 32-bit load too. P's
// A fragment is the S accumulator of two neighbouring n-tiles, repacked.
template <int DH>
__global__ void __launch_bounds__(MMA_WARPS * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int H, int rep, int Tq, int Tk, int kv_limit, int causal,
                     float scale, Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int LD = DH + 8;          // Q/K row length in smem (bank spread)
  constexpr int LDV = BLOCK_N + 8;    // Vt row length
  constexpr int KSTEPS = DH / 16;     // k-steps of Q K^T
  constexpr int NT = BLOCK_N / 8;     // key n-tiles of S
  constexpr int DT = DH / 8;          // d n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BLOCK_M][LD]
  __nv_bfloat16* Ks = Qs + BLOCK_M * LD;                            // [BLOCK_N][LD]
  __nv_bfloat16* Vt = Ks + BLOCK_N * LD;                            // [DH][LDV]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int q0 = q_tile * BLOCK_M;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / rep;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + hk * vs.h;
  __nv_bfloat16* op = o + b * os.b + h * os.h;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);

  // Q tile (rows past Tq as zeros), two bf16 per 32-bit access
  for (int idx = tid; idx < BLOCK_M * DH / 2; idx += MMA_WARPS * 32) {
    const int r = idx / (DH / 2), d = 2 * (idx - r * (DH / 2));
    const int row = q0 + r;
    __nv_bfloat162 val = zero2;
    if (row < Tq) val = *reinterpret_cast<const __nv_bfloat162*>(qp + row * qs.t + d);
    *reinterpret_cast<__nv_bfloat162*>(Qs + r * LD + d) = val;
  }
  __syncthreads();
  const int wr = warp * 16;  // this warp's first row in the tile
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    qf[kk][0] = lds32(Qs + (wr + g) * LD + kk * 16 + 2 * t);
    qf[kk][1] = lds32(Qs + (wr + g + 8) * LD + kk * 16 + 2 * t);
    qf[kk][2] = lds32(Qs + (wr + g) * LD + kk * 16 + 2 * t + 8);
    qf[kk][3] = lds32(Qs + (wr + g + 8) * LD + kk * 16 + 2 * t + 8);
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};

  int k_end = kv_limit;
  if (causal) k_end = min(k_end, q0 + BLOCK_M);
  const int n_tiles = (k_end + BLOCK_N - 1) / BLOCK_N;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int n0 = tile * BLOCK_N;
    __syncthreads();  // the previous tile's K/Vt reads are done
    for (int idx = tid; idx < BLOCK_N * DH / 2; idx += MMA_WARPS * 32) {
      const int r = idx / (DH / 2), d = 2 * (idx - r * (DH / 2));
      const int col = n0 + r;
      __nv_bfloat162 kv2 = zero2, vv2 = zero2;
      if (col < Tk) {
        kv2 = *reinterpret_cast<const __nv_bfloat162*>(kp + col * ks.t + d);
        vv2 = *reinterpret_cast<const __nv_bfloat162*>(vp + col * vs.t + d);
      }
      *reinterpret_cast<__nv_bfloat162*>(Ks + r * LD + d) = kv2;
      Vt[d * LDV + r] = vv2.x;
      Vt[(d + 1) * LDV + r] = vv2.y;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[j], qf[kk], lds32(kr), lds32(kr + 8));
      }
    }

    // scale, mask, online softmax; each thread holds rows g and g+8,
    // columns 2t, 2t+1 of every n-tile; a row spans the 4 threads of a quad
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + j * 8 + 2 * t + e;
          float x = s[j][2 * half + e] * scale;
          if (col >= kv_limit || (causal && col > rows[half])) x = NEG_INF;
          s[j][2 * half + e] = x;
          mt = fmaxf(mt, x);
        }
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_i[half], mt);
      alpha[half] = expf(m_i[half] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[j][2 * half + e] - m_new);
          s[j][2 * half + e] = p;
          rs += p;
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_i[half] = l_i[half] * alpha[half] + rs;
      m_i[half] = m_new;
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V over the tile's 64 keys: 4 k-steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const __nv_bfloat16* vr = Vt + (j * 8 + g) * LDV + kk * 16 + 2 * t;
        mma_bf16(acc[j], pf, lds32(vr), lds32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = rows[half];
    if (row >= Tq) continue;
    const float inv = l_i[half] > 0.f ? 1.f / l_i[half] : 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<uint32_t*>(op + row * os.t + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * half] * inv, acc[j][2 * half + 1] * inv);
    }
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Tq, int Tk, int kv_limit,
                   int causal, Strides qs, Strides ks, Strides vs, Strides os,
                   cudaStream_t stream) {
  constexpr int smem = (BLOCK_M * (DH + 1) + BLOCK_N * (DH + 1) + BLOCK_N * DH +
                        BLOCK_M * (BLOCK_N + 1)) * sizeof(float);
  // above 48 KB a launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_f32_kernel<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, H / KV, Tq, Tk, kv_limit, causal,
      static_cast<float>(1.0 / sqrt(static_cast<double>(DH))), qs, ks, vs, os);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Tq, int Tk, int kv_limit,
                       int causal, Strides qs, Strides ks, Strides vs, Strides os,
                       cudaStream_t stream) {
  constexpr int smem = (2 * BLOCK_M * (DH + 8) + DH * (BLOCK_N + 8)) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_mma_kernel<DH><<<grid, MMA_WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, H / KV, Tq, Tk, kv_limit, causal,
      static_cast<float>(1.0 / sqrt(static_cast<double>(DH))), qs, ks, vs, os);
  return cudaGetLastError();
}

// The bf16 tensor-core path moves two elements per 32-bit access: every
// row start must be 4-byte aligned.
bool pairs_aligned(const void* p, Strides s) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0 && (s.b & 1) == 0 &&
         (s.h & 1) == 0 && (s.t & 1) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_len < 0 means "no key-length mask".
// Strides are in elements: [b, h, t] for each of q, k, v, o.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int KV, int Tq, int Tk, int Dh, int causal, int kv_len,
    long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost, void* stream) {
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst}, os{osb, osh, ost};
  const int kv_limit = kv_len < 0 ? Tk : (kv_len < Tk ? kv_len : Tk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 64)
    err = launch_f32<64>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, qs, ks, vs, os, s);
  else if (dtype == 0 && Dh == 128)
    err = launch_f32<128>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, qs, ks, vs, os, s);
  else if (dtype == 1 && pairs_aligned(q, qs) && pairs_aligned(k, ks) &&
           pairs_aligned(v, vs) && pairs_aligned(o, os)) {
    if (Dh == 64)
      err = launch_mma<64>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, qs, ks, vs, os, s);
    else if (Dh == 128)
      err = launch_mma<128>(q, k, v, o, B, H, KV, Tq, Tk, kv_limit, causal, qs, ks, vs, os, s);
  }
  return static_cast<int>(err);
}
