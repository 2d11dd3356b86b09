// Masked attention for Hopper (sm_90a) on the tensor cores:
//     out = softmax(q·kᵀ·scale + bias) · v,   returned as f32.
//
// Replaces the Pallas TPU kernel hvrnet_tpu/ops/attention.py:_flash_kernel
// (launched by _flash_attention).  Same semantics, not the same blocking:
//   * q, k, v are f32 or bf16, (nq, d) and (nk, d) row-major; bias is an
//     f32 (nk,) additive key bias: 0 for live keys, -1e30 for masked ones.
//     -1e30 is finite, so a row whose keys are all masked averages v.
//   * logits, softmax statistics and accumulation are f32.  f32 inputs are
//     multiplied as 3xTF32 (a = hi + lo, both tf32; hi·hi + hi·lo + lo·hi
//     on the tensor cores), which keeps f32 accuracy; the kernel owns this
//     choice and reads no global TF32 setting.  With bf16 inputs the
//     softmax weights are rounded to bf16 before the product with v, and
//     l sums the unrounded weights.
//   * ragged nq and nk are masked in the kernels: keys past nk are left out
//     by index (TMA's zero fill would give them logit 0, not -inf), rows
//     past nq are never written.
//   * lanes: B independent problems of the same shape, q (B, nq, d), k and
//     v (B, nk, d), bias (B, nk), out (B, nq, d), in one launch per phase
//     (the counterpart of jax.vmap over the Pallas call, which adds a grid
//     axis).  Every phase takes the lane from a grid axis; every TMA map is
//     3-D (inner, rows, lanes), so a tile past a lane's last key or query
//     row is zero-filled within that lane and masked as above, never read
//     from the next lane.  A 2-D call is one lane, with the same tiles.
//
// What bounds it on the H100: at the exact-ring shapes (d = 1024; nq = nk =
// 6300 for NL1/NL3, nq = 300 and nk = 6300 for NL2/NL4) the work is
// 4·nq·nk·d FLOPs against (2·nq + 2·nk)·d·4 bytes of input and output: it is
// bound by arithmetic, at 3 × 4·nq·nk·d over the 495 TFLOP/s tf32 rate for
// f32 inputs and 4·nq·nk·d over 989 TFLOP/s for bf16.
//
// Design.  At d = 1024 a flash tile's f32 accumulator (64 rows × d) is
// 256 KB, more than the register file or shared memory, so the kernel
// writes the logits once instead of streaming them (S = nq × nk f32, 159 MB
// at NL1: about 0.1 ms of traffic against at least 1 ms of tensor-core
// work).  Five phases, launched in order on one stream by hvr_attn_run (each
// can also run alone, for timing); the Python wrapper allocates one
// workspace that holds every scratch buffer (struct Layout):
//   1. pre-split: f32 — q and k into tf32 hi/lo planes, v transposed into
//      hi/lo planes of vᵀ (d, ldv); bf16 — v transposed.  tf32 wgmma takes
//      only K-major operands, and pass 2's B operand is v along keys.
//   2. pass 1 (logits): S = scale·q·kᵀ + bias as a wgmma GEMM over blocks
//      of 128 rows × 128 keys (64 × 256 where that takes fewer waves, as at
//      NL2/NL4); TMA feeds a ring of shared-memory stages guarded by
//      mbarriers (a producer warpgroup, one thread of which starts the
//      loads, and two consumer warpgroups that take its registers).  The
//      epilogue writes S and, per (row, 128-key tile), the tile's max and
//      Σ exp(s − tile max).
//   3. row statistics: m = max over tiles, l = Σ_t exp(m_t − m)·l_t.
//   4. pass 2 (output): O = exp(S − m)·v as a wgmma GEMM over nk.  Each
//      consumer thread turns its part of a TMA-loaded S tile into P
//      fragments in registers (exp against the final row max, keys ≥ nk
//      forced to 0, tf32 hi/lo split or bf16 rounding), which wgmma takes as
//      its A operand, so P never goes back to shared memory.  Few query
//      tiles (NL2/NL4: 3 × 8 output tiles for 132 SMs) split nk across
//      blocks; P is normalised against the final m, so the partial sums add
//      linearly.
//   5. combine: out = Σ_split partial / l in a fixed order (no atomics, so
//      two calls give the same bits); without a split pass 2 divides by l.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <atomic>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                // output phase: query rows per block
constexpr int BN = 128;                // output columns per block; keys per statistics tile
constexpr int ROW_BYTES = 128;         // one swizzled smem row
constexpr int TILE = 128 * ROW_BYTES;  // one 128-row tile of a stage, 16 KB
constexpr int WG_SLAB = 64 * ROW_BYTES;
constexpr int THREADS = 384;           // consumer warpgroups 0, 1; producer 2
// registers a thread of the producer and of a consumer warpgroup keeps:
// 128·40 + 256·232 of the SM's 65536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int GROUP_M = 8;             // row blocks that share a sweep of keys
constexpr float LOG2E = 1.4426950408889634f;

template <int STAGES, int STAGE_BYTES>
constexpr int smem_bytes() {
  return STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
}

// Shared memory: STAGES stages of STAGE_BYTES, then the full and empty
// barriers of each stage; the base is aligned to 1024 bytes for the swizzle.
template <int STAGES, int STAGE_BYTES>
struct Ring {
  uint8_t* ptr;    // generic address of the aligned base
  uint32_t base;   // shared-window address of the same byte

  __device__ Ring(uint8_t* raw) {
    const uint32_t a = smem_addr(raw);
    const uint32_t pad = (1024u - (a & 1023u)) & 1023u;
    ptr = raw + pad;
    base = a + pad;
  }
  __device__ uint32_t stage(int s) const { return base + (uint32_t)(s * STAGE_BYTES); }
  // the output phase's stages are tiles of 16 KB
  __device__ uint32_t region(int s, int r) const { return stage(s) + (uint32_t)(r * TILE); }
  __device__ uint8_t* region_ptr(int s, int r) const {
    return ptr + s * STAGE_BYTES + r * TILE;
  }
  __device__ uint32_t full(int s) const {
    return base + (uint32_t)(STAGES * STAGE_BYTES + 8 * s);
  }
  __device__ uint32_t empty(int s) const {
    return base + (uint32_t)(STAGES * STAGE_BYTES + 8 * (STAGES + s));
  }
  __device__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);   // the producer's expect_tx
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
};

// The logits phase's block: 128 query rows × 128 keys (a warpgroup per 64
// rows), or, where that leaves fewer waves of blocks, 64 rows × 256 keys (a
// warpgroup per 128 keys): at NL2/NL4 (nq = 300) 125 blocks, one wave of
// 132 SMs, where 128 × 128 needs 150.  Stage layout: q planes, then k planes.
template <bool F32, bool WIDE>
struct LogitsTile {
  static constexpr int M = WIDE ? 64 : 128;
  static constexpr int N = WIDE ? 256 : 128;
  static constexpr int PARTS = F32 ? 2 : 1;  // tf32 hi and lo, or bf16
  static constexpr int A_BYTES = M * ROW_BYTES;
  static constexpr int B_BYTES = N * ROW_BYTES;
  static constexpr int STAGE_BYTES = PARTS * (A_BYTES + B_BYTES);
  static constexpr int STAGES = 196608 / STAGE_BYTES < 4 ? 196608 / STAGE_BYTES : 4;
};

// The tensor cores add a wgmma's products into its accumulator with
// truncation, which over nk = 6300 keys (or d = 1024) drifts well past f32
// rounding.  The 3xTF32 paths therefore let each stage's MMAs start a fresh
// accumulator and add it into the running sum on the CUDA cores, rounding
// to nearest once per stage.
__device__ __forceinline__ void promote(float (&acc)[64], float (&stage)[64]) {
  fence_acc(stage);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += stage[i];
}

// exp(s − m): 1 for s = m (an all-masked row's -1e30 logits), 0 for s = -inf
__device__ __forceinline__ float softmax_weight(float s, float m) {
  return exp2_approx((s - m) * LOG2E);
}

// ---- phase 1: pre-split ------------------------------------------------------

// hi = tf32(x), lo = tf32(x − hi), elementwise over the na float4s of a and
// then the nb float4s of b.
__global__ void split_rows(const float4* __restrict__ a, float4* __restrict__ a_hi,
                           float4* __restrict__ a_lo, size_t na, const float4* __restrict__ b,
                           float4* __restrict__ b_hi, float4* __restrict__ b_lo, size_t nb) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < na + nb;
       i += (size_t)gridDim.x * blockDim.x) {
    const bool in_a = i < na;
    const size_t j = in_a ? i : i - na;
    const float4 x = in_a ? a[j] : b[j];
    float4 h, l;
    h.x = tf32_round(x.x); l.x = tf32_round(x.x - h.x);
    h.y = tf32_round(x.y); l.y = tf32_round(x.y - h.y);
    h.z = tf32_round(x.z); l.z = tf32_round(x.z - h.z);
    h.w = tf32_round(x.w); l.w = tf32_round(x.w - h.w);
    (in_a ? a_hi : b_hi)[j] = h;
    (in_a ? a_lo : b_lo)[j] = l;
  }
}

// out_a[c][r] = in[r][c] for a (rows, cols) input; out is (cols, ld_out);
// lane blockIdx.z of (lanes, rows, cols) into (lanes, cols, ld_out).
// SPLIT (f32): out_a = tf32 hi, out_b = tf32 lo; otherwise a plain copy.
template <typename T, bool SPLIT>
__global__ void transpose(const T* __restrict__ in, T* __restrict__ out_a,
                          T* __restrict__ out_b, int rows, int cols, int ld_out) {
  __shared__ T tile[32][33];
  in += (size_t)blockIdx.z * rows * cols;
  out_a += (size_t)blockIdx.z * cols * ld_out;
  if constexpr (SPLIT) out_b += (size_t)blockIdx.z * cols * ld_out;
  const int c = blockIdx.x * 32 + threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = blockIdx.y * 32 + i;
    if (r < rows && c < cols) tile[i][threadIdx.x] = in[(size_t)r * cols + c];
  }
  __syncthreads();
  const int r = blockIdx.y * 32 + threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int oc = blockIdx.x * 32 + i;
    if (oc < cols && r < rows) {
      const T x = tile[threadIdx.x][i];
      if constexpr (SPLIT) {
        const float h = tf32_round(x);
        out_a[(size_t)oc * ld_out + r] = h;
        out_b[(size_t)oc * ld_out + r] = tf32_round(x - h);
      } else {
        out_a[(size_t)oc * ld_out + r] = x;
      }
    }
  }
}

// ---- phase 2: logits -------------------------------------------------------

// S[row, key] = scale·(q·kᵀ) + bias[key] over one block (LogitsTile); f32
// inputs come as tf32 hi/lo planes (qa/qb, ka/kb), bf16 inputs as q and k
// (qa, ka).  tiles_m × tiles_n blocks per lane, the lane blockIdx.y.
template <bool F32, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
logits_kernel(const __grid_constant__ CUtensorMap qa, const __grid_constant__ CUtensorMap qb,
              const __grid_constant__ CUtensorMap ka, const __grid_constant__ CUtensorMap kb,
              const float* __restrict__ bias, float* __restrict__ s_out,
              float* __restrict__ tile_m, float* __restrict__ tile_l, int nq, int nk,
              int d, int lds, float scale, int tiles_m, int tiles_n) {
  using Tile = LogitsTile<F32, WIDE>;
  constexpr int STAGES = Tile::STAGES;
  constexpr int BKE = F32 ? 32 : 64;  // d-elements per 128-byte row
  extern __shared__ uint8_t smem_raw[];
  const Ring<STAGES, Tile::STAGE_BYTES> ring(smem_raw);

  // grouped raster: GROUP_M row blocks sweep the key tiles together
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / per_group) * GROUP_M;
  const int gsize = min(tiles_m - first_m, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m_blk = first_m + in_group % gsize;
  const int n_blk = in_group / gsize;
  const int m0 = m_blk * Tile::M, n0 = n_blk * Tile::N;
  const int ktiles = (d + BKE - 1) / BKE;
  const int lane_id = blockIdx.y;
  const int stat_tiles = (nk + BN - 1) / BN;  // 128-key tiles of the statistics
  bias += (size_t)lane_id * nk;
  s_out += (size_t)lane_id * nq * lds;
  tile_m += (size_t)lane_id * nq * stat_tiles;
  tile_l += (size_t)lane_id * nq * stat_tiles;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one thread keeps the TMA loads in flight
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(ring.empty(s), ((kt / STAGES) - 1) & 1);
        const uint32_t bar = ring.full(s);
        const uint32_t a = ring.stage(s), b = a + Tile::PARTS * Tile::A_BYTES;
        const int c = kt * BKE;
        mbar_expect_tx(bar, Tile::STAGE_BYTES);
        tma_load_3d(a, &qa, bar, c, m0, lane_id);
        tma_load_3d(b, &ka, bar, c, n0, lane_id);
        if constexpr (F32) {
          tma_load_3d(a + Tile::A_BYTES, &qb, bar, c, m0, lane_id);
          tma_load_3d(b + Tile::B_BYTES, &kb, bar, c, n0, lane_id);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  // this warpgroup's rows and keys within the block
  const int row_off = WIDE ? 0 : wg * 64, key_off = WIDE ? wg * 128 : 0;
  float acc[64], fresh[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = fresh[i] = 0.f;
  fence_acc(acc);
  fence_acc(fresh);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(ring.full(s), (kt / STAGES) & 1);
    if constexpr (F32) {  // the previous stage's MMAs are done: fold them in
      if (kt > 0) {
        wgmma_wait<0>();
        promote(acc, fresh);
        if (threadIdx.x % 128 == 0) mbar_arrive(ring.empty((kt - 1) % STAGES));
      }
    }
    const uint32_t a_hi = ring.stage(s) + row_off * ROW_BYTES;
    const uint32_t b_hi = ring.stage(s) + Tile::PARTS * Tile::A_BYTES + key_off * ROW_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = smem_desc(a_hi + 32 * kk);
      const uint64_t db = smem_desc(b_hi + 32 * kk);
      if constexpr (F32) {
        const uint64_t da_lo = smem_desc(a_hi + Tile::A_BYTES + 32 * kk);
        const uint64_t db_lo = smem_desc(b_hi + Tile::B_BYTES + 32 * kk);
        wgmma_tf32(fresh, da_lo, db, kk > 0);
        wgmma_tf32(fresh, da, db_lo);
        wgmma_tf32(fresh, da, db);
      } else {
        wgmma_bf16(acc, da, db);
      }
    }
    wgmma_commit();
    if constexpr (!F32) {
      wgmma_wait<1>();
      if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(ring.empty((kt - 1) % STAGES));
    }
  }
  wgmma_wait<0>();
  if constexpr (F32) promote(acc, fresh);
  fence_acc(acc);

  // epilogue: write S, and each row's max and Σexp over this key tile
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int col0 = n0 + key_off + 2 * (lane % 4);
  const int stat_tile = (n0 + key_off) / BN;
  const bool has_keys = n0 + key_off < nk;          // false for a wide block's tail
  float b[32];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + e;
      b[2 * j + e] = col < nk ? bias[col] : 0.f;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + row_off + warp * 16 + lane / 4 + 8 * h;
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * j + e;
        const float s = __fadd_rn(__fmul_rn(acc[4 * j + 2 * h + e], scale), b[2 * j + e]);
        sv[2 * j + e] = col < nk ? s : -INFINITY;  // keys past nk by index
        mx = fmaxf(mx, sv[2 * j + e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sum += softmax_weight(sv[i], mx);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (row < nq) {
      float* srow = s_out + (size_t)row * lds;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = col0 + 8 * j;
        if (col + 1 < nk)
          *reinterpret_cast<float2*>(srow + col) = make_float2(sv[2 * j], sv[2 * j + 1]);
        else if (col < nk)
          srow[col] = sv[2 * j];
      }
      if (lane % 4 == 0 && has_keys) {
        tile_m[(size_t)row * stat_tiles + stat_tile] = mx;
        tile_l[(size_t)row * stat_tiles + stat_tile] = sum;
      }
    }
  }
}

// ---- phase 3: row statistics -------------------------------------------------

// One warp per row: m = max_t m_t, l = Σ_t exp(m_t − m)·l_t (the lanes' rows
// are consecutive, so nq counts all of them).
__global__ void rowstats_kernel(const float* __restrict__ tile_m,
                                const float* __restrict__ tile_l, float* __restrict__ row_m,
                                float* __restrict__ row_l, int nq, int tiles_n) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= nq) return;
  const float* tm = tile_m + (size_t)row * tiles_n;
  const float* tl = tile_l + (size_t)row * tiles_n;
  float mx = -INFINITY;
  for (int t = lane; t < tiles_n; t += 32) mx = fmaxf(mx, tm[t]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float l = 0.f;
  for (int t = lane; t < tiles_n; t += 32) l += softmax_weight(tm[t], mx) * tl[t];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  if (lane == 0) {
    row_m[row] = mx;
    row_l[row] = l;
  }
}

// ---- phase 4: output ---------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The output phase's stages: three 16 KB tiles — f32: the S tile, then the
// hi and lo planes of vᵀ; bf16: the two 32-key halves of the S tile, then vᵀ.
constexpr int OUTPUT_STAGES = 4;

// The S value of row r (of the slab) and key c (of the 32-key tile) in a
// 128-byte-swizzled tile.
__device__ __forceinline__ const float* swizzled(const uint8_t* slab, int r, int c) {
  return reinterpret_cast<const float*>(slab + r * ROW_BYTES + (((c >> 2) ^ (r & 7)) << 4) +
                                        (c & 3) * 4);
}

// O[rows, cols] = Σ_keys exp(S − m)·v over keys [kt0·BK, (kt0 + nkt)·BK) of
// this block's split.  P reaches wgmma from registers: each consumer thread
// forms its fragments (tf32 hi and lo, or bf16) from the S tile in shared
// memory.  Without a split the block writes out = O / l; with one it writes
// O to part[split].  The lane is blockIdx.z; part is (nsplit, lanes·nq, d).
template <bool F32>
__global__ void __launch_bounds__(THREADS, 1)
output_kernel(const __grid_constant__ CUtensorMap smap, const __grid_constant__ CUtensorMap va,
              const __grid_constant__ CUtensorMap vb, const float* __restrict__ row_m,
              const float* __restrict__ row_l, float* __restrict__ out,
              float* __restrict__ part, int nq, int nk, int d, int ktiles_per_split,
              int tiles_n) {
  constexpr int STAGES = OUTPUT_STAGES;
  constexpr int BK = F32 ? 32 : 64;  // keys per stage
  extern __shared__ uint8_t smem_raw[];
  const Ring<STAGES, 3 * TILE> ring(smem_raw);

  const int n_blk = blockIdx.x % tiles_n, m_blk = blockIdx.x / tiles_n;
  const int m0 = m_blk * BM, n0 = n_blk * BN;
  const int split = blockIdx.y;
  const int lane_id = blockIdx.z;
  const int total = (nk + BK - 1) / BK;
  row_m += (size_t)lane_id * nq;
  row_l += (size_t)lane_id * nq;
  out += (size_t)lane_id * nq * d;
  if (part) part += ((size_t)split * gridDim.z + lane_id) * nq * d;
  const int kt0 = split * ktiles_per_split;
  const int nkt = min(total, kt0 + ktiles_per_split) - kt0;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < nkt; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(ring.empty(s), ((i / STAGES) - 1) & 1);
        const uint32_t bar = ring.full(s);
        const int key = (kt0 + i) * BK;
        mbar_expect_tx(bar, 3 * TILE);
        tma_load_3d(ring.region(s, 0), &smap, bar, key, m0, lane_id);
        if constexpr (F32) {
          tma_load_3d(ring.region(s, 1), &va, bar, key, n0, lane_id);
          tma_load_3d(ring.region(s, 2), &vb, bar, key, n0, lane_id);
        } else {
          tma_load_3d(ring.region(s, 1), &smap, bar, key + 32, m0, lane_id);
          tma_load_3d(ring.region(s, 2), &va, bar, key, n0, lane_id);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  // Of each k-step kk (8 keys for tf32, 16 for bf16) thread t holds the
  // fragments of rows 16·warp + lane/4 + 8·(e%2), e < 4 (hopper.cuh).
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  float mrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    mrow[h] = row < nq ? row_m[row] : 0.f;
  }
  float acc[64], fresh[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = fresh[i] = 0.f;
  fence_acc(acc);
  fence_acc(fresh);
  uint32_t p_hi[4][4], p_lo[4][4];  // p_lo: f32 only
  for (int i = 0; i < nkt; ++i) {
    const int s = i % STAGES;
    mbar_wait(ring.full(s), (i / STAGES) & 1);
    if (i > 0) {  // the previous stage's MMAs are done with the fragments
      wgmma_wait<0>();
      if constexpr (F32) promote(acc, fresh);
      if (t == 0) mbar_arrive(ring.empty((i - 1) % STAGES));
    }
    const int key0 = (kt0 + i) * BK;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + lane / 4 + 8 * (e % 2);  // row of the slab
        if constexpr (F32) {
          const int c = 8 * kk + lane % 4 + 4 * (e / 2);     // key of the tile
          const float x = *swizzled(ring.region_ptr(s, 0) + wg * WG_SLAB, r, c);
          const float p = key0 + c < nk ? softmax_weight(x, mrow[e % 2]) : 0.f;
          const float hi = tf32_round(p);
          p_hi[kk][e] = __float_as_uint(hi);
          p_lo[kk][e] = __float_as_uint(tf32_round(p - hi));
        } else {
          const int c = 16 * kk + 2 * (lane % 4) + 8 * (e / 2);  // keys c, c + 1
          const float2 x = *reinterpret_cast<const float2*>(
              swizzled(ring.region_ptr(s, c / 32) + wg * WG_SLAB, r, c % 32));
          p_hi[kk][e] = pack_bf16(key0 + c < nk ? softmax_weight(x.x, mrow[e % 2]) : 0.f,
                                  key0 + c + 1 < nk ? softmax_weight(x.y, mrow[e % 2]) : 0.f);
        }
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (F32) {
        const uint64_t db = smem_desc(ring.region(s, 1) + 32 * kk);
        const uint64_t db_lo = smem_desc(ring.region(s, 2) + 32 * kk);
        wgmma_tf32_rs(fresh, p_lo[kk], db, kk > 0);
        wgmma_tf32_rs(fresh, p_hi[kk], db_lo);
        wgmma_tf32_rs(fresh, p_hi[kk], db);
      } else {
        wgmma_bf16_rs(acc, p_hi[kk], smem_desc(ring.region(s, 2) + 32 * kk));
      }
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  if constexpr (F32) promote(acc, fresh);
  fence_acc(acc);

  const bool whole = gridDim.y == 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (row >= nq) continue;
    const float l = row_l[row];
    float* dst = (whole ? out : part) + (size_t)row * d;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= d) continue;
      float2 o = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (whole) o = make_float2(o.x / l, o.y / l);
      *reinterpret_cast<float2*>(dst + col) = o;
    }
  }
}

// ---- phase 5: combine --------------------------------------------------------

// out = Σ_split part[split] / l, the splits summed in order.
__global__ void combine_kernel(const float4* __restrict__ part, const float* __restrict__ row_l,
                               float4* __restrict__ out, int nq, int d, int nsplit) {
  const size_t n4 = (size_t)nq * d / 4;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 a = part[i];
    for (int s = 1; s < nsplit; ++s) {
      const float4 b = part[s * n4 + i];
      a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
    }
    const float l = row_l[(i * 4) / d];
    out[i] = make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
  }
}

// ---- host side ---------------------------------------------------------------

constexpr int ENCODE_FAILED = 100000;  // + CUresult of cuTensorMapEncodeTiled

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// lanes row-major tensors (rows, inner) with rows row_bytes apart, each lane
// rows · row_bytes after the one before, as one 3-D map (inner, rows, lanes)
// read in 128-byte-wide boxes of box_rows rows of one lane, with the 128-byte
// swizzle.  Returns 0 or an error code.
int make_map(CUtensorMap* map, bool f32, const void* ptr, int inner, int rows,
             long long row_bytes, int lanes, int box_rows = 128) {
  const EncodeTiled encode = encode_fn();
  if (!encode) return ENCODE_FAILED;
  const int esize = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)lanes};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)row_bytes * rows};
  const cuuint32_t box[3] = {(cuuint32_t)(ROW_BYTES / esize), (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
      const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

constexpr int MAX_DEVICES = 64;

// cudaFuncSetAttribute raises the dynamic shared-memory limit of a kernel on
// the current device only, so each device's first launch of a kernel sets it
// there; done[dev] records it (a device past MAX_DEVICES sets it every call).
template <typename Kernel>
int prepare(Kernel kernel, int smem, std::atomic<int>* done) {
  int dev = 0;
  const int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const bool known = dev < MAX_DEVICES;
  if (known && done[dev].load(std::memory_order_acquire)) return 0;
  const int set =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (!set && known) done[dev].store(1, std::memory_order_release);
  return set;
}

int blocks_for(size_t n, int threads) {
  const size_t b = (n + threads - 1) / threads;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Every scratch buffer of one call, carved from one workspace in this order;
// each holds its lanes one after another.
struct Layout {
  float *q_hi = nullptr, *q_lo = nullptr, *k_hi = nullptr, *k_lo = nullptr;  // f32 only
  void *vt_a = nullptr, *vt_b = nullptr;  // vᵀ: hi and lo planes (f32), or bf16
  float *s, *tile_m, *tile_l, *row_m, *row_l, *part = nullptr;
  int lds, ldv, tiles_n;
  size_t bytes;

  Layout(bool f32, int lanes, int nq, int nk, int d, int nsplit, void* base) {
    const uintptr_t b = reinterpret_cast<uintptr_t>(base);
    size_t off = 0;
    auto take = [&](size_t n) {
      void* p = reinterpret_cast<void*>(b + off);
      off += (n + 255) & ~(size_t)255;
      return p;
    };
    lds = round_up(nk, 4);  // TMA needs 16-byte row strides
    ldv = round_up(nk, 8);
    tiles_n = (nk + BN - 1) / BN;
    const size_t esize = f32 ? 4 : 2, B = lanes;
    if (f32) {
      q_hi = (float*)take(B * nq * d * 4);
      q_lo = (float*)take(B * nq * d * 4);
      k_hi = (float*)take(B * nk * d * 4);
      k_lo = (float*)take(B * nk * d * 4);
      vt_b = take(B * d * ldv * esize);
    }
    vt_a = take(B * d * ldv * esize);
    s = (float*)take(B * nq * lds * 4);
    tile_m = (float*)take(B * nq * tiles_n * 4);
    tile_l = (float*)take(B * nq * tiles_n * 4);
    row_m = (float*)take(B * nq * 4);
    row_l = (float*)take(B * nq * 4);
    if (nsplit > 1) part = (float*)take((size_t)nsplit * B * nq * d * 4);
    bytes = off;
  }
};

// f32: q and k into tf32 hi/lo planes and v into hi/lo planes of vᵀ;
// bf16: v into vᵀ, its values moved as their 16-bit patterns.
template <bool F32>
int presplit(const void* q, const void* k, const void* v, const Layout& w, int lanes, int nq,
             int nk, int d, cudaStream_t stream) {
  const dim3 grid((d + 31) / 32, (nk + 31) / 32, lanes), block(32, 8);
  if constexpr (F32) {
    const size_t nq4 = (size_t)lanes * nq * d / 4, nk4 = (size_t)lanes * nk * d / 4;
    split_rows<<<blocks_for(nq4 + nk4, 256), 256, 0, stream>>>(
        (const float4*)q, (float4*)w.q_hi, (float4*)w.q_lo, nq4, (const float4*)k,
        (float4*)w.k_hi, (float4*)w.k_lo, nk4);
    transpose<float, true><<<grid, block, 0, stream>>>((const float*)v, (float*)w.vt_a,
                                                       (float*)w.vt_b, nk, d, w.ldv);
  } else {
    transpose<uint16_t, false><<<grid, block, 0, stream>>>((const uint16_t*)v,
                                                           (uint16_t*)w.vt_a, nullptr, nk, d,
                                                           w.ldv);
  }
  return (int)cudaGetLastError();
}

template <bool F32, bool WIDE>
int launch_logits(const void* q, const void* k, const float* bias, const Layout& w, int lanes,
                  int nq, int nk, int d, float scale, cudaStream_t stream) {
  using Tile = LogitsTile<F32, WIDE>;
  CUtensorMap qa, qb, ka, kb;
  const long long row = (long long)d * (F32 ? 4 : 2);
  int err = make_map(&qa, F32, F32 ? w.q_hi : q, d, nq, row, lanes, Tile::M);
  if (!err) err = make_map(&qb, F32, F32 ? w.q_lo : q, d, nq, row, lanes, Tile::M);
  if (!err) err = make_map(&ka, F32, F32 ? w.k_hi : k, d, nk, row, lanes, Tile::N);
  if (!err) err = make_map(&kb, F32, F32 ? w.k_lo : k, d, nk, row, lanes, Tile::N);
  if (err) return err;
  constexpr int smem = smem_bytes<Tile::STAGES, Tile::STAGE_BYTES>();
  static std::atomic<int> done[MAX_DEVICES];
  const int prepared = prepare(logits_kernel<F32, WIDE>, smem, done);
  if (prepared) return prepared;
  const int tiles_m = (nq + Tile::M - 1) / Tile::M, tiles_n = (nk + Tile::N - 1) / Tile::N;
  logits_kernel<F32, WIDE><<<dim3(tiles_m * tiles_n, lanes), THREADS, smem, stream>>>(
      qa, qb, ka, kb, bias, w.s, w.tile_m, w.tile_l, nq, nk, d, w.lds, scale, tiles_m,
      tiles_n);
  return (int)cudaGetLastError();
}

// The wide block where it needs fewer waves of blocks than the square one.
template <bool F32>
int logits(const void* q, const void* k, const float* bias, const Layout& w, int lanes, int nq,
           int nk, int d, float scale, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  const int err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const auto waves = [&](int m, int n) {
    return (lanes * ((nq + m - 1) / m) * ((nk + n - 1) / n) + sms - 1) / sms;
  };
  return waves(64, 256) < waves(128, 128)
             ? launch_logits<F32, true>(q, k, bias, w, lanes, nq, nk, d, scale, stream)
             : launch_logits<F32, false>(q, k, bias, w, lanes, nq, nk, d, scale, stream);
}

int rowstats(const Layout& w, int rows, cudaStream_t stream) {
  rowstats_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(w.tile_m, w.tile_l, w.row_m, w.row_l,
                                                     rows, w.tiles_n);
  return (int)cudaGetLastError();
}

template <bool F32>
int output(const Layout& w, float* out, int lanes, int nq, int nk, int d, int nsplit,
           int ktiles_per_split, cudaStream_t stream) {
  CUtensorMap smap, va, vb;
  const long long row = (long long)w.ldv * (F32 ? 4 : 2);
  int err = make_map(&smap, true, w.s, nk, nq, 4LL * w.lds, lanes);
  if (!err) err = make_map(&va, F32, w.vt_a, nk, d, row, lanes);
  if (!err) err = make_map(&vb, F32, F32 ? w.vt_b : w.vt_a, nk, d, row, lanes);
  if (err) return err;
  constexpr int smem = smem_bytes<OUTPUT_STAGES, 3 * TILE>();
  static std::atomic<int> done[MAX_DEVICES];
  const int prepared = prepare(output_kernel<F32>, smem, done);
  if (prepared) return prepared;
  const int tiles_m = (nq + BM - 1) / BM, tiles_n = (d + BN - 1) / BN;
  output_kernel<F32><<<dim3(tiles_m * tiles_n, nsplit, lanes), THREADS, smem, stream>>>(
      smap, va, vb, w.row_m, w.row_l, out, w.part, nq, nk, d, ktiles_per_split, tiles_n);
  return (int)cudaGetLastError();
}

int combine(const Layout& w, float* out, int rows, int d, int nsplit, cudaStream_t stream) {
  if (nsplit == 1) return 0;
  const size_t n4 = (size_t)rows * d / 4;
  combine_kernel<<<blocks_for(n4, 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(w.part), w.row_l, reinterpret_cast<float4*>(out), rows,
      d, nsplit);
  return (int)cudaGetLastError();
}

template <bool F32>
int run(int first, int last, const void* q, const void* k, const void* v, const float* bias,
        float* out, void* workspace, int lanes, int nq, int nk, int d, float scale, int nsplit,
        int ktiles_per_split, cudaStream_t stream) {
  const Layout w(F32, lanes, nq, nk, d, nsplit, workspace);
  int err = 0;
  for (int phase = first; phase <= last && !err; ++phase) {
    switch (phase) {
      case 0: err = presplit<F32>(q, k, v, w, lanes, nq, nk, d, stream); break;
      case 1: err = logits<F32>(q, k, bias, w, lanes, nq, nk, d, scale, stream); break;
      case 2: err = rowstats(w, lanes * nq, stream); break;
      case 3:
        err = output<F32>(w, out, lanes, nq, nk, d, nsplit, ktiles_per_split, stream);
        break;
      case 4: err = combine(w, out, lanes * nq, d, nsplit, stream); break;
      default: err = (int)cudaErrorInvalidValue;
    }
  }
  return err;
}

}  // namespace

// Plain C interface (loaded with ctypes).
//
// hvr_attn_run launches phases first..last (0 pre-split, 1 logits, 2 row
// statistics, 3 output, 4 combine) of one call on `stream` and returns 0 or
// an error code for hvr_attn_error_string; a whole call is phases 0..4, and
// a single phase can be rerun on its own once the phases before it have
// run.  `workspace` holds hvr_attn_workspace_bytes bytes for the same
// (f32, lanes, nq, nk, d, nsplit).  Requirements the Python wrapper checks:
// contiguous row-major operands (lanes × rows × d) with 16-byte aligned
// bases, 1 <= lanes <= 64, d a multiple of 64, nk >= 1, 1 <= nsplit, and
// nsplit · ktiles_per_split key tiles (32 keys for f32, 64 for bf16) covering
// nk with none of the splits empty.

extern "C" long long hvr_attn_workspace_bytes(int f32, int lanes, int nq, int nk, int d,
                                              int nsplit) {
  return (long long)Layout(f32 != 0, lanes, nq, nk, d, nsplit, nullptr).bytes;
}

extern "C" int hvr_attn_run(int f32, int first, int last, const void* q, const void* k,
                            const void* v, const float* bias, float* out, void* workspace,
                            int lanes, int nq, int nk, int d, float scale, int nsplit,
                            int ktiles_per_split, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? run<true>(first, last, q, k, v, bias, out, workspace, lanes, nq, nk, d, scale,
                         nsplit, ktiles_per_split, st)
             : run<false>(first, last, q, k, v, bias, out, workspace, lanes, nq, nk, d, scale,
                          nsplit, ktiles_per_split, st);
}

extern "C" const char* hvr_attn_error_string(int code) {
  static char buf[96];
  if (code >= ENCODE_FAILED) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - ENCODE_FAILED);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
