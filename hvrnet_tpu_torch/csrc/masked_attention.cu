// Flash masked attention for Hopper (sm_90a):
//     out = softmax(q·kᵀ·scale + bias) · v,   returned as f32.
//
// Replaces the Pallas TPU kernel hvrnet_tpu/ops/attention.py:_flash_kernel
// (launched by _flash_attention).  Same semantics, not the same blocking:
//   * q, k, v are f32 or bf16, (nq, d) and (nk, d) row-major; bias is an
//     f32 (nk,) additive key bias: 0 for live keys, -1e30 for masked ones.
//     -1e30 is finite, so a row whose keys are all masked averages v, as the
//     reference does.
//   * logits, the online-softmax state (running max m, normaliser l) and the
//     accumulator are f32.  f32 inputs are multiplied in full f32 (no TF32).
//     With bf16 inputs p is rounded to bf16 before the P·V product, as the
//     Pallas kernel does; l sums the unrounded p.
//   * ragged nq and nk are masked in the kernel: rows past nq are never
//     written, keys past nk take no part in the softmax.  (The TPU wrapper's
//     host pads were workarounds for Mosaic, not semantics.)
//
// What bounds it on the H100: at the exact-ring shapes (d = 1024; nq = nk =
// 6300 for NL1/NL3, nq = 300 and nk = 6300 for NL2/NL4) the work is
// 4·nq·nk·d FLOPs against (2·nq + 2·nk)·d·4 bytes of input and output, about
// 1600 FLOPs per byte: it is bound by arithmetic.  This first version uses
// the CUDA cores (f32 FMA, 67 TFLOP/s peak), not the tensor cores.
//
// Design.  At d = 1024 one query row's f32 accumulator is 4 KB, so the usual
// 64-row flash tile (256 KB) fits in neither registers nor shared memory.
// Each block therefore takes a small tile of BQ = 16 query rows and the
// whole of d:
//   * the Q tile sits in shared memory as f32 (64 KB at d = 1024);
//   * each 256-thread block walks its keys in tiles of BK = 64.  Logits:
//     K is staged in 64-wide chunks of d; each thread computes a 4×4 block
//     of (row, key) logits over a quarter of every chunk, and the four
//     quarters are summed through shared memory.  Online softmax: 16 lanes
//     per row, warp shuffles for the row max and sum.  P·V: each thread owns
//     4 of the d output columns for all 16 rows (64 accumulator registers)
//     and streams V rows straight from global memory as 16-byte loads, with
//     P broadcast from shared memory;
//   * 104 KB of shared memory per block, so two blocks share an SM.
// Small query sets (NL2/NL4: 19 query tiles for 132 SMs) split the keys
// across blocks (grid.y): each split writes its unnormalised accumulator and
// (m, l), and a second kernel combines the splits.
// Costs: Q·Kᵀ re-reads K once per query tile (from L2 at these sizes), the
// logit stage is bound by shared-memory bandwidth, and nothing overlaps the
// K-chunk loads with arithmetic.  wgmma/TMA pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int DC = 64;         // width of a staged K chunk along d
constexpr int THREADS = 256;
constexpr int QPAD = 4;        // row padding of the Q tile (floats)
constexpr int KSTRIDE = DC + 4;
constexpr int NSPLIT_D = THREADS / 64;   // d-quarters in the logit stage

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ float round_p(float p) { return p; }

template <>
__device__ __forceinline__ float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

__host__ __device__ constexpr size_t smem_floats(int d) {
  return (size_t)BQ * (d + QPAD) + (size_t)BK * KSTRIDE +
         (size_t)NSPLIT_D * BQ * BK + (size_t)BK * BQ + 3 * BQ;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_masked_attention(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       float* __restrict__ out, float* __restrict__ part_o,
                       float* __restrict__ part_ml, int nq, int nk, int d,
                       float scale, int keys_per_split) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int qstride = d + QPAD;
  float* qs = smem;                           // [BQ][qstride]
  float* ks = qs + BQ * qstride;              // [BK][KSTRIDE]
  float* red = ks + BK * KSTRIDE;             // [NSPLIT_D][BQ][BK]
  float* ps = red + NSPLIT_D * BQ * BK;       // [BK][BQ]  (P, key-major)
  float* row_m = ps + BK * BQ;                // [BQ]
  float* row_l = row_m + BQ;                  // [BQ]
  float* row_alpha = row_l + BQ;              // [BQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int kbeg = split * keys_per_split;
  const int kend = min(nk, kbeg + keys_per_split);

  const int d4 = d / 4;
  for (int i = tid; i < BQ * d4; i += THREADS) {
    const int r = i / d4;
    const int c = (i - r * d4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < nq) val = load4(q + (size_t)(q0 + r) * d + c);
    *reinterpret_cast<float4*>(qs + r * qstride + c) = val;
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  // logit stage: rows rg + 4i, keys kg + 16j, d-quarter dq of each chunk
  const int kg = tid & 15;
  const int rg = (tid >> 4) & 3;
  const int dq = tid >> 6;
  // softmax stage: 16 lanes per row
  const int srow = tid >> 4;
  const int slane = tid & 15;
  // P·V stage: output columns col .. col+3 of all BQ rows
  const int col = tid * 4;
  const bool has_col = col < d;

  float acc[BQ][4];
#pragma unroll
  for (int r = 0; r < BQ; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int kt = kbeg; kt < kend; kt += BK) {
    const int nkt = min(BK, kend - kt);

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

    for (int dc = 0; dc < d; dc += DC) {
      __syncthreads();  // the previous chunk (and tile) is no longer read
      for (int i = tid; i < BK * (DC / 4); i += THREADS) {
        const int kr = i / (DC / 4);
        const int c = (i - kr * (DC / 4)) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kr < nkt) val = load4(k + (size_t)(kt + kr) * d + dc + c);
        *reinterpret_cast<float4*>(ks + kr * KSTRIDE + c) = val;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < DC / NSPLIT_D; c += 4) {
        const int kc = dq * (DC / NSPLIT_D) + c;
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + (rg + 4 * i) * qstride + dc + kc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(ks + (kg + 16 * j) * KSTRIDE + kc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[(dq * BQ + rg + 4 * i) * BK + kg + 16 * j] = s[i][j];
    __syncthreads();

    // online softmax over this tile
    float x[4];
    float mloc = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = slane + 16 * j;
      float val = -INFINITY;  // keys past the end take no part
      if (key < nkt) {
        float dot = 0.f;
#pragma unroll
        for (int p = 0; p < NSPLIT_D; ++p) dot += red[(p * BQ + srow) * BK + key];
        val = dot * scale + bias[kt + key];
      }
      x[j] = val;
      mloc = fmaxf(mloc, val);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
    const float m_prev = row_m[srow];
    const float m_new = fmaxf(m_prev, mloc);  // finite: key 0 of a tile is live
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(x[j] - m_new);
      psum += p;
      ps[(slane + 16 * j) * BQ + srow] = round_p<T>(p);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    // every lane of the row has read m_prev: the shuffles above synchronise
    // the half-warp that owns the row
    if (slane == 0) {
      const float alpha = expf(m_prev - m_new);  // 0 on the first tile
      row_alpha[srow] = alpha;
      row_l[srow] = row_l[srow] * alpha + psum;
      row_m[srow] = m_new;
    }
    __syncthreads();

    if (has_col) {
#pragma unroll
      for (int r = 0; r < BQ; ++r) {
        const float a = row_alpha[r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= a;
      }
      for (int j = 0; j < nkt; ++j) {
        const float4 vv = load4(v + (size_t)(kt + j) * d + col);
#pragma unroll
        for (int r = 0; r < BQ; r += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(ps + j * BQ + r);
          const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[r + i][0] = fmaf(pr[i], vv.x, acc[r + i][0]);
            acc[r + i][1] = fmaf(pr[i], vv.y, acc[r + i][1]);
            acc[r + i][2] = fmaf(pr[i], vv.z, acc[r + i][2]);
            acc[r + i][3] = fmaf(pr[i], vv.w, acc[r + i][3]);
          }
        }
      }
    }
  }

  if (has_col) {
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      const int row = q0 + r;
      if (row < nq) {
        if (nsplit == 1) {
          const float l = row_l[r];
          *reinterpret_cast<float4*>(out + (size_t)row * d + col) =
              make_float4(acc[r][0] / l, acc[r][1] / l, acc[r][2] / l, acc[r][3] / l);
        } else {
          *reinterpret_cast<float4*>(part_o + ((size_t)split * nq + row) * d + col) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
    }
  }
  if (nsplit > 1 && tid < BQ && q0 + tid < nq) {
    part_ml[((size_t)split * nq + q0 + tid) * 2] = row_m[tid];
    part_ml[((size_t)split * nq + q0 + tid) * 2 + 1] = row_l[tid];
  }
}

// out[row] = Σ_s e^(m_s − M)·o_s / Σ_s e^(m_s − M)·l_s over the key splits
__global__ void __launch_bounds__(THREADS)
combine_splits(const float* __restrict__ part_o, const float* __restrict__ part_ml,
               float* __restrict__ out, int nq, int d, int nsplit) {
  const int row = blockIdx.x;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_ml[((size_t)s * nq + row) * 2]);
  float l = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float* ml = part_ml + ((size_t)s * nq + row) * 2;
    l += expf(ml[0] - mx) * ml[1];
  }
  for (int col = threadIdx.x * 4; col < d; col += THREADS * 4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(part_ml[((size_t)s * nq + row) * 2] - mx);
      const float4 o = load4(part_o + ((size_t)s * nq + row) * d + col);
      a.x = fmaf(w, o.x, a.x);
      a.y = fmaf(w, o.y, a.y);
      a.z = fmaf(w, o.z, a.z);
      a.w = fmaf(w, o.w, a.w);
    }
    *reinterpret_cast<float4*>(out + (size_t)row * d + col) =
        make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           float* out, float* part_o, float* part_ml, int nq, int nk, int d,
           float scale, int nsplit, int keys_per_split, cudaStream_t stream) {
  const size_t smem = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_masked_attention<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + BQ - 1) / BQ, nsplit);
  flash_masked_attention<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, out, part_o, part_ml, nq, nk, d, scale, keys_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  combine_splits<<<nq, THREADS, 0, stream>>>(part_o, part_ml, out, nq, d, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t code.
// Requirements the Python wrapper checks: contiguous row-major operands,
// 16-byte aligned rows, d a multiple of 64 and at most 1024, nk >= 1,
// nsplit * keys_per_split >= nk with keys_per_split a multiple of 64, and
// part_o / part_ml sized (nsplit, nq, d) / (nsplit, nq, 2) when nsplit > 1.
extern "C" int hvr_masked_attention_f32(const void* q, const void* k, const void* v,
                                        const float* bias, float* out, float* part_o,
                                        float* part_ml, int nq, int nk, int d,
                                        float scale, int nsplit, int keys_per_split,
                                        void* stream) {
  return launch<float>(q, k, v, bias, out, part_o, part_ml, nq, nk, d, scale, nsplit,
                       keys_per_split, static_cast<cudaStream_t>(stream));
}

extern "C" int hvr_masked_attention_bf16(const void* q, const void* k, const void* v,
                                         const float* bias, float* out, float* part_o,
                                         float* part_ml, int nq, int nk, int d,
                                         float scale, int nsplit, int keys_per_split,
                                         void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, out, part_o, part_ml, nq, nk, d, scale,
                               nsplit, keys_per_split, static_cast<cudaStream_t>(stream));
}

extern "C" const char* hvr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
