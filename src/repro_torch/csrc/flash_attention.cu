// Flash attention forward for Hopper (sm_90a): causal / sliding-window / GQA.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel) and computes what it computes: blocked online-softmax
// attention with the running max m, the running sum l and the output
// accumulator in f32, scores and p in f32, output acc / max(l, 1e-30) in
// q's dtype.  q (B, Sq, H, hd) and k/v (B, Sk, KV, hd) are read through
// their strides (only the last dim must be contiguous), so the transposes
// the Pallas wrapper makes are gone; q head h reads kv head h / G.
//
// Layout of the work: one block per (q tile of 64 rows, q head, batch).
// The TPU grid's sequential KV dimension is the loop over 64-key tiles
// inside the block.  Tiles entirely after the q tile (causal) or entirely
// older than the window are never visited; inside a visited tile each
// (q, k) pair is masked for causality, the window (k > q - window) and the
// ragged Sk edge.  Rows with no valid key come out 0.
//
// head_dim: any hd in 1..128.  Q and K tiles are padded to 128 columns in
// shared memory (the QK^T loop runs over the true hd); V is padded with
// zeros to 128 columns and output columns >= hd are never stored.
//
// Bound: at prefill lengths the work is 4*hd FLOPs per visible (q, k)
// pair against a few bytes per row, so tensor-core FLOPs bound it.  This
// first version is the simple correct one: K/V tiles staged in shared
// memory as f32 and every product an f32 FMA on the CUDA cores (each
// thread holds a 4x4 score tile and a 4x8 slice of the output), so it
// runs at a fraction of the f32 CUDA-core rate and far from the
// tensor-core bound.  wgmma, TMA and warp specialisation are left to a
// later version.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; launched from repro_torch/kernels/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per KV tile
constexpr int HD_MAX = 128;            // largest head_dim taken
constexpr int THREADS = 256;           // 16 x 16: ty picks rows, tx picks columns
constexpr int QK_STRIDE = HD_MAX + 1;  // +1: reading one dim of 16 rows hits 16 banks
constexpr int P_STRIDE = BK + 1;
constexpr int SMEM_FLOATS = BQ * QK_STRIDE + BK * QK_STRIDE + BK * HD_MAX + BQ * P_STRIDE;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int H, int G, int hd,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][QK_STRIDE], pre-scaled
  float* Ks = Qs + BQ * QK_STRIDE;     // [BK][QK_STRIDE]
  float* Vs = Ks + BK * QK_STRIDE;     // [BK][HD_MAX]
  float* Ps = Vs + BK * HD_MAX;        // [BQ][P_STRIDE]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // keys tx + 16 j of the tile; output dims tx + 16 c
  const int ty = tid >> 4;  // query rows ty + 16 i of the tile
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / G) * k_sh;
  const T* vb = v + b * v_sb + (h / G) * v_sh;

  // q is scaled in f32, as the Pallas kernel does.
  for (int idx = tid; idx < BQ * HD_MAX; idx += THREADS) {
    const int r = idx / HD_MAX, d = idx % HD_MAX;
    float x = 0.f;
    if (q0 + r < Sq && d < hd) x = to_float(qb[(int64_t)(q0 + r) * q_ss + d]) * scale;
    Qs[r * QK_STRIDE + d] = x;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  // Key tiles this q tile can see: causal stops after its last row; the
  // window starts at its first row's oldest visible key.
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // Qs written; last tile's Ks/Vs/Ps reads finished
    for (int idx = tid; idx < BK * HD_MAX; idx += THREADS) {
      const int r = idx / HD_MAX, d = idx % HD_MAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Sk && d < hd) {
        kx = to_float(kb[(int64_t)(k0 + r) * k_ss + d]);
        vx = to_float(vb[(int64_t)(k0 + r) * v_ss + d]);
      }
      Ks[r * QK_STRIDE + d] = kx;
      Vs[r * HD_MAX + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QK_STRIDE + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QK_STRIDE + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Mask, then the online softmax.  A row's 64 scores live in the 16
    // lanes that share ty (half a warp), so its max and sum are 4 shuffles.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[4];
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool valid = kp < Sk;
        if (causal) valid = valid && kp <= qp;
        if (window > 0) valid = valid && kp > qp - window;
        ok[j] = valid;
        if (valid) row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      // Rows with no valid key yet keep m = -inf; guard exp(-inf - -inf).
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        row_sum += p;
        Ps[(ty + 16 * i) * P_STRIDE + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V, p kept in f32.
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * P_STRIDE + j];
#pragma unroll
      for (int c = 0; c < 8; ++c) vv[c] = Vs[j * HD_MAX + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (((int64_t)b * Sq + qp) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) store_out(orow + d, acc[i][c] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int KV, int hd, const long long* qs, const long long* ks,
                   const long long* vs, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, H / KV, hd, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2],
      vs[0], vs[1], vs[2], causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// batch, sequence and head dims; the head_dim stride must be 1.  window <= 0
// means no window.  The output o is contiguous (B, Sq, H, hd).  Returns a
// cudaError_t: 0 when the launch was accepted.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                        int Sq, int Sk, int H, int KV, int hd, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh, int causal, int window,
                        float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || hd < 1 || hd > HD_MAX)
    return (int)cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, B, Sq, Sk, H, KV, hd, qs, ks, vs, causal, window,
                              scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, hd, qs, ks, vs, causal,
                                      window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
