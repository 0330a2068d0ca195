// The Mamba-2 block's elementwise work on each side of the SSD scan, for
// Hopper (sm_90a): two kernels.
//
// It replaces no TPU kernel.  src/repro/models/ssm.py leaves this work to
// XLA, which fuses the chain of casts, pads, taps, adds and activations into
// a few passes; eager PyTorch runs every op of it as a pass of its own, each
// reading and writing a whole (B, S, channels) tensor.  Each kernel here
// does one side of the scan in one pass.
//
// 1. ssm_conv: causal depthwise conv + bias + SiLU.  Reads x, B and C in
//    place from the in_proj's f32 output (B, S, W) through its row stride
//    (the C columns from the xBC offset), w (K, C) and b (C,) f32, and
//    writes xBC (B, S, C) contiguous in the model dtype T.  Per channel and
//    position t, the arithmetic of models/ssm.py::_causal_conv on the
//    rounded input:
//      v_j   = T(in[t - (K-1) + j])             (0 before position 0)
//      acc   = 0 + v_0 w_0; acc += v_j w_j for j = 1 .. K-1   (each product
//              and each sum rounded to f32, left to right from tap 0)
//      out   = T(silu(acc + b)),  silu(x) = x / (1 + exp(-x)) in f32
// 2. ssm_gate_norm: rms_norm(y * silu(z)) * scale over a row of d.  Reads y
//    (B, S, d) in T (the scan's output, through its strides) and z as the f32
//    view of the in_proj's output (through its row stride), scale (d,) f32,
//    and writes (B, S, d) contiguous in T.  The roundings of models/ssm.py:
//      g     = T(y * T(silu(T(z))))
//      r     = rsqrt(sum(g * g) * (1/d) + eps)   (f32, as PyTorch's mean;
//              the sum in the kernel's order, which is not PyTorch's)
//      out   = T((g * r) * scale)
//
// Bound: bytes.  Each does a few dozen instructions an element against 6
// (conv: 4 read, 2 written in bf16) or 8 (gate norm: 2 + 4 read, 2 written)
// bytes, below the card's 295 operations a byte; but the exact SiLU (an
// IEEE division and a full-precision exp, as PyTorch computes it) costs
// about as many instruction cycles as the bytes take, so the design keeps many
// warps resident for the loads to overlap the arithmetic.  Each byte moves
// once:
// - ssm_conv: a thread owns 4 adjacent channels (one 16-byte f32 load and
//   one 8-byte bf16 store a row) and walks a run of RUN positions, keeping
//   the last K-1 rounded inputs in registers, so each row is read once plus
//   K-1 halo rows a run (5 % more reads at K 4, mostly from L2).  The next
//   row's load is in flight while a row is computed.  Blocks of at most
//   CONV_THREADS threads across the channels; grid (C/4 threads across,
//   ceil(S / RUN), B), the ragged edges masked.  Under 60 registers a
//   thread, 8 channels a thread (120) or two rows in flight ran slower
//   (an H100, 128 x 2048: 1.18 and 1.15 ms against 1.10).
// - ssm_gate_norm: one warp a row up to d 2048 (mamba2-130m: 1536 = 6
//   16-byte vectors a lane), the gated row kept in registers between the
//   sum of squares (shuffles) and the scaled store, at most 80 registers a
//   thread so that 24 warps fit an SM; above d 2048 one block a row (jamba:
//   16,384), the gated row kept in shared memory as T, which holds it
//   exactly.
// Products and sums use the _rn intrinsics, so no multiply and add are
// contracted into an FMA: every rounding is at the place PyTorch's separate
// passes put it.  Without 16-byte alignment (an odd row stride, d not a
// multiple of 8) the same kernels load element by element (template VEC).
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; launched from repro_torch/kernels/ssm_block.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CH = 8;              // elements a vector item of the norm (16 bytes of bf16)
constexpr int CONV_CH = 4;         // channels a conv thread (one 16-byte f32 load a row)
constexpr int RUN = 64;            // positions a conv thread walks
constexpr int AHEAD = 1;           // rows a conv thread has in flight while it computes
constexpr int CONV_THREADS = 64;   // at most, a conv block
constexpr int K_MAX = 4;
constexpr int WARP_ROW_MAX = 2048;  // d up to which one warp takes a row
constexpr int ROWS_A_BLOCK = 2;     // warps (rows) a block of the warp variant
constexpr int NORM_BLOCKS = 12;     // blocks of the warp variant an SM: at most 80 registers a thread
constexpr int ROW_THREADS = 256;    // threads a row in the block variant

// N f32 values from device memory at p: 16-byte loads, or one at a time
// where p is not 16-byte aligned.
template <int N, bool VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
  if constexpr (VEC) {
    static_assert(N % 4 == 0, "16-byte loads take 4 floats");
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = __ldg(p + j);
  }
}

// Loads and stores of the model dtype T, N at a time in 16- or 8-byte
// accesses (N a multiple of 4), and T's rounding.  Plain accesses, so the
// same helpers serve device and shared memory.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  template <int N>
  static __device__ __forceinline__ void load(const float* p, float (&v)[N]) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 a = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
    }
  }
  static __device__ __forceinline__ void store1(float* p, float v) { *p = v; }
  template <int N>
  static __device__ __forceinline__ void store(float* p, const float (&v)[N]) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
};

// bf16 bits are the high half of the f32 they widen to
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float v) { return __uint_as_float(bf16_bits(v) << 16); }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  template <int N>
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[N]) {
    static_assert(N == 8, "one 16-byte load");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
  template <int N>
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint32_t w[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
    if constexpr (N == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      static_assert(N == 4, "one 16- or 8-byte store");
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    }
  }
};

// PyTorch's CUDA SiLU in f32: x / (1 + exp(-x)), each step rounded.
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(CONV_THREADS) ssm_conv_kernel(
    const float* __restrict__ in, long long in_sb, long long in_ss, const float* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ out, int S, int C) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * CONV_CH;
  if (c0 >= C) return;
  const int t0 = blockIdx.y * RUN;
  const int t1 = min(t0 + RUN, S);
  const long long b = blockIdx.z;
  const float* src = in + b * in_sb + c0;
  T* dst = out + b * S * (long long)C + c0;

  float wk[K][CONV_CH], bk[CONV_CH];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < CONV_CH; ++j) wk[k][j] = __ldg(w + (long long)k * C + c0 + j);
#pragma unroll
  for (int j = 0; j < CONV_CH; ++j) bk[j] = __ldg(bias + c0 + j);

  // win[k]: the rounded input K-1-k positions before the one computed next
  float win[K > 1 ? K - 1 : 1][CONV_CH];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    const int t = t0 - (K - 1) + k;
    if (t >= 0) {
      load_f32<CONV_CH, VEC>(src + t * in_ss, win[k]);
#pragma unroll
      for (int j = 0; j < CONV_CH; ++j) win[k][j] = Io<T>::round(win[k][j]);
    } else {
#pragma unroll
      for (int j = 0; j < CONV_CH; ++j) win[k][j] = 0.f;
    }
  }

  // ahead[u]: row t + u, loaded AHEAD rows before it is computed; the slot
  // is refilled with row t + u + AHEAD as soon as it is read
  float ahead[AHEAD][CONV_CH];
#pragma unroll
  for (int u = 0; u < AHEAD; ++u)
    if (t0 + u < t1) load_f32<CONV_CH, VEC>(src + (t0 + u) * in_ss, ahead[u]);
  for (int t = t0; t < t1; t += AHEAD) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (t + u < t1) {
        float cur[CONV_CH], o[CONV_CH];
#pragma unroll
        for (int j = 0; j < CONV_CH; ++j) cur[j] = Io<T>::round(ahead[u][j]);
        if (t + u + AHEAD < t1) load_f32<CONV_CH, VEC>(src + (t + u + AHEAD) * in_ss, ahead[u]);
#pragma unroll
        for (int j = 0; j < CONV_CH; ++j) {
          // the taps left to right, from 0 as Python's sum starts
          float acc = __fadd_rn(0.f, __fmul_rn(K > 1 ? win[0][j] : cur[j], wk[0][j]));
#pragma unroll
          for (int k = 1; k < K - 1; ++k) acc = __fadd_rn(acc, __fmul_rn(win[k][j], wk[k][j]));
          if (K > 1) acc = __fadd_rn(acc, __fmul_rn(cur[j], wk[K - 1][j]));
          o[j] = silu(__fadd_rn(acc, bk[j]));
#pragma unroll
          for (int k = 0; k + 1 < K - 1; ++k) win[k][j] = win[k + 1][j];
          if (K > 1) win[K > 1 ? K - 2 : 0][j] = cur[j];
        }
        Io<T>::template store<CONV_CH>(dst + (long long)(t + u) * C, o);
      }
    }
  }
}

// g = T(y * T(silu(T(z)))), as float
template <typename T>
__device__ __forceinline__ float gate(float y, float z) {
  const float s = Io<T>::round(silu(Io<T>::round(z)));
  return Io<T>::round(__fmul_rn(y, s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// W elements an item: 8 (16-byte loads) or 1.
template <typename T, int W>
__device__ __forceinline__ void load_item(const T* yr, const float* zr, int e, float (&g)[W],
                                          float& ss) {
  float yv[W], zv[W];
  if constexpr (W == CH) {
    Io<T>::template load<CH>(yr + e, yv);
    load_f32<CH, true>(zr + e, zv);
  } else {
    yv[0] = Io<T>::load1(yr + e);
    zv[0] = __ldg(zr + e);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    g[j] = gate<T>(yv[j], zv[j]);
    ss = __fadd_rn(ss, __fmul_rn(g[j], g[j]));
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_item(T* outr, const float* scale, int e, const float (&g)[W],
                                           float r) {
  float o[W];
  if constexpr (W == CH) {
    load_f32<CH, true>(scale + e, o);
  } else {
    o[0] = __ldg(scale + e);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) o[j] = __fmul_rn(__fmul_rn(g[j], r), o[j]);
  if constexpr (W == CH) {
    Io<T>::template store<CH>(outr + e, o);
  } else {
    Io<T>::store1(outr + e, o[0]);
  }
}

// One warp a row, the gated row in registers: ITEMS items of W a lane.
template <typename T, int W>
__global__ void __launch_bounds__(ROWS_A_BLOCK * 32, NORM_BLOCKS) ssm_gate_norm_warp_kernel(
    const T* __restrict__ y, long long y_sb, long long y_ss, const float* __restrict__ z,
    long long z_sb, long long z_ss, const float* __restrict__ scale, T* __restrict__ out,
    int rows, int S, int d, float inv_d, float eps) {
  constexpr int ITEMS = WARP_ROW_MAX / (32 * W);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_A_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp at once: the shuffles below stay full
  const long long b = row / S, s = row % S;
  const T* yr = y + b * y_sb + s * y_ss;
  const float* zr = z + b * z_sb + s * z_ss;
  T* outr = out + (long long)row * d;
  const int items = d / W;
  float g[ITEMS][W];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int it = lane + 32 * i;
    if (it < items) load_item<T, W>(yr, zr, it * W, g[i], ss);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int it = lane + 32 * i;
    if (it < items) store_item<T, W>(outr, scale, it * W, g[i], r);
  }
}

// One block a row, the gated row kept in shared memory as T (exact: each
// gated value is rounded to T already).  Each thread reads back only what it
// wrote, so the one barrier is the sum's.
template <typename T, int W>
__global__ void __launch_bounds__(ROW_THREADS) ssm_gate_norm_block_kernel(
    const T* __restrict__ y, long long y_sb, long long y_ss, const float* __restrict__ z,
    long long z_sb, long long z_ss, const float* __restrict__ scale, T* __restrict__ out, int S,
    int d, float inv_d, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* gs = reinterpret_cast<T*>(smem_raw);
  __shared__ float part[ROW_THREADS / 32];
  const int row = blockIdx.x;
  const long long b = row / S, s = row % S;
  const T* yr = y + b * y_sb + s * y_ss;
  const float* zr = z + b * z_sb + s * z_ss;
  T* outr = out + (long long)row * d;
  const int items = d / W;
  float ss = 0.f;
  for (int it = threadIdx.x; it < items; it += ROW_THREADS) {
    float g[W];
    load_item<T, W>(yr, zr, it * W, g, ss);
    if constexpr (W == CH) {
      Io<T>::template store<CH>(gs + it * W, g);
    } else {
      Io<T>::store1(gs + it, g[0]);
    }
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = part[0];
#pragma unroll
  for (int i = 1; i < ROW_THREADS / 32; ++i) total = __fadd_rn(total, part[i]);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, inv_d), eps));
  for (int it = threadIdx.x; it < items; it += ROW_THREADS) {
    float g[W];
    if constexpr (W == CH) {
      Io<T>::template load<CH>(gs + it * W, g);
    } else {
      g[0] = Io<T>::load1(gs + it);
    }
    store_item<T, W>(outr, scale, it * W, g, r);
  }
}

template <typename T, int K>
cudaError_t launch_conv_k(const float* in, long long in_sb, long long in_ss, const float* w,
                          const float* b, void* out, int B, int S, int C, bool vec,
                          cudaStream_t stream) {
  // as few blocks across the channels as CONV_THREADS allows, in whole warps
  const int groups = C / CONV_CH;
  const int across = (groups + CONV_THREADS - 1) / CONV_THREADS;
  const int threads = ((groups + across - 1) / across + 31) / 32 * 32;
  const dim3 grid(across, (S + RUN - 1) / RUN, B);
  T* o = static_cast<T*>(out);
  if (vec)
    ssm_conv_kernel<T, K, true><<<grid, threads, 0, stream>>>(in, in_sb, in_ss, w, b, o, S, C);
  else
    ssm_conv_kernel<T, K, false><<<grid, threads, 0, stream>>>(in, in_sb, in_ss, w, b, o, S, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_conv(const float* in, long long in_sb, long long in_ss, const float* w,
                        const float* b, void* out, int B, int S, int C, int K, bool vec,
                        cudaStream_t s) {
  switch (K) {
    case 1: return launch_conv_k<T, 1>(in, in_sb, in_ss, w, b, out, B, S, C, vec, s);
    case 2: return launch_conv_k<T, 2>(in, in_sb, in_ss, w, b, out, B, S, C, vec, s);
    case 3: return launch_conv_k<T, 3>(in, in_sb, in_ss, w, b, out, B, S, C, vec, s);
    case 4: return launch_conv_k<T, 4>(in, in_sb, in_ss, w, b, out, B, S, C, vec, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int W>
cudaError_t launch_norm_w(const void* y, long long y_sb, long long y_ss, const float* z,
                          long long z_sb, long long z_ss, const float* scale, void* out, int B,
                          int S, int d, float eps, cudaStream_t stream) {
  const T* yt = static_cast<const T*>(y);
  T* o = static_cast<T*>(out);
  const int rows = B * S;
  const float inv_d = 1.0f / (float)d;  // PyTorch's mean: the sum times 1/d in f32
  if (d <= WARP_ROW_MAX) {
    const int blocks = (rows + ROWS_A_BLOCK - 1) / ROWS_A_BLOCK;
    ssm_gate_norm_warp_kernel<T, W><<<blocks, ROWS_A_BLOCK * 32, 0, stream>>>(
        yt, y_sb, y_ss, z, z_sb, z_ss, scale, o, rows, S, d, inv_d, eps);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)d * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(ssm_gate_norm_block_kernel<T, W>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  ssm_gate_norm_block_kernel<T, W><<<rows, ROW_THREADS, smem, stream>>>(
      yt, y_sb, y_ss, z, z_sb, z_ss, scale, o, S, d, inv_d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_norm(const void* y, long long y_sb, long long y_ss, const float* z,
                        long long z_sb, long long z_ss, const float* scale, void* out, int B,
                        int S, int d, float eps, bool vec, cudaStream_t s) {
  if (vec) return launch_norm_w<T, CH>(y, y_sb, y_ss, z, z_sb, z_ss, scale, out, B, S, d, eps, s);
  return launch_norm_w<T, 1>(y, y_sb, y_ss, z, z_sb, z_ss, scale, out, B, S, d, eps, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the output, the model dtype).  in is
// f32, read at in + b * in_sb + t * in_ss + c (strides in elements, the
// channels contiguous); w (K, C) and b (C,) f32 contiguous; out a
// contiguous (B, S, C).  C a multiple of 4, 1 <= K <= 4, B <= 65535,
// ceil(S / 64) <= 65535.  vec: in, in_sb and in_ss allow 16-byte loads (the
// base 16-byte aligned, both strides multiples of 4).  Returns a
// cudaError_t: 0 when the launch was accepted.
int ssm_conv_fwd(const void* in, const void* w, const void* b, void* out, int dtype, int B, int S,
                 int C, int K, long long in_sb, long long in_ss, int vec, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || (S + RUN - 1) / RUN > 65535 || C < CONV_CH || C % CONV_CH != 0 ||
      K < 1 || K > K_MAX)
    return (int)cudaErrorInvalidValue;
  const float* inf = static_cast<const float*>(in);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_conv<float>(inf, in_sb, in_ss, wf, bf, out, B, S, C, K, vec, s);
  if (dtype == 1)
    return (int)launch_conv<__nv_bfloat16>(inf, in_sb, in_ss, wf, bf, out, B, S, C, K, vec, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (y and out).  y read at y + b * y_sb +
// t * y_ss + c, z (f32) at z + b * z_sb + t * z_ss + c; scale (d,) f32
// contiguous; out a contiguous (B, S, d).  B * S <= 2^31 - 1; above d 2048
// the row takes d * sizeof(T) bytes of shared memory.  vec: d a multiple of
// 8, y, z and scale 16-byte aligned, with strides that keep every row so.
int ssm_gate_norm_fwd(const void* y, const void* z, const void* scale, void* out, int dtype, int B,
                      int S, int d, long long y_sb, long long y_ss, long long z_sb, long long z_ss,
                      float eps, int vec, void* stream) {
  if (B < 1 || S < 1 || d < 1 || (long long)B * S > 2147483647LL || (vec && d % CH != 0))
    return (int)cudaErrorInvalidValue;
  const float* zf = static_cast<const float*>(z);
  const float* sf = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_norm<float>(y, y_sb, y_ss, zf, z_sb, z_ss, sf, out, B, S, d, eps, vec, s);
  if (dtype == 1)
    return (int)launch_norm<__nv_bfloat16>(y, y_sb, y_ss, zf, z_sb, z_ss, sf, out, B, S, d, eps,
                                           vec, s);
  return (int)cudaErrorInvalidValue;
}

const char* ssm_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
