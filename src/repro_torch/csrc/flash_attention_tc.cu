// Flash attention forward for Hopper (sm_90a), bf16 inputs, on the tensor cores.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel) for bf16 q/k/v, the dtype the serving path runs; f32 inputs go
// to the CUDA-core kernel in flash_attention.cu (the wrapper's dtype rule,
// kernels/flash_attention.py).  Same function: causal and sliding-window
// masks (a key is kept when k > q - window), GQA (q head h reads kv head
// h / G), running max m, running sum l and the output accumulator in f32,
// output acc / max(l, 1e-30) in bf16; rows with no valid key come out 0.
//
// What bounds it: 4*hd FLOPs per visible (q, k) pair against q, k, v and o
// moved once, so at prefill lengths the tensor cores' bf16 rate.  The
// CUDA-core kernel ran every product as an f32 FMA (the 67 TFLOP/s ceiling).
// Here both products run as wgmma, Hopper's warpgroup product (bf16 in, f32
// accumulate):
//   - one block is one warpgroup (4 warps) and owns a 64-row q tile, which
//     is wgmma's m64; Q is loaded once;
//   - K/V tiles of 64 keys stream through a two-stage ring in shared memory
//     by cp.async, so tile j+1 loads while tile j is multiplied; every tile
//     is stored in the 128-byte swizzle wgmma reads without bank conflicts;
//   - S = Q K^T is wgmma m64n64k16 with both operands in shared memory;
//     scale, masks, the online softmax (m, l) and the alpha rescale of the
//     accumulator run in registers on S's accumulator fragments, with quad
//     shuffles for the row max;
//   - P is rounded to bf16 in registers (S's accumulator layout is the A
//     fragment layout of P V) and O += P V is wgmma m64n128k16 (m64n64k16 for
//     hd <= 64) with P from registers and V read transposed from shared
//     memory.  P in bf16 is the one rounding the f32 path does not have; l
//     sums the f32 p.
// Tiles wholly after the q tile (causal) or wholly older than the window are
// never visited; masking inside a tile covers causality, the window and the
// ragged Sk edge.  The heaviest q tiles (the last, under causality) start
// first.  Shared memory: 81 KB at hd 128, two blocks an SM.
//
// head_dim: the reduction of Q K^T runs in steps of 16 and the swizzle works
// in 64-column panels, so hd is padded to HDP (64 or 128; danube's 120 ->
// 128) with zeros that cp.async writes in shared memory (a 16-byte chunk
// wholly past hd is zero-filled, never read from the next head).  Output
// columns >= hd are never stored.  The wrapper sends here only input that
// cp.async can read 16 bytes at a time: hd a multiple of 8, batch/sequence/
// head strides multiples of 8 elements and 16-byte-aligned bases (danube:
// 240 B a head, 1920 B a k row, 7680 B a q row); the rest goes to the
// CUDA-core kernel.
//
// Not yet here (ROADMAP queue B): TMA with mbarriers in place of cp.async,
// warp specialisation (a producer warp and two consumer warpgroups), and
// overlap of one tile's softmax with the next tile's Q K^T inside a
// warpgroup; each wgmma group is waited for before its result is used.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; launched from repro_torch/kernels/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "tc_ops.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // query rows per block: wgmma's m64
constexpr int BK = 64;  // keys per K/V tile
constexpr int THREADS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// Q, then K and V twice each, plus room to align the start to 1024 bytes
template <int HDP>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + 4 * BK) * HDP * sizeof(bf16) + 1024;
}

// rows [row0, row0 + 64) into a tile of 64-element panels, 128 B a row,
// 16-byte chunk c of row r at chunk (c ^ (r % 8)): the 128-byte swizzle.
template <int HDP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t row_stride,
                                          int row0, int nrows, int hd) {
  constexpr int CH = HDP / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = row0 + r < nrows && c * 8 < hd;
    const bf16* p = ok ? src + (int64_t)(row0 + r) * row_stride + c * 8 : src;
    tc::cp_async16(dst + (c >> 3) * (64 * 64) + r * 64 + (((c & 7) ^ (r & 7)) * 8), p, ok);
  }
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, 2) flash_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int Sq, int Sk, int H, int G, int hd,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int causal, int window, float scale_log2) {
  constexpr int TILE = BK * HDP;
  constexpr int KS = HDP / 16;
  constexpr int NT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles start 1024-byte aligned
  const uint32_t pad = (1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + pad);  // [HDP / 64][BQ][64]
  bf16* Ks = Qs + BQ * HDP;                              // two stages of [HDP / 64][BK][64]
  bf16* Vs = Ks + 2 * TILE;                              // two stages likewise

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + (h / G) * k_sh;
  const bf16* vb = v + b * v_sb + (h / G) * v_sh;

  // Key tiles this q tile can see: causal stops after its last row; the
  // window starts at its first row's oldest visible key.
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  load_tile<HDP>(Qs, qb, q_ss, q0, Sq, hd);
  if (n_tiles > 0) {
    load_tile<HDP>(Ks, kb, k_ss, k_begin, Sk, hd);
    load_tile<HDP>(Vs, vb, v_ss, k_begin, Sk, hd);
  }
  tc::cp_async_commit();

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};  // this thread's share of each row's sum
  float acc[NT * 4];          // O: 64 x HDP a warpgroup, acc[4 n + e]
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    const bf16* Kt = Ks + (it & 1) * TILE;
    const bf16* Vt = Vs + (it & 1) * TILE;
    if (it + 1 < n_tiles) {  // the next tile loads while this one is multiplied
      load_tile<HDP>(Ks + ((it + 1) & 1) * TILE, kb, k_ss, k0 + BK, Sk, hd);
      load_tile<HDP>(Vs + ((it + 1) & 1) * TILE, vb, v_ss, k0 + BK, Sk, hd);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_proxy_async();  // cp.async's writes, visible to wgmma
    __syncthreads();

    // S = Q K^T: 64 x 64 a warpgroup, s[4 n + e] for keys 8 n + 2t (+1)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    tc::wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = (ks >> 2) * (64 * 64) + (ks & 3) * 16;  // panel, then 32 bytes a k-step
      tc::wgmma_ss_m64n64(s, tc::desc_sw128(Qs + off, 0, 1024),
                          tc::desc_sw128(Kt + off, 0, 1024), 1);
    }
    tc::wg_commit();
    tc::wg_wait_all();

    // scale (log2 domain), mask, online softmax on the fragments
    const bool need_mask = k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                           (window > 0 && k0 <= q0 + BQ - 1 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = i >> 2, e = i & 3;
      float x = s[i] * scale_log2;
      if (need_mask) {
        const int kp = k0 + n * 8 + 2 * t + (e & 1);
        const int qp = row0 + (e >> 1) * 8;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        if (!ok) x = -INFINITY;
      }
      s[i] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      // rows with no valid key yet keep m = -inf: guard exp2(-inf - -inf)
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = m_r[r] == -INFINITY ? 0.f : exp2f(m_r[r] - m_use[r]);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - m_use[(i & 3) >> 1]);  // masked: exp2(-inf) = 0
      s[i] = p;
      l_r[(i & 3) >> 1] += p;
    }
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) acc[i] *= alpha[(i & 3) >> 1];

    // O += P V: P's A fragments straight from S's accumulators, in bf16;
    // V's k-step of 16 keys is 16 rows on, its 64-column panels 8 KB apart
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* a = s + 8 * kk;
      pf[kk][0] = tc::pack(a[0], a[1]);
      pf[kk][1] = tc::pack(a[2], a[3]);
      pf[kk][2] = tc::pack(a[4], a[5]);
      pf[kk][3] = tc::pack(a[6], a[7]);
    }
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = tc::desc_sw128(Vt + kk * 16 * 64, 64 * 128, 1024);
      if constexpr (HDP == 128) tc::wgmma_rs_m64n128_tb(acc, pf[kk], dv);
      else tc::wgmma_rs_m64n64_tb(acc, pf[kk], dv);
    }
    tc::wg_commit();
    tc::wg_wait_all();
    __syncthreads();  // this stage is read: the next iteration may load over it
  }
  tc::cp_async_wait<0>();  // nothing left in flight (a q tile with no key tile)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + r * 8;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
    bf16* orow = o + (((int64_t)b * Sq + qp) * H + h) * hd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + 2 * t;  // hd is a multiple of 8: d < hd means d + 1 < hd
      if (d < hd)
        *reinterpret_cast<uint32_t*>(orow + d) =
            tc::pack(acc[n * 4 + 2 * r] * inv, acc[n * 4 + 2 * r + 1] * inv);
    }
  }
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int KV, int hd, const long long* st, int causal, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_tc_kernel<HDP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Sk, H, H / KV, hd, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q/k/v/o.  Strides are in elements, for the batch, sequence and head
// dims; the head_dim stride must be 1, hd a multiple of 8 and every stride a
// multiple of 8, each base 16-byte aligned.  window <= 0 means no window.
// The output o is contiguous (B, Sq, H, hd).  Returns a cudaError_t: 0 when
// the launch was accepted.
int flash_attention_tc_fwd(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                           int Sk, int H, int KV, int hd, long long q_sb, long long q_ss,
                           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh, int causal,
                           int window, float scale, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  bool aligned = hd % 8 == 0;
  for (long long s : st) aligned = aligned && s % 8 == 0;
  for (const void* p : {q, k, v, (const void*)o})
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || hd < 1 || hd > 128 || !aligned ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return (int)launch<64>(q, k, v, o, B, Sq, Sk, H, KV, hd, st, causal, window, scale, s);
  return (int)launch<128>(q, k, v, o, B, Sq, Sk, H, KV, hd, st, causal, window, scale, s);
}

const char* flash_attention_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
