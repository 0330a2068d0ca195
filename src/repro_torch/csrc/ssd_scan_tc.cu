// Mamba-2 SSD chunked scan for Hopper (sm_90a), bf16 x/B/C, on the tensor cores.
//
// Replaces src/repro/kernels/ssd.py::_ssd_kernel (the Pallas TPU kernel) for
// bf16 x, B and C, the dtype the serving path runs; f32 inputs go to the
// CUDA-core kernel in ssd_scan.cu (the wrapper's dtype rule, kernels/ssd.py).
// Same function: per chunk of Q steps
//   a_cum = cumsum(dt * A)                       (f32, sequential)
//   y     = (C B^T o L o dt_j) x                 L[i, j] = exp(a_i - a_j), i >= j; else 0
//   y    += (C S^T) o exp(a_cum)                 S: the (P, N) f32 state entering the chunk
//   S     = exp(a_tot) S + (w o x)^T B           w_j = exp(a_tot - a_j) dt_j
//   out   = (y + D x) in bf16
// and the final state (B, H, P, N) in f32.
//
// What bounds it: 2Q(QN + QP + 2NP) FLOPs per (batch, head, chunk) against a
// few bytes a row, so the tensor cores' rate at mamba2-130m's widths.  The
// CUDA-core kernel ran all four products as f32 FMAs from 199 KB of f32 tiles
// (one block an SM).  Here all four run as mma.sync.m16n8k16 with f32
// accumulators, from bf16 tiles in 89,088 bytes of shared memory, so two
// blocks fit on an SM and the main path's 192 (batch, head) blocks run in
// one wave on 132 SMs.  One block of 4 warps owns a (batch, head, P tile)
// and loops over the chunks:
//   - x, C and dt of a chunk are staged by cp.async (rows past Q zero-filled,
//     so chunks of 100 or 8 work; Q is padded to its multiple of 16);
//   - C S^T (Q x N x P): each warp owns two 16-row tiles of the chunk, rows
//     w and 7 - w, which balances the causal work of the next step;
//   - C B^T (Q x N x Q) by 16 x 16 blocks on and below the diagonal, masked
//     and scaled into M in registers, then y += M x (Q x Q x P) with M's A
//     fragments taken straight from the C B^T accumulators;
//   - the state update (P x Q x N): each warp owns 16 rows of S, held in
//     registers as the product's f32 accumulator for the whole sequence;
//     w is applied to x's fragments in registers;
//   - B's tile and the state's operand copy share one buffer: B is loaded
//     after C S^T has read the state, and the state is written back after
//     the update has read B.
//
// Operand rounding: x, B and C are bf16 already and go in exactly.  M, S and
// w o x are f32 intermediates; each is split into bf16 hi + lo (hi =
// bf16(v), lo = bf16(v - hi), about 2^-16 of v together) and multiplied
// twice.  Plain bf16 rounding of them (2^-9) was measured against the Pallas
// kernel by tests/test_torch_kernels_tc.py's emulation: y came out at 2.5 to
// 8 times the 2e-2 allowance at mamba width; with the split the worst share
// is about 0.37 (the f32 kernel's own bf16 output rounding: 0.34).
//
// Kept from the CUDA-core kernel: a_cum is a sequential f32 sum in one
// thread, product and sum rounded separately (a parallel scan moved f32 y by
// 1e-3), and exp(a_i - a_j) is taken only where i >= j.
//
// Chunk and tile: the chunk loop runs over tiles of Q <= 128 rows.  A
// longer chunk (jamba-1.5-large's 256) runs as chunk / Q sub-tiles (Q the
// largest divisor of the chunk up to 128, kernels/ssd.py::ssd_tile) with the
// state carried between them; keeping the 128-row tiles keeps the 89 KB of
// shared memory and two blocks an SM (256-row tiles would take over 170 KB,
// one block).  As in ssd_scan.cu, a_cum stays the chunk's single sequential
// sum, carried across its sub-tiles (a_base: the sum at the end of the
// previous sub-tile, 0 at a chunk's start); the inter-tile term is
// (C S^T) o exp(a_i - a_base) and the update S = exp(a_end - a_base) S + ...
// A pair across a sub-tile boundary then decays by exp(a_i - a_base)
// exp(a_base - a_j), the reference's exp(a_i - a_j) up to one rounding of
// each factor.
//
// Widths: the state's rows, y's columns and x's columns split into tiles of
// P_TILE = 64, one block each (y[:, p] and S[p, :] depend on their own p
// only; only C B^T is shared, and each P tile recomputes it), so any P runs,
// ceil(P / 64) blocks a (batch, head); a tile's 16 state rows a warp stay in
// registers as before.  N <= 128: the state's registers (st[16][4]) and C's
// fragments (cf[8][4]) grow with N, and an N of 256 would double them under
// the two blocks an SM; the wrapper's rule sends bf16 at N > 128 to the
// CUDA-core kernel (kernels/ssd.py::variant), which takes N up to 256.
//
// The wrapper sends here only input that cp.async can read 16 bytes at a
// time: P and N multiples of 8, strides multiples of 8 elements, 16-byte
// aligned bases (mamba2-130m: x a slice of the fused xBC activation, row
// stride 1792 elements); the rest goes to the CUDA-core kernel.  Not yet
// here (ROADMAP queue B): wgmma, TMA, overlap of a chunk's loads with the
// previous chunk's products inside a block, and chunk-parallel state passing
// (a batch of 1 gives only H = 24 blocks).
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; launched from repro_torch/kernels/ssd.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "tc_ops.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;  // 4 warps
constexpr int Q_MAX = 128;
constexpr int P_TILE = 64;  // the state rows (x and y columns) a block owns: 16 a warp
constexpr int N_MAX = 128;
constexpr int XLD = P_TILE + 8;  // row strides: +16 bytes, so ldmatrix's 8 rows hit 8 bank groups
constexpr int NLD = N_MAX + 8;
constexpr size_t SMEM_BYTES =
    (size_t)(Q_MAX * XLD + 2 * Q_MAX * NLD) * sizeof(bf16) + 2 * Q_MAX * sizeof(float);
static_assert(2 * P_TILE <= Q_MAX, "the state's hi and lo copies fit in B's tile");
static_assert(SMEM_BYTES <= 115712, "two blocks an SM");

// rows [row0, row0 + Q_MAX) into a [Q_MAX][LD] tile; rows >= nrows and
// 16-byte chunks at or past ncols are zero-filled.
template <int LD, int CH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t row_stride,
                                          int row0, int nrows, int ncols) {
  for (int idx = threadIdx.x; idx < Q_MAX * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < nrows && c * 8 < ncols;
    const bf16* p = ok ? src + (int64_t)(row0 + r) * row_stride + c * 8 : src;
    tc::cp_async16(dst + r * LD + c * 8, p, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 2) ssd_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const float* __restrict__ D,
    bf16* __restrict__ y, float* __restrict__ state_out, int S, int H, int P, int N, int chunk,
    int Q, int rep, int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb, int64_t dt_ss,
    int64_t dt_sh, int64_t b_sb, int64_t b_ss, int64_t b_sg, int64_t c_sb, int64_t c_ss,
    int64_t c_sg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [Q_MAX][XLD]
  bf16* cs = xs + Q_MAX * XLD;                     // [Q_MAX][NLD]
  bf16* bs = cs + Q_MAX * NLD;                     // [Q_MAX][NLD]: B, or the state's operand
  bf16* s_hi = bs;                                 //   [P_TILE][NLD] hi
  bf16* s_lo = bs + P_TILE * NLD;                  //   [P_TILE][NLD] lo
  float* s_dt = reinterpret_cast<float*>(bs + Q_MAX * NLD);  // [Q_MAX], 0 past Q
  float* s_a = s_dt + Q_MAX;  // [Q_MAX] a_cum (the chunk's sum at each row), a_tot past Q

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_pt = (P + P_TILE - 1) / P_TILE;
  const int h = blockIdx.x / n_pt, b = blockIdx.y;
  const int p0 = (blockIdx.x % n_pt) * P_TILE;
  const int Pt = min(P_TILE, P - p0);  // this block's columns of x and y, rows of S
  const float Ah = A[h], Dh = D[h];
  const bf16* xb = x + b * x_sb + h * x_sh + p0;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const bf16* bb = Bm + b * b_sb + (h / rep) * b_sg;
  const bf16* cb = Cm + b * c_sb + (h / rep) * c_sg;
  bf16* yb = y + ((int64_t)b * S * H + h) * P + p0;  // y is contiguous (B, S, H, P)
  const int64_t y_ss = (int64_t)H * P;
  const int n_mt = (Q + 15) / 16;  // 16-row tiles of the chunk in use
  const int mts[2] = {warp, 7 - warp};

  // this warp's 16 rows of the state, p = 16 warp + g (+8), n = 8 nt + 2t (+1)
  float st[N_MAX / 8][4];
#pragma unroll
  for (int n = 0; n < N_MAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = 0.f;

  float a_base = 0.f;  // a_cum at the end of the previous sub-tile of this chunk
  for (int s0 = 0; s0 < S; s0 += Q) {
    if (s0 % chunk == 0) a_base = 0.f;  // a chunk starts
    // 1. x, C and dt of the chunk (the last chunk's reads of x and C are done)
    load_rows<XLD, P_TILE / 8>(xs, xb + (int64_t)s0 * x_ss, x_ss, 0, Q, Pt);
    load_rows<NLD, N_MAX / 8>(cs, cb + (int64_t)s0 * c_ss, c_ss, 0, Q, N);
    tc::cp_async_commit();
    if (tid < Q_MAX) s_dt[tid] = tid < Q ? dtb[(int64_t)(s0 + tid) * dt_ss] : 0.f;
    tc::cp_async_wait<0>();
    __syncthreads();
    if (tid == 0) {
      // a_cum: a sequential f32 sum, product and sum rounded separately, as
      // the TPU kernel's elementwise product and cumsum round them.
      float run = a_base;
#pragma unroll 8
      for (int i = 0; i < Q; ++i) {
        run = __fadd_rn(run, __fmul_rn(s_dt[i], Ah));
        s_a[i] = run;
      }
      for (int i = Q; i < Q_MAX; ++i) s_a[i] = run;  // w = 0 there (dt = 0)
    }
    __syncthreads();
    const float a_tot = s_a[Q - 1];

    // 2. y = exp(a_i - a_base) (C S^T), the state entering the tile (none at the first)
    float yacc[2][P_TILE / 8][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int n = 0; n < P_TILE / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[u][n][e] = 0.f;
    if (s0 > 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int mt = mts[u];
        if (mt >= n_mt) continue;
#pragma unroll
        for (int ks = 0; ks < N_MAX / 16; ++ks) {
          uint32_t af[4];
          tc::ldsm_x4(cs + (mt * 16 + (lane & 15)) * NLD + ks * 16 + (lane >> 4) * 8, af);
#pragma unroll
          for (int np = 0; np < P_TILE / 16; ++np) {
            const int off = (np * 16 + (lane >> 4) * 8 + (lane & 7)) * NLD + ks * 16 +
                            ((lane >> 3) & 1) * 8;
            uint32_t hf[4], lf[4];
            tc::ldsm_x4(s_hi + off, hf);
            tc::ldsm_x4(s_lo + off, lf);
            tc::mma(yacc[u][2 * np], af, hf[0], hf[1]);
            tc::mma(yacc[u][2 * np + 1], af, hf[2], hf[3]);
            tc::mma(yacc[u][2 * np], af, lf[0], lf[1]);
            tc::mma(yacc[u][2 * np + 1], af, lf[2], lf[3]);
          }
        }
        const float e0 = expf(s_a[mt * 16 + g] - a_base);
        const float e1 = expf(s_a[mt * 16 + g + 8] - a_base);
#pragma unroll
        for (int n = 0; n < P_TILE / 8; ++n) {
          yacc[u][n][0] *= e0;
          yacc[u][n][1] *= e0;
          yacc[u][n][2] *= e1;
          yacc[u][n][3] *= e1;
        }
      }
    }
    __syncthreads();  // every read of the state's copy is done: B goes over it

    // 3. B of the chunk
    load_rows<NLD, N_MAX / 8>(bs, bb + (int64_t)s0 * b_ss, b_ss, 0, Q, N);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();

    // 4. y += M x, M = (C B^T) o L o dt_j by 16 x 16 blocks on and below the
    //    diagonal; then out = y + D x
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int mt = mts[u];
      if (mt >= n_mt) continue;
      uint32_t cf[N_MAX / 16][4];
#pragma unroll
      for (int ks = 0; ks < N_MAX / 16; ++ks)
        tc::ldsm_x4(cs + (mt * 16 + (lane & 15)) * NLD + ks * 16 + (lane >> 4) * 8, cf[ks]);
      const int i0 = mt * 16 + g, i1 = i0 + 8;
      const float a_i0 = s_a[i0], a_i1 = s_a[i1];
      for (int jt = 0; jt <= mt; ++jt) {
        float cbv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < N_MAX / 16; ++ks) {
          uint32_t bf[4];
          tc::ldsm_x4(bs + (jt * 16 + (lane >> 4) * 8 + (lane & 7)) * NLD + ks * 16 +
                          ((lane >> 3) & 1) * 8, bf);
          tc::mma(cbv[0], cf[ks], bf[0], bf[1]);
          tc::mma(cbv[1], cf[ks], bf[2], bf[3]);
        }
        float m[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = jt * 16 + n * 8 + 2 * t + (e & 1);
            const int i = (e >> 1) ? i1 : i0;
            const float a_i = (e >> 1) ? a_i1 : a_i0;
            // exp(a_i - a_j) only where i >= j: above the diagonal it can be inf
            m[n][e] = (j <= i && i < Q) ? cbv[n][e] * expf(a_i - s_a[j]) * s_dt[j] : 0.f;
          }
        }
        uint32_t mh[4], ml[4];
        tc::split(m[0][0], m[0][1], mh[0], ml[0]);
        tc::split(m[0][2], m[0][3], mh[1], ml[1]);
        tc::split(m[1][0], m[1][1], mh[2], ml[2]);
        tc::split(m[1][2], m[1][3], mh[3], ml[3]);
#pragma unroll
        for (int np = 0; np < P_TILE / 16; ++np) {
          uint32_t xf[4];
          tc::ldsm_x4_t(xs + (jt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * XLD + np * 16 +
                            (lane >> 4) * 8, xf);
          tc::mma(yacc[u][2 * np], mh, xf[0], xf[1]);
          tc::mma(yacc[u][2 * np + 1], mh, xf[2], xf[3]);
          tc::mma(yacc[u][2 * np], ml, xf[0], xf[1]);
          tc::mma(yacc[u][2 * np + 1], ml, xf[2], xf[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? i1 : i0;
        if (i >= Q) continue;
        bf16* row = yb + (int64_t)(s0 + i) * y_ss;
#pragma unroll
        for (int n = 0; n < P_TILE / 8; ++n) {
          const int p = n * 8 + 2 * t;  // Pt is a multiple of 8: p < Pt means p + 1 < Pt
          if (p >= Pt) continue;
          const float2 xv = tc::unpack(*reinterpret_cast<const uint32_t*>(xs + i * XLD + p));
          *reinterpret_cast<uint32_t*>(row + p) =
              tc::pack(yacc[u][n][2 * r] + xv.x * Dh, yacc[u][n][2 * r + 1] + xv.y * Dh);
        }
      }
    }

    // 5. S = exp(a_tot - a_base) S + (w o x)^T B; this warp's rows p = 16 warp + ...
    const float decay = expf(a_tot - a_base);
#pragma unroll
    for (int n = 0; n < N_MAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] *= decay;
    for (int ks = 0; ks < n_mt; ++ks) {
      uint32_t xf[4];  // A = x^T: rows p, k = j
      tc::ldsm_x4_t(xs + (ks * 16 + (lane >> 4) * 8 + (lane & 7)) * XLD + warp * 16 +
                        ((lane >> 3) & 1) * 8, xf);
      const int j0 = ks * 16 + 2 * t;
      const float w0 = expf(a_tot - s_a[j0]) * s_dt[j0];
      const float w1 = expf(a_tot - s_a[j0 + 1]) * s_dt[j0 + 1];
      const float w8 = expf(a_tot - s_a[j0 + 8]) * s_dt[j0 + 8];
      const float w9 = expf(a_tot - s_a[j0 + 9]) * s_dt[j0 + 9];
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // a0, a1: k = j0, j0 + 1; a2, a3: k = j0 + 8, j0 + 9
        const float2 v = tc::unpack(xf[r]);
        tc::split(v.x * (r < 2 ? w0 : w8), v.y * (r < 2 ? w1 : w9), ah[r], al[r]);
      }
#pragma unroll
      for (int np = 0; np < N_MAX / 16; ++np) {
        uint32_t bf[4];
        tc::ldsm_x4_t(bs + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * NLD + np * 16 +
                          (lane >> 4) * 8, bf);
        tc::mma(st[2 * np], ah, bf[0], bf[1]);
        tc::mma(st[2 * np + 1], ah, bf[2], bf[3]);
        tc::mma(st[2 * np], al, bf[0], bf[1]);
        tc::mma(st[2 * np + 1], al, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every read of B and x is done

    // 6. the state's operand copy for the next chunk's C S^T, hi and lo
#pragma unroll
    for (int n = 0; n < N_MAX / 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (warp * 16 + g + 8 * r) * NLD + n * 8 + 2 * t;
        uint32_t hi, lo;
        tc::split(st[n][2 * r], st[n][2 * r + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(s_hi + off) = hi;
        *reinterpret_cast<uint32_t*>(s_lo + off) = lo;
      }
    }
    a_base = a_tot;
  }

  float* so = state_out + (((int64_t)b * H + h) * P + p0) * N;
#pragma unroll
  for (int n = 0; n < N_MAX / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = warp * 16 + g + 8 * r, c = n * 8 + 2 * t;
      if (p < Pt && c < N)
        *reinterpret_cast<float2*>(so + (int64_t)p * N + c) =
            make_float2(st[n][2 * r], st[n][2 * r + 1]);
    }
  }
}

}  // namespace

extern "C" {

// bf16 x, B, C and y; dt, A, D and the state float32.  Strides are in
// elements, for the batch, sequence and head/group dims of x, dt, B and C
// (the last dim of x, B and C must have stride 1; A and D are contiguous).
// P and N must be multiples of 8, the strides of x, B and C multiples of 8,
// and x, B, C, y and the state 16-byte aligned.  y is a contiguous
// (B, S, H, P) and state a contiguous (B, H, P, N).  S must be a multiple of
// the chunk, and the chunk a multiple of the tile Q (1..128), the rows taken
// at a time.  N <= 128; any P, H * ceil(P / 64) <= 2^31 - 1.  Returns a
// cudaError_t: 0 when the launch was accepted.
int ssd_scan_tc_fwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                    const void* D, void* y, void* state, int B, int S, int H, int P, int G,
                    int N, int chunk, int Q, long long x_sb, long long x_ss, long long x_sh,
                    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
                    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
                    long long c_sg, void* stream) {
  bool aligned = P % 8 == 0 && N % 8 == 0;
  for (long long s : {x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg})
    aligned = aligned && s % 8 == 0;
  for (const void* p : {x, Bm, Cm, (const void*)y, (const void*)state})
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if (B < 1 || B > 65535 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 || N < 1 ||
      N > N_MAX || chunk < 1 || S % chunk != 0 || Q < 1 || Q > Q_MAX || chunk % Q != 0 ||
      !aligned || (long long)H * ((P + P_TILE - 1) / P_TILE) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H * ((P + P_TILE - 1) / P_TILE), B);
  ssd_tc_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<const float*>(D),
      static_cast<bf16*>(y), static_cast<float*>(state), S, H, P, N, chunk, Q, H / G, x_sb, x_ss,
      x_sh,
      dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg);
  return (int)cudaGetLastError();
}

const char* ssd_scan_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
