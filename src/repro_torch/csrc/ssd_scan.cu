// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd.py::_ssd_kernel (the Pallas TPU kernel)
// and computes what it computes, for x (B, S, H, P), dt (B, S, H) f32,
// A and D (H,) f32, B/C (B, S, G, N) with head h reading group h / (H / G):
// per chunk of Q steps
//   a_cum = cumsum(dt * A)                       (f32)
//   y     = (C B^T o L o dt_j) x                 L[i, j] = exp(a_i - a_j), i >= j; else 0
//   y    += (C S^T) o exp(a_cum)                 S: the (P, N) f32 state entering the chunk
//   S     = exp(a_tot) S + x^T (exp(a_tot - a_cum) dt B)
//   out   = (y + D x) in x's dtype
// and the final state (B, H, P, N) in f32.  x/B/C/out are f32 or bf16.
//
// Layout of the work: one block per (head, batch), which loops over the
// chunks itself; the TPU grid's sequential chunk axis and its VMEM state
// become that loop and a state tile in shared memory (blocks run in no
// order on Hopper, and nothing carries from one block to the next).  x, B
// and C are read through their (B, S, H|G, .) strides, so x may be a slice
// of the fused xBC activation and the Pallas wrapper's transposes are gone;
// B/C are read from their group without a per-head copy.
//
// Per chunk, 256 threads (16 x 16: ty picks rows, tx picks columns):
//   1. x, B, C, dt staged in shared memory as f32, rows past Q zeroed;
//      one thread takes the cumsum, in order (under 1 % of a chunk's time);
//   2. y_acc[i, p] = exp(a_i) * sum_n C[i, n] S[p, n]   (8 x 4 a thread, registers);
//   3. cb[i, j] = sum_n C[i, n] B[j, n] (8 x 8 a thread), masked and scaled
//      into M, which is written over C's tile (C is read by then);
//   4. y_acc += M x;
//   5. S = exp(a_tot) S + x^T (w B), each thread updating its 4 x 8 of S;
//   6. out = y_acc + D x, stored.
// exp(a_i - a_j) is taken only where i >= j: above the diagonal it can
// overflow to inf, and inf * 0 would be NaN.
//
// Shared memory: x 128 x 64, B and C/M 128 x 129, S 64 x 129 and three
// vectors of 128, all f32: 199,424 bytes, one block an SM.  Limits: tile
// Q <= 128, P <= 64, N <= 128 (mamba2-130m: 128, 64, 128).
//
// Chunk and tile: the loop below runs over tiles of Q rows.  A chunk longer
// than 128 (jamba-1.5-large's 256) runs as chunk / Q sub-tiles of Q rows
// (Q the largest divisor of the chunk up to 128, kernels/ssd.py::ssd_tile),
// the state carried between them; a 256-row tile would need 256 KB of
// shared memory here, past the 227 KB a block can have.  a_cum is still the
// chunk's: one sequential sum over the whole chunk, carried from sub-tile to
// sub-tile (a_base, the sum at the end of the previous sub-tile, 0 at a
// chunk's start), so every exp(a_i - a_j) inside a sub-tile is the one the
// reference takes.  A pair (i, j) across a sub-tile boundary reaches y
// through the state: exp(a_i - a_base) exp(a_base - a_j), the same decay up
// to one rounding of each factor.  So the inter-tile term is
// (C S^T) o exp(a_i - a_base) and the update S = exp(a_end - a_base) S + ...,
// with a_end the sum at the sub-tile's last row.  (Restarting the sum at each
// sub-tile is the same function in exact arithmetic, but its a_cum rounds
// apart from the reference's: at jamba's widths y moved by about 1e-3, past
// the f32 tolerance of 2e-4.)
//
// Bound: the work is 2Q(QN + QP + 2NP) FLOPs a (b, h, chunk) against a few
// bytes a row, so tensor-core FLOPs bound it at these widths.  This first
// version does every product as an f32 FMA on the CUDA cores from shared
// memory and runs far from that bound; its B*H blocks (192 at batch 8,
// 24 heads) fill 132 SMs in 1.5 waves.  wgmma, TMA and chunk-parallel
// state passing are left to a later version.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; launched from repro_torch/kernels/ssd.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int Q_MAX = 128;
constexpr int P_MAX = 64;
constexpr int N_MAX = 128;
constexpr int NS = N_MAX + 1;  // row stride of the B, C/M and S tiles (+1: no bank conflicts)
constexpr int SMEM_FLOATS = Q_MAX * P_MAX + 2 * Q_MAX * NS + P_MAX * NS + 3 * Q_MAX;
static_assert(Q_MAX <= N_MAX, "M (Q x Q) is written over C's tile (Q x N_MAX)");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    T* __restrict__ y, float* __restrict__ state_out, int S, int H, int P, int N, int chunk,
    int Q, int rep,
    int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
    int64_t b_sb, int64_t b_ss, int64_t b_sg, int64_t c_sb, int64_t c_ss, int64_t c_sg) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [Q_MAX][P_MAX]
  float* bs = xs + Q_MAX * P_MAX;   // [Q_MAX][NS]
  float* cm = bs + Q_MAX * NS;      // [Q_MAX][NS]: C, then M over it
  float* ss = cm + Q_MAX * NS;      // [P_MAX][NS]: the carried state
  float* s_dt = ss + P_MAX * NS;    // [Q_MAX]
  float* s_a = s_dt + Q_MAX;        // [Q_MAX] a_cum, the chunk's sum at each row of the tile
  float* s_w = s_a + Q_MAX;         // [Q_MAX] exp(a_tot - a_cum) * dt

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / rep;
  const float Ah = A[h];
  const float Dh = D[h];

  const T* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* bb = Bm + b * b_sb + g * b_sg;
  const T* cb = Cm + b * c_sb + g * c_sg;
  T* yb = y + ((int64_t)b * S * H + h) * P;  // y is contiguous (B, S, H, P)
  const int64_t y_ss = (int64_t)H * P;

  for (int idx = tid; idx < P_MAX * NS; idx += THREADS) ss[idx] = 0.f;

  float a_base = 0.f;  // a_cum at the end of the previous sub-tile of this chunk
  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the last tile's reads of every tile are done
    if (s0 % chunk == 0) a_base = 0.f;  // a chunk starts

    // 1. stage the chunk; rows past Q (and x's columns past P) are zero
    for (int idx = tid; idx < Q_MAX * P_MAX; idx += THREADS) {
      const int r = idx / P_MAX, c = idx % P_MAX;
      xs[idx] = (r < Q && c < P) ? to_float(xb[(int64_t)(s0 + r) * x_ss + c]) : 0.f;
    }
    for (int idx = tid; idx < Q_MAX * N_MAX; idx += THREADS) {
      const int r = idx / N_MAX, c = idx % N_MAX;
      if (c >= N) continue;
      const bool in = r < Q;
      bs[r * NS + c] = in ? to_float(bb[(int64_t)(s0 + r) * b_ss + c]) : 0.f;
      cm[r * NS + c] = in ? to_float(cb[(int64_t)(s0 + r) * c_ss + c]) : 0.f;
    }
    if (tid < Q) s_dt[tid] = dtb[(int64_t)(s0 + tid) * dt_ss];
    __syncthreads();

    if (tid == 0) {
      // a_cum: a sequential f32 sum, as the TPU kernel takes it.  Over 128
      // steps a_cum reaches about -100, where an f32 ulp is 8e-6, and
      // exp(a_i - a_j) carries that error into every term of y; a sum in
      // another order (a parallel scan) moves y by 1e-3 at f32.  The product
      // and the sum are rounded separately (no fused multiply-add), as an
      // elementwise product followed by a cumsum rounds them.
      float run = a_base;
      for (int i = 0; i < Q; ++i) {
        run = __fadd_rn(run, __fmul_rn(s_dt[i], Ah));
        s_a[i] = run;
      }
    }
    __syncthreads();
    const float a_tot = s_a[Q - 1];  // a_end: the sum at the tile's last row
    if (tid < Q) s_w[tid] = expf(a_tot - s_a[tid]) * s_dt[tid];

    // 2. inter-tile: acc[i, p] = exp(a_i - a_base) * sum_n C[i, n] S[p, n]
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 2
    for (int n = 0; n < N; ++n) {
      float cv[8], sv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) cv[r] = cm[(ty + 16 * r) * NS + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) sv[c] = ss[(tx + 16 * c) * NS + n];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      const float e = i < Q ? expf(s_a[i] - a_base) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= e;
    }

    // 3. intra-chunk scores cb[i, j] = C_i . B_j, then M = cb * L * dt_j
    float cbv[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) cbv[r][c] = 0.f;
#pragma unroll 2
    for (int n = 0; n < N; ++n) {
      float cv[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) cv[r] = cm[(ty + 16 * r) * NS + n];
#pragma unroll
      for (int c = 0; c < 8; ++c) bv[c] = bs[(tx + 16 * c) * NS + n];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) cbv[r][c] = fmaf(cv[r], bv[c], cbv[r][c]);
    }
    __syncthreads();  // every read of C is done: M goes over it
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = tx + 16 * c;
        float m = 0.f;
        if (i < Q && j <= i) m = cbv[r][c] * expf(s_a[i] - s_a[j]) * s_dt[j];
        cm[i * NS + j] = m;
      }
    }
    __syncthreads();

    // 4. intra-chunk output: acc[i, p] += sum_j M[i, j] x[j, p]
#pragma unroll 2
    for (int j = 0; j < Q; ++j) {
      float mv[8], xv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) mv[r] = cm[(ty + 16 * r) * NS + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = xs[j * P_MAX + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(mv[r], xv[c], acc[r][c]);
    }

    // 5. state: S[p, n] = exp(a_tot - a_base) S[p, n] + sum_j x[j, p] (w_j B[j, n]);
    //    this thread owns p = ty + 16 r, n = tx + 16 c (step 2's reads of S
    //    finished before the barriers above)
    float su[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) su[r][c] = 0.f;
#pragma unroll 2
    for (int j = 0; j < Q; ++j) {
      const float wj = s_w[j];
      float xv[4], bv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[j * P_MAX + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 8; ++c) bv[c] = bs[j * NS + tx + 16 * c] * wj;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) su[r][c] = fmaf(xv[r], bv[c], su[r][c]);
    }
    const float decay = expf(a_tot - a_base);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = tx + 16 * c;
        if (n < N) ss[p * NS + n] = ss[p * NS + n] * decay + su[r][c];
      }
    }

    // 6. out = y + D x, in x's dtype
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= Q) continue;
      T* row = yb + (int64_t)(s0 + i) * y_ss;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx + 16 * c;
        if (p < P) store_out(row + p, acc[r][c] + xs[i * P_MAX + p] * Dh);
      }
    }
    a_base = a_tot;
  }

  __syncthreads();
  float* so = state_out + ((int64_t)b * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += THREADS) so[idx] = ss[(idx / N) * NS + idx % N];
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* D, void* y, float* state, int B, int S, int H,
                   int P, int G, int N, int chunk, int Q, const long long* st,
                   cudaStream_t stream) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), D,
      static_cast<T*>(y), state, S, H, P, N, chunk, Q, H / G, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A, D and the state
// are float32.  Strides are in elements, for the batch, sequence and
// head/group dims of x, dt, B and C (the last dim of x, B and C must have
// stride 1; A and D are contiguous).  y is a contiguous (B, S, H, P) and
// state a contiguous (B, H, P, N).  S must be a multiple of the chunk, and
// the chunk a multiple of the tile Q (1..128), the rows taken at a time.
// Returns a cudaError_t: 0 when the launch was accepted.
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                 const void* D, void* y, void* state, int dtype, int B, int S, int H, int P, int G,
                 int N, int chunk, int Q, long long x_sb, long long x_ss, long long x_sh,
                 long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb, long long b_ss, long long b_sg,
                 long long c_sb, long long c_ss, long long c_sg, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 || P > P_MAX ||
      N < 1 || N > N_MAX || chunk < 1 || S % chunk != 0 || Q < 1 || Q > Q_MAX ||
      chunk % Q != 0)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                            b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* sf = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, dtf, Af, Bm, Cm, Df, y, sf, B, S, H, P, G, N, chunk, Q, st, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, y, sf, B, S, H, P, G, N, chunk, Q,
                                      st, s);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
