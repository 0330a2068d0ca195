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
// Layout of the work: one block per (head, P tile, batch), which loops over the
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
//   2. y_acc[i, p] = exp(a_i) * sum_n C[i, n] S[p, n]   (Q/16 x 4 a thread, registers);
//   3. cb[i, j] = sum_n C[i, n] B[j, n] (Q/16 x Q/16 a thread), masked and scaled
//      into M, which is written over C's tile (C is read by then);
//   4. y_acc += M x;
//   5. S = exp(a_tot) S + x^T (w B), each thread updating its 4 x 8 of S;
//   6. out = y_acc + D x, stored.
// exp(a_i - a_j) is taken only where i >= j: above the diagonal it can
// overflow to inf, and inf * 0 would be NaN.
//
// Widths: one block per (head, P tile, batch).  The state's rows, y's
// columns and x's columns split into tiles of P_TILE = 64 (y[:, p] and S[p, :]
// depend on their own p only; only C B^T is shared, and each P tile
// recomputes it), so any P runs, ceil(P / 64) blocks a (batch, head).  N
// picks one of two instances of the kernel: N <= 128 takes tiles of Q <= 128
// rows (x 128 x 64, B and C/M 128 x 129, S 64 x 129 and three vectors of 128,
// all f32: 199,424 bytes), 128 < N <= 256 takes tiles of Q <= 64 rows (x 64 x
// 64, B and C/M 64 x 257, S 64 x 257, three vectors of 64: 214,528 bytes; at
// Q = 128 B and C alone would take 263 KB, past the 227 KB a block can
// have).  One block an SM either way.  Limits: N <= 256; P any (the grid's
// x dim holds H * ceil(P / 64) blocks).
//
// Chunk and tile: the loop below runs over tiles of Q rows.  A chunk longer
// than 128 (jamba-1.5-large's 256) runs as chunk / Q sub-tiles of Q rows
// (Q the largest divisor of the chunk up to 128, kernels/ssd.py::ssd_tile),
// the state carried between them; a 256-row tile would need 256 KB of
// shared memory here, past the 227 KB a block can have.  At N > 128 the tile
// is at most 64 rows, and a chunk of 128 runs as two sub-tiles the same way.  a_cum is still the
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
constexpr int P_TILE = 64;  // the state rows (x and y columns) a block owns

// One instance of the kernel: tiles of at most QM rows, N at most NM.
template <int QM, int NM>
struct Widths {
  static constexpr int NS = NM + 1;  // row stride of the B, C/M and S tiles (+1: no bank conflicts)
  static constexpr int SMEM_FLOATS = QM * P_TILE + 2 * QM * NS + P_TILE * NS + 3 * QM;
  static_assert(QM <= NM, "M (Q x Q) is written over C's tile (Q x NM)");
  static_assert(QM % 16 == 0 && NM % 16 == 0, "16 x 16 threads tile the rows and columns");
};
constexpr int N_MAX = 256;  // Widths<128, 128> up to N 128 (the zoo's), Widths<64, 256> above

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int QM, int NM>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    T* __restrict__ y, float* __restrict__ state_out, int S, int H, int P, int N, int chunk,
    int Q, int rep,
    int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
    int64_t b_sb, int64_t b_ss, int64_t b_sg, int64_t c_sb, int64_t c_ss, int64_t c_sg) {
  constexpr int NS = Widths<QM, NM>::NS;
  constexpr int RM = QM / 16;  // rows of the tile (and columns of M) a thread takes
  constexpr int CN = NM / 16;  // columns of the state a thread takes
  extern __shared__ float smem[];
  float* xs = smem;                 // [QM][P_TILE]
  float* bs = xs + QM * P_TILE;     // [QM][NS]
  float* cm = bs + QM * NS;         // [QM][NS]: C, then M over it
  float* ss = cm + QM * NS;         // [P_TILE][NS]: the carried state, this block's rows
  float* s_dt = ss + P_TILE * NS;   // [QM]
  float* s_a = s_dt + QM;           // [QM] a_cum, the chunk's sum at each row of the tile
  float* s_w = s_a + QM;            // [QM] exp(a_tot - a_cum) * dt

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_pt = (P + P_TILE - 1) / P_TILE;
  const int h = blockIdx.x / n_pt;
  const int p0 = (blockIdx.x % n_pt) * P_TILE;
  const int Pt = min(P_TILE, P - p0);  // this block's columns of x and y, rows of S
  const int b = blockIdx.y;
  const int g = h / rep;
  const float Ah = A[h];
  const float Dh = D[h];

  const T* xb = x + b * x_sb + h * x_sh + p0;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* bb = Bm + b * b_sb + g * b_sg;
  const T* cb = Cm + b * c_sb + g * c_sg;
  T* yb = y + ((int64_t)b * S * H + h) * P + p0;  // y is contiguous (B, S, H, P)
  const int64_t y_ss = (int64_t)H * P;

  for (int idx = tid; idx < P_TILE * NS; idx += THREADS) ss[idx] = 0.f;

  float a_base = 0.f;  // a_cum at the end of the previous sub-tile of this chunk
  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the last tile's reads of every tile are done
    if (s0 % chunk == 0) a_base = 0.f;  // a chunk starts

    // 1. stage the chunk; rows past Q (and x's columns past Pt) are zero
    for (int idx = tid; idx < QM * P_TILE; idx += THREADS) {
      const int r = idx / P_TILE, c = idx % P_TILE;
      xs[idx] = (r < Q && c < Pt) ? to_float(xb[(int64_t)(s0 + r) * x_ss + c]) : 0.f;
    }
    for (int idx = tid; idx < QM * NM; idx += THREADS) {
      const int r = idx / NM, c = idx % NM;
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
    float acc[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 2
    for (int n = 0; n < N; ++n) {
      float cv[RM], sv[4];
#pragma unroll
      for (int r = 0; r < RM; ++r) cv[r] = cm[(ty + 16 * r) * NS + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) sv[c] = ss[(tx + 16 * c) * NS + n];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = ty + 16 * r;
      const float e = i < Q ? expf(s_a[i] - a_base) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= e;
    }

    // 3. intra-chunk scores cb[i, j] = C_i . B_j, then M = cb * L * dt_j
    float cbv[RM][RM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RM; ++c) cbv[r][c] = 0.f;
#pragma unroll 2
    for (int n = 0; n < N; ++n) {
      float cv[RM], bv[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) cv[r] = cm[(ty + 16 * r) * NS + n];
#pragma unroll
      for (int c = 0; c < RM; ++c) bv[c] = bs[(tx + 16 * c) * NS + n];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RM; ++c) cbv[r][c] = fmaf(cv[r], bv[c], cbv[r][c]);
    }
    __syncthreads();  // every read of C is done: M goes over it
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < RM; ++c) {
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
      float mv[RM], xv[4];
#pragma unroll
      for (int r = 0; r < RM; ++r) mv[r] = cm[(ty + 16 * r) * NS + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = xs[j * P_TILE + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(mv[r], xv[c], acc[r][c]);
    }

    // 5. state: S[p, n] = exp(a_tot - a_base) S[p, n] + sum_j x[j, p] (w_j B[j, n]);
    //    this thread owns p = ty + 16 r, n = tx + 16 c (step 2's reads of S
    //    finished before the barriers above)
    float su[4][CN];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) su[r][c] = 0.f;
#pragma unroll 2
    for (int j = 0; j < Q; ++j) {
      const float wj = s_w[j];
      float xv[4], bv[CN];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[j * P_TILE + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < CN; ++c) bv[c] = bs[j * NS + tx + 16 * c] * wj;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CN; ++c) su[r][c] = fmaf(xv[r], bv[c], su[r][c]);
    }
    const float decay = expf(a_tot - a_base);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int n = tx + 16 * c;
        if (n < N) ss[p * NS + n] = ss[p * NS + n] * decay + su[r][c];
      }
    }

    // 6. out = y + D x, in x's dtype
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = ty + 16 * r;
      if (i >= Q) continue;
      T* row = yb + (int64_t)(s0 + i) * y_ss;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx + 16 * c;
        if (p < Pt) store_out(row + p, acc[r][c] + xs[i * P_TILE + p] * Dh);
      }
    }
    a_base = a_tot;
  }

  __syncthreads();
  float* so = state_out + (((int64_t)b * H + h) * P + p0) * N;
  for (int idx = tid; idx < Pt * N; idx += THREADS) so[idx] = ss[(idx / N) * NS + idx % N];
}

template <typename T, int QM, int NM>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* D, void* y, float* state, int B, int S, int H,
                   int P, int G, int N, int chunk, int Q, const long long* st,
                   cudaStream_t stream) {
  const size_t smem = Widths<QM, NM>::SMEM_FLOATS * sizeof(float);
  auto* kernel = ssd_scan_kernel<T, QM, NM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H * ((P + P_TILE - 1) / P_TILE), B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), D,
      static_cast<T*>(y), state, S, H, P, N, chunk, Q, H / G, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

// The instance N picks: tiles of Q <= 128 up to N 128, of Q <= 64 above.
template <typename T>
cudaError_t launch_for_width(const void* x, const float* dt, const float* A, const void* Bm,
                             const void* Cm, const float* D, void* y, float* state, int B,
                             int S, int H, int P, int G, int N, int chunk, int Q,
                             const long long* st, cudaStream_t stream) {
  if (N <= 128)
    return launch<T, 128, 128>(x, dt, A, Bm, Cm, D, y, state, B, S, H, P, G, N, chunk, Q, st,
                               stream);
  if (Q > 64) return cudaErrorInvalidValue;
  return launch<T, 64, 256>(x, dt, A, Bm, Cm, D, y, state, B, S, H, P, G, N, chunk, Q, st,
                            stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A, D and the state
// are float32.  Strides are in elements, for the batch, sequence and
// head/group dims of x, dt, B and C (the last dim of x, B and C must have
// stride 1; A and D are contiguous).  y is a contiguous (B, S, H, P) and
// state a contiguous (B, H, P, N).  S must be a multiple of the chunk, and
// the chunk a multiple of the tile Q, the rows taken at a time (1..128 at
// N <= 128, 1..64 at 128 < N <= 256).  Any P; H * ceil(P / 64) <= 2^31 - 1.
// Returns a cudaError_t: 0 when the launch was accepted.
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                 const void* D, void* y, void* state, int dtype, int B, int S, int H, int P, int G,
                 int N, int chunk, int Q, long long x_sb, long long x_ss, long long x_sh,
                 long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb, long long b_ss, long long b_sg,
                 long long c_sb, long long c_ss, long long c_sg, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 || N < 1 ||
      N > N_MAX || chunk < 1 || S % chunk != 0 || Q < 1 || Q > 128 || chunk % Q != 0 ||
      (long long)H * ((P + P_TILE - 1) / P_TILE) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                            b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* sf = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_for_width<float>(x, dtf, Af, Bm, Cm, Df, y, sf, B, S, H, P, G, N, chunk, Q,
                                        st, s);
  if (dtype == 1)
    return (int)launch_for_width<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, y, sf, B, S, H, P, G, N,
                                                chunk, Q, st, s);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
