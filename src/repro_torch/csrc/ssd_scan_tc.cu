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
// What bounds it: 2Q(QN + QP + 2NP) FLOPs per (batch, head, tile of Q rows)
// against a few bytes a row, so the tensor cores' rate at mamba2-130m's and
// jamba's widths.  The TPU kernel walks a head's chunks in order (its chunk
// grid axis is sequential), and so did this kernel's first form: one block a
// (batch, head, P tile) ran a tile's loads, products and state update in
// series, with five barriers a tile, at 7-9 % of its SM's tensor-core rate.
// Only the state update is sequential along the sequence; the design keeps
// every other step off that chain:
//   - The unit of work is one (batch, head, P tile, tile of Q rows).  A
//     unit first computes its own contribution to the state, U = (w o x)^T
//     B from zero (it needs no earlier state), then waits for the state
//     S_{t-1} its predecessor tile (same batch, head and P tile) handed on,
//     computes S_t = exp(a_end - a_base) S_{t-1} + U in f32 and hands S_t
//     on.  Only after that, off the chain, come C B^T, the masked and scaled
//     M, y0 = M x and y = y0 + exp(a_i - a_base) (C S_{t-1}^T) + D x,
//     rounded to bf16 once.  A link of the chain is a read of the (64, N)
//     f32 state from L2, an FMA a value and a write, early in each unit.
//   - The hand-off: a ring slot of 32 KB a chain in global memory (it stays
//     in the 50 MB L2) and one monotonic flag a chain and warpgroup half;
//     the writer's stores, a barrier over its warpgroup, then one thread's
//     gpu-scope fence and flag store; the reader spins on an acquire load of
//     the flag and reads the state with ld.global.cg (L1 is not coherent
//     across SMs).  The last tile writes state_out instead.  A spin that
//     outlasts any real wait traps, so a lost hand-off ends the launch with
//     an error instead of hanging the card.
//   - Order: persistent blocks, one an SM, claim units from an atomic ticket
//     in tile-major order (tile, then batch, head, P tile), so a unit's
//     predecessor always holds a smaller ticket, claimed earlier by a
//     running block or earlier in this block's own queue; a block runs its
//     units in ticket order, and claims one only once a stage is free (a
//     deeper queue makes a rank's 128 chains on 132 SMs wait on each
//     other).  The chain cannot deadlock however blocks are scheduled.  The
//     wrapper zeroes the flags and the ticket every call.
//   - Warp specialisation and TMA.  A producer warp claims a unit, loads its
//     x (one 64-column box of the P tile), C and B (two boxes each) with
//     4-D TMA tensor maps over (cols, heads, sequence, batch), 128 rows
//     each, in the 128-byte swizzle wgmma reads, into a ring of two stages
//     on full / empty mbarriers; then it computes a_cum (one lane's
//     sequential sum, the chunk's rows before this tile included), w, the
//     decays and exp(a_i - a_base) while the loads fly.  Two consumer
//     warpgroups each own 64 rows of the tile (warps 0-7, so each starts at
//     a warp index divisible by 4, as wgmma asks); one block of 288 threads
//     an SM.
//   - Registers.  Nine warps put three on one of the SM's four
//     sub-partitions, so ptxas gives a thread 168 registers; at 384 threads
//     with setmaxnreg 232 for the consumers it spilled more, not less, and
//     ran the products serialised (C7512).  So the operands are built in
//     pieces: U's A fragments in two halves of j, M and M x in 64-column
//     blocks, each waited on before the next is built, with the thread's
//     index made opaque once a unit so the compiler does not hoist shared
//     memory addresses out of the loop into registers.
//   - The four products on wgmma.  U: m 64 = the P tile, A = (w o x)^T
//     from registers (ldmatrix.trans of x, scaled, hi and lo), B = B
//     MN-major, N split between the warpgroups, each of which owns its half
//     of the state's columns along the chain; the predecessor's flag is
//     awaited under its second half.  C B^T: A = C, B = B, both K-major
//     from shared memory, in 64-column blocks of j at n 64: warpgroup 0 its
//     diagonal block (issued under U's first half), warpgroup 1 the block
//     below it and its diagonal block (the causal upper block is skipped).
//     M x: A = M from registers (hi and lo), B = x MN-major, after each
//     block.  C S^T: A = C, B = S_{t-1} hi and lo, which each warpgroup
//     writes for its half into shared memory from the f32 state it read;
//     named barriers hand that buffer between the two.
//   What bounds it as built (clock64 stamps a step on the card): the
//   consumers' instructions, not the tensor cores, which are busy about a
//   quarter of a unit: the hi / lo splits, the exponentials of M and the
//   address arithmetic of two warpgroups that meet at two barriers a unit.
//
// Operand rounding: x, B and C are bf16 already and go in exactly.  M, S and
// w o x are f32 intermediates; each is split into bf16 hi + lo (hi =
// bf16(v), lo = bf16(v - hi), about 2^-16 of v together) and multiplied
// twice.  Plain bf16 rounding of them (2^-9) was measured against the Pallas
// kernel by tests/test_torch_kernels_tc.py's emulation: y came out at 2.5 to
// 8 times the 2e-2 allowance at mamba width.
//
// Kept from the CUDA-core kernel: a_cum is a sequential f32 sum in one
// thread, product and sum rounded separately (a parallel scan moved f32 y by
// 1e-3), and exp(a_i - a_j) is taken only where i >= j.
//
// Chunk and tile: units are tiles of Q <= 128 rows.  A longer chunk
// (jamba-1.5-large's 256) runs as chunk / Q sub-tiles (Q the largest
// divisor of the chunk up to 128, kernels/ssd.py::ssd_tile) with the state
// handed on between them; a_cum stays the chunk's single sequential sum,
// carried across its sub-tiles (a_base: the sum at the end of the previous
// sub-tile, 0 at a chunk's start).  The TMA boxes are 128 rows whatever Q
// is: rows past Q are the next chunk's real rows (or zeros past S), and
// reach nothing: dt is 0 there (w = 0) and M is masked by i < Q.
//
// Widths: the state's rows, y's columns and x's columns split into P tiles
// of 64 (y[:, p] and S[p, :] depend on their own p only; each P tile
// recomputes C B^T), so any P runs; TMA's zero fill covers the ragged tile
// and columns past N.  N <= 128: two 64-column boxes of B and C a stage; the
// wrapper's rule sends bf16 at N > 128 to the CUDA-core kernel
// (kernels/ssd.py::variant), which takes N up to 256.  Shared memory: 197 KB.
//
// The wrapper sends here only input that TMA can read: P and N multiples of
// 8, strides multiples of 8 elements, 16-byte aligned bases (mamba2-130m: x
// a slice of the fused xBC activation, row stride 1792 elements); the rest
// goes to the CUDA-core kernel.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; launched from repro_torch/kernels/ssd.py.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "tc_ops.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 128;               // rows a tile's boxes hold; Q <= ROWS of them are used
constexpr int P_TILE = 64;              // the state rows (x and y columns) a unit owns
constexpr int N_MAX = 128;
constexpr int STAGES = 2;               // the ring of loaded units
constexpr int THREADS = 288;            // two consumer warpgroups (warps 0-7) + a producer warp
constexpr int PANEL = ROWS * 64;        // elements of one 64-column box of 128 rows
constexpr int SPANEL = P_TILE * 64;     // one 64-column panel of the state's operand
constexpr int STAGE = 5 * PANEL;        // x, C (two panels), B (two panels)
constexpr uint32_t STAGE_TX = STAGE * 2;
constexpr int BAR_SHALF = 1;            // both halves of the state's operand written
constexpr int BAR_FREE = 2;             // 2, 3: warpgroup c has read the operand (C S^T done)
constexpr int BAR_WG = 4;               // 4, 5: a consumer warpgroup's own barrier
constexpr int SPIN_LIMIT = 1 << 24;     // polls of a flag before the kernel traps

struct Unit {
  int t, ch, b, h, pt;  // tile, chain, batch, head, P tile
};

// What the producer computes for a unit beside the loads.
struct Aux {
  float a[ROWS];    // a_cum at each row (the chunk's sum); a_end past Q
  float dt[ROWS];   // 0 past Q
  float w[ROWS];    // exp(a_end - a_j) dt_j
  float e[ROWS];    // exp(a_i - a_base)
  float decay;      // exp(a_end - a_base)
  float Dh;         // D of the unit's head
  int unit;         // the ticket, or -1: no more units
  Unit pos;         // its tile, chain, batch, head and P tile
};

struct Bars {
  uint64_t full[STAGES], empty[STAGES];
};

constexpr size_t SMEM_BYTES =
    (size_t)(STAGES * STAGE + 4 * SPANEL) * sizeof(bf16) + STAGES * sizeof(Aux) + sizeof(Bars) +
    1024;  // room to align the start to 1024 bytes (the swizzle is a function of the address)

// Clock stamps at each step of block 0's first 64 units, for the probe's
// step profile (python -m repro_torch.kernels.probe ssd --steps); compiled
// only with -DSSD_STEP_CLOCKS.  who: consumer 0 or 1, or 2 the producer.
#ifdef SSD_STEP_CLOCKS
__device__ long long ssd_step_clocks[3][64][8];
#define STEP(who, k, n, first) \
  if (blockIdx.x == 0 && (first) && (k) < 64) ssd_step_clocks[who][k][n] = clock64()
#else
#define STEP(who, k, n, first)
#endif

__device__ __forceinline__ Unit unit_of(int u, int n_chains, int H, int n_pt) {
  Unit w;
  w.t = u / n_chains;
  w.ch = u - w.t * n_chains;
  w.pt = w.ch % n_pt;
  const int bh = w.ch / n_pt;
  w.h = bh % H;
  w.b = bh / H;
  return w;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

struct Args {
  const float* dt;
  const float* A;
  const float* D;
  bf16* y;
  float* state_out;
  float* ring;  // (chain, half, 8, 128 threads, 4) f32: the state handed on
  int* flags;   // (chain, half) published tiles; the ticket after them
  int S, H, P, N, chunk, Q, rep, n_pt, n_chains, T, total;
  int64_t dt_sb, dt_ss, dt_sh;
};

// Consumer warpgroup C: rows 64 C .. 64 C + 63 of each unit's tile, and
// columns 64 C .. 64 C + 63 of its state.
template <int C>
__device__ __forceinline__ void consume(const Args& a, bf16* stages, bf16* s_op, Aux* aux,
                                        Bars& bar) {
  constexpr int r0 = 64 * C;  // the warpgroup's first row of the tile
  bf16* s_hi = s_op;
  bf16* s_lo = s_op + 2 * SPANEL;
  tc::bar_arrive(BAR_FREE + C, 256);  // the operand buffer starts free

  for (int k = 0;; ++k) {
    // the thread's index, opaque to the compiler once a unit: the shared
    // memory addresses derived from it are recomputed in the loop, not
    // hoisted out of it into registers the products need
    int tid = threadIdx.x - 128 * C;
    asm volatile("" : "+r"(tid));
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int i0 = r0 + warp * 16 + g;  // this thread's rows: i0 and i0 + 8
    const int s = k % STAGES;
    tc::mbar_wait(&bar.full[s], (k / STAGES) & 1);
    const Aux& ax = aux[s];
    if (ax.unit < 0) break;
    STEP(C, k, 0, tid == 0);
    const Unit w = ax.pos;
    const bf16* X = stages + s * STAGE;
    const bf16* Cs = X + PANEL;
    const bf16* Bs = X + 3 * PANEL;
    const int s0 = w.t * a.Q, p0 = w.pt * P_TILE, Pt = min(P_TILE, a.P - p0);
    const int fl = w.ch * 2 + C;
    // the predecessor's flag: once it reaches w.t, S_{t-1} is in the ring
    auto flag_wait = [&]() {
      if (w.t == 0) return;
      if (tid == 0) {
        int spins = 0;
        while (ld_acquire(a.flags + fl) < w.t) {
          __nanosleep(32);
          if (++spins > SPIN_LIMIT) __trap();
        }
      }
      __syncwarp();
      tc::bar_sync(BAR_WG + C, 128);
    };

    // 1. U = (w o x)^T B[:, 64 C ..] from zero, its A fragments (ldmatrix.trans
    //    of x, scaled, as bf16 hi + lo) built in two halves of j, each half's
    //    product waited on before the next is built; the first half under
    //    warpgroup 0's C B^T
    constexpr int NB = C + 1;  // blocks of 64 columns j: below the diagonal (C = 1), diagonal
    auto cbt = [&](float (&cb)[32], int h) {  // C B^T of block h, issued and committed
#pragma unroll
      for (int i = 0; i < 32; ++i) cb[i] = 0.f;
      tc::fence_regs(cb);
      tc::wg_fence();
#pragma unroll
      for (int ks = 0; ks < N_MAX / 16; ++ks) {
        const int off = (ks >> 2) * PANEL + (ks & 3) * 16;
        tc::wgmma_ss(cb, tc::desc_sw128(Cs + r0 * 64 + off, 0, 1024),
                     tc::desc_sw128(Bs + h * 64 * 64 + off, 0, 1024), ks > 0);
      }
      tc::wg_commit();
    };
    float cb0[32], cb1[32];
    if constexpr (NB == 1) cbt(cb0, 0);
    float u[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) u[i] = 0.f;
    tc::fence_regs(u);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t uh[ROWS / 32][4], ul[ROWS / 32][4];
#pragma unroll
      for (int q = 0; q < ROWS / 32; ++q) {
        const int kk = half * (ROWS / 32) + q;
        const int j = kk * 16 + (lane >> 4) * 8 + (lane & 7);  // this lane's row address
        const int c16 = warp * 2 + ((lane >> 3) & 1);          // its 16-byte chunk of p
        uint32_t xf[4];
        tc::ldsm_x4_t(X + j * 64 + ((c16 ^ (j & 7)) * 8), xf);
        const int j0 = kk * 16 + 2 * t4;
        const float2 wa = *reinterpret_cast<const float2*>(ax.w + j0);
        const float2 wb = *reinterpret_cast<const float2*>(ax.w + j0 + 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // a0, a1: k = j0, j0 + 1; a2, a3: k = j0 + 8, j0 + 9
          const float2 v = tc::unpack(xf[r]);
          const float2 wv = r < 2 ? wa : wb;
          tc::split(v.x * wv.x, v.y * wv.y, uh[q][r], ul[q][r]);
        }
      }
      tc::wg_fence();
#pragma unroll
      for (int q = 0; q < ROWS / 32; ++q) {
        const int kk = half * (ROWS / 32) + q;
        const uint64_t db = tc::desc_sw128(Bs + C * PANEL + kk * 16 * 64, PANEL * 2, 1024);
        tc::wgmma_rs_tb(u, uh[q], db);
        tc::wgmma_rs_tb(u, ul[q], db);
      }
      tc::wg_commit();
      if (half == 1) flag_wait();  // the predecessor's flag, under U
      tc::wg_wait<0>();
    }
    tc::fence_regs(u);

    STEP(C, k, 1, tid == 0);

    // 2. S_t = decay S_{t-1} + U, handed on (or the final state); S_{t-1}
    //    (zero at the first tile) read from L2 past L1, rows p = 16 warp + g
    //    (+8), columns 64 C + 8 nt + 2 t4 (+1)
    float sp[32];
    if (w.t > 0) {
      const float4* src = reinterpret_cast<const float4*>(a.ring) + (size_t)fl * 8 * 128 + tid;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 v = __ldcg(src + r * 128);
        sp[4 * r] = v.x;
        sp[4 * r + 1] = v.y;
        sp[4 * r + 2] = v.z;
        sp[4 * r + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sp[i] = 0.f;
    }
    const float decay = ax.decay;
#pragma unroll
    for (int i = 0; i < 32; ++i) u[i] = decay * sp[i] + u[i];
    if (w.t + 1 < a.T) {
      float4* dst = reinterpret_cast<float4*>(a.ring) + (size_t)fl * 8 * 128 + tid;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        __stcg(dst + r * 128, make_float4(u[4 * r], u[4 * r + 1], u[4 * r + 2], u[4 * r + 3]));
      tc::bar_sync(BAR_WG + C, 128);  // every thread's stores are issued
      if (tid == 0) {
        __threadfence();
        st_relaxed(a.flags + fl, w.t + 1);
      }
    } else {
      float* so = a.state_out + (((int64_t)w.b * a.H + w.h) * a.P + p0) * a.N;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = warp * 16 + g + 8 * r, n = 64 * C + nt * 8 + 2 * t4;
          if (p < Pt && n < a.N)  // N is a multiple of 8: n < N means n + 1 < N
            *reinterpret_cast<float2*>(so + (int64_t)p * a.N + n) =
                make_float2(u[4 * nt + 2 * r], u[4 * nt + 2 * r + 1]);
        }
      }
    }

    STEP(C, k, 2, tid == 0);

    // 3. S_{t-1} in bf16 hi + lo into shared memory for C S^T, this
    //    warpgroup's half, once the other's last C S^T has read the buffer
    if (w.t > 0) {
      tc::bar_sync(BAR_FREE + 1 - C, 256);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = warp * 16 + g + 8 * r;  // p % 8 == g
          const int off = C * SPANEL + p * 64 + ((nt ^ g) * 8) + 2 * t4;
          uint32_t hi, lo;
          tc::split(sp[4 * nt + 2 * r], sp[4 * nt + 2 * r + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_hi + off) = hi;
          *reinterpret_cast<uint32_t*>(s_lo + off) = lo;
        }
      }
      tc::fence_proxy_async();  // the stores above, visible to wgmma
    }

    STEP(C, k, 3, tid == 0);

    // 4. y0 = M x by blocks, M = (C B^T) o L o dt_j as the A fragments of
    //    M x (hi and lo), exp(a_i - a_j) only where j <= i (above the
    //    diagonal it can be inf: the select drops it)
    const float a_i0 = ax.a[i0], a_i1 = ax.a[i0 + 8];
    auto build_m = [&](const float (&cb)[32], uint32_t (&mh)[4][4], uint32_t (&ml)[4][4],
                       auto diag) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // a0 (g, 2 t4), a1 (g + 8, ..), a2 (g, 2 t4 + 8), a3
          const int nt = 2 * kk + (q >> 1), r = q & 1;
          const int i = i0 + 8 * r, j = (decltype(diag)::value ? r0 : 0) + nt * 8 + 2 * t4;
          const float a_i = r ? a_i1 : a_i0;
          const bool row_ok = i < a.Q;
          const bool ok0 = row_ok && (!decltype(diag)::value || j <= i);
          const bool ok1 = row_ok && (!decltype(diag)::value || j + 1 <= i);
          const float2 aj = *reinterpret_cast<const float2*>(ax.a + j);
          const float2 dj = *reinterpret_cast<const float2*>(ax.dt + j);
          const float m0 = cb[4 * nt + 2 * r] * __expf(a_i - aj.x) * dj.x;
          const float m1 = cb[4 * nt + 2 * r + 1] * __expf(a_i - aj.y) * dj.y;
          tc::split(ok0 ? m0 : 0.f, ok1 ? m1 : 0.f, mh[kk][q], ml[kk][q]);
        }
      }
    };
    auto mx = [&](float (&y)[32], const uint32_t (&mh)[4][4], const uint32_t (&ml)[4][4],
                  int h) {  // y += M x over block h's rows j, issued and committed
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = tc::desc_sw128(X + (h * 64 + kk * 16) * 64, PANEL * 2, 1024);
        tc::wgmma_rs_tb(y, mh[kk], db);
        tc::wgmma_rs_tb(y, ml[kk], db);
      }
      tc::wg_commit();
    };
    float y[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = 0.f;
    tc::fence_regs(y);
    if constexpr (NB == 1) {
      uint32_t mh[4][4], ml[4][4];
      tc::fence_regs(cb0);
      build_m(cb0, mh, ml, std::true_type());
      mx(y, mh, ml, 0);
      tc::wg_wait<0>();
    } else {
      uint32_t mh0[4][4], ml0[4][4], mh1[4][4], ml1[4][4];
      cbt(cb0, 0);
      tc::wg_wait<0>();
      tc::fence_regs(cb0);
      build_m(cb0, mh0, ml0, std::false_type());
      mx(y, mh0, ml0, 0);
      cbt(cb1, 1);
      tc::wg_wait<0>();  // block 0's M x and block 1's C B^T
      tc::fence_regs(cb1);
      build_m(cb1, mh1, ml1, std::true_type());
      mx(y, mh1, ml1, 1);
      tc::wg_wait<0>();
    }
    tc::fence_regs(y);

    STEP(C, k, 4, tid == 0);

    // 5. y += exp(a_i - a_base) (C S_{t-1}^T) with both halves of the operand
    if (w.t > 0) {
      tc::bar_sync(BAR_SHALF, 256);
      float ycs[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) ycs[i] = 0.f;
      tc::fence_regs(ycs);
      tc::wg_fence();
#pragma unroll
      for (int ks = 0; ks < N_MAX / 16; ++ks) {
        const int off = (ks >> 2) * SPANEL + (ks & 3) * 16;
        const uint64_t da =
            tc::desc_sw128(Cs + r0 * 64 + (ks >> 2) * PANEL + (ks & 3) * 16, 0, 1024);
        tc::wgmma_ss(ycs, da, tc::desc_sw128(s_hi + off, 0, 1024), ks > 0);
        tc::wgmma_ss(ycs, da, tc::desc_sw128(s_lo + off, 0, 1024), 1);
      }
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs(ycs);
      tc::bar_arrive(BAR_FREE + C, 256);
      const float e0 = ax.e[i0], e1 = ax.e[i0 + 8];
#pragma unroll
      for (int i = 0; i < 32; ++i) y[i] += ((i & 3) >> 1 ? e1 : e0) * ycs[i];
    }

    STEP(C, k, 5, tid == 0);

    // 6. out = y + D x in bf16, rows < Q and columns < Pt
    const float Dh = ax.Dh;
    const int64_t y_ss = (int64_t)a.H * a.P;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;  // i % 8 == g
      if (i >= a.Q) continue;
      bf16* row = a.y + ((int64_t)w.b * a.S + s0 + i) * y_ss + (int64_t)w.h * a.P + p0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = nt * 8 + 2 * t4;  // Pt is a multiple of 8: p < Pt means p + 1 < Pt
        if (p >= Pt) continue;
        const float2 xv =
            tc::unpack(*reinterpret_cast<const uint32_t*>(X + i * 64 + ((nt ^ g) * 8) + 2 * t4));
        *reinterpret_cast<uint32_t*>(row + p) =
            tc::pack(y[4 * nt + 2 * r] + xv.x * Dh, y[4 * nt + 2 * r + 1] + xv.y * Dh);
      }
    }
    STEP(C, k, 6, tid == 0);
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(&bar.empty[s]);  // this warp is done with the stage
  }
}

__global__ void __launch_bounds__(THREADS, 1) ssd_tc_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tcm, const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023;
  bf16* stages = reinterpret_cast<bf16*>(smem_raw + pad);  // [STAGES][x, C 0, C 1, B 0, B 1]
  bf16* s_op = stages + STAGES * STAGE;                      // [hi, lo][2 panels][64][64]
  Aux* aux = reinterpret_cast<Aux*>(s_op + 4 * SPANEL);      // [STAGES]
  Bars& bar = *reinterpret_cast<Bars*>(aux + STAGES);
  const int wg = threadIdx.x / 128;  // 0, 1: the consumers; 2: the producer warp

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tc::mbar_init(&bar.full[s], 2);   // the TMA bytes' arrival, then the producer's Aux
      tc::mbar_init(&bar.empty[s], 8);  // each consumer warp
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) return consume<0>(a, stages, s_op, aux, bar);
  if (wg == 1) return consume<1>(a, stages, s_op, aux, bar);

  // ---- producer: one warp claims units, loads them and computes their Aux ----
  const int lane = threadIdx.x & 31;
  for (int k = 0;; ++k) {
    // the next unit, claimed only once a stage is free: a claimed unit is
    // one a running block is about to load
    const int s = k % STAGES;
    tc::mbar_wait(&bar.empty[s], ((k / STAGES) & 1) ^ 1);
    STEP(2, k, 0, lane == 0);
    int u = 0;
    if (lane == 0) u = atomicAdd(a.flags + 2 * a.n_chains, 1);
    u = __shfl_sync(0xffffffffu, u, 0);
    Aux& ax = aux[s];
    if (u >= a.total) {
      if (lane == 0) {
        ax.unit = -1;
        tc::mbar_arrive(&bar.full[s]);
        tc::mbar_arrive(&bar.full[s]);
      }
      return;
    }
    const Unit w = unit_of(u, a.n_chains, a.H, a.n_pt);
    const int s0 = w.t * a.Q;
    const float Ah = a.A[w.h];
    const float* dtb = a.dt + w.b * a.dt_sb + w.h * a.dt_sh;
    float d[ROWS / 32];  // dt of the tile's rows lane + 32 q, 0 past Q
#pragma unroll
    for (int q = 0; q < ROWS / 32; ++q) {
      const int i = lane + 32 * q;
      d[q] = i < a.Q ? dtb[(int64_t)(s0 + i) * a.dt_ss] : 0.f;
    }
    if (lane == 0) {
      bf16* st = stages + s * STAGE;
      tc::mbar_expect_tx(&bar.full[s], STAGE_TX);
      tc::tma_load_4d(st, &tx, &bar.full[s], w.pt * P_TILE, w.h, s0, w.b);
      for (int p = 0; p < 2; ++p) {
        tc::tma_load_4d(st + (1 + p) * PANEL, &tcm, &bar.full[s], p * 64, w.h / a.rep, s0, w.b);
        tc::tma_load_4d(st + (3 + p) * PANEL, &tb, &bar.full[s], p * 64, w.h / a.rep, s0, w.b);
      }
    }
    STEP(2, k, 1, lane == 0);
    // a_cum: the chunk's sequential f32 sum from its first row, product and
    // sum rounded separately, as the TPU kernel's elementwise product and
    // cumsum round them; the rows of the chunk's earlier tiles first.  The
    // products go to w (scratch here), the sums to a.
    float run = 0.f;  // lane 0's
    for (int c0 = s0 - s0 % a.chunk; c0 < s0; c0 += ROWS) {
      const int n = min(ROWS, s0 - c0);
#pragma unroll
      for (int q = 0; q < ROWS / 32; ++q) {
        const int i = lane + 32 * q;
        if (i < n) ax.w[i] = __fmul_rn(dtb[(int64_t)(c0 + i) * a.dt_ss], Ah);
      }
      __syncwarp();
      if (lane == 0) {
        for (int i = 0; i < n; ++i) run = __fadd_rn(run, ax.w[i]);
      }
      __syncwarp();
    }
#pragma unroll
    for (int q = 0; q < ROWS / 32; ++q) {
      const int i = lane + 32 * q;
      ax.dt[i] = d[q];
      ax.w[i] = __fmul_rn(d[q], Ah);
    }
    __syncwarp();
    const float a_base = __shfl_sync(0xffffffffu, run, 0);
    if (lane == 0) {  // all 128 rows: past Q the products are 0 and a stays a_end
#pragma unroll
      for (int i = 0; i < ROWS; i += 8) {
        const float4 p0 = *reinterpret_cast<const float4*>(ax.w + i);
        const float4 p1 = *reinterpret_cast<const float4*>(ax.w + i + 4);
        const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        float sv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) sv[e] = run = __fadd_rn(run, pv[e]);
        *reinterpret_cast<float4*>(ax.a + i) = make_float4(sv[0], sv[1], sv[2], sv[3]);
        *reinterpret_cast<float4*>(ax.a + i + 4) = make_float4(sv[4], sv[5], sv[6], sv[7]);
      }
    }
    __syncwarp();
    STEP(2, k, 2, lane == 0);
    const float a_end = ax.a[ROWS - 1];
#pragma unroll
    for (int q = 0; q < ROWS / 32; ++q) {
      const int i = lane + 32 * q;
      const float ai = ax.a[i];
      ax.w[i] = expf(a_end - ai) * d[q];  // 0 past Q (dt = 0)
      ax.e[i] = expf(ai - a_base);
    }
    if (lane == 0) {
      ax.decay = expf(a_end - a_base);
      ax.Dh = a.D[w.h];
      ax.unit = u;
      ax.pos = w;
    }
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(&bar.full[s]);
    STEP(2, k, 3, lane == 0);
  }
}

}  // namespace

extern "C" {

// bf16 x, B, C and y; dt, A, D and the state float32.  Strides are in
// elements, for the batch, sequence and head/group dims of x, dt, B and C
// (the last dim of x, B and C must have stride 1; A and D are contiguous).
// P and N must be multiples of 8, the strides of x, B and C multiples of 8,
// and x, B, C, y, the state and the ring 16-byte aligned.  y is a contiguous
// (B, S, H, P) and state a contiguous (B, H, P, N).  S must be a multiple of
// the chunk, and the chunk a multiple of the tile Q (1..128), the rows taken
// at a time.  N <= 128, B <= 65535, any P.  Scratch from the caller: `ring`,
// B * H * ceil(P / 64) * 8192 floats, and `flags`, 2 * B * H * ceil(P / 64)
// + 1 ints, zero.  Returns 0 when the launch was accepted, else a
// cudaError_t or one of tc_ops.cuh's tensor-map codes.
int ssd_scan_tc_fwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                    const void* D, void* y, void* state, void* ring, void* flags, int B, int S,
                    int H, int P, int G, int N, int chunk, int Q, long long x_sb, long long x_ss,
                    long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
                    long long b_sb, long long b_ss, long long b_sg, long long c_sb,
                    long long c_ss, long long c_sg, void* stream) {
  bool aligned = P % 8 == 0 && N % 8 == 0;
  for (long long s : {x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg})
    aligned = aligned && s % 8 == 0;
  for (const void* p : {x, Bm, Cm, (const void*)y, (const void*)state, (const void*)ring})
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const long long n_chains = (long long)B * H * ((P + P_TILE - 1) / P_TILE);
  if (B < 1 || B > 65535 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 || N < 1 ||
      N > N_MAX || chunk < 1 || S % chunk != 0 || Q < 1 || Q > ROWS || chunk % Q != 0 ||
      !aligned || flags == nullptr || n_chains * (S / Q) > 2147483647LL ||
      2 * n_chains + 1 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const tc::EncodeTiled encode = tc::encode_fn();
  if (encode == nullptr) return tc::NO_ENCODE;
  CUtensorMap tx, tb, tcm;  // boxes of 64 columns x 128 rows
  CUresult r = tc::make_map(encode, &tx, x, P, H, S, B, x_sh, x_ss, x_sb, ROWS);
  if (r == CUDA_SUCCESS) r = tc::make_map(encode, &tb, Bm, N, G, S, B, b_sg, b_ss, b_sb, ROWS);
  if (r == CUDA_SUCCESS) r = tc::make_map(encode, &tcm, Cm, N, G, S, B, c_sg, c_ss, c_sb, ROWS);
  if (r != CUDA_SUCCESS) return tc::MAP_ERROR + (int)r;

  // the attribute and the SM count, once for the device last used
  static int set_for = -1, sms = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (set_for != dev) {
    err = cudaFuncSetAttribute(ssd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    set_for = dev;
  }
  Args a;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.D = static_cast<const float*>(D);
  a.y = static_cast<bf16*>(y);
  a.state_out = static_cast<float*>(state);
  a.ring = static_cast<float*>(ring);
  a.flags = static_cast<int*>(flags);
  a.S = S, a.H = H, a.P = P, a.N = N, a.chunk = chunk, a.Q = Q, a.rep = H / G;
  a.n_pt = (P + P_TILE - 1) / P_TILE;
  a.n_chains = (int)n_chains;
  a.T = S / Q;
  a.total = a.n_chains * a.T;
  a.dt_sb = dt_sb, a.dt_ss = dt_ss, a.dt_sh = dt_sh;
  const int grid = a.total < sms ? a.total : sms;
  ssd_tc_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(tx, tb, tcm, a);
  return (int)cudaGetLastError();
}

const char* ssd_scan_tc_error_string(int code) { return tc::error_string(code); }

#ifdef SSD_STEP_CLOCKS
// The stamps of the last launch, 3 x 64 x 8 values, into `out` on the host.
int ssd_scan_tc_step_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, ssd_step_clocks, sizeof(ssd_step_clocks));
}
#endif

}  // extern "C"
