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
// moved once, so at prefill lengths the tensor cores' bf16 rate.  The design
// keeps the tensor cores busy the way Hopper allows:
//   - Warp specialisation.  A block is three warpgroups.  The producer
//     (warpgroup 0) gives up registers (setmaxnreg 24) and one of its
//     threads issues every load: Q once for a 128-row q tile (two buffers:
//     the next tile's Q loads during this one), then K and V tiles of 128
//     keys through two rings of two stages each.  Two consumer
//     warpgroups (setmaxnreg 240) each own 64 of the tile's rows: wgmma's
//     m64.
//   - TMA.  Each tile is one or two boxes of 64 columns (128 bytes) of a 4-D
//     tensor map over (hd, heads, sequence, batch) built on the host from
//     the tensors' strides, stored in the 128-byte swizzle wgmma reads.
//     TMA's zero fill covers rows past Sq or Sk and columns past hd.  Loads
//     complete on "full" mbarriers; consumers hand a stage back on its
//     "empty" mbarrier.  No cp.async, no __syncthreads in the loop.
//   - Overlap inside a warpgroup.  S_{j+1} = Q K_{j+1}^T and O += P_j V_j
//     are issued together; wgmma.wait_group 1 waits for S_{j+1} alone, so
//     its softmax runs while P_j V_j is still on the tensor cores.  O is
//     rescaled once P_j V_j is done (wait_group 0): no instruction but a
//     wgmma writes an accumulator while a product is in flight, else ptxas
//     serialises the wgmma (its warning C7515).
//   - Overlap between the two consumers.  Named barriers hand the right to
//     issue products back and forth (ping-pong), so one warpgroup's softmax
//     runs while the other's products do.
//   - Each head width at its own size.  Q K^T runs ceil(hd/16) k-steps of
//     16 (hd 80: 5, not 8), and P V is one wgmma of n = HDP, the template
//     width: 32, 64, 80, 96 or 128 (hd 120 -> 128; any other hd takes the
//     next width up).
//   - O through shared memory.  Each consumer writes O / l in bf16 over its
//     own 64 rows of the Q buffer and one thread stores them with TMA
//     (rows past Sq and columns past hd are not written); the buffer goes
//     back to the producer once the store has read it.
//   - Persistent blocks.  One block an SM, or fewer where there are fewer
//     tiles, each walking a static order of (q tile, head, batch) with the
//     q tiles that see the most keys first, in rounds that alternate
//     direction, so one tile's epilogue overlaps the next tile's loads and
//     the block with a round's longest tile takes the next round's
//     shortest (deepseek's 5 / 1 run: 160 tiles on 132 SMs).
// P is rounded to bf16 before P V (S's accumulator layout is the A fragment
// layout of P V): the one rounding the f32 path does not have; l sums the
// f32 p.  Tiles wholly after the q tile (causal) or wholly older than the
// window are never loaded; masking inside a tile covers causality, the
// window and the ragged Sk edge.  Shared memory: 193 KB at HDP 128.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; launched from repro_torch/kernels/flash_attention.py.

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

constexpr int BM = 128;           // q rows a tile: two consumers of wgmma's m64
constexpr int BN = 128;           // keys a K/V tile
constexpr int STAGES = 2;         // K and V ring depth
constexpr int QSTAGES = 2;        // Q buffers: the next tile's Q loads during this one
static_assert(QSTAGES >= 2, "a Q buffer is handed back during the next tile, which needs another");
constexpr int THREADS = 384;      // producer + two consumer warpgroups
constexpr int PANEL = 128 * 64;   // elements of one 64-column box of 128 rows
constexpr int PANEL_BYTES = PANEL * 2;
constexpr int BAR_SCHED = 1;      // named barriers 1, 2: the consumers' turns
constexpr int BAR_EPI = 3;        // named barriers 3, 4: a consumer's own epilogue
constexpr float LOG2E = 1.4426950408889634f;

template <int HDP>
__host__ __device__ constexpr int panels() { return (HDP + 63) / 64; }

// Q QSTAGES times, K and V STAGES times each, the mbarriers, and room to
// align the start to 1024 bytes (the swizzle is a function of the address).
template <int HDP>
constexpr size_t smem_bytes() {
  return (size_t)(QSTAGES + 2 * STAGES) * panels<HDP>() * PANEL_BYTES + 1024 + 128;
}

struct Tile {
  int b, h, q0, k_begin, n;  // n key tiles from k_begin
};

// The tile a block takes in round r of the static order, or -1: rounds of
// gridDim.x tiles, the odd ones walked backwards (a snake), so the block
// that took a round's longest tile takes the next round's shortest.
__device__ __forceinline__ int tile_of_round(int r, int total) {
  const int t = r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return t < total ? t : -1;
}

// The t-th tile of the static order: the q tile outermost and, under a
// causal mask, the last (longest) first; heads then batch inside it.
__device__ __forceinline__ Tile tile_at(int t, int H, int B, int n_qt, int Sk, int causal,
                                        int window) {
  const int per = H * B, qi = t / per, rem = t - qi * per;
  Tile w;
  w.h = rem % H;
  w.b = rem / H;
  w.q0 = (causal ? n_qt - 1 - qi : qi) * BM;
  const int k_end = causal ? min(Sk, w.q0 + BM) : Sk;
  const int kb = (window > 0 ? max(0, w.q0 - window + 1) : 0) / BN * BN;
  w.k_begin = kb;
  w.n = k_end > kb ? (k_end - kb + BN - 1) / BN : 0;
  return w;
}

struct Bars {
  uint64_t q_full[QSTAGES], q_empty[QSTAGES];
  uint64_t k_full[STAGES], k_empty[STAGES], v_full[STAGES], v_empty[STAGES];
};

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1) flash_tc_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to, int B, int Sq,
    int Sk, int H, int G, int hd, int causal, int window, float scale_log2) {
  constexpr int NP = panels<HDP>();
  constexpr int KS = HDP / 16;  // k-steps of Q K^T at this width
  constexpr int NT = HDP / 8;   // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + pad);  // [QSTAGES][NP][128 rows][64]
  bf16* Ks = Qs + QSTAGES * NP * PANEL;                  // [STAGES][NP][128][64]
  bf16* Vs = Ks + STAGES * NP * PANEL;                   // likewise
  Bars& bar = *reinterpret_cast<Bars*>(Vs + STAGES * NP * PANEL);

  const int n_qt = (Sq + BM - 1) / BM;
  const int total = n_qt * H * B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < QSTAGES; ++s) {
      tc::mbar_init(&bar.q_full[s], 1);
      tc::mbar_init(&bar.q_empty[s], 2);  // each consumer, once its O has left the buffer
    }
    for (int s = 0; s < STAGES; ++s) {
      tc::mbar_init(&bar.k_full[s], 1);
      tc::mbar_init(&bar.k_empty[s], 8);
      tc::mbar_init(&bar.v_full[s], 1);
      tc::mbar_init(&bar.v_empty[s], 8);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps Q and the K/V rings loaded ----
    tc::setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    constexpr uint32_t TILE_TX = NP * PANEL_BYTES;
    int kc = 0, vc = 0, qc = 0;  // loads issued so far, across tiles: ring slot and phase
    for (int r = 0; r * (int)gridDim.x < total; ++r) {
      const int t = tile_of_round(r, total);
      if (t < 0) continue;
      const Tile w = tile_at(t, H, B, n_qt, Sk, causal, window);
      const int kvh = w.h / G;
      const int qs = qc % QSTAGES;  // both consumers are done with this buffer's last Q
      tc::mbar_wait(&bar.q_empty[qs], ((qc++ / QSTAGES) & 1) ^ 1);
      tc::mbar_expect_tx(&bar.q_full[qs], TILE_TX);
      for (int p = 0; p < NP; ++p)
        tc::tma_load_4d(Qs + (qs * NP + p) * PANEL, &tq, &bar.q_full[qs], p * 64, w.h, w.q0, w.b);
      auto load = [&](const CUtensorMap* map, bf16* ring, uint64_t* full, uint64_t* empty, int& c,
                      int j) {
        const int s = c % STAGES;
        tc::mbar_wait(&empty[s], ((c / STAGES) & 1) ^ 1);
        tc::mbar_expect_tx(&full[s], TILE_TX);
        for (int p = 0; p < NP; ++p)
          tc::tma_load_4d(ring + (s * NP + p) * PANEL, map, &full[s], p * 64, kvh,
                          w.k_begin + j * BN, w.b);
        ++c;
      };
      if (w.n == 0) continue;  // no key: the consumers store zeros through this Q buffer
      // the order the consumers use them: K_0, then K_{j+1} with V_j
      load(&tk, Ks, bar.k_full, bar.k_empty, kc, 0);
      for (int j = 0; j < w.n; ++j) {
        if (j + 1 < w.n) load(&tk, Ks, bar.k_full, bar.k_empty, kc, j + 1);
        load(&tv, Vs, bar.v_full, bar.v_empty, vc, j);
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    tc::setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int ks_n = (hd + 15) / 16;  // k-steps this hd needs (<= KS)
    if (c == 1) tc::bar_arrive(BAR_SCHED, 256);  // consumer 0 issues first
    int kc = 0, vc = 0, qc = 0;
    int pending = -1;  // the Q buffer whose O the TMA store may still be reading
    // hand that buffer back to the producer once the store has read it: in the
    // next tile, under its first Q K^T, so no warp waits on the store
    auto release_pending = [&]() {
      if (pending >= 0 && tid == 0) {
        tc::bulk_wait_read<0>();
        tc::mbar_arrive(&bar.q_empty[pending]);
      }
      pending = -1;
    };
    float s[64];       // S: 64 x 128 a warpgroup, s[4 n + e] for keys 8 n + 2 t4 (+1)
    float acc[HDP / 2];  // O: 64 x HDP
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;

    for (int r = 0; r * (int)gridDim.x < total; ++r) {
      const int t = tile_of_round(r, total);
      if (t < 0) continue;
      const Tile w = tile_at(t, H, B, n_qt, Sk, causal, window);
      const int rq0 = w.q0 + 64 * c;       // this warpgroup's first row
      const int row0 = rq0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
      float m_r[2] = {-INFINITY, -INFINITY};
      float l_r[2] = {0.f, 0.f};  // this thread's share of each row's sum
      float alpha[2] = {0.f, 0.f};
      uint32_t pf[8][4];

      const int qs = qc % QSTAGES;
      tc::mbar_wait(&bar.q_full[qs], (qc++ / QSTAGES) & 1);
      bf16* Qc = Qs + qs * NP * PANEL + c * 64 * 64;  // this consumer's 64 rows of Q, then of O
      if (w.n > 0) {

        // s = Q K^T over N k-steps, issued and committed; no branch between
        // the wgmma of one group (ptxas would move their accumulators)
        auto qk_steps = [&](const bf16* Kt, auto n_steps) {
          constexpr int N = decltype(n_steps)::value;
          tc::wg_fence();
#pragma unroll
          for (int ks = 0; ks < N; ++ks) {
            const int off = (ks >> 2) * PANEL + (ks & 3) * 16;  // panel, then 32 bytes a k-step
            tc::wgmma_ss(s, tc::desc_sw128(Qc + off, 0, 1024), tc::desc_sw128(Kt + off, 0, 1024),
                         ks > 0);
          }
          tc::wg_commit();
        };
        auto qk = [&](const bf16* Kt) {  // ceil(hd / 16) k-steps: KS, or KS - 1 (hd 40, 112, ...)
          if (ks_n == KS) qk_steps(Kt, std::integral_constant<int, KS>());
          else qk_steps(Kt, std::integral_constant<int, (KS > 1 ? KS - 1 : 1)>());
        };
        auto pv = [&](const bf16* Vt) {  // acc += P V, issued and committed
          tc::fence_regs(acc);
          tc::wg_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
            tc::wgmma_rs_tb(acc, pf[kk], tc::desc_sw128(Vt + kk * 16 * 64, PANEL_BYTES, 1024));
          tc::wg_commit();
        };
        // mask, online softmax of S's tile at key k0 in the log2 domain: the
        // max of the raw scores (the scale is positive), then one FFMA a
        // score, s * scale - m, into exp2; p stays in s, alpha rescales O
        auto softmax = [&](int k0) {
          const bool need_mask = k0 + BN > Sk || (causal && k0 + BN - 1 > rq0) ||
                                 (window > 0 && k0 <= rq0 + 63 - window);
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int n = i >> 2, e = i & 3;
            if (need_mask) {
              const int kp = k0 + n * 8 + 2 * t4 + (e & 1);
              const int qp = row0 + (e >> 1) * 8;
              bool ok = kp < Sk;
              if (causal) ok = ok && kp <= qp;
              if (window > 0) ok = ok && kp > qp - window;
              if (!ok) s[i] = -INFINITY;
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], s[i]);
          }
          float m_neg[2];  // -m, the running max in the log2 domain
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);
            // rows with no valid key yet keep m = -inf: guard exp2(-inf - -inf)
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            alpha[r] = m_r[r] == -INFINITY ? 0.f : exp2f(m_r[r] - m_use);
            m_r[r] = m_new;
            m_neg[r] = -m_use;
            l_r[r] *= alpha[r];
          }
#pragma unroll
          for (int i = 0; i < 64; ++i) {  // masked: exp2(-inf) = 0
            const float p = exp2f(fmaf(s[i], scale_log2, m_neg[(i & 3) >> 1]));
            s[i] = p;
            l_r[(i & 3) >> 1] += p;
          }
        };
        auto rescale = [&]() {  // only with no wgmma in flight: ptxas serialises otherwise
#pragma unroll
          for (int i = 0; i < HDP / 2; ++i) acc[i] *= alpha[(i & 3) >> 1];
        };
        auto pack_p = [&]() {  // P's A fragments straight from S's accumulators
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const float* a = s + 8 * kk;
            pf[kk][0] = tc::pack(a[0], a[1]);
            pf[kk][1] = tc::pack(a[2], a[3]);
            pf[kk][2] = tc::pack(a[4], a[5]);
            pf[kk][3] = tc::pack(a[6], a[7]);
          }
        };
        auto release = [&](uint64_t* b) {
          if (lane == 0) tc::mbar_arrive(b);
        };

        // S_0 alone
        int ks_ = kc % STAGES;
        tc::mbar_wait(&bar.k_full[ks_], (kc / STAGES) & 1);
        tc::bar_sync(BAR_SCHED + c, 256);
        qk(Ks + ks_ * NP * PANEL);
        tc::bar_arrive(BAR_SCHED + 1 - c, 256);
        release_pending();
        tc::wg_wait<0>();
        tc::fence_regs(s);
        release(&bar.k_empty[ks_]);
        ++kc;
        softmax(w.k_begin);  // O is 0: no rescale
        pack_p();

        for (int j = 0; j + 1 < w.n; ++j) {
          // S_{j+1} and P_j V_j in flight together; softmax of S_{j+1} under P_j V_j
          ks_ = kc % STAGES;
          tc::mbar_wait(&bar.k_full[ks_], (kc / STAGES) & 1);
          tc::bar_sync(BAR_SCHED + c, 256);
          qk(Ks + ks_ * NP * PANEL);
          const int vs = vc % STAGES;
          tc::mbar_wait(&bar.v_full[vs], (vc / STAGES) & 1);
          pv(Vs + vs * NP * PANEL);
          tc::bar_arrive(BAR_SCHED + 1 - c, 256);
          tc::wg_wait<1>();
          tc::fence_regs(s);
          release(&bar.k_empty[ks_]);
          ++kc;
          softmax(w.k_begin + (j + 1) * BN);
          tc::wg_wait<0>();
          tc::fence_regs(acc);
          release(&bar.v_empty[vs]);
          ++vc;
          rescale();  // O to the running max of tile j + 1, before P_{j+1} V_{j+1} adds
          pack_p();
        }
        const int vs = vc % STAGES;
        tc::mbar_wait(&bar.v_full[vs], (vc / STAGES) & 1);
        pv(Vs + vs * NP * PANEL);
        tc::wg_wait<0>();
        tc::fence_regs(acc);
        release(&bar.v_empty[vs]);
        ++vc;
      }

      // epilogue: O / l in bf16 over this consumer's rows of the Q buffer (the
      // same 128-byte swizzle), then one TMA store, which writes no row past
      // Sq and no column past hd; a tile with no key stores zeros
      release_pending();
      tc::bar_sync(BAR_EPI + c, 128);  // every warp's products have read Q
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
        const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
        const int rr = warp * 16 + g + r * 8;  // row in the 64; rr % 8 == g
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<uint32_t*>(Qc + (n >> 3) * PANEL + rr * 64 + (((n & 7) ^ g) * 8) +
                                       2 * t4) =
              tc::pack(acc[n * 4 + 2 * r] * inv, acc[n * 4 + 2 * r + 1] * inv);
      }
      tc::fence_proxy_async();  // the stores above, visible to the TMA store
      tc::bar_sync(BAR_EPI + c, 128);
      if (tid == 0) {
        for (int p = 0; p < NP; ++p) tc::tma_store_4d(&to, Qc + p * PANEL, p * 64, w.h, rq0, w.b);
        tc::bulk_commit();
      }
      pending = qs;
    }
    if (tid == 0) tc::bulk_wait<0>();  // the last stores are done before the block ends
  }
}

template <int HDP>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const CUtensorMap& to, int B, int Sq, int Sk, int H, int KV, int hd, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  // the attribute and the SM count, once for the device last used: a call's
  // host time is of the order of a small shape's kernel time
  static int set_for = -1, sms = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (set_for != dev) {
    err = cudaFuncSetAttribute(flash_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    set_for = dev;
  }
  const long long total = (long long)((Sq + BM - 1) / BM) * H * B;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(total < sms ? total : sms);
  flash_tc_kernel<HDP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, to, B, Sq, Sk, H, H / KV, hd, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q/k/v/o.  Strides are in elements, for the batch, sequence and head
// dims; the head_dim stride must be 1, hd a multiple of 8 and every stride a
// multiple of 8, each base 16-byte aligned (what TMA reads).  window <= 0
// means no window.  The output o is contiguous (B, Sq, H, hd).  Returns 0
// when the launch was accepted, else a cudaError_t or one of the codes above.
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
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || hd < 1 || hd > 128 || !aligned)
    return (int)cudaErrorInvalidValue;
  const tc::EncodeTiled encode = tc::encode_fn();
  if (encode == nullptr) return tc::NO_ENCODE;
  CUtensorMap tq, tk, tv, to;  // loads of 128 rows; the output's stores of a consumer's 64
  CUresult r = tc::make_map(encode, &tq, q, hd, H, Sq, B, q_sh, q_ss, q_sb, BM);
  if (r == CUDA_SUCCESS) r = tc::make_map(encode, &tk, k, hd, KV, Sk, B, k_sh, k_ss, k_sb, BN);
  if (r == CUDA_SUCCESS) r = tc::make_map(encode, &tv, v, hd, KV, Sk, B, v_sh, v_ss, v_sb, BN);
  if (r == CUDA_SUCCESS)
    r = tc::make_map(encode, &to, o, hd, H, Sq, B, hd, (long long)H * hd,
                     (long long)Sq * H * hd, 64);
  if (r != CUDA_SUCCESS) return tc::MAP_ERROR + (int)r;
  if (window >= Sq) window = -1;  // it hides no key: drop the per-tile window test
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return launch<32>(tq, tk, tv, to, B, Sq, Sk, H, KV, hd, causal, window, scale, s);
  if (hd <= 64) return launch<64>(tq, tk, tv, to, B, Sq, Sk, H, KV, hd, causal, window, scale, s);
  if (hd <= 80) return launch<80>(tq, tk, tv, to, B, Sq, Sk, H, KV, hd, causal, window, scale, s);
  if (hd <= 96) return launch<96>(tq, tk, tv, to, B, Sq, Sk, H, KV, hd, causal, window, scale, s);
  return launch<128>(tq, tk, tv, to, B, Sq, Sk, H, KV, hd, causal, window, scale, s);
}

const char* flash_attention_tc_error_string(int code) { return tc::error_string(code); }

}  // extern "C"
