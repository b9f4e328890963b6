// LSTM recurrence kernels for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of phones_las_tpu/ops/lstm.py:
//   _recurrence_pallas_bidir    (_make_bilstm_kernel)        -> plt_lstm_recurrence, nd = 2
//   _recurrence_pallas          (_make_lstm_kernel)          -> plt_lstm_recurrence, nd = 1
//   _recurrence_pallas_residual (_make_lstm_fwd_res_kernel)  -> plt_lstm_residual
//   _recurrence_pallas_bwd      (_make_lstm_bwd_kernel)      -> plt_lstm_bwd
// reached through pallas_bidir_recurrence (the listener: its primal on the
// inference path, its custom VJP in the training step) and
// pallas_recurrence (lstm_layer).
//
// Every entry takes one or two directions (nd), each with its own xp, Wh
// and outputs; bit d of rev_bits says whether direction d walks time
// backwards. Outputs land at their own time index, as lax.scan(reverse=...).
//
// Forward (recurrence, residual), for each direction:
//   gates = xp[t] + h @ Wh                     [B, 4U], gate order (i,f,g,o)
//   c'    = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(g)
//   h'    = sigmoid(o) * tanh(c')
//   h, c  = m*h' + (1-m)*h, m*c' + (1-m)*c     (m = mask[t, b]: frozen past the length)
//   out[t] = m * h'
// and the final (h, c); with SAVE_RES also the carried state before each
// step, hprev[t] and cprev[t], in the type of Wh (bf16 in bf16 mode).
//
// What bounds the forward on this card. The work is T dependent steps of a
// small product ([B, U] x [U, 4U]); the operations (67 GFLOP at T = 999,
// B = 64, both directions: 1.0 ms at 67 TFLOP/s) and the bytes (0.65 GB,
// 0.2 ms) are far below what a step's latency costs when it is paid T
// times. The TPU kernel keeps Wh in VMEM across its sequential grid; one
// SM cannot (Wh is 1 MB in float32, a block has 227 KB), and a block that
// streams Wh from L2 at every step waits on those reads (the first port:
// 23 us a step, float32 and bf16 alike).
//
// Design: one forward template, lstm_fwd_kernel<W, SAVE_RES>, launched as
// thread-block clusters. A cluster of C blocks runs one direction for a
// tile of Bt batch rows over all T steps (grid = C * ceil(B/Bt) x nd).
// Block c owns units [c*U/C, (c+1)*U/C) and the four gate columns of each,
// so the cell update of its units is local. Its slice of Wh, regrouped by
// the caller to [C][U][4*U/C] (float32) or [C][4*U/C][K] (bf16, k
// contiguous, K = U rounded up to 16), is copied into shared memory once,
// before the time loop, and never read from L2 again. Per step a block
//   1. computes its gate columns for the tile from the full h of the last
//      step, which lies in its own shared memory:
//      float32: true float32 FMAs, register-tiled 8 rows x 4 columns a
//      thread with k split over the warps (one 16-byte shared load of Wh
//      feeds 32 FMAs, one of h 16), partial sums met in shared memory;
//      bf16: tensor cores, mma.sync.m16n8k16 with the tile's rows as M
//      (h rounded to bf16, float32 accumulate);
//   2. updates c and h of its units (float32 state in shared memory), two
//      units a thread: the gate math is a long dependent chain, so it is
//      spread over all threads;
//   3. sends its h slice into the other h buffer of every block of the
//      cluster (distributed shared memory; h is double-buffered so step
//      t+1's stores cannot overtake step t's reads) with st.async, which
//      counts the bytes on a transaction barrier in the receiving block;
//      while they travel it writes out[t] (and the next step's residuals)
//      and starts the cp.async of a later xp tile; the next step begins
//      when the block's own barrier has seen all Bt * U values. No fence
//      and no cluster-wide barrier is paid per step.
// C = 1 is one block that owns every unit; where no slice fits in shared
// memory (C = 1 at a large U) the same code streams Wh from L2. The caller
// chooses C, Bt and the k split from the shape (ops/lstm.py::forward_plan)
// and this file refuses what does not fit: there is no second route.
//
// Prediction, made before the first run on the card (H100, B = 64, U = 256,
// C = 8): the float32 product is 16*256*128 FMA a step and block at
// Bt = 16, 2.3 us at the SM's FMA rate, half at Bt = 8; with one block
// barrier, the cell update and the cluster barrier a step should take
// 4-6 us in float32 (4-6 ms at T = 999, against 23.5 ms) and less in
// bf16, where the product is 32 mma a warp. (Written for the kernel's first
// form, which ended each step with a cluster barrier; the measurements, and
// what the barrier cost, are in PERF.md.)
//
// VJP (plt_lstm_bwd), the three products of the reference's kernel body,
// each a kernel here, launched in this order on one stream:
//   1. gates = xp + hprev @ Wh over all T*B rows: the rows are independent,
//      so a tiled GEMM (64x64 tiles, 16-deep k chunks, 4x4 outputs a thread)
//      writes them into dxp, which the serial loop then overwrites with the
//      gate gradients (each thread reads and writes only its own entries);
//   2. the serial loop, opposite in time to the forward, per step:
//        dh'     = m*(dout + dh)
//        dc'     = m*dc + dh'*so*(1 - tanh(c')^2)
//        dgates  = [di, df, dg, do]            (zero at masked steps)
//        dxp[t]  = dgates
//        dh_prev = (1-m)*dh + dgates @ Wh^T    (Wh^T [4U, U] read coalesced)
//        dc_prev = (1-m)*dc + dc'*sf
//      one block for R = 4 rows, thread j owns the (row j/U, unit j%U)
//      pair, and for the dot sums quarter j/U of the 4U gate columns for
//      unit j%U over all R rows; the four partial sums meet in shared
//      memory. It streams Wh^T from L2 at every step, as the first forward
//      did, and waits on those reads; the forward's cluster design is the
//      cure and is not applied here yet;
//   3. dWh = sum_t hprev_t^T dgates_t over T*B rows as a split-K GEMM: each
//      block writes the partial sum of its row range, and a second kernel
//      adds the partials in a fixed order, so repeated runs are bitwise
//      equal (no float atomics).
// In bf16 mode (Wh in bf16) the operands of every dot are bf16 values (h,
// hprev and dgates rounded) with float32 accumulation; xp and dxp stay
// float32 (the reference streams them bf16).
//
// Bounds of the VJP (67 TFLOP/s float32, 3.35 TB/s) at the training shape
// (B = 32, T = 999, both directions): three products of 33.5 GFLOP
// (1.5 ms) against 0.72 GB (0.21 ms); operations bound it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 4;  // batch rows per block of the VJP's serial kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x as a dot with W-typed weights reads it: rounded to bf16 in bf16 mode
template <typename W>
__device__ __forceinline__ float dot_in(float x) { return to_f(from_f<W>(x)); }

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// ---------------------------------------------------------------- forward

constexpr int FWD_THREADS = 256;
constexpr int TR = 8;    // rows of a thread's register tile in the float32 product
constexpr int MMA_M = 16;  // rows of the bf16 product's tile (h rows past Bt stay zero)
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may use
// xp tiles in flight: the tile of step s + 2 is requested during step s, so
// device memory's latency is hidden even where the product is short (bf16)
constexpr int XP_RING = 3;

struct FwdArgs {
  const float* xp[2];  // [T, B, 4U]
  const void* wh[2];   // regrouped by unit slice (see the header)
  float* out[2];       // [T, B, U]
  void* hprev[2];      // [T, B, U] W (SAVE_RES only)
  void* cprev[2];
  float* hfin[2];      // [B, U]
  float* cfin[2];
  int reverse[2];
};

// how one launch cuts the work, chosen by the caller from the shape
struct FwdPlan {
  int C;         // blocks of a cluster = slices of the units
  int Bt;        // batch rows of a cluster's tile (8 or 16)
  int KS;        // float32: parts the k range is split into
  int resident;  // the block's slice of Wh lies in shared memory
};

// byte offsets of a block's shared memory; ops/lstm.py::forward_smem_bytes mirrors it
struct FwdLayout {
  int Us, Nc, Kp;  // units and gate columns of a block; U rounded up to 16
  int ldh, ldw;    // row strides of h and of the Wh slice, in elements
  int xp_tile;     // floats of one xp tile: [Bt, Nc] gates, then [Bt] mask
  size_t w, h, part, xp, cst, hst, ost, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int U, FwdPlan p, bool bf) {
  FwdLayout L;
  L.Us = U / p.C;
  L.Nc = 4 * L.Us;
  L.Kp = (U + 15) / 16 * 16;
  // bf16 rows are padded by 8 elements (16 bytes) so that the 8 rows a
  // warp's mma fragment loads fall into different banks
  L.ldh = bf ? L.Kp + 8 : U;
  L.ldw = bf ? (p.resident ? L.Kp + 8 : L.Kp) : L.Nc;
  size_t off = 0;
  L.w = off;
  if (p.resident) off += bf ? (size_t)L.Nc * L.ldw * 2 : (size_t)U * L.Nc * 4;
  L.h = off;
  off += bf ? (size_t)2 * MMA_M * L.ldh * 2 : (size_t)2 * p.Bt * U * 4;
  L.part = off;
  off += (size_t)p.KS * p.Bt * L.Nc * 4;
  L.xp_tile = p.Bt * L.Nc + p.Bt;
  L.xp = off;
  off += (size_t)XP_RING * L.xp_tile * 4;
  L.cst = off;
  off += (size_t)p.Bt * L.Us * 4;
  L.hst = off;
  off += (size_t)p.Bt * L.Us * 4;
  L.ost = off;
  off += (size_t)p.Bt * L.Us * 4;
  L.total = off;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all of this thread's groups but the newest have landed
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// The exchange of h between the blocks of a cluster: st.async stores a value
// into a peer's shared memory and adds its bytes to a transaction barrier
// (mbarrier) there; the peer waits until the bytes it expects have landed.
// No fence and no cluster-wide barrier stand in a step's way.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// the address of my shared-memory location `addr` in block `rank` of the cluster
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(unsigned bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}
// one arrival, and `bytes` more to wait for in the barrier's current phase
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_done(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}
// wait for the phase of `parity`; a wait of seconds means a lost store, and
// the kernel ends with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_done(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_done(bar, parity))
    if (clock64() - t0 > 4000000000LL) __trap();
}
// two values of W type into a peer, counted on its barrier
__device__ __forceinline__ void store2_async(unsigned dst, unsigned bar, const float*, float2 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
      ::"r"(dst), "f"(v.x), "f"(v.y), "r"(bar) : "memory");
}
__device__ __forceinline__ void store2_async(unsigned dst, unsigned bar, const __nv_bfloat16*,
                                             float2 v) {
  __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
      ::"r"(dst), "r"(*reinterpret_cast<unsigned*>(&b)), "r"(bar) : "memory");
}

// float32: part[ks][row][col] = sum over k part ks of h[row][k] * w[k][col],
// an item = (k part, 8 rows, 4 columns) a thread
__device__ __forceinline__ void product_f32(const float* __restrict__ w,
                                            const float* __restrict__ h,
                                            float* __restrict__ part, int U, int Bt,
                                            int Nc, int KS) {
  const int ncg = Nc / 4, nrg = Bt / TR;
  const int nitems = nrg * ncg * KS;
  const int k4n = U / 4, kper = (k4n + KS - 1) / KS;
  for (int item = threadIdx.x; item < nitems; item += FWD_THREADS) {
    const int cgi = item % ncg, rest = item / ncg;
    const int rg = rest % nrg, ks = rest / nrg;
    const int kb = ks * kper, ke = min(k4n, kb + kper);
    float acc[TR][4];
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
    const float* hp = h + (size_t)rg * TR * U;
    const float* wp = w + cgi * 4;
#pragma unroll 2
    for (int k4 = kb; k4 < ke; ++k4) {
      const float4 w0 = *reinterpret_cast<const float4*>(wp + (size_t)(4 * k4) * Nc);
      const float4 w1 = *reinterpret_cast<const float4*>(wp + (size_t)(4 * k4 + 1) * Nc);
      const float4 w2 = *reinterpret_cast<const float4*>(wp + (size_t)(4 * k4 + 2) * Nc);
      const float4 w3 = *reinterpret_cast<const float4*>(wp + (size_t)(4 * k4 + 3) * Nc);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hp + r * U + 4 * k4);
        acc[r][0] = fmaf(hv.x, w0.x, acc[r][0]);
        acc[r][1] = fmaf(hv.x, w0.y, acc[r][1]);
        acc[r][2] = fmaf(hv.x, w0.z, acc[r][2]);
        acc[r][3] = fmaf(hv.x, w0.w, acc[r][3]);
        acc[r][0] = fmaf(hv.y, w1.x, acc[r][0]);
        acc[r][1] = fmaf(hv.y, w1.y, acc[r][1]);
        acc[r][2] = fmaf(hv.y, w1.z, acc[r][2]);
        acc[r][3] = fmaf(hv.y, w1.w, acc[r][3]);
        acc[r][0] = fmaf(hv.z, w2.x, acc[r][0]);
        acc[r][1] = fmaf(hv.z, w2.y, acc[r][1]);
        acc[r][2] = fmaf(hv.z, w2.z, acc[r][2]);
        acc[r][3] = fmaf(hv.z, w2.w, acc[r][3]);
        acc[r][0] = fmaf(hv.w, w3.x, acc[r][0]);
        acc[r][1] = fmaf(hv.w, w3.y, acc[r][1]);
        acc[r][2] = fmaf(hv.w, w3.z, acc[r][2]);
        acc[r][3] = fmaf(hv.w, w3.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < TR; ++r)
      *reinterpret_cast<float4*>(part + ((size_t)(ks * Bt + rg * TR + r) * Nc + cgi * 4)) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: part[row][col] = sum_k h[row][k] * w[col][k] on the tensor cores.
// A warp takes pairs of 8-column tiles and runs two k chains a tile, so four
// independent mma chains hide the instruction's latency.
__device__ __forceinline__ void product_bf16(const __nv_bfloat16* __restrict__ w, int ldw,
                                             const __nv_bfloat16* __restrict__ h, int ldh,
                                             float* __restrict__ part, int Kp, int Bt,
                                             int Nc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int ntiles = Nc / 8;  // a multiple of 4: Nc is a multiple of 32
  for (int nt = warp * 2; nt < ntiles; nt += 2 * (FWD_THREADS / 32)) {
    float d[2][2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) d[j][ch][0] = d[j][ch][1] = d[j][ch][2] = d[j][ch][3] = 0.0f;
    for (int k0 = 0; k0 < Kp; k0 += 32) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const int kk = k0 + 16 * ch + tig * 2;
        if (k0 + 16 * ch < Kp) {
          unsigned a[4];
          a[0] = *reinterpret_cast<const unsigned*>(h + g * ldh + kk);
          a[1] = *reinterpret_cast<const unsigned*>(h + (g + 8) * ldh + kk);
          a[2] = *reinterpret_cast<const unsigned*>(h + g * ldh + kk + 8);
          a[3] = *reinterpret_cast<const unsigned*>(h + (g + 8) * ldh + kk + 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const __nv_bfloat16* wr = w + (size_t)((nt + j) * 8 + g) * ldw + kk;
            mma_bf16(d[j][ch], a, *reinterpret_cast<const unsigned*>(wr),
                     *reinterpret_cast<const unsigned*>(wr + 8));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = (nt + j) * 8 + tig * 2;
      *reinterpret_cast<float2*>(part + (size_t)g * Nc + col) =
          make_float2(d[j][0][0] + d[j][1][0], d[j][0][1] + d[j][1][1]);
      if (Bt > 8)
        *reinterpret_cast<float2*>(part + (size_t)(g + 8) * Nc + col) =
            make_float2(d[j][0][2] + d[j][1][2], d[j][0][3] + d[j][1][3]);
    }
  }
}

// two values of W type as one store
__device__ __forceinline__ void store2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

template <typename W, bool SAVE_RES>
__global__ void __launch_bounds__(FWD_THREADS, 1)
lstm_fwd_kernel(FwdArgs a, const float* __restrict__ mask, int T, int B, int U, FwdPlan plan,
                float forget_bias, long long* __restrict__ clocks) {
  constexpr bool BF = std::is_same<W, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  __shared__ __align__(8) unsigned long long h_bar[2];  // one transaction barrier an h buffer
  cg::cluster_group cluster = cg::this_cluster();
  const int C = plan.C, Bt = plan.Bt, KS = plan.KS;
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / C) * Bt;
  const int tid = threadIdx.x;
  const FwdLayout L = fwd_layout(U, plan, BF);
  const int Us = L.Us, Nc = L.Nc, G = 4 * U;

  const float* __restrict__ xp = a.xp[d];
  float* __restrict__ out = a.out[d];
  W* hprev = static_cast<W*>(a.hprev[d]);
  W* cprev = static_cast<W*>(a.cprev[d]);
  const bool reverse = a.reverse[d] != 0;
  const W* wg = static_cast<const W*>(a.wh[d]) +
                (size_t)rank * (BF ? (size_t)Nc * L.Kp : (size_t)U * Nc);

  W* w_s = reinterpret_cast<W*>(fwd_smem + L.w);
  W* h_s = reinterpret_cast<W*>(fwd_smem + L.h);  // [2][rows][ldh], as the dot reads h
  float* part_s = reinterpret_cast<float*>(fwd_smem + L.part);
  float* xp_s = reinterpret_cast<float*>(fwd_smem + L.xp);
  float* c_st = reinterpret_cast<float*>(fwd_smem + L.cst);  // [Bt][Us] float32 state
  float* h_st = reinterpret_cast<float*>(fwd_smem + L.hst);
  float* o_st = reinterpret_cast<float*>(fwd_smem + L.ost);  // [Bt][Us] m * h' of this step
  const int hbuf = (BF ? MMA_M : Bt) * L.ldh;            // elements of one h buffer

  // everything but the Wh slice starts at zero: h, the state, and the xp
  // tiles (rows past B are never loaded)
  for (size_t i = L.h / 16 + tid; i < L.total / 16; i += FWD_THREADS)
    reinterpret_cast<float4*>(fwd_smem)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (plan.resident) {
    if (BF) {  // [Nc][Kp] -> rows padded to ldw
      const int cpr = L.Kp / 8;
      for (int i = tid; i < Nc * cpr; i += FWD_THREADS)
        *reinterpret_cast<uint4*>(w_s + (size_t)(i / cpr) * L.ldw + (i % cpr) * 8) =
            reinterpret_cast<const uint4*>(wg)[i];
    } else {
      for (int i = tid; i < U * Nc / 4; i += FWD_THREADS)
        reinterpret_cast<float4*>(w_s)[i] = reinterpret_cast<const float4*>(wg)[i];
    }
  }
  __syncthreads();

  // a pair = 2 units of one row: the item of the cell update, so that at
  // Bt = 16 every thread has one (the gate math is a long dependent chain)
  const int uqn = Us / 4, upn = Us / 2, np = Bt * upn;
  // xp[t] columns of this block and mask[t] for the tile -> xp_s[buf]
  auto prefetch = [&](int t, int buf) {
    float* dst = xp_s + buf * L.xp_tile;
    for (int i = tid; i < Bt * Us; i += FWD_THREADS) {
      const int row = i / Us, rem = i - row * Us;
      const int gate = rem / uqn, j = rem - gate * uqn;
      if (row0 + row < B)
        cp_async16(dst + row * Nc + gate * Us + 4 * j,
                   xp + ((size_t)t * B + row0 + row) * G + gate * U + rank * Us + 4 * j);
    }
    if (tid < Bt && row0 + tid < B)
      cp_async4(dst + Bt * Nc + tid, mask + (size_t)t * B + row0 + tid);
    cp_async_commit();
  };
  // the carried state before step t (the residuals of the VJP)
  auto save_state = [&](int t) {
    for (int q = tid; q < np; q += FWD_THREADS) {
      const int row = q / upn, u0 = (q - row * upn) * 2;
      if (row0 + row >= B) continue;
      const size_t idx = ((size_t)t * B + row0 + row) * U + rank * Us + u0;
      store2(hprev + idx, *reinterpret_cast<const float2*>(h_st + row * Us + u0));
      store2(cprev + idx, *reinterpret_cast<const float2*>(c_st + row * Us + u0));
    }
  };
  prefetch(reverse ? T - 1 : 0, 0);
  if (T > 1) prefetch(reverse ? T - 2 : 1, 1);
  else cp_async_commit();  // an empty group keeps the count of groups per step
  if (SAVE_RES) save_state(reverse ? T - 1 : 0);
  // Step s reads h buffer s & 1, which the blocks of the cluster fill during
  // step s - 1: each sends its slice of the tile, Bt * U values in all.
  const unsigned bar0 = smem_addr(&h_bar[0]), bar1 = smem_addr(&h_bar[1]);
  const unsigned h_bytes = (unsigned)(Bt * U * sizeof(W));
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (T > 1) mbar_expect(bar1, h_bytes);  // step 1's h
    if (T > 2) mbar_expect(bar0, h_bytes);  // step 2's h
  }
  // no block may store into a peer before that peer has zeroed its buffers
  // and set up its barriers
  cluster.sync();

  // clocks (optional, 4 counters): SM cycles thread 0 of block (0, 0) spent in
  // the product, the cell update with its stores to the peers, the output
  // stores and prefetch, and the wait for the peers' h
  const bool timed = clocks != nullptr && tid == 0 && blockIdx.x == 0 && blockIdx.y == 0;
  long long tick = timed ? clock64() : 0;
  auto lap = [&](int i) {
    if (timed) {
      const long long now = clock64();
      clocks[i] += now - tick;
      tick = now;
    }
  };
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    const int cur = step & 1, nxt = cur ^ 1;
    if (step > 0) {
      // the h of this step has landed; the buffer's barrier then expects the
      // h of step + 2. A peer's stores for it may come first: a peer is at
      // most one step ahead, and only after it has read what this block
      // sends in this step, so the buffer is no longer read when they land.
      const unsigned bar = cur ? bar1 : bar0;
      mbar_wait(bar, ((step - 1) >> 1) & 1);
      if (tid == 0 && step + 2 < T) mbar_expect(bar, h_bytes);
    }
    lap(3);
    if (BF) {
      const __nv_bfloat16* hb = reinterpret_cast<const __nv_bfloat16*>(h_s) + cur * hbuf;
      if (plan.resident)
        product_bf16(reinterpret_cast<const __nv_bfloat16*>(w_s), L.ldw, hb, L.ldh, part_s,
                     L.Kp, Bt, Nc);
      else
        product_bf16(reinterpret_cast<const __nv_bfloat16*>(wg), L.ldw, hb, L.ldh, part_s,
                     L.Kp, Bt, Nc);
    } else {
      const float* hb = reinterpret_cast<const float*>(h_s) + cur * hbuf;
      if (plan.resident)
        product_f32(reinterpret_cast<const float*>(w_s), hb, part_s, U, Bt, Nc, KS);
      else
        product_f32(reinterpret_cast<const float*>(wg), hb, part_s, U, Bt, Nc, KS);
    }
    cp_async_wait_but_one();
    __syncthreads();
    lap(0);

    // cell update of this block's units, and its h slice to every block
    const float* xt = xp_s + (step % XP_RING) * L.xp_tile;
    for (int q = tid; q < np; q += FWD_THREADS) {
      const int row = q / upn, u0 = (q - row * upn) * 2;
      float gate[4][2];
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        const int col = row * Nc + gi * Us + u0;
        float2 s = *reinterpret_cast<const float2*>(part_s + col);
        for (int ks = 1; ks < KS; ++ks) {
          const float2 p = *reinterpret_cast<const float2*>(part_s + (size_t)ks * Bt * Nc + col);
          s.x += p.x, s.y += p.y;
        }
        const float2 x = *reinterpret_cast<const float2*>(xt + col);
        gate[gi][0] = x.x + s.x, gate[gi][1] = x.y + s.y;
      }
      const float m = xt[Bt * Nc + row];
      const float2 c2 = *reinterpret_cast<const float2*>(c_st + row * Us + u0);
      const float2 hp2 = *reinterpret_cast<const float2*>(h_st + row * Us + u0);
      float cv[2] = {c2.x, c2.y}, hv[2] = {hp2.x, hp2.y}, ov[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float c_new = sigmoidf_(gate[1][i] + forget_bias) * cv[i] +
                            sigmoidf_(gate[0][i]) * tanhf(gate[2][i]);
        const float h_new = sigmoidf_(gate[3][i]) * tanhf(c_new);
        hv[i] = m * h_new + (1.0f - m) * hv[i];
        cv[i] = m * c_new + (1.0f - m) * cv[i];
        ov[i] = m * h_new;
      }
      const float2 h2 = make_float2(hv[0], hv[1]);
      *reinterpret_cast<float2*>(c_st + row * Us + u0) = make_float2(cv[0], cv[1]);
      *reinterpret_cast<float2*>(h_st + row * Us + u0) = h2;
      *reinterpret_cast<float2*>(o_st + row * Us + u0) = make_float2(ov[0], ov[1]);
      // the last step's h is only the final state: nobody waits for it
      if (step + 1 < T) {
        W* mine = h_s + nxt * hbuf + row * L.ldh + rank * Us + u0;
        const unsigned dst = smem_addr(mine), bar = nxt ? bar1 : bar0;
        for (int r = 0; r < C; ++r) store2_async(peer_addr(dst, r), peer_addr(bar, r), mine, h2);
      }
    }
    lap(1);

    // while the slices travel: this step's output, the next step's
    // residuals and xp tile
    for (int q = tid; q < np; q += FWD_THREADS) {
      const int row = q / upn, u0 = (q - row * upn) * 2;
      if (row0 + row < B)
        *reinterpret_cast<float2*>(out + ((size_t)t * B + row0 + row) * U + rank * Us + u0) =
            *reinterpret_cast<const float2*>(o_st + row * Us + u0);
    }
    if (SAVE_RES && step + 1 < T) save_state(reverse ? t - 1 : t + 1);
    if (step + 2 < T) prefetch(reverse ? t - 2 : t + 2, (step + 2) % XP_RING);
    else cp_async_commit();
    // part_s and the xp tile are free for the next step once every thread
    // has left the cell update
    __syncthreads();
    lap(2);
  }
  cluster.sync();  // no block leaves while a peer may still address it
  for (int q = tid; q < np; q += FWD_THREADS) {
    const int row = q / upn, u0 = (q - row * upn) * 2;
    if (row0 + row >= B) continue;
    const size_t idx = (size_t)(row0 + row) * U + rank * Us + u0;
    *reinterpret_cast<float2*>(a.hfin[d] + idx) =
        *reinterpret_cast<const float2*>(h_st + row * Us + u0);
    *reinterpret_cast<float2*>(a.cfin[d] + idx) =
        *reinterpret_cast<const float2*>(c_st + row * Us + u0);
  }
}

// ------------------------------------------------------------------- VJP

struct BwdArgs {
  const float* xp[2];     // [T, B, 4U]
  const void* wh[2];      // [U, 4U] W
  const void* wht[2];     // [4U, U] W
  const void* hprev[2];   // [T, B, U] W
  const void* cprev[2];   // [T, B, U] W
  const float* dout[2];   // [T, B, U]
  const float* dhfin[2];  // [B, U]
  const float* dcfin[2];
  float* dxp[2];          // [T, B, 4U]: recomputed gates, then their gradients
  float* dwh[2];          // [U, 4U]
  int reverse[2];
};

// tiles of the two GEMMs: BM x BN outputs, BK-deep chunks, 256 threads,
// thread (tx, ty) computes rows ty + 16*i and columns tx + 16*j (i, j < 4)
constexpr int BM = 64, BN = 64, BK = 16, GEMM_THREADS = 256;

// 1. gates[m, n] = xp[m, n] + sum_k hprev[m, k] * Wh[k, n], M = T*B, K = U, N = 4U
template <typename W>
__global__ void __launch_bounds__(GEMM_THREADS)
gates_kernel(BwdArgs a, int M, int K, int N) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int d = blockIdx.z;
  const W* __restrict__ A = static_cast<const W*>(a.hprev[d]);
  const W* __restrict__ Bw = static_cast<const W*>(a.wh[d]);
  const float* __restrict__ xp = a.xp[d];
  float* __restrict__ C = a.dxp[d];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / GEMM_THREADS; ++i) {
      const int e = tid + GEMM_THREADS * i, row = e / BK, kk = e % BK;
      const int m = m0 + row, k = k0 + kk;
      As[kk][row] = (m < M && k < K) ? to_f(A[(long)m * K + k]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / GEMM_THREADS; ++i) {
      const int e = tid + GEMM_THREADS * i, kk = e / BN, col = e % BN;
      const int k = k0 + kk, n = n0 + col;
      Bs[kk][col] = (k < K && n < N) ? to_f(Bw[(long)k * N + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = Bs[kk][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx + 16 * jj;
      if (n < N) C[(long)m * N + n] = xp[(long)m * N + n] + acc[i][jj];
    }
  }
}

// 2. the serial reverse-time loop (see the header)
template <typename W>
__global__ void __launch_bounds__(1024)
bwd_loop_kernel(BwdArgs a, const float* __restrict__ mask, int T, int B, int U,
                float forget_bias) {
  extern __shared__ float smem[];
  const int d = blockIdx.y;
  const W* __restrict__ wht = static_cast<const W*>(a.wht[d]);
  const W* __restrict__ cprev = static_cast<const W*>(a.cprev[d]);
  const float* __restrict__ dout = a.dout[d];
  float* __restrict__ dxp = a.dxp[d];
  const bool reverse = a.reverse[d] != 0;

  const int G = 4 * U;
  float* dg_s = smem;              // [R, 4U] dgates as the dot reads them
  float* part_s = smem + R * G;    // [4, R, U] partial sums of dgates @ Wh^T
  const int j = threadIdx.x;
  const int pr = j / U, pu = j - (j / U) * U;  // pair (row, unit); also (quarter, unit)
  const int prow = blockIdx.x * R + pr;
  const bool live = prow < B;
  float dh = live ? a.dhfin[d][(long)prow * U + pu] : 0.0f;
  float dc = live ? a.dcfin[d][(long)prow * U + pu] : 0.0f;

  for (int step = 0; step < T; ++step) {
    const int t = reverse ? step : T - 1 - step;  // opposite order to the forward
    float m = 0.0f;
    float* dgr = dg_s + pr * G;
    if (live) {
      const long row = (long)t * B + prow;
      float* g = dxp + row * G;
      const float gi = g[pu], gf = g[U + pu], gg = g[2 * U + pu], go = g[3 * U + pu];
      m = mask[row];
      const float cp = to_f(cprev[row * U + pu]);
      const float si = sigmoidf_(gi), sf = sigmoidf_(gf + forget_bias);
      const float sg = tanhf(gg), so = sigmoidf_(go);
      const float c_new = sf * cp + si * sg;
      const float tch = tanhf(c_new);
      const float dh_tot = m * (dout[row * U + pu] + dh);
      const float dc_new = m * dc + dh_tot * so * (1.0f - tch * tch);
      const float d_o = dh_tot * tch * so * (1.0f - so);
      const float d_f = dc_new * cp * sf * (1.0f - sf);
      const float d_i = dc_new * sg * si * (1.0f - si);
      const float d_g = dc_new * si * (1.0f - sg * sg);
      g[pu] = d_i;
      g[U + pu] = d_f;
      g[2 * U + pu] = d_g;
      g[3 * U + pu] = d_o;
      dgr[pu] = dot_in<W>(d_i);
      dgr[U + pu] = dot_in<W>(d_f);
      dgr[2 * U + pu] = dot_in<W>(d_g);
      dgr[3 * U + pu] = dot_in<W>(d_o);
      dc = (1.0f - m) * dc + dc_new * sf;
    } else {
      dgr[pu] = dgr[U + pu] = dgr[2 * U + pu] = dgr[3 * U + pu] = 0.0f;
    }
    __syncthreads();

    // quarter q = pr of the 4U gate columns, for unit pu, over all R rows
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    const int k0 = pr * U;
#pragma unroll 8
    for (int k = k0; k < k0 + U; ++k) {
      const float w = to_f(wht[(long)k * U + pu]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(dg_s[r * G + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) part_s[(pr * R + r) * U + pu] = acc[r];
    __syncthreads();

    if (live) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) s += part_s[(q * R + pr) * U + pu];
      dh = (1.0f - m) * dh + s;
    }
  }
}

// 3a. partial[s][u, n] = sum over rows m of split s of hprev[m, u] * dgates[m, n]
template <typename W>
__global__ void __launch_bounds__(GEMM_THREADS)
dwh_partial_kernel(BwdArgs a, float* __restrict__ partials, int M, int U, int N,
                   int ksplit, int chunk) {
  __shared__ float As[BK][BM];
  __shared__ float Gs[BK][BN];
  const int d = blockIdx.z / ksplit, s = blockIdx.z % ksplit;
  const W* __restrict__ A = static_cast<const W*>(a.hprev[d]);
  const float* __restrict__ Gm = a.dxp[d];
  const int n0 = blockIdx.x * BN, u0 = blockIdx.y * BM;
  const int mbeg = s * chunk, mend = min(M, mbeg + chunk);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = mbeg; k0 < mend; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BK * BM / GEMM_THREADS; ++i) {
      const int e = tid + GEMM_THREADS * i, kk = e / BM, col = e % BM;
      const int m = k0 + kk, u = u0 + col;
      As[kk][col] = (m < mend && u < U) ? to_f(A[(long)m * U + u]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / GEMM_THREADS; ++i) {
      const int e = tid + GEMM_THREADS * i, kk = e / BN, col = e % BN;
      const int m = k0 + kk, n = n0 + col;
      Gs[kk][col] = (m < mend && n < N) ? dot_in<W>(Gm[(long)m * N + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = Gs[kk][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
  float* P = partials + ((long)d * ksplit + s) * U * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = u0 + ty + 16 * i;
    if (u >= U) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx + 16 * jj;
      if (n < N) P[(long)u * N + n] = acc[i][jj];
    }
  }
}

// 3b. dwh = sum over s of partial[s], in order
__global__ void dwh_reduce_kernel(BwdArgs a, const float* __restrict__ partials,
                                  int ksplit, long size) {
  const int d = blockIdx.y;
  const float* P = partials + (long)d * ksplit * size;
  float* dwh = a.dwh[d];
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < ksplit; ++k) s += P[(long)k * size + i];
    dwh[i] = s;
  }
}

bool bad_shape(int nd, int T, int B, int U) {
  return nd < 1 || nd > 2 || T <= 0 || B <= 0 || 4 * U > 1024 || (4 * U) % 32 != 0;
}

// what the forward kernel takes: C divides U into slices of a multiple of 8
// units (16-byte column groups, 8-column mma tiles), tiles of 8 or 16 rows,
// and a layout that fits a block's shared memory
bool bad_plan(int U, FwdPlan p, bool bf) {
  if (p.C < 1 || p.C > 16 || U % p.C || (U / p.C) % 8) return true;
  if (p.Bt != 8 && p.Bt != 16) return true;
  if (p.KS < 1 || p.KS > 16 || (bf && p.KS != 1)) return true;
  if (!p.resident && p.C != 1) return true;
  return fwd_layout(U, p, bf).total > SMEM_MAX;
}

template <typename W, bool SAVE_RES>
cudaError_t prepare_fwd(int U, FwdPlan p, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const bool bf = std::is_same<W, __nv_bfloat16>::value;
  auto kernel = lstm_fwd_kernel<W, SAVE_RES>;
  const size_t smem = fwd_layout(U, p, bf).total;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           p.C > 8 ? 1 : 0);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(FWD_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename W, bool SAVE_RES>
int launch_fwd(const FwdArgs& a, const float* mask, int nd, int T, int B, int U, FwdPlan p,
               float fb, long long* clocks, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = prepare_fwd<W, SAVE_RES>(U, p, &cfg, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3(p.C * ((B + p.Bt - 1) / p.Bt), nd);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, lstm_fwd_kernel<W, SAVE_RES>, a, mask, T, B, U, p, fb, clocks);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// out[0..3] = clusters of this plan the card can run at once, dynamic shared
// memory bytes, registers a thread, static shared memory bytes
template <typename W, bool SAVE_RES>
int info_fwd(int U, FwdPlan p, int* out) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = prepare_fwd<W, SAVE_RES>(U, p, &cfg, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3(p.C * 64, 1);
  auto kernel = lstm_fwd_kernel<W, SAVE_RES>;
  e = cudaOccupancyMaxActiveClusters(&out[0], kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[1] = (int)cfg.dynamicSmemBytes;
  out[2] = fa.numRegs;
  out[3] = (int)fa.sharedSizeBytes;
  return 0;
}

template <bool SAVE_RES>
int fwd_entry(const float* xp0, const float* xp1, const float* mask, const void* wh0,
              const void* wh1, int nd, int rev_bits, int wh_bf16, float* out0,
              float* out1, void* hprev0, void* hprev1, void* cprev0, void* cprev1,
              float* hfin0, float* hfin1, float* cfin0, float* cfin1, int T, int B,
              int U, float fb, FwdPlan p, long long* clocks, void* stream) {
  if (bad_shape(nd, T, B, U) || bad_plan(U, p, wh_bf16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{{xp0, xp1}, {wh0, wh1}, {out0, out1}, {hprev0, hprev1},
            {cprev0, cprev1}, {hfin0, hfin1}, {cfin0, cfin1},
            {rev_bits & 1, (rev_bits >> 1) & 1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wh_bf16) return launch_fwd<__nv_bfloat16, SAVE_RES>(a, mask, nd, T, B, U, p, fb, clocks, s);
  return launch_fwd<float, SAVE_RES>(a, mask, nd, T, B, U, p, fb, clocks, s);
}

template <typename W>
int launch_bwd(const BwdArgs& a, const float* mask, float* partials, int nd,
               int ksplit, int T, int B, int U, float fb, cudaStream_t stream) {
  const int M = T * B, N = 4 * U;
  gates_kernel<W><<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM, nd), GEMM_THREADS, 0,
                    stream>>>(a, M, U, N);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const size_t smem = sizeof(float) * (size_t)R * 8 * U;
  bwd_loop_kernel<W><<<dim3((B + R - 1) / R, nd), 4 * U, smem, stream>>>(a, mask, T, B,
                                                                       U, fb);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int chunk = ((M + ksplit - 1) / ksplit + BK - 1) / BK * BK;
  dwh_partial_kernel<W><<<dim3((N + BN - 1) / BN, (U + BM - 1) / BM, nd * ksplit),
                          GEMM_THREADS, 0, stream>>>(a, partials, M, U, N, ksplit, chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long size = (long)U * N;
  const long want = (size + 255) / 256;
  const int blocks = want < 1024 ? (int)want : 1024;
  dwh_reduce_kernel<<<dim3(blocks, nd), 256, 0, stream>>>(a, partials, ksplit, size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// one or two directions of the recurrence -> out, final (h, c). wh0/wh1 are
// regrouped by unit slice for `cluster` blocks (see the header); cluster,
// bt, ksplit and resident are the caller's plan for the launch; clocks is
// null or 4 cycle counters the kernel adds to (see the kernel).
extern "C" int plt_lstm_recurrence(const float* xp0, const float* xp1, const float* mask,
                                   const void* wh0, const void* wh1, int nd, int rev_bits,
                                   int wh_bf16, float* out0, float* out1, void* hprev0,
                                   void* hprev1, void* cprev0, void* cprev1, float* hfin0,
                                   float* hfin1, float* cfin0, float* cfin1, int T, int B,
                                   int U, float forget_bias, int cluster, int bt, int ksplit,
                                   int resident, long long* clocks, void* stream) {
  return fwd_entry<false>(xp0, xp1, mask, wh0, wh1, nd, rev_bits, wh_bf16, out0, out1,
                          hprev0, hprev1, cprev0, cprev1, hfin0, hfin1, cfin0, cfin1, T,
                          B, U, forget_bias, FwdPlan{cluster, bt, ksplit, resident}, clocks, stream);
}

// as plt_lstm_recurrence, plus the carried state before each step
extern "C" int plt_lstm_residual(const float* xp0, const float* xp1, const float* mask,
                                 const void* wh0, const void* wh1, int nd, int rev_bits,
                                 int wh_bf16, float* out0, float* out1, void* hprev0,
                                 void* hprev1, void* cprev0, void* cprev1, float* hfin0,
                                 float* hfin1, float* cfin0, float* cfin1, int T, int B,
                                 int U, float forget_bias, int cluster, int bt, int ksplit,
                                 int resident, long long* clocks, void* stream) {
  return fwd_entry<true>(xp0, xp1, mask, wh0, wh1, nd, rev_bits, wh_bf16, out0, out1,
                         hprev0, hprev1, cprev0, cprev1, hfin0, hfin1, cfin0, cfin1, T,
                         B, U, forget_bias, FwdPlan{cluster, bt, ksplit, resident}, clocks, stream);
}

// what the card gives a plan of the forward kernel: info[0] = clusters it
// can run at once (cudaOccupancyMaxActiveClusters), info[1] = dynamic shared
// memory bytes a block, info[2] = registers a thread, info[3] = static
// shared memory bytes
extern "C" int plt_lstm_fwd_info(int U, int wh_bf16, int save_res, int cluster, int bt,
                                 int ksplit, int resident, int* info) {
  const FwdPlan p{cluster, bt, ksplit, resident};
  if (bad_plan(U, p, wh_bf16 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (wh_bf16)
    return save_res ? info_fwd<__nv_bfloat16, true>(U, p, info)
                    : info_fwd<__nv_bfloat16, false>(U, p, info);
  return save_res ? info_fwd<float, true>(U, p, info) : info_fwd<float, false>(U, p, info);
}

// the VJP: dxp [T, B, 4U] and dWh [U, 4U] for each direction; partials is
// scratch of nd*ksplit*U*4U floats
extern "C" int plt_lstm_bwd(const float* xp0, const float* xp1, const float* mask,
                            const void* wh0, const void* wh1, const void* wht0,
                            const void* wht1, const void* hprev0, const void* hprev1,
                            const void* cprev0, const void* cprev1, const float* dout0,
                            const float* dout1, const float* dhfin0, const float* dhfin1,
                            const float* dcfin0, const float* dcfin1, int nd, int rev_bits,
                            int wh_bf16, float* dxp0, float* dxp1, float* dwh0,
                            float* dwh1, float* partials, int ksplit, int T, int B, int U,
                            float forget_bias, void* stream) {
  if (bad_shape(nd, T, B, U) || ksplit < 1) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{{xp0, xp1},       {wh0, wh1},       {wht0, wht1},   {hprev0, hprev1},
            {cprev0, cprev1}, {dout0, dout1},   {dhfin0, dhfin1}, {dcfin0, dcfin1},
            {dxp0, dxp1},     {dwh0, dwh1},     {rev_bits & 1, (rev_bits >> 1) & 1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wh_bf16)
    return launch_bwd<__nv_bfloat16>(a, mask, partials, nd, ksplit, T, B, U, forget_bias, s);
  return launch_bwd<float>(a, mask, partials, nd, ksplit, T, B, U, forget_bias, s);
}
