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
// C = 1 is one block that owns every unit. Where a cut of U fits a block
// only without its slice of Wh (e.g. a U of a prime number of 8-unit
// slices), the planner takes the grid layout below. (The template's former
// streamed slice, each step's Wh from L2 by the threads' 16-byte loads, read
// 2-3x slower than the grid layout at the widths it served: PERF.md.)
//
// Past the resident widths (float32 past U = 256, bf16 past 384; the
// constants are ops/lstm.py's) the forward takes the grid layout
// (lstm_grid_kernel, lstm_grid_bf16_kernel, lstm_grid_mma_kernel, below) up
// to MAX_UNITS = 2048: a cluster has no room for its slices there, so the
// whole card holds Wh. One cooperative launch of one block an SM, each
// block a run of units with its slice of Wh in shared memory as far as it
// fits (at U = 1024 both directions of bf16 Wh, 16.8 MB, fit the 132 SMs;
// float32, 33.5 MB, about half of it), and only h moves each step: written
// by its blocks into global memory, each chunk of it published on a
// readiness counter, and taken in chunk by chunk by every block of its
// direction through a ring of bulk copies that overlaps the product, a
// chunk copied as soon as its writers have published it (no grid barrier).
// The product: float32 on true FMAs (8 columns by 4 or 8 rows a thread, h
// k-major); bf16 on wgmma (both operands in its canonical swizzled layout)
// or, where the planner measured it faster, on mma.sync in the fragments'
// order. The first form of this layout (one grid barrier a step, a unit a
// thread in float32) beat in turns both routes it replaced, the rings and
// the template's streamed slice past U = 256, and this one beat it
// (PERF.md). Multicast of h to clusters of 2 read slower on the H100 and is
// not used. U is a multiple of 8 up to MAX_UNITS = 2048; the caller
// chooses the route and its cut from the shape, pads any other U with zeros
// to one that a plan takes, and this file refuses what does not fit.
//
// Predictions for the grid layout, from the planner's step cost
// (ops/lstm.py::_grid_step_cycles) and from cycle counts, before the first
// timed runs, and the measurements, are in PERF.md.
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
// launched in this order on one stream:
//   1. gates = xp + hprev @ Wh over all T*B rows: the rows are independent,
//      so a tiled GEMM (128x128 tiles, 16-deep k chunks, 8x8 outputs a
//      thread). Its epilogue holds the four gates of a unit in one thread and
//      turns them, with cprev, into everything a step needs that does not
//      depend on dh: six factors a (row, unit),
//        Fi = sg*si*(1-si), Ff = cp*sf*(1-sf), Fg = si*(1-sg^2),
//        Fo = tanh(c')*so*(1-so), A = so*(1-tanh(c')^2), sf
//      (si, sf, sg, so the gate activations, c' = sf*cp + si*sg), written
//      into dxp (the first four, at their gate's column) and a scratch array;
//   2. the serial loop, opposite in time to the forward, per step:
//        dh'     = m*(dout + dh)
//        dc'     = m*dc + dh'*A
//        dgates  = [dc'*Fi, dc'*Ff, dc'*Fg, dh'*Fo]   (zero at masked steps)
//        dxp[t]  = dgates                             (over the factors)
//        dh_prev = (1-m)*dh + dgates @ Wh^T
//        dc_prev = (1-m)*dc + dc'*sf
//   3. dWh = sum_t hprev_t^T dgates_t over T*B rows as a split-K GEMM of the
//      same tiling: each block writes the partial sum of its row range, and
//      a second kernel adds the partials in a fixed order, so repeated runs
//      are bitwise equal (no float atomics).
// In bf16 mode (Wh in bf16) the operands of every dot are bf16 values (h,
// hprev and dgates rounded) with float32 accumulation; xp and dxp stay
// float32 (the reference streams them bf16). The two GEMMs then run on the
// tensor cores (gates_kernel_tc, dwh_partial_kernel_tc: mma.sync.m16n8k16,
// fragments by ldmatrix); in float32 mode they are true float32 FMAs.
//
// Design of the serial loop: lstm_bwd_kernel<W>, the forward's cluster
// design carried over. A cluster of C blocks runs one direction for a tile
// of Bt rows over all T steps; block c owns units [c*U/C, (c+1)*U/C) and
// their four gate columns, so dgates, dc and the store of dxp[t] for those
// units are local. The dot dgates @ Wh^T is cut by k: block c multiplies
// its own 4*U/C dgate columns by the matching rows of Wh^T (the slice
// regroup_wh builds for the forward, transposed for the float32 product)
// into a partial dh for ALL U units, and sends each peer the [Bt, U/C]
// part that peer owns; a block adds the C partials in rank order, so the
// sum is the same in every run. That exchange is Bt*U float32 values a
// step and block, the forward's volume; the other cut (a block owns output
// units and needs all 4U dgates of the tile) would move four times as much.
// The slice of Wh^T (128 KB float32, 68 KB bf16 at U = 256, C = 8) is
// copied into shared memory once. Per step a block
//   1. waits until the C partials of its units have landed (st.async onto a
//      transaction barrier, the partials double-buffered, no cluster-wide
//      barrier), adds them to the dh it kept, and forms dh', dc', dgates
//      and the new dc from the step's factors: a dozen FMAs a (row, unit);
//      dgates go to shared memory as the product reads them and to dxp[t];
//   2. multiplies: float32 with product_f32 (true float32 FMAs, k split
//      over the warps), bf16 with product_bf16 on the tensor cores;
//   3. adds the k parts and sends the partial dh to its owners, 16 bytes a
//      store;
//   4. while they travel, requests the factors, dout and mask of the step
//      after the next (cp.async into the tile this step has just used).
// The sigmoids and tanhs are off the serial chain altogether. (The loop's
// first form computed the next step's factors in part 4; the cycle counters
// showed that the partials arrive in a few hundred cycles, so those 2.6 k
// cycles a step stood on the chain, and they moved into kernel 1.) The gate
// recompute stays a separate GEMM: its rows are independent, and inside the
// loop it would double the loop's product.
// C = 1 serves the widths no cluster divides (U = 40; at U = 248 the slice
// streams from L2); past U = 256 in float32 the slices of a cluster stream
// from L2 at every step by the threads' loads, up to GRID_UNITS_BWD = 512
// (ops/lstm.py: on the H100 the template read faster there, PERF.md). Past
// it in float32, and past RING_UNITS_BF16 = 384 in bf16, the loop takes the
// grid layout (lstm_bwd_grid_kernel, lstm_bwd_grid_bf16_kernel, below: the
// whole card holds Wh^T, the gate gradients move) up to MAX_UNITS = 2048. It
// replaced the rings (a cluster of 16 that streamed its whole slice of Wh^T
// from L2 every step), which it beat in turns at every shape they served
// (PERF.md). The caller chooses the route, C, Bt, the k split and residency
// (the grid layout's cut) from the shape (ops/lstm.py::backward_plan); this
// file refuses what does not fit. The two GEMMs take any U of the range
// (columns by blocks of 32 units, rows of T*B).
//
// Prediction, made before the first run on the card (H100, T = 999, B = 32,
// U = 256, both directions, C = 8, Bt = 8: 8 clusters): the loop's product
// is 8*128*256 FMA a step and block, 2.0 k cycles at the SM's FMA rate, the
// forward's product at this shape; with the two block barriers, the
// exchange and the short step 1, a float32 step should take 5-6.5 us
// (forward at this shape: 5.5 us), the loop 5-6.5 ms, and with the two
// GEMMs as they are (about 2 ms each) the VJP 9-10.5 ms against 29.1 ms.
// bf16: 3.5-4.5 us a step, the VJP 7.5-8.5 ms. The measurements are in
// PERF.md.
//
// Bounds of the VJP (67 TFLOP/s float32, 3.35 TB/s) at the training shape
// (B = 32, T = 999, both directions): three products of 33.5 GFLOP
// (1.5 ms) against 0.72 GB (0.21 ms); operations bound it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "grid_sync.cuh"

namespace cg = cooperative_groups;

namespace {

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
// the gate activations of a step, in Wh's mode: float32 as sigmoidf_ and
// tanhf; bf16 (its dots already rounded to bf16, a few 1e-3 off) by the fast
// exponential and division (relative errors near 1e-6), a few times fewer
// instructions on the cell update that every step waits for
template <typename W>
__device__ __forceinline__ float gate_sigmoid(float x) {
  if constexpr (std::is_same<W, float>::value) return sigmoidf_(x);
  else return __fdividef(1.0f, 1.0f + __expf(-x));
}
template <typename W>
__device__ __forceinline__ float gate_tanh(float x) {
  if constexpr (std::is_same<W, float>::value) return tanhf(x);
  else return 2.0f * gate_sigmoid<W>(2.0f * x) - 1.0f;
}

// n / d for the small index ranges of a step (n < 2^32 / d, d >= 2) as one
// multiply: the divisors are run-time values, and a step pays for every
// instruction T times
struct Div {
  unsigned d, magic;
  __device__ explicit Div(int div) : d((unsigned)div), magic((unsigned)((0x100000000ull + div - 1) / div)) {}
  __device__ __forceinline__ int quot(int n) const { return (int)__umulhi((unsigned)n, magic); }
};

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
  int C;   // blocks of a cluster = slices of the units
  int Bt;  // batch rows of a cluster's tile (8 or 16)
  int KS;  // float32: parts the k range is split into
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
  L.ldw = bf ? L.Kp + 8 : L.Nc;
  size_t off = 0;
  L.w = off;
  off += bf ? (size_t)L.Nc * L.ldw * 2 : (size_t)U * L.Nc * 4;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// four float32 values into a peer, counted on its barrier
__device__ __forceinline__ void store4_async(unsigned dst, unsigned bar, float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
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
  if (BF) {  // [Nc][Kp] -> rows padded to ldw
    const int cpr = L.Kp / 8;
    for (int i = tid; i < Nc * cpr; i += FWD_THREADS)
      *reinterpret_cast<uint4*>(w_s + (size_t)(i / cpr) * L.ldw + (i % cpr) * 8) =
          reinterpret_cast<const uint4*>(wg)[i];
  } else {
    for (int i = tid; i < U * Nc / 4; i += FWD_THREADS)
      reinterpret_cast<float4*>(w_s)[i] = reinterpret_cast<const float4*>(wg)[i];
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
      product_bf16(reinterpret_cast<const __nv_bfloat16*>(w_s), L.ldw, hb, L.ldh, part_s, L.Kp, Bt, Nc);
    } else {
      const float* hb = reinterpret_cast<const float*>(h_s) + cur * hbuf;
      product_f32(reinterpret_cast<const float*>(w_s), hb, part_s, U, Bt, Nc, KS);
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

// ------------------------------------------- the ring of bulk copies (the grid kernels' intake)
//
// A grid block's moving operand (and the chunks of its wh slice that do not
// fit in shared memory) arrive in chunks of whole k rows through a ring of
// shared-memory slots: one producer warp keeps the slots filled with bulk
// copies (cp.async.bulk, counted on a transaction barrier a slot), eight
// consumer warps multiply each chunk as it lands and release its slot.

constexpr int RING_WARPS = FWD_THREADS / 32;     // consumer warps
constexpr int RING_THREADS = FWD_THREADS + 32;   // and the producer warp

// `n` arrivals at once
__device__ __forceinline__ void mbar_arrive(unsigned bar, unsigned n) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(n) : "memory");
}
__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
// `bytes` from global memory into this block's shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar, unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy) : "memory");
}
// the consumer warps' own block barrier (the producer warp never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(FWD_THREADS) : "memory");
}

// ------------------------------------------------ the grid layout (past the resident widths)
//
// One cooperative launch of at most one block an SM takes a direction's
// units in runs of Us (a multiple of 8): block b
// owns units [s Us, (s + 1) Us) of direction b / (U / Us), s = b mod (U /
// Us), with the four gate columns of each side by side ([unit][gate]: a
// float4 of a k row of wh is one unit's i, f, g, o), so the cell update
// stays in the block. The block's column slice of wh (k padded to Kp with
// zero rows) is copied into shared memory once, before the time loop, as
// far as it fits beside the staging buffers: its first nres chunks of kc
// rows; the rest streams each step through the ring beside the h it
// multiplies. Only h moves every step: each block writes its units' h for
// the rows of the pass into a double-buffered h in global memory; the
// producer warp of every block of the direction takes it in chunk by chunk
// (k order) with bulk copies through the ring, so the product of one chunk
// overlaps the copy of the next. A chunk is copied once the blocks that
// write it have published it (one readiness counter a chunk, grid_sync.cuh):
// a step waits on the h it reads, not on a grid barrier (grid_steps says
// why the double buffer stays safe).
//
// The product. float32 (true float32 FMAs, fwd_product_f32): the k chunks
// are dealt to KS parts (chunk i to part i mod KS), each part 256 / KS
// consumer threads with two ring slots or more; a thread takes two units (8
// gate columns) and TR rows, sums its chunks in k order in registers, and
// the parts are added in part order in shared memory, so a launch is
// bitwise repeatable. bf16 (wgmma m64nNk16, float32 accumulators,
// fwd_product_bf16): wh and h in wgmma's canonical swizzled K-major layout,
// M the block's gate columns (zero rows up to whole tiles of 64), N the
// pass's rows; a warpgroup a part (or, with one part, half the M tiles). Gate math and cell state stay float32;
// hprev/cprev are rounded to Wh's type.
//
// Rows: a launch holds `rows` batch rows, a pass; a batch past them runs in
// passes of rows, a launch each (ops/lstm.py::grid_plan), each reading wh
// once a step.
//
// The VJP's loop (below) keeps this file's first grid design: a grid
// barrier a step (grid_produce), the products grid_product_f32 (a unit a
// thread, h rows padded by 16 bytes) and grid_product_bf16 (mma.sync on
// fragment-ordered operands).

constexpr int GRID_SLOTS_MAX = 16;
constexpr int GRID_WS_HEAD = 128;  // bytes of the workspace before the h buffers: the barrier's counter
constexpr size_t GRID_SMEM_MAX = SMEM_MAX - 1024;  // dynamic shared memory: the barriers are static

// how one grid launch cuts the work: the caller's plan, for one pass of rows
struct GridCut {
  int blocks;  // blocks of the launch: nd U / us
  int us;      // units a block (its cell update's)
  int rows;    // rows the layout holds: the pass's rows, zero rows past them
  int row0;    // the pass's first batch row
  int nrows;   // the pass's rows
  int tile;    // float32: rows a thread (TR); bf16: the VJP's 16-row tiles (MT), the forward's M tiles a warpgroup
  int ks;      // k parts: chunk i belongs to part i mod ks
  int kc;      // k rows of a chunk
  int kp;      // the k range, padded to a multiple of kc ks
  int nres;    // chunks of the block's wh slice held in shared memory
  int ns;      // ring slots, a multiple of ks
  int cl;      // blocks of a cluster (the VJP's loop; 1 in the forward)
};

// byte offsets of a block of the VJP's grid loop; ops/lstm.py::
// grid_bwd_smem_bytes mirrors it (the forward's: FwdGridLayout)
struct GridLayout {
  int Nc, ldh, ldp;             // the product's columns; float32: the row stride of a staged operand chunk;
                                // part_s's row stride
  size_t hchunk, wchunk, slot;  // bytes of a chunk of the moving operand (dgates), of Wh^T, and a ring slot
  int tile;                     // floats of a step's tile of factors
  size_t w, ring, part, recv, xp, cst, hst, total;
};

// the VJP's loop, whose product is [rows][cl us] (the partial dh of its
// cluster's units) over the 4 U / cl gate columns of its k piece; it keeps
// the cluster's partials, two tiles of factors and dh, dc
__host__ __device__ inline GridLayout grid_layout(const GridCut& g, bool bf) {
  GridLayout L;
  L.Nc = g.cl * g.us;
  L.ldp = L.Nc;
  L.ldh = g.kc + 4;  // 16 bytes of padding: a warp's row tiles read rows in other banks
  if (bf) {
    L.hchunk = (size_t)(g.kc / 16) * (g.rows / 16) * 512;  // [k steps][row tiles][32 lanes][8 bf16]
    L.wchunk = (size_t)(g.kc / 16) * (L.Nc / 8) * 256;     // [k steps][n-tiles][32 lanes][4 bf16]
  } else {
    L.hchunk = (size_t)g.rows * L.ldh * 4;  // [rows][kc + 4] floats
    L.wchunk = (size_t)g.kc * L.Nc * 4;     // [kc][Nc] floats
  }
  const bool streams = g.nres < g.kp / g.kc;
  L.slot = L.hchunk + (streams ? L.wchunk : 0);
  // [rows][4][us] factors Fi..Fo, then dout, A, sf [rows][us] each, then [rows] mask
  L.tile = (g.rows * 7 * g.us + g.rows + 3) / 4 * 4;
  size_t off = 0;
  L.w = off;
  off += (size_t)g.nres * L.wchunk;
  L.ring = off;
  off += (size_t)g.ns * L.slot;
  L.part = off;  // [rows][Nc]: the product, its parts added in order
  off += (size_t)g.rows * L.Nc * 4;
  L.recv = off;  // cl > 1: [2][cl][rows][us] the cluster's partial dh of this block's units
  if (g.cl > 1) off += (size_t)2 * g.cl * g.rows * g.us * 4;
  L.xp = off;
  off += (size_t)2 * L.tile * 4;
  L.cst = off;  // [rows][us] dc
  off += (size_t)g.rows * g.us * 4;
  L.hst = off;  // (1 - m) dh, what a row keeps of dh
  off += (size_t)g.rows * g.us * 4;
  L.total = off;
  return L;
}

// the VJP's loop's workspace: the barrier's counter, then two dgates
// buffers of every chunk of every piece of each direction; ops/lstm.py::
// grid_bwd_ws_bytes mirrors it
__host__ __device__ inline size_t grid_bwd_ws_bytes(int nd, const GridCut& g, bool bf) {
  return GRID_WS_HEAD + (size_t)2 * nd * g.cl * (g.kp / g.kc) * grid_layout(g, bf).hchunk;
}

// a bulk copy without a cache hint (a chunk of h is read once a step by each block of a direction)
__device__ __forceinline__ void bulk_load_plain(unsigned dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The producer of a grid block (one lane): for each of `steps` products,
// once every block has arrived at barrier step + after (none where that is
// 0), the operand chunks of the step in k order into the ring, each with
// its chunk of wh where that streams; the step's chunks lie at src, in the
// buffer of its parity (buf_bytes apart)
__device__ __forceinline__ void grid_produce(const GridCut& g, const GridLayout& L, int steps, int after,
                                             const unsigned char* src, size_t buf_bytes, const unsigned char* wg,
                                             const unsigned* bar, unsigned ring0, unsigned long long* full,
                                             unsigned long long* empty) {
  const unsigned long long keep = evict_last_policy();
  const int nch = g.kp / g.kc;
  int slot = 0, round = 0;
  for (int step = 0; step < steps; ++step) {
    if (step + after > 0) grid_wait(bar, (unsigned)(step + after) * gridDim.x);
    const unsigned char* hb = src + (size_t)(step & 1) * buf_bytes;
    for (int i = 0; i < nch; ++i) {
      if (round > 0) mbar_wait(smem_addr(&empty[slot]), (round - 1) & 1);
      const bool streamed = i >= g.nres;
      const unsigned fb = smem_addr(&full[slot]);
      const unsigned dst = ring0 + (unsigned)(slot * L.slot);
      mbar_expect(fb, (unsigned)(L.hchunk + (streamed ? L.wchunk : 0)));
      bulk_load_plain(dst, hb + (size_t)i * L.hchunk, (unsigned)L.hchunk, fb);
      if (streamed) bulk_load(dst + (unsigned)L.hchunk, wg + (size_t)i * L.wchunk, (unsigned)L.wchunk, fb, keep);
      if (++slot == g.ns) slot = 0, ++round;
    }
  }
}

// the set-up every grid kernel shares: zero the block's buffers, copy the
// resident chunks of its wh slice, set up the ring's barriers
__device__ __forceinline__ void grid_setup(const GridCut& g, const GridLayout& L, const unsigned char* wg,
                                           unsigned char* smem, unsigned long long* full,
                                           unsigned long long* empty, int empty_count) {
  const int tid = threadIdx.x;
  for (size_t i = L.part / 16 + tid; i < L.total / 16; i += RING_THREADS)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (size_t i = tid; i < (size_t)g.nres * L.wchunk / 16; i += RING_THREADS)
    reinterpret_cast<uint4*>(smem + L.w)[i] = reinterpret_cast<const uint4*>(wg)[i];
  if (tid == 0) {
    for (int s = 0; s < g.ns; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), empty_count);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The listener's forward in the grid layout: its shared-memory layout, the
// readiness of h, the producer, the two products and the step loop.
//
// A block's shared memory (ops/lstm.py::grid_smem_bytes mirrors it): the
// resident chunks of its wh slice, the ring's slots (a chunk of h, and of wh
// where some of it streams), the product [rows][Nc + 4] (4 floats of
// padding a row: the bf16 product's stores of one column land in other
// banks), the xp tile and mask, c, h and the step's out. bf16 operands lie in wgmma's
// canonical K-major layout with the 128-byte swizzle: a chunk of 64 k is,
// for each of its R rows (wh: the block's 4 us gate columns, zero rows up to
// whole M tiles of 64; h: the pass's rows), 128 bytes whose 16-byte groups are permuted by row mod 8 (group
// j of row r at j ^ (r & 7)), 8 rows a 1024-byte atom, so the regions start
// on 1024 bytes (the dynamic region is aligned at run time: 1024 bytes more
// are reserved). float32 h chunks are k-major, [kc][rows] floats: a warp's
// row tiles read neighbouring float4 without padding.
struct FwdGridLayout {
  int Nc, Ncp, ldp, nch;        // the product's columns (bf16: padded to whole M tiles of 64); part_s's row stride;
                                // chunks a step
  size_t hchunk, wchunk, slot;  // bytes of a chunk of h, of wh, and a ring slot
  int tile;                     // floats of a step's xp tile and mask
  size_t align;                 // bytes reserved to align the region (bf16)
  size_t w, ring, part, xp, cst, hst, ost, total;
};

// mma: the bf16 product on mma.sync (grid_product_bf16), its operands in the
// fragments' order, no M tiles to pad and no swizzle to align
__host__ __device__ inline FwdGridLayout fwd_grid_layout(const GridCut& g, bool bf, bool mma = false) {
  FwdGridLayout L;
  L.Nc = 4 * g.us;
  L.Ncp = bf && !mma ? (L.Nc + 63) / 64 * 64 : L.Nc;
  L.ldp = L.Nc + 4;
  L.nch = g.kp / g.kc;
  L.hchunk = (size_t)g.rows * g.kc * (bf ? 2 : 4);
  L.wchunk = (size_t)g.kc * L.Ncp * (bf ? 2 : 4);
  L.slot = L.hchunk + (g.nres < L.nch ? L.wchunk : 0);
  L.tile = (g.rows * L.Nc + g.rows + 3) / 4 * 4;
  L.align = bf && !mma ? 1024 : 0;
  size_t off = 0;
  L.w = off;
  off += (size_t)g.nres * L.wchunk;
  L.ring = off;
  off += (size_t)g.ns * L.slot;
  L.part = off;
  off += (size_t)g.rows * L.ldp * 4;
  L.xp = off;
  off += (size_t)L.tile * 4;
  L.cst = off;
  off += (size_t)g.rows * g.us * 4;
  L.hst = off;
  off += (size_t)g.rows * g.us * 4;
  L.ost = off;
  off += (size_t)g.rows * g.us * 4;
  L.total = off;
  return L;
}

// the forward's workspace: the readiness counters of every chunk of each
// direction (rounded to 128 bytes), then two h buffers of every chunk of
// each direction; ops/lstm.py::grid_ws_bytes mirrors it
__host__ __device__ inline size_t fwd_grid_head(int nd, int nch) { return ((size_t)4 * nd * nch + 127) / 128 * 128; }

// the blocks of a direction (us units each, per_dir of them) whose units
// fall in chunk ch of kc k rows: what its counter gains a step
__device__ __forceinline__ unsigned chunk_writers(int ch, int kc, int us, int per_dir) {
  const int first = ch * kc / us;
  if (first >= per_dir) return 0;  // k padding: never written, zero
  return (unsigned)(min(per_dir - 1, (ch * kc + kc - 1) / us) - first + 1);
}

// the forward's set-up: zero the block's buffers, copy the resident chunks
// of its wh slice (handed to the async proxy, which wgmma reads through),
// set up the ring's barriers (`readers`: the consumer threads that read a
// chunk)
__device__ __forceinline__ void fwd_grid_setup(const GridCut& g, const FwdGridLayout& L, const unsigned char* wg,
                                               unsigned char* smem, unsigned long long* full,
                                               unsigned long long* empty, int readers) {
  const int tid = threadIdx.x;
  for (size_t i = L.part / 16 + tid; i < L.total / 16; i += RING_THREADS)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (size_t i = tid; i < (size_t)g.nres * L.wchunk / 16; i += RING_THREADS)
    reinterpret_cast<uint4*>(smem + L.w)[i] = reinterpret_cast<const uint4*>(wg)[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < g.ns; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), readers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp of a forward grid block: each step's chunks of its
// direction's h in k order into the ring (lane 0 issues the copies), each
// copied once its counter says every block writing into it has stored the
// step's h (step 0's h is the zeroed buffer), each with its chunk of wh
// where that streams (requested first: it waits on nothing); the step's
// chunks lie at src, in the buffer of its parity (buf_bytes apart). The
// warp's lanes poll the counters of 32 chunks at once (one round trip to
// L2 for all), so a chunk found ready costs no wait of its own.
__device__ __forceinline__ void fwd_grid_produce(const GridCut& g, const FwdGridLayout& L, int T, int per_dir,
                                                 const unsigned char* src, size_t buf_bytes, const unsigned* ready,
                                                 const unsigned char* wg, unsigned ring0, unsigned long long* full,
                                                 unsigned long long* empty) {
  const int lane = threadIdx.x & 31;
  const unsigned long long keep = evict_last_policy();
  int slot = 0, round = 0;
  for (int step = 0; step < T; ++step) {
    const unsigned char* hb = src + (size_t)(step & 1) * buf_bytes;
    unsigned seen = 0;  // the chunks of the current 32 known to be ready
    for (int i = 0; i < L.nch; ++i) {
      const int bit = i & 31;
      const bool streamed = i >= g.nres;
      const unsigned fb = smem_addr(&full[slot]);
      const unsigned dst = ring0 + (unsigned)(slot * L.slot);
      if (lane == 0) {
        if (round > 0) mbar_wait(smem_addr(&empty[slot]), (round - 1) & 1);
        mbar_expect(fb, (unsigned)(L.hchunk + (streamed ? L.wchunk : 0)));
        if (streamed) bulk_load(dst + (unsigned)L.hchunk, wg + (size_t)i * L.wchunk, (unsigned)L.wchunk, fb, keep);
      }
      if (bit == 0) seen = step == 0 ? ~0u : 0u;
      if (!((seen >> bit) & 1)) {
        const int c = i - bit + lane;  // this lane's chunk of the 32
        seen = chunks_wait(ready + c, c < L.nch ? (unsigned)step * chunk_writers(c, g.kc, g.us, per_dir) : 0u, bit);
        if (lane == 0) asm volatile("fence.acq_rel.gpu;\n fence.proxy.async;\n" ::: "memory");
      }
      if (lane == 0) bulk_load_plain(dst, hb + (size_t)i * L.hchunk, (unsigned)L.hchunk, fb);
      if (++slot == g.ns) slot = 0, ++round;
    }
  }
}

// A forward grid block's consumer threads, step after step, around their
// product: the xp prefetch, `product(step, timed, first, later)` (the step's
// gate sums of the block into part_s; first and later gather the cycles
// thread 0 waited for the step's first chunk and for the others), the cell
// update with its stores of out, of h into the next h buffer (`put_h(buf,
// row, k, h)`, two units of a row) and of the residuals, the publication of
// the chunks it wrote, and the final state. W is Wh's type (the
// residuals').
//
// No grid barrier: a block raises the counters of the chunks it writes
// once its h of the step is stored, and a block's producer copies a chunk
// once its counter says so, so a step waits on the chunks it reads, in k
// order, and a direction never on the other. The double buffer stays safe:
// a block writes h(s + 1) (into the buffer of h(s - 1)) only after its
// product of step s, which took in every chunk of h(s), so every block of
// its direction had published h(s); a block publishes h(s) only after its
// own product of step s - 1, whose copies of every chunk of h(s - 1) had
// landed. So no block still reads h(s - 1) when any block writes h(s + 1).
template <typename W, class Product, class PutH>
__device__ __forceinline__ void grid_steps(const FwdArgs& a, const float* __restrict__ mask, int T, int B, int U,
                                           const GridCut& g, const FwdGridLayout& L, int d, int slice, float fb,
                                           unsigned* ready, unsigned char* smem, Product product, PutH put_h,
                                           long long* clocks) {
  const int tid = threadIdx.x, Us = g.us, Nc = L.Nc, ldp = L.ldp, rows = g.rows, G = 4 * U;
  const float* __restrict__ xp = a.xp[d];
  float* __restrict__ out = a.out[d];
  W* hprev = static_cast<W*>(a.hprev[d]);
  W* cprev = static_cast<W*>(a.cprev[d]);
  const bool reverse = a.reverse[d] != 0, save_res = hprev != nullptr;
  const float* part_s = reinterpret_cast<const float*>(smem + L.part);
  float* xp_s = reinterpret_cast<float*>(smem + L.xp);
  float* c_st = reinterpret_cast<float*>(smem + L.cst);
  float* h_st = reinterpret_cast<float*>(smem + L.hst);
  float* o_st = reinterpret_cast<float*>(smem + L.ost);
  const int uq = Us / 4, up = Us / 2, u_off = slice * Us;
  const int c0 = u_off / g.kc, c1 = (u_off + Us - 1) / g.kc;  // the chunks this block writes

  auto prefetch = [&](int t) {
    for (int i = tid; i < g.nrows * Us; i += FWD_THREADS) {
      const int row = i / Us, rem = i - row * Us;
      const int gate = rem / uq, j = rem - gate * uq;
      cp_async16(xp_s + row * Nc + gate * Us + 4 * j,
                 xp + ((size_t)t * B + g.row0 + row) * G + gate * U + u_off + 4 * j);
    }
    for (int r = tid; r < g.nrows; r += FWD_THREADS) cp_async4(xp_s + rows * Nc + r, mask + (size_t)t * B + g.row0 + r);
    cp_async_commit();
  };
  prefetch(reverse ? T - 1 : 0);
  if (save_res)  // the state before the first step
    for (int q = tid; q < g.nrows * up; q += FWD_THREADS) {
      const int row = q / up, u0 = (q - row * up) * 2;
      const size_t idx = ((size_t)(reverse ? T - 1 : 0) * B + g.row0 + row) * U + u_off + u0;
      store2(hprev + idx, make_float2(0.0f, 0.0f));
      store2(cprev + idx, make_float2(0.0f, 0.0f));
    }

  // clocks (optional, 5 counters): SM cycles thread 0 of block 0 spent in 0
  // the product, 1 the cell update with its stores of h, 2 the
  // publication, the stores of out and the residuals and the prefetch, 3
  // the wait for the step's first chunk (its writers and its copy), 4 the
  // waits for later chunks
  const bool timed = clocks != nullptr && tid == 0 && blockIdx.x == 0;
  long long tick = timed ? clock64() : 0;
  long long spent[5] = {};
  auto lap = [&](int i) {
    if (timed) {
      const long long now = clock64();
      spent[i] += now - tick;
      tick = now;
    }
  };
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    long long first = 0, later = 0;
    product(step, timed, first, later);
    lap(0);
    if (timed) spent[0] -= first + later, spent[3] += first, spent[4] += later;

    // the cell update of this block's units, four units of a row an item (four
    // independent chains): h into the next h buffer first, so the
    // publication waits on those stores alone
    for (int q = tid; q < rows * uq; q += FWD_THREADS) {
      const int row = q / uq, u0 = (q - row * uq) * 4;
      const float* ps = part_s + row * ldp + 4 * u0;
      const float* xr = xp_s + row * Nc + u0;
      const float4 x4[4] = {*reinterpret_cast<const float4*>(xr), *reinterpret_cast<const float4*>(xr + Us),
                            *reinterpret_cast<const float4*>(xr + 2 * Us),
                            *reinterpret_cast<const float4*>(xr + 3 * Us)};
      const float m = xp_s[rows * Nc + row];
      const float4 c4 = *reinterpret_cast<const float4*>(c_st + row * Us + u0);
      const float4 h4 = *reinterpret_cast<const float4*>(h_st + row * Us + u0);
      const float xg[4][4] = {{x4[0].x, x4[0].y, x4[0].z, x4[0].w}, {x4[1].x, x4[1].y, x4[1].z, x4[1].w},
                              {x4[2].x, x4[2].y, x4[2].z, x4[2].w}, {x4[3].x, x4[3].y, x4[3].z, x4[3].w}};
      float cv[4] = {c4.x, c4.y, c4.z, c4.w}, hv[4] = {h4.x, h4.y, h4.z, h4.w}, ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 sg = *reinterpret_cast<const float4*>(ps + 4 * i);  // unit u0 + i's i, f, g, o sums
        const float c_new = gate_sigmoid<W>(xg[1][i] + sg.y + fb) * cv[i] +
                            gate_sigmoid<W>(xg[0][i] + sg.x) * gate_tanh<W>(xg[2][i] + sg.z);
        const float h_new = gate_sigmoid<W>(xg[3][i] + sg.w) * gate_tanh<W>(c_new);
        hv[i] = m * h_new + (1.0f - m) * hv[i];
        cv[i] = m * c_new + (1.0f - m) * cv[i];
        ov[i] = m * h_new;
      }
      *reinterpret_cast<float4*>(c_st + row * Us + u0) = make_float4(cv[0], cv[1], cv[2], cv[3]);
      *reinterpret_cast<float4*>(h_st + row * Us + u0) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<float4*>(o_st + row * Us + u0) = make_float4(ov[0], ov[1], ov[2], ov[3]);
      if (row < g.nrows && step + 1 < T) {  // rows past the pass stay zero
        put_h((step + 1) & 1, row, u_off + u0, make_float2(hv[0], hv[1]));
        put_h((step + 1) & 1, row, u_off + u0 + 2, make_float2(hv[2], hv[3]));
      }
    }
    lap(1);
    // every consumer's h is stored, part_s and the xp tile are free: the
    // block publishes its chunks of h(step + 1), then stores out[t] (and
    // the residuals of the next step) and requests the next xp tile
    consumers_sync();
    if (tid == 0 && step + 1 < T)
      for (int c = c0; c <= c1; ++c) chunk_publish(ready + c);
    for (int q = tid; q < g.nrows * up; q += FWD_THREADS) {
      const int row = q / up, u0 = (q - row * up) * 2;
      const float2 hn = *reinterpret_cast<const float2*>(h_st + row * Us + u0);
      *reinterpret_cast<float2*>(out + ((size_t)t * B + g.row0 + row) * U + u_off + u0) =
          *reinterpret_cast<const float2*>(o_st + row * Us + u0);
      if (save_res && step + 1 < T) {
        const size_t idx = ((size_t)(reverse ? t - 1 : t + 1) * B + g.row0 + row) * U + u_off + u0;
        store2(hprev + idx, hn);
        store2(cprev + idx, *reinterpret_cast<const float2*>(c_st + row * Us + u0));
      }
    }
    if (step + 1 < T) prefetch(reverse ? t - 1 : t + 1);
    lap(2);
  }
  if (timed)
    for (int i = 0; i < 5; ++i) clocks[i] += spent[i];
  for (int q = tid; q < g.nrows * up; q += FWD_THREADS) {
    const int row = q / up, u0 = (q - row * up) * 2;
    const size_t idx = (size_t)(g.row0 + row) * U + u_off + u0;
    *reinterpret_cast<float2*>(a.hfin[d] + idx) = *reinterpret_cast<const float2*>(h_st + row * Us + u0);
    *reinterpret_cast<float2*>(a.cfin[d] + idx) = *reinterpret_cast<const float2*>(c_st + row * Us + u0);
  }
}

// The float32 product of a grid block's step (true float32 FMAs): the
// consumer thread of part p = tid / (256 / ks) takes 4 columns of the
// product (column group q mod Nc / 4: one unit's 4 gate columns in the
// forward, 4 units of the partial dh in the VJP) and TR rows (row tile rt =
// q / (Nc / 4) takes rows rt, rt + nrt, ...: the row tiles of a warp read
// rows one padded stride apart, in other banks) of its part's chunks (chunk
// i of the step to part i mod ks), sums them in k order in registers; the
// parts are then added in part order into part_s ([rows][Nc]), so a launch
// is bitwise repeatable. Threads past nrt row tiles idle. first and later
// gather the cycles thread 0 of the timed block waited for the step's first
// chunk and for the others.
template <int TR>
__device__ __forceinline__ void grid_product_f32(const GridCut& g, const GridLayout& L, unsigned char* smem,
                                                 unsigned long long* full, unsigned long long* empty, int step,
                                                 bool timed, long long& first, long long& later) {
  const int tid = threadIdx.x, lane = tid & 31, Nc = L.Nc, ncg = Nc / 4;
  const int nch = g.kp / g.kc, tpp = FWD_THREADS / g.ks;
  const int part = tid / tpp, q = tid - part * tpp;
  const int nrt = tpp / ncg, u = q % ncg, rt = q / ncg;
  const bool busy = rt < nrt;
  const float* w_res = reinterpret_cast<const float*>(smem + L.w);
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  const int kc4 = g.kc / 4, ldh = L.ldh;
  float acc[TR][4];
#pragma unroll
  for (int j = 0; j < TR; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int i = part; i < nch; i += g.ks) {
    const int c = step * nch + i, slot = c % g.ns;
    const long long w0 = timed ? clock64() : 0;
    mbar_wait(smem_addr(&full[slot]), (unsigned)(c / g.ns) & 1);
    if (timed) (i == 0 ? first : later) += clock64() - w0;
    const unsigned char* sl = smem + L.ring + slot * L.slot;
    const float* hs = reinterpret_cast<const float*>(sl) + rt * ldh;
    const float* wc = (i < g.nres ? w_res + (size_t)i * g.kc * Nc : reinterpret_cast<const float*>(sl + L.hchunk)) +
                      4 * u;
    if (busy) {
#pragma unroll 2
      for (int k4 = 0; k4 < kc4; ++k4) {
        const float4 w0v = *reinterpret_cast<const float4*>(wc + (size_t)(4 * k4) * Nc);
        const float4 w1v = *reinterpret_cast<const float4*>(wc + (size_t)(4 * k4 + 1) * Nc);
        const float4 w2v = *reinterpret_cast<const float4*>(wc + (size_t)(4 * k4 + 2) * Nc);
        const float4 w3v = *reinterpret_cast<const float4*>(wc + (size_t)(4 * k4 + 3) * Nc);
#pragma unroll
        for (int j = 0; j < TR; ++j) {
          const float4 hv = *reinterpret_cast<const float4*>(hs + (size_t)j * nrt * ldh + 4 * k4);
          acc[j][0] = fmaf(hv.x, w0v.x, acc[j][0]);
          acc[j][1] = fmaf(hv.x, w0v.y, acc[j][1]);
          acc[j][2] = fmaf(hv.x, w0v.z, acc[j][2]);
          acc[j][3] = fmaf(hv.x, w0v.w, acc[j][3]);
          acc[j][0] = fmaf(hv.y, w1v.x, acc[j][0]);
          acc[j][1] = fmaf(hv.y, w1v.y, acc[j][1]);
          acc[j][2] = fmaf(hv.y, w1v.z, acc[j][2]);
          acc[j][3] = fmaf(hv.y, w1v.w, acc[j][3]);
          acc[j][0] = fmaf(hv.z, w2v.x, acc[j][0]);
          acc[j][1] = fmaf(hv.z, w2v.y, acc[j][1]);
          acc[j][2] = fmaf(hv.z, w2v.z, acc[j][2]);
          acc[j][3] = fmaf(hv.z, w2v.w, acc[j][3]);
          acc[j][0] = fmaf(hv.w, w3v.x, acc[j][0]);
          acc[j][1] = fmaf(hv.w, w3v.y, acc[j][1]);
          acc[j][2] = fmaf(hv.w, w3v.z, acc[j][2]);
          acc[j][3] = fmaf(hv.w, w3v.w, acc[j][3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[slot]), 32);
  }
  cp_async_wait_all();  // this step's tile, requested a step ago
  for (int p = 0; p < g.ks; ++p) {  // the parts into part_s, in part order
    if (part == p && busy) {
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        float4* dst = reinterpret_cast<float4*>(part_s + (size_t)(rt + j * nrt) * Nc + 4 * u);
        float4 v = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        if (p > 0) {
          const float4 s = *dst;
          v = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
        }
        *dst = v;
      }
    }
    consumers_sync();
  }
}

// The bf16 product of a grid block's step (mma.sync m16n8k16, float32
// accumulators): a part's warps split the n-tiles of the product's columns
// (n-tile j WP + wl, j < NTW, WP = 8 / ks warps a part), each warp takes all
// MT row tiles of its part's chunks; the operand chunk is in the A
// fragments' order, wh in the B fragments'; the parts are added in part
// order into part_s (rows L.ldp apart), as grid_product_f32's. The
// forward's mma.sync route shares it (its FwdGridLayout).
template <int MT, int NTW, class Layout>
__device__ __forceinline__ void grid_product_bf16(const GridCut& g, const Layout& L, unsigned char* smem,
                                                  unsigned long long* full, unsigned long long* empty, int step,
                                                  bool timed, long long& first, long long& later) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, Nc = L.Nc, ldp = L.ldp;
  const int nch = g.kp / g.kc, NT = Nc / 8, kc16 = g.kc / 16;
  const int WP = RING_WARPS / g.ks, part = warp / WP, wl = warp - part * WP;
  const int gq = lane >> 2, tig = lane & 3;
  const uint2* w_res = reinterpret_cast<const uint2*>(smem + L.w);
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float acc[MT][NTW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.0f;
  for (int i = part; i < nch; i += g.ks) {
    const int c = step * nch + i, slot = c % g.ns;
    const long long w0 = timed ? clock64() : 0;
    mbar_wait(smem_addr(&full[slot]), (unsigned)(c / g.ns) & 1);
    if (timed) (i == 0 ? first : later) += clock64() - w0;
    const unsigned char* sl = smem + L.ring + slot * L.slot;
    const uint4* hf = reinterpret_cast<const uint4*>(sl);
    const uint2* wf = i < g.nres ? w_res + (size_t)i * kc16 * NT * 32 : reinterpret_cast<const uint2*>(sl + L.hchunk);
#pragma unroll 2
    for (int s = 0; s < kc16; ++s) {
      // every fragment of the k step first, so that their loads are in flight together
      unsigned af[MT][4];
      uint2 bf[NTW];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint4 v = hf[(s * MT + m) * 32 + lane];
        af[m][0] = v.x, af[m][1] = v.y, af[m][2] = v.z, af[m][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) bf[j] = wf[(s * NT + min(j * WP + wl, NT - 1)) * 32 + lane];
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        if (j * WP + wl < NT)
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_bf16(acc[m][j], af[m], bf[j].x, bf[j].y);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[slot]), 32);
  }
  cp_async_wait_all();  // this step's tile, requested a step ago
  for (int p = 0; p < g.ks; ++p) {  // the parts into part_s, in part order
    if (part == p) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int nt = j * WP + wl;
        if (nt >= NT) continue;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            float2* dst = reinterpret_cast<float2*>(part_s + (size_t)(16 * m + gq + 8 * hi) * ldp + nt * 8 + tig * 2);
            float2 v = make_float2(acc[m][j][2 * hi], acc[m][j][2 * hi + 1]);
            if (p > 0) {
              const float2 s = *dst;
              v = make_float2(s.x + v.x, s.y + v.y);
            }
            *dst = v;
          }
      }
    }
    consumers_sync();
  }
}

// the word of an A fragment buffer ([k steps][MT row tiles][32 lanes][4
// words]) that holds the bf16 pair (k, k + 1) of `row` (k even): k step k /
// 16, row tile row / 16, lane 4 (row mod 8) + (k mod 8) / 2, register (row
// mod 16) / 8 + 2 ((k mod 16) / 8)
__device__ __forceinline__ size_t a_frag_word(int mt, int row, int k) {
  const int r = row & 15, kk = k & 15;
  return (((size_t)(k >> 4) * mt + (row >> 4)) * 32 + (r & 7) * 4 + ((kk & 7) >> 1)) * 4 + (r >> 3) + 2 * (kk >> 3);
}

// The float32 product of a forward grid block's step (true float32 FMAs).
// A consumer thread of part p = tid / (256 / ks) takes 8 columns (unit cg
// and unit cg + us / 2, each its 4 gate columns: two float4 of a k row of
// wh) and TR consecutive rows (row tile rt) of its part's chunks (chunk i
// of the step to part i mod ks), summing them in k order in registers; the
// parts are then added in part order into part_s, so a launch is bitwise
// repeatable. h chunks are k-major ([kc][rows]), so a k step is two float4
// of wh and TR / 4 of h for 8 TR FMAs, with no more than 8 TR + 16
// registers of sums and operands; a warp's loads of wh are 8 neighbouring
// float4 and of h 4 row tiles' neighbouring float4 (one wavefront each).
// Threads past nrt row tiles idle.
template <int TR>
__device__ __forceinline__ void fwd_product_f32(const GridCut& g, const FwdGridLayout& L, unsigned char* smem,
                                                unsigned long long* full, unsigned long long* empty, int step,
                                                bool timed, long long& first, long long& later) {
  const int tid = threadIdx.x, lane = tid & 31, Nc = L.Nc, half = Nc / 2, ncg = Nc / 8, ldp = L.ldp;
  const int tpp = FWD_THREADS / g.ks, part = tid / tpp, q = tid - part * tpp;
  const int nrt = tpp / ncg, cg = q % ncg, rt = q / ncg;
  const bool busy = rt < nrt;
  const float* w_res = reinterpret_cast<const float*>(smem + L.w);
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  const int kc = g.kc, rows = g.rows;
  float acc[TR][8];
#pragma unroll
  for (int j = 0; j < TR; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.0f;
  for (int i = part; i < L.nch; i += g.ks) {
    const int c = step * L.nch + i, slot = c % g.ns;
    const long long w0 = timed ? clock64() : 0;
    mbar_wait(smem_addr(&full[slot]), (unsigned)(c / g.ns) & 1);
    if (timed) (i == 0 ? first : later) += clock64() - w0;
    const unsigned char* sl = smem + L.ring + slot * L.slot;
    const float* hs = reinterpret_cast<const float*>(sl) + rt * TR;
    const float* wc = (i < g.nres ? w_res + (size_t)i * kc * Nc : reinterpret_cast<const float*>(sl + L.hchunk)) +
                      4 * cg;
    if (busy) {
#pragma unroll 4
      for (int k = 0; k < kc; ++k) {
        const float4 wa = *reinterpret_cast<const float4*>(wc + (size_t)k * Nc);
        const float4 wb = *reinterpret_cast<const float4*>(wc + (size_t)k * Nc + half);
        float hk[TR];
#pragma unroll
        for (int j = 0; j < TR; j += 4) {
          const float4 hv = *reinterpret_cast<const float4*>(hs + (size_t)k * rows + j);
          hk[j] = hv.x, hk[j + 1] = hv.y, hk[j + 2] = hv.z, hk[j + 3] = hv.w;
        }
#pragma unroll
        for (int j = 0; j < TR; ++j) {
          acc[j][0] = fmaf(hk[j], wa.x, acc[j][0]);
          acc[j][1] = fmaf(hk[j], wa.y, acc[j][1]);
          acc[j][2] = fmaf(hk[j], wa.z, acc[j][2]);
          acc[j][3] = fmaf(hk[j], wa.w, acc[j][3]);
          acc[j][4] = fmaf(hk[j], wb.x, acc[j][4]);
          acc[j][5] = fmaf(hk[j], wb.y, acc[j][5]);
          acc[j][6] = fmaf(hk[j], wb.z, acc[j][6]);
          acc[j][7] = fmaf(hk[j], wb.w, acc[j][7]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[slot]), 32);
  }
  cp_async_wait_all();  // this step's tile, requested a step ago
  for (int p = 0; p < g.ks; ++p) {  // the parts into part_s, in part order
    if (part == p && busy) {
#pragma unroll
      for (int j = 0; j < TR; ++j) {
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          float4* dst = reinterpret_cast<float4*>(part_s + (size_t)(rt * TR + j) * ldp + hlf * half + 4 * cg);
          float4 v = make_float4(acc[j][4 * hlf], acc[j][4 * hlf + 1], acc[j][4 * hlf + 2], acc[j][4 * hlf + 3]);
          if (p > 0) {
            const float4 s = *dst;
            v = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
          }
          *dst = v;
        }
      }
    }
    consumers_sync();
  }
}

// ---- wgmma (the bf16 forward's product): m64nNk16, both operands K-major
// in shared memory with the 128-byte swizzle, float32 accumulators

// the descriptor of a K-major operand with the 128-byte swizzle at shared
// address `addr` (1024-byte atoms of 8 rows; the leading offset unused, the
// stride between 8-row atoms 1024 bytes); a k step of 16 within an atom
// starts 32 bytes further
__device__ __forceinline__ unsigned long long sw128_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((unsigned long long)(1024 >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving an accumulator across an asynchronous
// product: before a group is issued and after a wait (never between: a use
// of an accumulator in flight makes the compiler wait for its group)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

// D[64 x N] += A[64 x 16] B[16 x N]^T, A and B by descriptor
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], unsigned long long da, unsigned long long db);
template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], unsigned long long da, unsigned long long db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], unsigned long long da, unsigned long long db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], unsigned long long da, unsigned long long db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),
        "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], unsigned long long da, unsigned long long db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),
        "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The bf16 product of a forward grid block's step on wgmma: M the block's
// 4 us gate columns (MT tiles of 64, zero rows past them), N the pass's
// rows, K the chunk's 128 k (two 64-k atom columns of the swizzled layout,
// eight k steps of 16). With ks = 1 both warpgroups take every chunk,
// warpgroup w the M tiles w MTW .. w MTW + MTW - 1; with ks = 2 warpgroup w
// takes every M tile of the chunks i with i mod 2 = w. A chunk's k steps
// are issued back to back as one asynchronous group, waited on at once to
// free the chunk's slot. (On the H100 the ring's chunks, not the product,
// set a step's pace: a step takes its h in few large chunks, and a group
// left in flight across chunks held its slot and read slower.)
// The parts are added in part order into part_s ([rows][Nc + 4]; accumulator
// d[j] of lane l in warp w of the warpgroup is column 16 w + l / 4 + 8 ((j /
// 2) mod 2) of its M tile, row 8 (j / 4) + 2 (l mod 4) + j mod 2).
template <int N, int MTW>
__device__ __forceinline__ void fwd_product_bf16(const GridCut& g, const FwdGridLayout& L, unsigned char* smem,
                                                 unsigned long long* full, unsigned long long* empty, int step,
                                                 bool timed, long long& first, long long& later) {
  const int tid = threadIdx.x, wgi = tid / 128, wl = (tid >> 5) & 3, lane = tid & 31, ldp = L.ldp, Nc = L.Nc;
  const int i0 = g.ks == 1 ? 0 : wgi, di = g.ks == 1 ? 1 : 2, mt0 = g.ks == 1 ? wgi * MTW : 0;
  const unsigned w_res = smem_addr(smem + L.w), ring = smem_addr(smem + L.ring);
  const unsigned mstride = 64 * 128;              // bytes of an M tile of an atom column
  const unsigned acol = L.Ncp * 128, bcol = N * 128;  // bytes of an atom column of wh, of h
  float* part_s = reinterpret_cast<float*>(smem + L.part);
  float acc[MTW][N / 2];
#pragma unroll
  for (int m = 0; m < MTW; ++m)
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[m][j] = 0.0f;
  auto fence_all = [&]() {
#pragma unroll
    for (int m = 0; m < MTW; ++m) fence_acc(acc[m]);
  };
  auto release = [&](int slot) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[slot]), 32);
  };
  for (int i = i0; i < L.nch; i += di) {
    const int c = step * L.nch + i, slot = c % g.ns;
    const long long w0 = timed ? clock64() : 0;
    mbar_wait(smem_addr(&full[slot]), (unsigned)(c / g.ns) & 1);
    if (timed) (i == 0 ? first : later) += clock64() - w0;
    __syncwarp();
    const unsigned sl = ring + (unsigned)(slot * L.slot);
    const unsigned a0 = (i < g.nres ? w_res + (unsigned)(i * L.wchunk) : sl + (unsigned)L.hchunk) + mt0 * mstride;
    fence_all();
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < MTW; ++m)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_bf16<N>(acc[m], sw128_desc(a0 + m * mstride + (kk >> 2) * acol + 32 * (kk & 3)),
                      sw128_desc(sl + (kk >> 2) * bcol + 32 * (kk & 3)));
    wgmma_commit();
    wgmma_wait<0>();  // the chunk is read: free its slot at once
    fence_all();
    release(slot);
  }
  cp_async_wait_all();  // this step's tile, requested a step ago
  for (int p = 0; p < g.ks; ++p) {  // the parts into part_s, in part order
    if (g.ks == 1 || p == wgi) {
#pragma unroll
      for (int m = 0; m < MTW; ++m)
#pragma unroll
        for (int j = 0; j < N / 2; ++j) {
          const int col = 64 * (mt0 + m) + 16 * wl + (lane >> 2) + 8 * ((j >> 1) & 1);
          const int row = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
          float* dst = part_s + (size_t)row * ldp + col;
          if (col < Nc) *dst = p > 0 ? *dst + acc[m][j] : acc[m][j];
        }
    }
    consumers_sync();
  }
}

// The two forward grid kernels: one block an SM, 8 consumer warps and a
// producer warp (fwd_grid_produce); block b the units [s us, (s + 1) us) of
// direction b / (U / us), s = b mod (U / us); the workspace ws holds the
// readiness counters, then the two h buffers of each direction. The
// residuals are saved where the entry gives hprev.
//
// float32: a consumer thread takes 8 columns and TR rows of its part's
// chunks (fwd_product_f32); h chunks k-major
template <int TR>
__global__ void __launch_bounds__(RING_THREADS, 1)
lstm_grid_kernel(FwdArgs a, const float* __restrict__ mask, int T, int B, int U, GridCut g, float fb,
                 unsigned char* ws, long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char grid_smem[];
  __shared__ __align__(8) unsigned long long full_bar[GRID_SLOTS_MAX], empty_bar[GRID_SLOTS_MAX];
  const FwdGridLayout L = fwd_grid_layout(g, false);
  const int warp = threadIdx.x >> 5;
  const int per_dir = U / g.us, nd = gridDim.x / per_dir;
  const int d = blockIdx.x / per_dir, slice = blockIdx.x - d * per_dir;
  unsigned* ready = reinterpret_cast<unsigned*>(ws) + d * L.nch;
  unsigned char* hbufs = ws + fwd_grid_head(nd, L.nch);  // [2][nd][nch] chunks of [kc][rows] floats
  const unsigned char* wg = static_cast<const unsigned char*>(a.wh[d]) + (size_t)slice * g.kp * L.Nc * 4;
  fwd_grid_setup(g, L, wg, grid_smem, full_bar, empty_bar, FWD_THREADS / g.ks);
  if (warp == RING_WARPS) {
    fwd_grid_produce(g, L, T, per_dir, hbufs + (size_t)d * L.nch * L.hchunk, (size_t)nd * L.nch * L.hchunk, ready, wg,
                     smem_addr(grid_smem + L.ring), full_bar, empty_bar);
    return;
  }
  auto product = [&](int step, bool timed, long long& first, long long& later) {
    fwd_product_f32<TR>(g, L, grid_smem, full_bar, empty_bar, step, timed, first, later);
  };
  // two units' h of a row into h buffer `buf`: a chunk k-major, [kc][rows]
  auto put_h = [&](int buf, int row, int k, float2 h) {
    float* hb = reinterpret_cast<float*>(hbufs + (size_t)(buf * nd + d) * L.nch * L.hchunk) + (size_t)k * g.rows + row;
    hb[0] = h.x;
    hb[g.rows] = h.y;
  };
  grid_steps<float>(a, mask, T, B, U, g, L, d, slice, fb, ready, grid_smem, product, put_h, clocks);
}

// bf16: the product on wgmma (fwd_product_bf16), N = rows; wh and h in the
// canonical swizzled layout (ops/lstm.py::grid_wh, put_h below), the
// dynamic region aligned to 1024 bytes
template <int N, int MTW>
__global__ void __launch_bounds__(RING_THREADS, 1)
lstm_grid_bf16_kernel(FwdArgs a, const float* __restrict__ mask, int T, int B, int U, GridCut g, float fb,
                      unsigned char* ws, long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char grid_smem[];
  __shared__ __align__(8) unsigned long long full_bar[GRID_SLOTS_MAX], empty_bar[GRID_SLOTS_MAX];
  const FwdGridLayout L = fwd_grid_layout(g, true);
  unsigned char* smem = grid_smem + ((1024 - (smem_addr(grid_smem) & 1023)) & 1023);
  const int warp = threadIdx.x >> 5;
  const int per_dir = U / g.us, nd = gridDim.x / per_dir;
  const int d = blockIdx.x / per_dir, slice = blockIdx.x - d * per_dir;
  unsigned* ready = reinterpret_cast<unsigned*>(ws) + d * L.nch;
  unsigned char* hbufs = ws + fwd_grid_head(nd, L.nch);  // [2][nd][nch] chunks of [rows][64] bf16, swizzled
  const unsigned char* wg = static_cast<const unsigned char*>(a.wh[d]) + (size_t)slice * g.kp * L.Ncp * 2;
  fwd_grid_setup(g, L, wg, smem, full_bar, empty_bar, FWD_THREADS / g.ks);
  if (warp == RING_WARPS) {
    fwd_grid_produce(g, L, T, per_dir, hbufs + (size_t)d * L.nch * L.hchunk, (size_t)nd * L.nch * L.hchunk, ready, wg,
                     smem_addr(smem + L.ring), full_bar, empty_bar);
    return;
  }
  auto product = [&](int step, bool timed, long long& first, long long& later) {
    fwd_product_bf16<N, MTW>(g, L, smem, full_bar, empty_bar, step, timed, first, later);
  };
  // two units' h of a row, rounded to bf16, into h buffer `buf`: 16-byte
  // group j of a chunk's row r at j ^ (r & 7)
  auto put_h = [&](int buf, int row, int k, float2 h) {
    __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(hbufs + (size_t)(buf * nd + d) * L.nch * L.hchunk);
    const int ch = k >> 6, kk = k & 63;
    *reinterpret_cast<__nv_bfloat162*>(hb + ((size_t)ch * g.rows + row) * 64 + (((kk >> 3) ^ (row & 7)) << 3) +
                                       (kk & 7)) = __floats2bfloat162_rn(h.x, h.y);
  };
  grid_steps<__nv_bfloat16>(a, mask, T, B, U, g, L, d, slice, fb, ready, smem, product, put_h, clocks);
}

// bf16 on mma.sync (grid_product_bf16, as the VJP's loop): h in the A
// fragments' order (a_frag_word), wh in the B fragments' (ops/lstm.py::
// grid_wh, ring_fragments); MT 16-row tiles, a warp NTW n-tiles
template <int MT, int NTW>
__global__ void __launch_bounds__(RING_THREADS, 1)
lstm_grid_mma_kernel(FwdArgs a, const float* __restrict__ mask, int T, int B, int U, GridCut g, float fb,
                     unsigned char* ws, long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char grid_smem[];
  __shared__ __align__(8) unsigned long long full_bar[GRID_SLOTS_MAX], empty_bar[GRID_SLOTS_MAX];
  const FwdGridLayout L = fwd_grid_layout(g, true, true);
  const int warp = threadIdx.x >> 5;
  const int per_dir = U / g.us, nd = gridDim.x / per_dir;
  const int d = blockIdx.x / per_dir, slice = blockIdx.x - d * per_dir;
  unsigned* ready = reinterpret_cast<unsigned*>(ws) + d * L.nch;
  unsigned char* hbufs = ws + fwd_grid_head(nd, L.nch);  // [2][nd][k steps][MT][32 lanes][8 bf16]: A fragments
  const unsigned char* wg = static_cast<const unsigned char*>(a.wh[d]) + (size_t)slice * g.kp * L.Nc * 2;
  fwd_grid_setup(g, L, wg, grid_smem, full_bar, empty_bar, FWD_THREADS / g.ks);
  if (warp == RING_WARPS) {
    fwd_grid_produce(g, L, T, per_dir, hbufs + (size_t)d * L.nch * L.hchunk, (size_t)nd * L.nch * L.hchunk, ready, wg,
                     smem_addr(grid_smem + L.ring), full_bar, empty_bar);
    return;
  }
  auto product = [&](int step, bool timed, long long& first, long long& later) {
    grid_product_bf16<MT, NTW>(g, L, grid_smem, full_bar, empty_bar, step, timed, first, later);
  };
  // two units' h of a row, rounded to bf16, into h buffer `buf` at their place in the A fragments
  auto put_h = [&](int buf, int row, int k, float2 h) {
    unsigned* hb = reinterpret_cast<unsigned*>(hbufs + (size_t)(buf * nd + d) * L.nch * L.hchunk);
    __nv_bfloat162 v = __floats2bfloat162_rn(h.x, h.y);
    hb[a_frag_word(MT, row, k)] = *reinterpret_cast<unsigned*>(&v);
  };
  grid_steps<__nv_bfloat16>(a, mask, T, B, U, g, L, d, slice, fb, ready, grid_smem, product, put_h, clocks);
}

// ------------------------------------------------------------------- VJP

struct BwdArgs {
  const float* xp[2];     // [T, B, 4U]
  const void* wh[2];      // [U, 4U] W
  const void* whg[2];     // the loop's slices of Wh^T (see bwd_layout)
  const void* wht[2];     // bf16 mode: Wh^T [4U, U] for the gates GEMM on the tensor cores
  const void* hprev[2];   // [T, B, U] W
  const void* cprev[2];   // [T, B, U] W
  const float* dout[2];   // [T, B, U]
  const float* dhfin[2];  // [B, U]
  const float* dcfin[2];
  float* dxp[2];          // [T, B, 4U]: the steps' factors (kernel 1), then the gate gradients
  float* fac[2];          // [T, B, 2U] scratch: the factors A and sf of every step
  float* dwh[2];          // [U, 4U]
  int reverse[2];
};

// tiles of the two GEMMs: GM x GN outputs, GK-deep chunks, 256 threads,
// thread (tx, ty) computes 8 x 8 outputs from two 16-byte loads of each
// operand a k (true float32 FMAs; bf16 operands are exact in float32)
constexpr int GM = 128, GN = 128, GK = 16, GEMM_THREADS = 256;
constexpr int LDA = GM + 4;  // row stride of the A tile: its transposing stores spread over the banks

// acc[i][j] += sum over the chunk of a[kk][rows i] * b[kk][columns j]
__device__ __forceinline__ void tile_fma(const float (*As)[LDA], const float (*Bs)[GN],
                                         const int (&arow)[2], const int (&bcol)[4],
                                         float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < GK; ++kk) {
    float av[8], bv[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(&As[kk][arow[h]]);
      av[4 * h] = v.x, av[4 * h + 1] = v.y, av[4 * h + 2] = v.z, av[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(&Bs[kk][bcol[q]]);
      bv[2 * q] = v.x, bv[2 * q + 1] = v.y;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// four values of W type from global memory as float32 (16-byte or 8-byte load)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// the six factors (see kernel 1) of two neighbouring units of one row, from
// their four gates g[i|f|g|o] and cprev -> fr (the row's dxp at the first
// unit, a gate U apart) and ar (the row's fac at that unit)
__device__ __forceinline__ void write_factors(const float2 (&g)[4], const float (&cp)[2],
                                              float forget_bias, float* fr, float* ar, int U) {
  float f[6][2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const float gi = jj ? g[0].y : g[0].x, gf = jj ? g[1].y : g[1].x;
    const float gg = jj ? g[2].y : g[2].x, go = jj ? g[3].y : g[3].x;
    const float si = sigmoidf_(gi), sf = sigmoidf_(gf + forget_bias);
    const float sg = tanhf(gg), so = sigmoidf_(go);
    const float tch = tanhf(sf * cp[jj] + si * sg);
    f[0][jj] = sg * si * (1.0f - si);
    f[1][jj] = cp[jj] * sf * (1.0f - sf);
    f[2][jj] = si * (1.0f - sg * sg);
    f[3][jj] = tch * so * (1.0f - so);
    f[4][jj] = so * (1.0f - tch * tch);
    f[5][jj] = sf;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) *reinterpret_cast<float2*>(fr + q * U) = make_float2(f[q][0], f[q][1]);
  *reinterpret_cast<float2*>(ar) = make_float2(f[4][0], f[4][1]);
  *reinterpret_cast<float2*>(ar + U) = make_float2(f[5][0], f[5][1]);
}

// 1. gates[m, n] = xp[m, n] + sum_k hprev[m, k] * Wh[k, n] over all M = T*B
// rows, and from them what a step of the loop needs that does not depend on
// dh: with si, sf, sg, so the gate activations and c' = sf*cprev + si*sg,
//   dxp[m, i|f|g|o of unit u] <- Fi = sg*si*(1-si), Ff = cprev*sf*(1-sf),
//                                Fg = si*(1-sg^2),  Fo = tanh(c')*so*(1-so)
//   fac[m, u] <- A = so*(1-tanh(c')^2),  fac[m, U + u] <- sf
// so that the loop's step is  dh' = m*(dout+dh), dc' = m*dc + dh'*A,
// dgates = (dc'*Fi, dc'*Ff, dc'*Fg, dh'*Fo), dc = (1-m)*dc + dc'*sf.
// A block's 128 columns are the four gates of 32 units, and a thread's 8
// columns the four gates of 2 units, so the factors are formed in registers.
template <typename W>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gates_kernel(BwdArgs a, int M, int U, float forget_bias) {
  __shared__ __align__(16) float As[GK][LDA];
  __shared__ __align__(16) float Bs[GK][GN];
  const int d = blockIdx.z;
  const W* __restrict__ A = static_cast<const W*>(a.hprev[d]);
  const W* __restrict__ Bw = static_cast<const W*>(a.wh[d]);
  const W* __restrict__ cprev = static_cast<const W*>(a.cprev[d]);
  const float* __restrict__ xp = a.xp[d];
  float* __restrict__ F = a.dxp[d];
  float* __restrict__ fac = a.fac[d];
  const int K = U, N = 4 * U;
  const int u0 = blockIdx.x * (GN / 4), m0 = blockIdx.y * GM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int arow[2] = {ty * 4, GM / 2 + ty * 4};
  const int bcol[4] = {tx * 2, 32 + tx * 2, 64 + tx * 2, 96 + tx * 2};  // gate q, units tx*2, +1
  float acc[8][8] = {};
  for (int k0 = 0; k0 < K; k0 += GK) {
#pragma unroll
    for (int i = 0; i < GM * GK / 4 / GEMM_THREADS; ++i) {  // A: rows x 4 k, stored transposed
      const int e = tid + GEMM_THREADS * i, row = e / (GK / 4), kq = (e % (GK / 4)) * 4;
      const int m = m0 + row, k = k0 + kq;
      const float4 v = (m < M && k < K) ? load4(A + (size_t)m * K + k)
                                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      As[kq][row] = v.x, As[kq + 1][row] = v.y, As[kq + 2][row] = v.z, As[kq + 3][row] = v.w;
    }
#pragma unroll
    for (int i = 0; i < GK * GN / 4 / GEMM_THREADS; ++i) {  // B: k x 4 columns of one gate
      const int e = tid + GEMM_THREADS * i, kk = e / (GN / 4), c = (e % (GN / 4)) * 4;
      const int k = k0 + kk, u = u0 + c % 32;
      const float4 v = (k < K && u < U) ? load4(Bw + (size_t)k * N + (c / 32) * U + u)
                                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(&Bs[kk][c]) = v;
    }
    __syncthreads();
    tile_fma(As, Bs, arow, bcol, acc);
    __syncthreads();
  }
  const int u = u0 + tx * 2;
  if (u >= U) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + arow[i / 4] + i % 4;
    if (m >= M) continue;
    const float* xr = xp + (size_t)m * N + u;
    float2 g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 x = *reinterpret_cast<const float2*>(xr + q * U);
      g[q] = make_float2(x.x + acc[i][2 * q], x.y + acc[i][2 * q + 1]);
    }
    const float cp[2] = {to_f(cprev[(size_t)m * U + u]), to_f(cprev[(size_t)m * U + u + 1])};
    write_factors(g, cp, forget_bias, F + (size_t)m * N + u, fac + (size_t)m * 2 * U + u, U);
  }
}

// ---- bf16 mode: the two GEMMs on the tensor cores (mma.sync.m16n8k16, bf16
// operands, float32 accumulate). 128 x 128 outputs a block, 32-deep k chunks
// in two shared-memory buffers; 8 warps as 4 x 2, a warp 32 x 64 outputs
// (2 x 8 mma tiles); the fragments come from shared memory by ldmatrix.
constexpr int TK = 32;        // k of a chunk
constexpr int TLD = TK + 8;   // row stride (bf16) of a tile with k contiguous: ldmatrix's 8 rows
constexpr int TLDT = GM + 8;  // ... and of a tile stored k-major (GM == GN): fall into different banks

// four 8x8 bf16 matrices: lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
// ... each transposed on the way (the tile is stored k-major)
__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void zero16(void* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}

// 1, bf16 mode: as gates_kernel. The block's 128 columns are the four gates
// of 32 units, ordered so that a thread's accumulators hold the four gates of
// its units: column r of the tile is gate (r % 64) / 16 of unit
// (r / 64) * 16 + ((r % 64) / 8 % 2) * 8 + r % 8.
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gates_kernel_tc(BwdArgs a, int M, int U, float forget_bias) {
  __shared__ __align__(16) __nv_bfloat16 As[2][GM][TLD];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[2][GN][TLD];  // [column][k], from Wh^T
  const int d = blockIdx.z;
  const __nv_bfloat16* __restrict__ A = static_cast<const __nv_bfloat16*>(a.hprev[d]);
  const __nv_bfloat16* __restrict__ Bt = static_cast<const __nv_bfloat16*>(a.wht[d]);
  const __nv_bfloat16* __restrict__ cprev = static_cast<const __nv_bfloat16*>(a.cprev[d]);
  const float* __restrict__ xp = a.xp[d];
  float* __restrict__ F = a.dxp[d];
  float* __restrict__ fac = a.fac[d];
  const int K = U, N = 4 * U;
  const int u0 = blockIdx.x * (GN / 4), m0 = blockIdx.y * GM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % 4, wn = warp / 4;
  auto stage = [&](int k0, int buf) {
    for (int i = tid; i < GM * (TK / 8); i += GEMM_THREADS) {
      const int row = i / (TK / 8), k = k0 + (i % (TK / 8)) * 8, m = m0 + row;
      __nv_bfloat16* dst = &As[buf][row][k - k0];
      if (m < M && k < K) cp_async16(dst, A + (size_t)m * K + k);
      else zero16(dst);
    }
    for (int i = tid; i < GN * (TK / 8); i += GEMM_THREADS) {
      const int r = i / (TK / 8), k = k0 + (i % (TK / 8)) * 8;
      const int q = (r % 64) / 8, unit = u0 + (r / 64) * 16 + (q % 2) * 8 + r % 8;
      __nv_bfloat16* dst = &Bs[buf][r][k - k0];
      if (unit < U && k < K) cp_async16(dst, Bt + ((size_t)(q / 2) * U + unit) * K + k);
      else zero16(dst);
    }
    cp_async_commit();
  };
  float acc[2][8][4] = {};
  const int nk = (K + TK - 1) / TK;
  stage(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < nk) stage((kc + 1) * TK, buf ^ 1);
    else cp_async_commit();
    cp_async_wait_but_one();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TK; ks += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm4(af[mi], &As[buf][wm * 32 + mi * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)][ks + (lane >> 4) * 8]);
#pragma unroll
      for (int q2 = 0; q2 < 4; ++q2) {
        unsigned bf[4];
        ldsm4(bf, &Bs[buf][wn * 64 + q2 * 16 + (lane >> 4) * 8 + (lane & 7)][ks + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * q2], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * q2 + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // the buffer is free for the chunk after the next
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + mi * 16 + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = u0 + wn * 16 + h * 8 + 2 * t;
        if (u >= U) continue;
        const float* xr = xp + (size_t)m * N + u;
        float2 gt[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 x = *reinterpret_cast<const float2*>(xr + q * U);
          gt[q] = make_float2(x.x + acc[mi][2 * q + h][2 * half], x.y + acc[mi][2 * q + h][2 * half + 1]);
        }
        const float cp[2] = {to_f(cprev[(size_t)m * U + u]), to_f(cprev[(size_t)m * U + u + 1])};
        write_factors(gt, cp, forget_bias, F + (size_t)m * N + u, fac + (size_t)m * 2 * U + u, U);
      }
    }
}

// 3a, bf16 mode: as dwh_partial_kernel. Both operands lie k-major in memory
// (hprev [m][u], dgates [m][n], m the contracted index), so their tiles are
// stored as they come and ldmatrix transposes them into the fragments.
__global__ void __launch_bounds__(GEMM_THREADS, 2)
dwh_partial_kernel_tc(BwdArgs a, float* __restrict__ partials, int M, int U, int N, int ksplit,
                      int chunk) {
  __shared__ __align__(16) __nv_bfloat16 As[2][TK][TLDT];  // [m][u]
  __shared__ __align__(16) __nv_bfloat16 Gs[2][TK][TLDT];  // [m][n]
  const int d = blockIdx.z / ksplit, s = blockIdx.z % ksplit;
  const __nv_bfloat16* __restrict__ A = static_cast<const __nv_bfloat16*>(a.hprev[d]);
  const float* __restrict__ Gm = a.dxp[d];
  const int n0 = blockIdx.x * GN, u0 = blockIdx.y * GM;
  const int mbeg = s * chunk, mend = min(M, mbeg + chunk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % 4, wn = warp / 4;
  constexpr int SEG = GM / 8, PER = TK * SEG / GEMM_THREADS;  // 16-byte segments a row, a thread
  // hprev rows by cp.async; dgates rows (float32 in memory) through registers:
  // loaded before the chunk in flight is multiplied, rounded and stored after
  auto stage_a = [&](int k0, int buf) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + GEMM_THREADS * i, row = e / SEG, c = (e % SEG) * 8;
      const int m = k0 + row, u = u0 + c;
      if (m < mend && u < U) cp_async16(&As[buf][row][c], A + (size_t)m * U + u);
      else zero16(&As[buf][row][c]);
    }
    cp_async_commit();
  };
  auto load_g = [&](int k0, float4 (&v)[PER][2]) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + GEMM_THREADS * i, row = e / SEG, c = (e % SEG) * 8;
      const int m = k0 + row, n = n0 + c;
      const bool in = m < mend && n < N;
      const float* src = Gm + (size_t)m * N + n;
      v[i][0] = in ? *reinterpret_cast<const float4*>(src) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[i][1] = in ? *reinterpret_cast<const float4*>(src + 4) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto store_g = [&](int buf, const float4 (&v)[PER][2]) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + GEMM_THREADS * i, row = e / SEG, c = (e % SEG) * 8;
      __nv_bfloat162 p[4] = {__floats2bfloat162_rn(v[i][0].x, v[i][0].y), __floats2bfloat162_rn(v[i][0].z, v[i][0].w),
                             __floats2bfloat162_rn(v[i][1].x, v[i][1].y), __floats2bfloat162_rn(v[i][1].z, v[i][1].w)};
      *reinterpret_cast<uint4*>(&Gs[buf][row][c]) = *reinterpret_cast<const uint4*>(p);
    }
  };
  float acc[2][8][4] = {};
  float4 gv[PER][2];
  load_g(mbeg, gv);
  stage_a(mbeg, 0);
  store_g(0, gv);
  for (int k0 = mbeg, kc = 0; k0 < mend; k0 += TK, ++kc) {
    const int buf = kc & 1;
    const bool more = k0 + TK < mend;
    if (more) {
      load_g(k0 + TK, gv);
      stage_a(k0 + TK, buf ^ 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait_but_one();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TK; ks += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm4_t(af[mi], &As[buf][ks + (lane >> 4) * 8 + (lane & 7)][wm * 32 + mi * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int q2 = 0; q2 < 4; ++q2) {
        unsigned bf[4];
        ldsm4_t(bf, &Gs[buf][ks + ((lane >> 3) & 1) * 8 + (lane & 7)][wn * 64 + q2 * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * q2], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * q2 + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    if (more) store_g(buf ^ 1, gv);  // read last in the chunk before this one
    __syncthreads();
  }
  float* P = partials + ((size_t)d * ksplit + s) * U * N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int u = u0 + wm * 32 + mi * 16 + g + 8 * half;
      if (u >= U) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + wn * 64 + nt * 8 + 2 * t;
        if (n < N)
          *reinterpret_cast<float2*>(P + (size_t)u * N + n) =
              make_float2(acc[mi][nt][2 * half], acc[mi][nt][2 * half + 1]);
      }
    }
}

// 2. the serial reverse-time loop (see the header)

// how one launch of the loop cuts the work, chosen by the caller from the shape
struct BwdPlan {
  int C;         // blocks of a cluster = slices of the units
  int Bt;        // batch rows of a cluster's tile (8 or 16)
  int KS;        // float32: parts the k range (the block's gate columns) is split into
  int resident;  // the block's slice of Wh^T lies in shared memory
};
// tiles of factors, dout and mask a block keeps: one in use, one in flight,
// requested a whole step before its use (a third measured no faster)
constexpr int BWD_RING = 2;

// byte offsets of a block's shared memory; ops/lstm.py::backward_smem_bytes
// mirrors it. The slice of Wh^T a block multiplies by: float32 [Nc][U]
// (row = one of its gate columns, U contiguous: product_f32's [k][n]), bf16
// [Np][Nc] (row = a unit, the block's gate columns contiguous: product_bf16's
// [n][k]; Np = U rounded up to 16, the rows past U zero).
struct BwdLayout {
  int Us, Nc, Np;
  int ldg, ldw, ldp;  // row strides of dgates and the slice (elements), the partial sums (floats)
  int tile;           // floats of one ring tile: the factors Fi, Ff, Fg, Fo [Bt, Nc], then
                      // dout, A and sf (each [Bt, Us]), then the mask [Bt]
  size_t w, recv, dg, part, ring, dh, dc, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int U, BwdPlan p, bool bf) {
  BwdLayout L;
  L.Us = U / p.C;
  L.Nc = 4 * L.Us;
  L.Np = (U + 15) / 16 * 16;
  L.ldg = bf ? L.Nc + 8 : L.Nc;
  L.ldw = bf ? (p.resident ? L.Nc + 8 : L.Nc) : U;
  L.ldp = bf ? L.Np : U;
  size_t off = 0;
  L.w = off;
  if (p.resident) off += bf ? (size_t)L.Np * L.ldw * 2 : (size_t)L.Nc * U * 4;
  L.recv = off;  // [2][C][Bt][Us] partial dh of this block's units, one slot a sender
  off += (size_t)2 * p.Bt * U * 4;
  L.dg = off;
  off += bf ? (size_t)MMA_M * L.ldg * 2 : (size_t)p.Bt * L.Nc * 4;
  L.part = off;
  off += (size_t)p.KS * p.Bt * L.ldp * 4;
  L.tile = p.Bt * (L.Nc + 3 * L.Us) + p.Bt;
  L.ring = off;
  off += (size_t)BWD_RING * L.tile * 4;
  L.dh = off;
  off += (size_t)p.Bt * L.Us * 4;
  L.dc = off;
  off += (size_t)p.Bt * L.Us * 4;
  L.total = off;
  return L;
}

template <typename W>
__global__ void __launch_bounds__(FWD_THREADS, 1)
lstm_bwd_kernel(BwdArgs a, const float* __restrict__ mask, int T, int B, int U, BwdPlan plan,
                long long* __restrict__ clocks) {
  constexpr bool BF = std::is_same<W, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __shared__ __align__(8) unsigned long long p_bar[2];  // one transaction barrier a recv buffer
  cg::cluster_group cluster = cg::this_cluster();
  const int C = plan.C, Bt = plan.Bt, KS = plan.KS;
  constexpr int RG = BWD_RING;
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / C) * Bt;
  const int tid = threadIdx.x;
  const BwdLayout L = bwd_layout(U, plan, BF);
  const int Us = L.Us, Nc = L.Nc, G = 4 * U;

  float* dxp = a.dxp[d];  // the factors Fi, Ff, Fg, Fo of every step on entry, dgates on exit
  const float* __restrict__ dout = a.dout[d];
  const float* __restrict__ fac = a.fac[d];
  const bool reverse = a.reverse[d] != 0;
  const W* wg = static_cast<const W*>(a.whg[d]) +
                (size_t)rank * (BF ? (size_t)L.Np * Nc : (size_t)Nc * U);

  W* w_s = reinterpret_cast<W*>(bwd_smem + L.w);
  float* recv_s = reinterpret_cast<float*>(bwd_smem + L.recv);
  W* dg_s = reinterpret_cast<W*>(bwd_smem + L.dg);  // dgates of this step, as the dot reads them
  float* part_s = reinterpret_cast<float*>(bwd_smem + L.part);
  float* ring_s = reinterpret_cast<float*>(bwd_smem + L.ring);
  float* dh_st = reinterpret_cast<float*>(bwd_smem + L.dh);  // (1-m)*dh: what a row keeps of dh
  float* dc_st = reinterpret_cast<float*>(bwd_smem + L.dc);
  const int nq = Bt * Us;       // (row, unit) items of this block
  const int rbuf = C * nq;      // floats of one recv buffer
  const Div by_us(Us), by_uq(Us / 4), by_q4(nq / 4), by_u4(U / 4);
  // offsets inside a ring tile
  const int o_dout = Bt * Nc, o_fa = o_dout + nq, o_fs = o_fa + nq, o_mask = o_fs + nq;

  // everything but the slice starts at zero: rows past B are never loaded
  // and then carry zeros through every step
  for (size_t i = L.recv / 16 + tid; i < L.total / 16; i += FWD_THREADS)
    reinterpret_cast<float4*>(bwd_smem)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (plan.resident) {
    if (BF) {  // [Np][Nc] -> rows padded to ldw
      const int cpr = Nc / 8;
      for (int i = tid; i < L.Np * cpr; i += FWD_THREADS)
        *reinterpret_cast<uint4*>(w_s + (size_t)(i / cpr) * L.ldw + (i % cpr) * 8) =
            reinterpret_cast<const uint4*>(wg)[i];
    } else {
      for (int i = tid; i < Nc * U / 4; i += FWD_THREADS)
        reinterpret_cast<float4*>(w_s)[i] = reinterpret_cast<const float4*>(wg)[i];
    }
  }
  __syncthreads();
  for (int q = tid; q < nq; q += FWD_THREADS) {
    const int row = q / Us, u = q - row * Us;
    if (row0 + row >= B) continue;
    const size_t idx = (size_t)(row0 + row) * U + rank * Us + u;
    dh_st[q] = a.dhfin[d][idx];
    dc_st[q] = a.dcfin[d][idx];
  }

  // what step t needs of this block's units for the tile's rows -> ring
  // tile `slot`: the four factors of each gate column, dout, A, sf, mask[t]
  const int uqn = Us / 4;
  auto prefetch = [&](int t, int slot) {
    float* dst = ring_s + slot * L.tile;
    for (int i = tid; i < nq; i += FWD_THREADS) {
      const int row = by_us.quot(i), rem = i - row * Us;
      const int gate = by_uq.quot(rem), j = rem - gate * uqn;
      if (row0 + row < B)
        cp_async16(dst + row * Nc + gate * Us + 4 * j,
                   dxp + ((size_t)t * B + row0 + row) * G + gate * U + rank * Us + 4 * j);
    }
    for (int i = tid; i < 3 * (nq / 4); i += FWD_THREADS) {
      const int part = by_q4.quot(i), r = i - part * (nq / 4);
      const int row = by_uq.quot(r), j = r - row * uqn;
      if (row0 + row >= B) continue;
      const size_t at = (size_t)t * B + row0 + row;
      const float* src = part == 0 ? dout + at * U : fac + at * 2 * U + (part - 1) * U;
      cp_async16(dst + o_dout + part * nq + row * Us + 4 * j, src + rank * Us + 4 * j);
    }
    if (tid < Bt && row0 + tid < B)
      cp_async4(dst + o_mask + tid, mask + (size_t)t * B + row0 + tid);
  };
  // opposite order to the forward
  auto time_of = [&](int step) { return reverse ? step : T - 1 - step; };
  for (int i = 0; i < RG; ++i) {
    if (i < T) prefetch(time_of(i), i);
    cp_async_commit();  // an empty group keeps the count of groups per step
  }
  // Step s reads recv buffer s & 1, which the blocks of the cluster fill
  // during step s - 1: each sends its partial dh of this block's units.
  const unsigned bar0 = smem_addr(&p_bar[0]), bar1 = smem_addr(&p_bar[1]);
  const unsigned p_bytes = (unsigned)(Bt * U * sizeof(float));
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (T > 1) mbar_expect(bar1, p_bytes);  // step 1's partials
    if (T > 2) mbar_expect(bar0, p_bytes);  // step 2's
  }
  cp_async_wait_all();  // step 0's tile
  // no block may store into a peer before that peer has zeroed its buffers
  // and set up its barriers
  cluster.sync();

  // clocks (optional, 5 counters): SM cycles thread 0 of block (0, 0) spent
  // forming dgates, in the product, adding and sending the partials,
  // requesting a later tile, and waiting for the peers' partials
  const bool timed = clocks != nullptr && tid == 0 && blockIdx.x == 0 && blockIdx.y == 0;
  long long tick = timed ? clock64() : 0;
  long long spent[5] = {};  // kept in registers: a counter in memory would stall its next part
  auto lap = [&](int i) {
    if (timed) {
      const long long now = clock64();
      spent[i] += now - tick;
      tick = now;
    }
  };
  for (int step = 0; step < T; ++step) {
    const int t = time_of(step);
    const int cur = step & 1, nxt = cur ^ 1;
    if (step > 0) {
      // as the forward's h: the buffer's barrier then expects step + 2; a
      // peer's stores for it cannot land while the buffer is still read
      const unsigned bar = cur ? bar1 : bar0;
      mbar_wait(bar, ((step - 1) >> 1) & 1);
      if (tid == 0 && step + 2 < T) mbar_expect(bar, p_bytes);
    }
    lap(4);

    // 1. dh of this step, then dh', dc', dgates and what the row keeps
    const float* tl = ring_s + (step % RG) * L.tile;
    const float* rc = recv_s + cur * rbuf;
    for (int q = tid; q < nq; q += FWD_THREADS) {
      const int row = by_us.quot(q), u = q - row * Us;
      float dh = dh_st[q];
      if (step > 0)
        for (int r = 0; r < C; ++r) dh += rc[r * nq + q];  // in rank order
      const float m = tl[o_mask + row];
      const float dc = dc_st[q];
      const float dh_tot = m * (tl[o_dout + q] + dh);
      const float dc_new = m * dc + dh_tot * tl[o_fa + q];
      const float* f = tl + row * Nc + u;
      const float dg[4] = {dc_new * f[0], dc_new * f[Us], dc_new * f[2 * Us], dh_tot * f[3 * Us]};
      dh_st[q] = (1.0f - m) * dh;
      dc_st[q] = (1.0f - m) * dc + dc_new * tl[o_fs + q];
      W* ds = dg_s + row * L.ldg + u;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) ds[gi * Us] = from_f<W>(dg[gi]);
      if (row0 + row < B) {
        float* gx = dxp + ((size_t)t * B + row0 + row) * G + rank * Us + u;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) gx[gi * U] = dg[gi];
      }
    }
    __syncthreads();
    lap(0);

    // 2. partial dh of every unit from this block's gate columns
    if (step + 1 < T) {
      if (BF) {
        const __nv_bfloat16* db = reinterpret_cast<const __nv_bfloat16*>(dg_s);
        const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(plan.resident ? w_s : wg);
        product_bf16(wb, L.ldw, db, L.ldg, part_s, Nc, Bt, L.Np);
      } else {
        const float* db = reinterpret_cast<const float*>(dg_s);
        if (plan.resident)
          product_f32(reinterpret_cast<const float*>(w_s), db, part_s, Nc, Bt, U, KS);
        else
          product_f32(reinterpret_cast<const float*>(wg), db, part_s, Nc, Bt, U, KS);
      }
    }
    cp_async_wait_all();  // the tile of the next step has landed
    __syncthreads();
    lap(1);

    // 3. the k parts added, each unit's partial to the block that owns it
    if (step + 1 < T) {
      const int u4n = U / 4;
      const unsigned base = smem_addr(recv_s + nxt * rbuf + rank * nq);
      const unsigned bar = nxt ? bar1 : bar0;
      for (int i = tid; i < Bt * u4n; i += FWD_THREADS) {
        const int row = by_u4.quot(i), u = (i - row * u4n) * 4;
        float4 s = *reinterpret_cast<const float4*>(part_s + (size_t)row * L.ldp + u);
        for (int ks = 1; ks < KS; ++ks) {
          const float4 p =
              *reinterpret_cast<const float4*>(part_s + ((size_t)ks * Bt + row) * L.ldp + u);
          s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
        }
        const int peer = by_us.quot(u);
        const unsigned dst = base + (unsigned)((row * Us + u - peer * Us) * sizeof(float));
        store4_async(peer_addr(dst, peer), peer_addr(bar, peer), s);
      }
    }
    lap(2);

    // 4. while the partials travel: the tile of a later step
    if (step + RG < T) prefetch(time_of(step + RG), step % RG);
    cp_async_commit();
    lap(3);
  }
  if (timed)
    for (int i = 0; i < 5; ++i) clocks[i] += spent[i];
  cluster.sync();  // no block leaves while a peer may still address it
}

// ------------------------------------------------ the VJP's loop in the grid layout (past the resident widths)
//
// One cooperative launch of at most one block an SM, in clusters of cl
// blocks (cl = 1, 2, 4 or 8; a launch in clusters only where the card takes
// a cooperative launch made so and holds all its clusters at once, which
// the planner asks before it plans one: ops/lstm.py::backward_plan). The
// product dgates @ Wh^T is cut twice. The U output units of a direction (the
// units of dh) split into G groups of Ug = cl us units, a cluster each;
// inside a cluster the k range, the direction's 4U gate columns, splits into
// cl pieces of 4 U / cl: piece r is the gate columns of the unit run [r U /
// cl, (r + 1) U / cl), k = 4 j + gate for its unit j (the four gates of a
// unit side by side). Block (group g, rank r) holds the tile Wh^T[piece r,
// units of group g] in shared memory as far as it fits (ops/lstm.py::
// grid_wht; 4 U^2 / blocks a direction elements whatever cl: at U = 1024
// 128 KB in bf16, all of it, 256 KB in float32, of which the rest streams
// each step through the ring beside the dgates it multiplies), and owns the
// us units g Ug + r us + [0, us) for the cell gradients. Per step a block
//   1. takes the dh of its units: with cl > 1 the cluster's cl partials,
//      added in rank order (st.async onto a transaction barrier, double
//      buffered, as lstm_bwd_kernel's exchange), with cl = 1 its own
//      product; forms dh', dc', dgates and what a row keeps of dh and dc
//      from the step's factors (requested a step ahead, as the template's);
//   2. writes dgates to dxp[t] and, for the product, into a double-buffered
//      workspace in the operand's type and layout, chunk after chunk of each
//      piece's k order: float32 [rows][kc + 4], bf16 the A fragments. The
//      float32 dgates are copied rather than read from dxp: a piece's k
//      order gathers four gate columns U apart, which no bulk copy of dxp
//      holds together;
//   3. arrives at one grid barrier (grid_sync.cuh);
//   4. its producer warp takes in the step's dgates of its piece for all the
//      pass's rows, chunk by chunk in k order, with bulk copies through the
//      ring (grid_produce), and the consumer warps multiply each chunk by
//      its tile as it lands (grid_product_f32 / grid_product_bf16, shared
//      with the forward): k chunks dealt to parts, parts added in order, so
//      a launch is bitwise repeatable;
//   5. with cl > 1, sends each block of its cluster that block's units of
//      the partial dh (16 bytes a store).
// The last step has no product. Only dgates (and with cl > 1 the partial dh
// in the cluster) move each step: a block takes in rows x 4U / cl of them
// (cl = 1: every gate column of its direction), the cost the planner weighs
// against the exchange (ops/lstm.py::_grid_bwd_step_cycles). Double
// buffering makes one barrier a step enough, as the forward's h: a block
// writes dgates(s + 1) after its product of step s, which needed every
// block's arrival of step s, made after that block had consumed its chunks
// of step s - 1. The partials of step s + 1 land in the buffer the cell
// gradients of step s - 1 read, which every block had left before barrier
// s. A block reads only its own units' columns of dxp (the factors of
// kernel 1 on entry). Rows past the pass's stay zero; padded units and k
// stay exactly zero (zero rows of Wh, zero dgates).

constexpr int GRID_BWD_CLOCKS = 7;

// The consumer threads of a grid loop block, step after step, around their
// product (`product(step, timed, first, later)`, into part_s) and
// `put_dg(buf, row, u, dg)`, which stores the four dgates of the block's unit
// u of a row into dgates buffer `buf` for the product.
template <class Product, class PutDg>
__device__ __forceinline__ void bwd_grid_steps(const BwdArgs& a, const float* __restrict__ mask, int T, int B,
                                               int U, const GridCut& g, const GridLayout& L, int d, int rank,
                                               int u_off, unsigned char* smem, unsigned* bar,
                                               unsigned long long* rbar, Product product, PutDg put_dg,
                                               long long* clocks) {
  const int tid = threadIdx.x, us = g.us, cl = g.cl, Nc = L.Nc, rows = g.rows, G4 = 4 * U;
  float* dxp = a.dxp[d];  // the factors Fi, Ff, Fg, Fo of every step on entry, dgates on exit
  const float* __restrict__ dout = a.dout[d];
  const float* __restrict__ fac = a.fac[d];
  const bool reverse = a.reverse[d] != 0;
  const float* part_s = reinterpret_cast<const float*>(smem + L.part);
  float* recv_s = reinterpret_cast<float*>(smem + L.recv);
  float* tiles = reinterpret_cast<float*>(smem + L.xp);
  float* dc_st = reinterpret_cast<float*>(smem + L.cst);
  float* dh_st = reinterpret_cast<float*>(smem + L.hst);
  const int nq = rows * us, uq = us / 4, nrq = g.nrows * uq;
  const int o_dout = rows * 4 * us, o_fa = o_dout + nq, o_fs = o_fa + nq, o_mask = o_fs + nq;

  for (int q = tid; q < g.nrows * us; q += FWD_THREADS) {
    const int row = q / us, u = q - row * us;
    const size_t idx = (size_t)(g.row0 + row) * U + u_off + u;
    dh_st[q] = a.dhfin[d][idx];
    dc_st[q] = a.dcfin[d][idx];
  }
  // what step t needs of this block's units for the pass's rows -> tile
  // `buf`: the four factors of each unit, dout, A, sf, mask[t]
  auto prefetch = [&](int t, int buf) {
    float* dst = tiles + buf * L.tile;
    for (int i = tid; i < g.nrows * us; i += FWD_THREADS) {
      const int row = i / us, rem = i - row * us;
      const int gate = rem / uq, j = rem - gate * uq;
      cp_async16(dst + row * 4 * us + gate * us + 4 * j,
                 dxp + ((size_t)t * B + g.row0 + row) * G4 + gate * U + u_off + 4 * j);
    }
    for (int i = tid; i < 3 * nrq; i += FWD_THREADS) {
      const int pt = i / nrq, r = i - pt * nrq;
      const int row = r / uq, j = r - row * uq;
      const size_t at = (size_t)t * B + g.row0 + row;
      const float* src = pt == 0 ? dout + at * U : fac + at * 2 * U + (pt - 1) * U;
      cp_async16(dst + o_dout + pt * nq + row * us + 4 * j, src + u_off + 4 * j);
    }
    for (int r = tid; r < g.nrows; r += FWD_THREADS) cp_async4(dst + o_mask + r, mask + (size_t)t * B + g.row0 + r);
    cp_async_commit();
  };
  auto time_of = [&](int step) { return reverse ? step : T - 1 - step; };  // opposite to the forward
  prefetch(time_of(0), 0);
  cp_async_wait_all();
  consumers_sync();
  const unsigned rb0 = smem_addr(&rbar[0]), rb1 = smem_addr(&rbar[1]);
  const unsigned p_bytes = (unsigned)(rows * Nc * 4);

  // clocks (optional, GRID_BWD_CLOCKS counters): SM cycles thread 0 of block
  // 0 spent forming dgates, arriving and requesting the next tile, in the
  // product, waiting for the step's first chunk (the grid barrier and its
  // copy), waiting for later chunks, sending the partials, and waiting for
  // the cluster's partials
  const bool timed = clocks != nullptr && tid == 0 && blockIdx.x == 0;
  long long tick = timed ? clock64() : 0;
  long long spent[GRID_BWD_CLOCKS] = {};
  auto lap = [&](int i) {
    if (timed) {
      const long long now = clock64();
      spent[i] += now - tick;
      tick = now;
    }
  };
  for (int step = 0; step < T; ++step) {
    const int t = time_of(step), cur = step & 1, nxt = cur ^ 1;
    if (cl > 1 && step > 0) {
      // as lstm_bwd_kernel's: the buffer's barrier then expects step + 2
      const unsigned rb = cur ? rb1 : rb0;
      mbar_wait(rb, ((step - 1) >> 1) & 1);
      if (tid == 0 && step + 2 < T) mbar_expect(rb, p_bytes);
    }
    lap(6);

    // 1-2. dh of this step, then dh', dc', dgates and what the row keeps
    const float* tl = tiles + cur * L.tile;
    const float* rc = recv_s + cur * cl * nq;
    for (int q = tid; q < nq; q += FWD_THREADS) {
      const int row = q / us, u = q - row * us;
      float dh = dh_st[q];
      if (step > 0) {
        if (cl == 1)
          dh += part_s[row * Nc + u];
        else
          for (int r = 0; r < cl; ++r) dh += rc[r * nq + q];  // in rank order
      }
      const float m = tl[o_mask + row];
      const float dc = dc_st[q];
      const float dh_tot = m * (tl[o_dout + q] + dh);
      const float dc_new = m * dc + dh_tot * tl[o_fa + q];
      const float* f = tl + row * 4 * us + u;
      const float dg[4] = {dc_new * f[0], dc_new * f[us], dc_new * f[2 * us], dh_tot * f[3 * us]};
      dh_st[q] = (1.0f - m) * dh;
      dc_st[q] = (1.0f - m) * dc + dc_new * tl[o_fs + q];
      if (row < g.nrows) {  // rows past the pass stay zero, in the tiles and the dgates buffers
        float* gx = dxp + ((size_t)t * B + g.row0 + row) * G4 + u_off + u;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) gx[gi * U] = dg[gi];
        if (step + 1 < T) put_dg(cur, row, u, dg);
      }
    }
    consumers_sync();
    lap(0);
    if (step + 1 == T) break;

    // 3. every consumer's dgates are stored: the block arrives at the
    // barrier of this step; the next step's tile is requested
    if (tid == 0) grid_arrive(bar);
    prefetch(time_of(step + 1), nxt);
    lap(1);

    // 4. the partial dh of the cluster's units over this block's k piece
    long long first = 0, later = 0;
    product(step, timed, first, later);
    lap(2);
    if (timed) spent[2] -= first + later, spent[3] += first, spent[4] += later;

    // 5. each block of the cluster its units of the partial
    if (cl > 1) {
      const int c4n = Nc / 4;
      const unsigned base = smem_addr(recv_s + (nxt * cl + rank) * nq);
      const unsigned rb = nxt ? rb1 : rb0;
      for (int i = tid; i < rows * c4n; i += FWD_THREADS) {
        const int row = i / c4n, c4 = (i - row * c4n) * 4;
        const int peer = c4 / us;
        const float4 v = *reinterpret_cast<const float4*>(part_s + row * Nc + c4);
        store4_async(peer_addr(base + (unsigned)((row * us + c4 - peer * us) * 4), peer), peer_addr(rb, peer), v);
      }
    }
    lap(5);
  }
  if (timed)
    for (int i = 0; i < GRID_BWD_CLOCKS; ++i) clocks[i] += spent[i];
}

// The set-up both grid loop kernels share beside grid_setup's: the
// partials' barriers, and (cl > 1) the cluster's sync before any block
// stores into a peer
__device__ __forceinline__ void bwd_grid_setup(const GridCut& g, int T, unsigned long long* rbar) {
  if (g.cl > 1) {
    if (threadIdx.x == 0) {
      const unsigned p_bytes = (unsigned)(g.rows * g.cl * g.us * 4);
      mbar_init(smem_addr(&rbar[0]), 1);
      mbar_init(smem_addr(&rbar[1]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (T > 1) mbar_expect(smem_addr(&rbar[1]), p_bytes);  // step 1's partials
      if (T > 2) mbar_expect(smem_addr(&rbar[0]), p_bytes);  // step 2's
    }
    cg::this_cluster().sync();
  }
}

// the float32 grid loop kernel: a consumer thread takes 4 units of the
// partial dh and TR rows of its part's chunks of dgates (grid_product_f32)
template <int TR>
__global__ void __launch_bounds__(RING_THREADS, 1)
lstm_bwd_grid_kernel(BwdArgs a, const float* __restrict__ mask, int T, int B, int U, GridCut g,
                     unsigned char* ws, long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char grid_smem[];
  __shared__ __align__(8) unsigned long long full_bar[GRID_SLOTS_MAX], empty_bar[GRID_SLOTS_MAX], rbar[2];
  const GridLayout L = grid_layout(g, false);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, cl = g.cl;
  const int per_dir = U / g.us, nd = gridDim.x / per_dir;
  const int d = blockIdx.x / per_dir, b = blockIdx.x - d * per_dir, rank = b % cl;
  const int piece = U / cl, nch = g.kp / g.kc;
  const int u_off = b * g.us;  // group b / cl: units (b / cl) cl us + rank us + [0, us)
  const int pc = u_off / piece, j0 = u_off - pc * piece;  // the k piece of this block's units, their first unit in it
  unsigned* bar = reinterpret_cast<unsigned*>(ws);
  unsigned char* dbufs = ws + GRID_WS_HEAD;  // [2][nd][cl pieces][nch] chunks of [rows][kc + 4] floats
  const unsigned char* wg = static_cast<const unsigned char*>(a.whg[d]) + (size_t)b * g.kp * L.Nc * 4;
  grid_setup(g, L, wg, grid_smem, full_bar, empty_bar, FWD_THREADS / g.ks);
  bwd_grid_setup(g, T, rbar);
  const size_t piece_bytes = (size_t)nch * L.hchunk;
  if (warp == RING_WARPS) {
    if (lane == 0)
      grid_produce(g, L, T - 1, 1, dbufs + (size_t)(d * cl + rank) * piece_bytes, (size_t)nd * cl * piece_bytes, wg,
                   bar, smem_addr(grid_smem + L.ring), full_bar, empty_bar);
    __syncwarp();
    if (cl > 1) cg::this_cluster().sync();  // no block leaves while a peer may still address it
    return;
  }
  auto product = [&](int step, bool timed, long long& first, long long& later) {
    grid_product_f32<TR>(g, L, grid_smem, full_bar, empty_bar, step, timed, first, later);
  };
  // the four dgates of unit u of a row at k = 4 (j0 + u) of piece pc: [chunk][rows][kc + 4] floats
  auto put_dg = [&](int buf, int row, int u, const float (&dg)[4]) {
    const int k = 4 * (j0 + u), ch = k / g.kc;
    float* db = reinterpret_cast<float*>(dbufs + ((size_t)(buf * nd + d) * cl + pc) * piece_bytes + ch * L.hchunk);
    *reinterpret_cast<float4*>(db + (size_t)row * L.ldh + (k - ch * g.kc)) = make_float4(dg[0], dg[1], dg[2], dg[3]);
  };
  bwd_grid_steps(a, mask, T, B, U, g, L, d, rank, u_off, grid_smem, bar, rbar, product, put_dg, clocks);
  if (cl > 1) cg::this_cluster().sync();
}

// the bf16 grid loop kernel: the product on the tensor cores
// (grid_product_bf16), dgates rounded to bf16 in the A fragments' order
template <int MT, int NTW>
__global__ void __launch_bounds__(RING_THREADS, 1)
lstm_bwd_grid_bf16_kernel(BwdArgs a, const float* __restrict__ mask, int T, int B, int U, GridCut g,
                          unsigned char* ws, long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char grid_smem[];
  __shared__ __align__(8) unsigned long long full_bar[GRID_SLOTS_MAX], empty_bar[GRID_SLOTS_MAX], rbar[2];
  const GridLayout L = grid_layout(g, true);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, cl = g.cl;
  const int per_dir = U / g.us, nd = gridDim.x / per_dir;
  const int d = blockIdx.x / per_dir, b = blockIdx.x - d * per_dir, rank = b % cl;
  const int piece = U / cl, nch = g.kp / g.kc;
  const int u_off = b * g.us;
  const int pc = u_off / piece, j0 = u_off - pc * piece;
  unsigned* bar = reinterpret_cast<unsigned*>(ws);
  unsigned char* dbufs = ws + GRID_WS_HEAD;  // [2][nd][cl pieces][k steps][MT][32 lanes][8 bf16]: A fragments
  const unsigned char* wg = static_cast<const unsigned char*>(a.whg[d]) + (size_t)b * g.kp * L.Nc * 2;
  grid_setup(g, L, wg, grid_smem, full_bar, empty_bar, FWD_THREADS / g.ks);
  bwd_grid_setup(g, T, rbar);
  const size_t piece_bytes = (size_t)nch * L.hchunk;
  if (warp == RING_WARPS) {
    if (lane == 0)
      grid_produce(g, L, T - 1, 1, dbufs + (size_t)(d * cl + rank) * piece_bytes, (size_t)nd * cl * piece_bytes, wg,
                   bar, smem_addr(grid_smem + L.ring), full_bar, empty_bar);
    __syncwarp();
    if (cl > 1) cg::this_cluster().sync();
    return;
  }
  auto product = [&](int step, bool timed, long long& first, long long& later) {
    grid_product_bf16<MT, NTW>(g, L, grid_smem, full_bar, empty_bar, step, timed, first, later);
  };
  // the four dgates of unit u of a row, rounded to bf16, at k = 4 (j0 + u) of
  // piece pc: the pairs (i, f) and (g, o) in two lanes' words
  auto put_dg = [&](int buf, int row, int u, const float (&dg)[4]) {
    unsigned* db = reinterpret_cast<unsigned*>(dbufs + ((size_t)(buf * nd + d) * cl + pc) * piece_bytes);
    const int k = 4 * (j0 + u);
    __nv_bfloat162 lo = __floats2bfloat162_rn(dg[0], dg[1]), hi = __floats2bfloat162_rn(dg[2], dg[3]);
    db[a_frag_word(MT, row, k)] = *reinterpret_cast<unsigned*>(&lo);
    db[a_frag_word(MT, row, k + 2)] = *reinterpret_cast<unsigned*>(&hi);
  };
  bwd_grid_steps(a, mask, T, B, U, g, L, d, rank, u_off, grid_smem, bar, rbar, product, put_dg, clocks);
  if (cl > 1) cg::this_cluster().sync();
}

// 3a. partial[s][u, n] = sum over rows m of split s of hprev[m, u] * dgates[m, n]
template <typename W>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
dwh_partial_kernel(BwdArgs a, float* __restrict__ partials, int M, int U, int N,
                   int ksplit, int chunk) {
  __shared__ __align__(16) float As[GK][LDA];
  __shared__ __align__(16) float Gs[GK][GN];
  const int d = blockIdx.z / ksplit, s = blockIdx.z % ksplit;
  const W* __restrict__ A = static_cast<const W*>(a.hprev[d]);
  const float* __restrict__ Gm = a.dxp[d];
  const int n0 = blockIdx.x * GN, u0 = blockIdx.y * GM;
  const int mbeg = s * chunk, mend = min(M, mbeg + chunk);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int arow[2] = {ty * 4, GM / 2 + ty * 4};
  const int bcol[4] = {tx * 4, tx * 4 + 2, GN / 2 + tx * 4, GN / 2 + tx * 4 + 2};
  float acc[8][8] = {};
  for (int k0 = mbeg; k0 < mend; k0 += GK) {
#pragma unroll
    for (int i = 0; i < GK * GM / 4 / GEMM_THREADS; ++i) {  // hprev rows are k: no transpose
      const int e = tid + GEMM_THREADS * i, kk = e / (GM / 4), c = (e % (GM / 4)) * 4;
      const int m = k0 + kk, u = u0 + c;
      const float4 v = (m < mend && u < U) ? load4(A + (size_t)m * U + u)
                                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(&As[kk][c]) = v;
    }
#pragma unroll
    for (int i = 0; i < GK * GN / 4 / GEMM_THREADS; ++i) {
      const int e = tid + GEMM_THREADS * i, kk = e / (GN / 4), c = (e % (GN / 4)) * 4;
      const int m = k0 + kk, n = n0 + c;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m < mend && n < N) {
        v = *reinterpret_cast<const float4*>(Gm + (size_t)m * N + n);
        v = make_float4(dot_in<W>(v.x), dot_in<W>(v.y), dot_in<W>(v.z), dot_in<W>(v.w));
      }
      *reinterpret_cast<float4*>(&Gs[kk][c]) = v;
    }
    __syncthreads();
    tile_fma(As, Gs, arow, bcol, acc);
    __syncthreads();
  }
  float* P = partials + ((size_t)d * ksplit + s) * U * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int u = u0 + arow[i / 4] + i % 4;
    if (u >= U) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + bcol[q];
      if (n < N)
        *reinterpret_cast<float2*>(P + (size_t)u * N + n) = make_float2(acc[i][2 * q], acc[i][2 * q + 1]);
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

// U a multiple of 8 (the slices of a block) up to MAX_UNITS, the widest U at
// which every route (float32 and bf16; forward, residual and the VJP's loop)
// has a plan: past it the VJP's loop has none (ops/lstm.py::MAX_UNITS, which
// a test derives); ops/lstm.py pads any other U with zeros to one the plan
// takes
constexpr int MAX_UNITS = 2048;
bool bad_shape(int nd, int T, int B, int U) {
  return nd < 1 || nd > 2 || T <= 0 || B <= 0 || U <= 0 || U > MAX_UNITS || U % 8 != 0;
}

// what the forward template takes: C divides U into slices of a multiple of
// 8 units (16-byte column groups, 8-column mma tiles), tiles of 8 or 16
// rows, and a layout that fits a block's shared memory with its slice of Wh
// resident
bool bad_plan(int U, FwdPlan p, bool bf) {
  if (p.C < 1 || p.C > 16 || U % p.C || (U / p.C) % 8) return true;
  if (p.Bt != 8 && p.Bt != 16) return true;
  if (p.KS < 1 || p.KS > 16 || (bf && p.KS != 1)) return true;
  return fwd_layout(U, p, bf).total > SMEM_MAX;
}

// what the template loop of the VJP takes: as bad_plan
bool bad_bwd_plan(int U, BwdPlan p, bool bf) {
  if (p.C < 1 || p.C > 16 || U % p.C || (U / p.C) % 8) return true;
  if (p.Bt != 8 && p.Bt != 16) return true;
  if (p.KS < 1 || p.KS > 16 || (bf && p.KS != 1)) return true;
  return bwd_layout(U, p, bf).total > SMEM_MAX;
}

// a launch of `kernel` as clusters of C blocks of `threads` with `smem` dynamic bytes
template <typename K>
cudaError_t prepare_cluster(K kernel, size_t smem, int C, cudaLaunchConfig_t* cfg,
                            cudaLaunchAttribute* attr, int threads = FWD_THREADS) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           C > 8 ? 1 : 0);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// the template kernel of a forward plan, ready to launch or to ask about
template <typename W, bool SAVE_RES>
struct FwdKernel {
  using Fn = void (*)(FwdArgs, const float*, int, int, int, FwdPlan, float, long long*);
  Fn fn = lstm_fwd_kernel<W, SAVE_RES>;
  size_t smem;
  int threads = FWD_THREADS;
  FwdKernel(int U, FwdPlan p) : smem(fwd_layout(U, p, std::is_same<W, __nv_bfloat16>::value).total) {}
};

template <typename W, bool SAVE_RES>
int launch_fwd(const FwdArgs& a, const float* mask, int nd, int T, int B, int U, FwdPlan p,
               float fb, long long* clocks, cudaStream_t stream) {
  const FwdKernel<W, SAVE_RES> k(U, p);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = prepare_cluster(k.fn, k.smem, p.C, &cfg, &attr, k.threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3(p.C * ((B + p.Bt - 1) / p.Bt), nd);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, k.fn, a, mask, T, B, U, p, fb, clocks);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// out[0..3] = clusters of this launch the card can run at once, dynamic
// shared memory bytes, registers a thread, static shared memory bytes
template <typename K>
int cluster_info(K kernel, cudaLaunchConfig_t* cfg, int C, int* out) {
  cfg->gridDim = dim3(C * 64, 1);
  cudaError_t e = cudaOccupancyMaxActiveClusters(&out[0], kernel, cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[1] = (int)cfg->dynamicSmemBytes;
  out[2] = fa.numRegs;
  out[3] = (int)fa.sharedSizeBytes;
  return 0;
}

template <typename W, bool SAVE_RES>
int info_fwd(int U, FwdPlan p, int* out) {
  const FwdKernel<W, SAVE_RES> k(U, p);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = prepare_cluster(k.fn, k.smem, p.C, &cfg, &attr, k.threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  return cluster_info(k.fn, &cfg, p.C, out);
}

// the template loop kernel of a VJP plan, as FwdKernel
template <typename W>
struct BwdKernel {
  using Fn = void (*)(BwdArgs, const float*, int, int, int, BwdPlan, long long*);
  Fn fn = lstm_bwd_kernel<W>;
  size_t smem;
  int threads = FWD_THREADS;
  BwdKernel(int U, BwdPlan p) : smem(bwd_layout(U, p, std::is_same<W, __nv_bfloat16>::value).total) {}
};

template <typename W>
int info_bwd(int U, BwdPlan p, int* out) {
  const BwdKernel<W> k(U, p);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = prepare_cluster(k.fn, k.smem, p.C, &cfg, &attr, k.threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  return cluster_info(k.fn, &cfg, p.C, out);
}

// The bf16 grid kernel's bound on a warp's n-tiles: the NT n-tiles over
// the 8 / ks warps of a part, rounded up to a built instance (2, 4 or 8; a
// warp past its tiles still loads a fragment and skips the product), with
// MT * NTW <= 16 float32 sums of 4 a lane; 0 where none is built.
// ops/lstm.py::grid_bf16_ntw mirrors it.
inline int grid_bf16_ntw(int NT, int ks, int MT) {
  const int need = (NT + RING_WARPS / ks - 1) / (RING_WARPS / ks);
  for (int ntw = 2; ntw <= 8; ntw *= 2)
    if (need <= ntw) return MT * ntw <= 16 ? ntw : 0;
  return 0;
}

// what the VJP's grid kernels take: a cut of U into clusters of cl = 1, 2,
// 4 or 8 runs of a multiple of 8 units, one block each, both directions,
// the k range of a block its cluster's piece, 4 U / cl gate columns; 1, 2,
// 4 or 8 k parts with two ring slots a part or more, chunks of a multiple
// of 4 rows (bf16: 16) that cut the padded k range evenly among the parts,
// a pass of rows inside the batch, a built instance (float32: TR = 4 or 8
// rows a thread, the layout's rows the row tiles' of a part; bf16: MT = 1,
// 2 or 4 tiles of 16 rows), and a layout that fits a block's shared memory
bool bad_grid(int nd, int B, int U, const GridCut& g, bool bf) {
  if (g.us < 8 || g.us % 8 || U % g.us || g.blocks != nd * (U / g.us)) return true;
  if ((g.cl != 1 && g.cl != 2 && g.cl != 4 && g.cl != 8) || (U / g.us) % g.cl) return true;
  if (g.ks != 1 && g.ks != 2 && g.ks != 4 && g.ks != 8) return true;
  if (g.ns < 2 * g.ks || g.ns % g.ks || g.ns > GRID_SLOTS_MAX) return true;
  const int k = 4 * U / g.cl;
  if (g.kc < 4 || g.kc % (bf ? 16 : 4) || g.kp < k || g.kp % (g.kc * g.ks)) return true;
  if (g.nres < 0 || g.nres > g.kp / g.kc) return true;
  if (g.nrows < 1 || g.nrows > g.rows || g.row0 < 0 || g.row0 + g.nrows > B) return true;
  const int nc = g.cl * g.us;  // the product's columns
  if (bf) {
    if ((g.tile != 1 && g.tile != 2 && g.tile != 4) || g.rows != 16 * g.tile) return true;
    if (grid_bf16_ntw(nc / 8, g.ks, g.tile) == 0) return true;
  } else {
    const int nrt = FWD_THREADS / g.ks / (nc / 4);
    if (nrt < 1 || (g.tile != 4 && g.tile != 8) || g.rows != nrt * g.tile) return true;
  }
  return grid_layout(g, bf).total > GRID_SMEM_MAX;
}

// a built instance of the bf16 forward grid kernel: N = rows of 16, 32, 64
// or 128, MTW = 1, 2 or 4 M tiles a warpgroup, at most 64 accumulators a
// thread
inline bool fwd_bf16_built(int rows, int mtw) {
  return (rows == 16 || rows == 32 || rows == 64 || rows == 128) && (mtw == 1 || mtw == 2 || mtw == 4) &&
         mtw * rows <= 128;
}

// what the forward's grid kernels take: a cut of U into runs of a multiple
// of 8 units, one block each, both directions; 1, 2, 4 or 8 k parts (bf16:
// ks = 1, an even number of M tiles of 64 gate columns, half a warpgroup;
// or 2, a warpgroup every M tile of its part's chunks) with two ring slots a
// part or more; float32: chunks of 32, 64 or 128 k rows, TR = 4 or 8 rows a
// thread and the layout's rows the row tiles' of a part; bf16: chunks of 128
// k rows, tile the M tiles a warpgroup takes, a built instance of rows; bf16
// on mma.sync: chunks of a multiple of 16 k rows, MT = 1, 2 or 4 16-row tiles
// and a built instance of a warp's n-tiles; the chunks cutting the padded k
// range evenly among the parts, a pass of rows inside the batch, and a
// layout that fits a block's shared memory
bool bad_fwd_grid(int nd, int B, int U, const GridCut& g, bool bf, bool mma = false) {
  if (g.us < 8 || g.us % 8 || U % g.us || g.blocks != nd * (U / g.us) || g.cl != 1) return true;
  if (g.nrows < 1 || g.nrows > g.rows || g.row0 < 0 || g.row0 + g.nrows > B) return true;
  if (g.ks < 1 || g.ks > 8 || (g.ks & (g.ks - 1)) || g.ns < 2 * g.ks || g.ns % g.ks || g.ns > GRID_SLOTS_MAX)
    return true;
  if (g.kc < (mma ? 16 : 32) || g.kp < U || g.kp % (g.kc * g.ks) || g.nres < 0 || g.nres > g.kp / g.kc) return true;
  if (bf && mma) {
    if (g.kc % 16 || g.ns < 2 * g.ks || g.ns % g.ks || (g.tile != 1 && g.tile != 2 && g.tile != 4)) return true;
    if (g.rows != 16 * g.tile || grid_bf16_ntw(4 * g.us / 8, g.ks, g.tile) == 0) return true;
  } else if (bf) {
    const int mt = (g.us + 15) / 16;
    if (g.kc != 128 || g.ks > 2 || (g.ks == 1 && mt % 2) || g.tile != (g.ks == 1 ? mt / 2 : mt)) return true;
    if (!fwd_bf16_built(g.rows, g.tile)) return true;
  } else {
    const int nrt = FWD_THREADS / g.ks / (g.us / 2);
    if ((g.kc != 32 && g.kc != 64 && g.kc != 128) || nrt < 1) return true;
    if ((g.tile != 4 && g.tile != 8) || g.rows != nrt * g.tile) return true;
  }
  const FwdGridLayout L = fwd_grid_layout(g, bf, mma);
  return L.total + L.align > GRID_SMEM_MAX;
}

using GridFn = void (*)(FwdArgs, const float*, int, int, int, GridCut, float, unsigned char*, long long*);
using BwdGridFn = void (*)(BwdArgs, const float*, int, int, int, GridCut, unsigned char*, long long*);

template <int TR> struct BwdF32 { static BwdGridFn fn() { return lstm_bwd_grid_kernel<TR>; } };
template <int MT, int NTW> struct BwdBf16 { static BwdGridFn fn() { return lstm_bwd_grid_bf16_kernel<MT, NTW>; } };

GridFn grid_kernel(const GridCut& g, bool bf, bool mma) {
  if (!bf) return g.tile == 8 ? lstm_grid_kernel<8> : lstm_grid_kernel<4>;
  if (mma) {
    const int ntw = grid_bf16_ntw(4 * g.us / 8, g.ks, g.tile);
    if (g.tile == 4) return ntw == 2 ? lstm_grid_mma_kernel<4, 2> : lstm_grid_mma_kernel<4, 4>;
    if (g.tile == 2)
      return ntw == 2 ? lstm_grid_mma_kernel<2, 2> : ntw == 4 ? lstm_grid_mma_kernel<2, 4> : lstm_grid_mma_kernel<2, 8>;
    return ntw == 2 ? lstm_grid_mma_kernel<1, 2> : ntw == 4 ? lstm_grid_mma_kernel<1, 4> : lstm_grid_mma_kernel<1, 8>;
  }
  switch (g.rows * 8 + g.tile) {
    case 16 * 8 + 1: return lstm_grid_bf16_kernel<16, 1>;
    case 16 * 8 + 2: return lstm_grid_bf16_kernel<16, 2>;
    case 16 * 8 + 4: return lstm_grid_bf16_kernel<16, 4>;
    case 32 * 8 + 1: return lstm_grid_bf16_kernel<32, 1>;
    case 32 * 8 + 2: return lstm_grid_bf16_kernel<32, 2>;
    case 32 * 8 + 4: return lstm_grid_bf16_kernel<32, 4>;
    case 64 * 8 + 1: return lstm_grid_bf16_kernel<64, 1>;
    case 64 * 8 + 2: return lstm_grid_bf16_kernel<64, 2>;
    default: return lstm_grid_bf16_kernel<128, 1>;  // bad_fwd_grid refuses every other
  }
}
BwdGridFn bwd_grid_kernel(const GridCut& g, bool bf) {
  const int ntw = grid_bf16_ntw(g.cl * g.us / 8, g.ks, g.tile);
  if (!bf) return g.tile == 8 ? BwdF32<8>::fn() : BwdF32<4>::fn();
  if (g.tile == 4) return ntw == 2 ? BwdBf16<4, 2>::fn() : BwdBf16<4, 4>::fn();
  if (g.tile == 2) return ntw == 2 ? BwdBf16<2, 2>::fn() : ntw == 4 ? BwdBf16<2, 4>::fn() : BwdBf16<2, 8>::fn();
  return ntw == 2 ? BwdBf16<1, 2>::fn() : ntw == 4 ? BwdBf16<1, 4>::fn() : BwdBf16<1, 8>::fn();
}

// A grid launch (the listener's forward, the VJP's loop): cooperative, made
// in clusters of cl blocks where cl > 1, refused
// (cudaErrorCooperativeLaunchTooLarge) unless the card holds every block at
// once; no fallback. info, if not null, receives the blocks the card holds
// at once (cl > 1: in clusters, cudaOccupancyMaxActiveClusters times cl),
// the dynamic shared memory bytes a block, the registers a thread and the
// static shared memory bytes; with `go` false nothing is launched.
template <typename... P, typename... A>
int launch_grid(void (*fn)(P...), size_t smem, int blocks, int cl, cudaStream_t stream, int* info, bool go,
                A&&... args) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cl;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(RING_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 2 : 1;
  int held = 0;
  if (cl > 1) {
    cudaLaunchConfig_t q = cfg;  // the clusters the card holds at once
    q.attrs = &attr[1];
    q.numAttrs = 1;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&held, fn, &q);
    held *= cl;
  } else {
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, RING_THREADS, smem);
    held = per_sm * sms;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (info) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, fn);
    if (e != cudaSuccess) return static_cast<int>(e);
    info[0] = held;
    info[1] = (int)smem;
    info[2] = fa.numRegs;
    info[3] = (int)fa.sharedSizeBytes;
  }
  if (!go) return 0;
  if (held < blocks) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  e = cudaLaunchKernelEx(&cfg, fn, std::forward<A>(args)...);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

int launch_grid_fwd(const FwdArgs& a, const float* mask, int T, int B, int U, const GridCut& g, bool bf, bool mma,
                    float fb, void* ws, long long* clocks, cudaStream_t stream, int* info) {
  const FwdGridLayout L = fwd_grid_layout(g, bf, mma);
  return launch_grid(grid_kernel(g, bf, mma), L.total + L.align, g.blocks, 1, stream, info, ws != nullptr, a, mask, T, B,
                     U, g, fb, static_cast<unsigned char*>(ws), clocks);
}

// an empty kernel: whether the card takes a cooperative launch made in clusters
__global__ void cluster_coop_probe() {}

int coop_clusters_taken(int cl) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cl;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * cl);
  cfg.blockDim = dim3(32);
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_coop_probe);
  if (e == cudaSuccess) e = cudaGetLastError();
  cudaGetLastError();  // a refused launch leaves no error behind
  return e == cudaSuccess;
}

GridCut grid_cut(const int* c) {
  return GridCut{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9], c[10], c[11]};
}

constexpr int ROUTE_GRID = 3;      // the grid layout (bf16: wgmma)
constexpr int ROUTE_GRID_MMA = 4;  // the grid layout, bf16 on mma.sync

template <bool SAVE_RES>
int fwd_entry(const float* xp0, const float* xp1, const float* mask, const void* wh0,
              const void* wh1, int nd, int rev_bits, int wh_bf16, float* out0,
              float* out1, void* hprev0, void* hprev1, void* cprev0, void* cprev1,
              float* hfin0, float* hfin1, float* cfin0, float* cfin1, int T, int B,
              int U, float fb, FwdPlan p, int route, const int* cut, void* ws, long long* clocks,
              void* stream) {
  FwdArgs a{{xp0, xp1}, {wh0, wh1}, {out0, out1}, {hprev0, hprev1},
            {cprev0, cprev1}, {hfin0, hfin1}, {cfin0, cfin1},
            {rev_bits & 1, (rev_bits >> 1) & 1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_GRID || route == ROUTE_GRID_MMA) {
    const bool mma = route == ROUTE_GRID_MMA;
    if (cut == nullptr || ws == nullptr || bad_shape(nd, T, B, U) || (mma && !wh_bf16))
      return static_cast<int>(cudaErrorInvalidValue);
    const GridCut g = grid_cut(cut);
    if (bad_fwd_grid(nd, B, U, g, wh_bf16 != 0, mma) || (SAVE_RES && (hprev0 == nullptr || cprev0 == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_grid_fwd(a, mask, T, B, U, g, wh_bf16 != 0, mma, fb, ws, clocks, s, nullptr);
  }
  if (route != 1 || bad_shape(nd, T, B, U) || bad_plan(U, p, wh_bf16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wh_bf16) return launch_fwd<__nv_bfloat16, SAVE_RES>(a, mask, nd, T, B, U, p, fb, clocks, s);
  return launch_fwd<float, SAVE_RES>(a, mask, nd, T, B, U, p, fb, clocks, s);
}

// the four kernels of the VJP on one stream. part_ms is null or 4 floats on
// the host that receive the milliseconds of each kernel (CUDA events; the
// call then waits for the stream)
template <typename W>
int launch_bwd(const BwdArgs& a, const float* mask, float* partials, int nd, int dwh_split,
               int T, int B, int U, float fb, BwdPlan p, const int* cuts, int npass, unsigned char* ws,
               long long ws_pass, long long* clocks, float* part_ms, cudaStream_t stream) {
  constexpr bool bf = std::is_same<W, __nv_bfloat16>::value;
  const int M = T * B, N = 4 * U;
  cudaEvent_t ev[5] = {};
  cudaError_t e = cudaSuccess;
  auto mark = [&](int i) {
    if (part_ms != nullptr && e == cudaSuccess) e = cudaEventRecord(ev[i], stream);
  };
  if (part_ms != nullptr)
    for (int i = 0; i < 5 && e == cudaSuccess; ++i) e = cudaEventCreate(&ev[i]);
  auto finish = [&](cudaError_t err) {
    if (part_ms != nullptr) {
      if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
      for (int i = 0; i < 4 && err == cudaSuccess; ++i)
        err = cudaEventElapsedTime(&part_ms[i], ev[i], ev[i + 1]);
      for (int i = 0; i < 5; ++i)
        if (ev[i]) cudaEventDestroy(ev[i]);
    }
    return static_cast<int>(err);
  };
  if (e != cudaSuccess) return finish(e);
  mark(0);
  const dim3 gates_grid((U + GN / 4 - 1) / (GN / 4), (M + GM - 1) / GM, nd);
  if constexpr (bf) gates_kernel_tc<<<gates_grid, GEMM_THREADS, 0, stream>>>(a, M, U, fb);
  else gates_kernel<W><<<gates_grid, GEMM_THREADS, 0, stream>>>(a, M, U, fb);
  if ((e = cudaGetLastError()) != cudaSuccess) return finish(e);
  mark(1);
  if (cuts != nullptr) {  // the grid layout: a launch a pass of rows, each with its own zeroed workspace
    for (int i = 0; i < npass; ++i) {
      const GridCut g = grid_cut(cuts + 12 * i);
      e = static_cast<cudaError_t>(launch_grid(bwd_grid_kernel(g, bf), grid_layout(g, bf).total, g.blocks,
                                               g.cl, stream, nullptr, true, a, mask, T, B, U, g, ws + i * ws_pass,
                                               clocks));
      if (e != cudaSuccess) return finish(e);
    }
  } else {
    const BwdKernel<W> k(U, p);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    e = prepare_cluster(k.fn, k.smem, p.C, &cfg, &attr, k.threads);
    if (e != cudaSuccess) return finish(e);
    cfg.gridDim = dim3(p.C * ((B + p.Bt - 1) / p.Bt), nd);
    cfg.stream = stream;
    e = cudaLaunchKernelEx(&cfg, k.fn, a, mask, T, B, U, p, clocks);
    if (e != cudaSuccess || (e = cudaGetLastError()) != cudaSuccess) return finish(e);
  }
  mark(2);
  const int chunk = ((M + dwh_split - 1) / dwh_split + TK - 1) / TK * TK;
  const dim3 dwh_grid((N + GN - 1) / GN, (U + GM - 1) / GM, nd * dwh_split);
  if constexpr (bf) dwh_partial_kernel_tc<<<dwh_grid, GEMM_THREADS, 0, stream>>>(a, partials, M, U, N, dwh_split, chunk);
  else dwh_partial_kernel<W><<<dwh_grid, GEMM_THREADS, 0, stream>>>(a, partials, M, U, N, dwh_split, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return finish(e);
  mark(3);
  const long size = (long)U * N;
  const long want = (size + 255) / 256;
  const int blocks = want < 1024 ? (int)want : 1024;
  dwh_reduce_kernel<<<dim3(blocks, nd), 256, 0, stream>>>(a, partials, dwh_split, size);
  if ((e = cudaGetLastError()) != cudaSuccess) return finish(e);
  mark(4);
  return finish(e);
}

// a plan from the entries' arguments (the VJP's: route 0 streams the slice
// by the threads' loads, 1 holds it in shared memory; 3, the grid layout,
// reads its cut instead)
FwdPlan fwd_plan(int cluster, int bt, int ksplit) { return FwdPlan{cluster, bt, ksplit}; }
BwdPlan bwd_plan(int cluster, int bt, int ksplit, int route) { return BwdPlan{cluster, bt, ksplit, route == 1}; }

}  // namespace

// one or two directions of the recurrence -> out, final (h, c). wh0/wh1 are
// regrouped by unit slice for `cluster` blocks (see the header); cluster,
// bt, ksplit and route (1 the template, its slice of Wh resident; 3 the grid
// layout, bf16 on wgmma; 4 the grid layout, bf16 on mma.sync) are the
// caller's plan for the launch; the grid layout reads its
// cut from `cut` (12 ints: GridCut's fields in order) and wh0/wh1
// regrouped by its blocks, and takes `ws`, its workspace (the readiness
// counters, then two h buffers; zeroed by the caller), and ignores cluster,
// bt and ksplit; clocks is null or 5 cycle counters the kernel adds to (see
// the kernels).
extern "C" int plt_lstm_recurrence(const float* xp0, const float* xp1, const float* mask,
                                   const void* wh0, const void* wh1, int nd, int rev_bits,
                                   int wh_bf16, float* out0, float* out1, void* hprev0,
                                   void* hprev1, void* cprev0, void* cprev1, float* hfin0,
                                   float* hfin1, float* cfin0, float* cfin1, int T, int B,
                                   int U, float forget_bias, int cluster, int bt, int ksplit,
                                   int route, const int* cut, void* ws, long long* clocks, void* stream) {
  return fwd_entry<false>(xp0, xp1, mask, wh0, wh1, nd, rev_bits, wh_bf16, out0, out1,
                          hprev0, hprev1, cprev0, cprev1, hfin0, hfin1, cfin0, cfin1, T,
                          B, U, forget_bias, fwd_plan(cluster, bt, ksplit), route, cut, ws, clocks,
                          stream);
}

// as plt_lstm_recurrence, plus the carried state before each step
extern "C" int plt_lstm_residual(const float* xp0, const float* xp1, const float* mask,
                                 const void* wh0, const void* wh1, int nd, int rev_bits,
                                 int wh_bf16, float* out0, float* out1, void* hprev0,
                                 void* hprev1, void* cprev0, void* cprev1, float* hfin0,
                                 float* hfin1, float* cfin0, float* cfin1, int T, int B,
                                 int U, float forget_bias, int cluster, int bt, int ksplit,
                                 int route, const int* cut, void* ws, long long* clocks, void* stream) {
  return fwd_entry<true>(xp0, xp1, mask, wh0, wh1, nd, rev_bits, wh_bf16, out0, out1,
                         hprev0, hprev1, cprev0, cprev1, hfin0, hfin1, cfin0, cfin1, T,
                         B, U, forget_bias, fwd_plan(cluster, bt, ksplit), route, cut, ws, clocks,
                         stream);
}

// what the card gives a cut of the grid layout for nd directions of U
// units (wh_bf16: 0 float32, 1 bf16 on wgmma, 2 bf16 on mma.sync): info as
// launch_grid_fwd's (info[0] the blocks it holds at once)
extern "C" int plt_lstm_grid_info(int U, int nd, int wh_bf16, const int* cut, int* info) {
  const GridCut g = grid_cut(cut);
  if (bad_fwd_grid(nd, g.row0 + g.nrows, U, g, wh_bf16 != 0, wh_bf16 == 2))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{};
  return launch_grid_fwd(a, nullptr, 1, g.row0 + g.nrows, U, g, wh_bf16 != 0, wh_bf16 == 2, 0.0f, nullptr, nullptr,
                         nullptr, info);
}

// what the card gives a plan of the forward kernel: info[0] = clusters it
// can run at once (cudaOccupancyMaxActiveClusters), info[1] = dynamic shared
// memory bytes a block, info[2] = registers a thread, info[3] = static
// shared memory bytes
extern "C" int plt_lstm_fwd_info(int U, int wh_bf16, int save_res, int cluster, int bt,
                                 int ksplit, int route, int* info) {
  const FwdPlan p = fwd_plan(cluster, bt, ksplit);
  if (route != 1 || bad_plan(U, p, wh_bf16 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (wh_bf16)
    return save_res ? info_fwd<__nv_bfloat16, true>(U, p, info)
                    : info_fwd<__nv_bfloat16, false>(U, p, info);
  return save_res ? info_fwd<float, true>(U, p, info) : info_fwd<float, false>(U, p, info);
}

// what the card gives a plan of the VJP's loop kernel: info as plt_lstm_fwd_info
extern "C" int plt_lstm_bwd_info(int U, int wh_bf16, int cluster, int bt, int ksplit,
                                 int route, int* info) {
  const BwdPlan p = bwd_plan(cluster, bt, ksplit, route);
  if (bad_bwd_plan(U, p, wh_bf16 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  return wh_bf16 ? info_bwd<__nv_bfloat16>(U, p, info) : info_bwd<float>(U, p, info);
}

// what the card gives a cut of the VJP's loop in the grid layout for nd
// directions of U units: info[0..3] as plt_lstm_grid_info's (info[0] the
// blocks it holds at once, in clusters of the cut's cl), info[4] whether
// it takes a cooperative launch made in clusters of cl (1 where cl = 1)
extern "C" int plt_lstm_bwd_grid_info(int U, int nd, int wh_bf16, const int* cut, int* info) {
  const GridCut g = grid_cut(cut);
  const bool bf = wh_bf16 != 0;
  if (bad_grid(nd, g.row0 + g.nrows, U, g, bf)) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  const int e = launch_grid(bwd_grid_kernel(g, bf), grid_layout(g, bf).total, g.blocks, g.cl, nullptr, info,
                            false, a, static_cast<const float*>(nullptr), 1, g.row0 + g.nrows, U, g,
                            static_cast<unsigned char*>(nullptr), static_cast<long long*>(nullptr));
  if (e != 0) return e;
  info[4] = g.cl > 1 ? coop_clusters_taken(g.cl) : 1;
  return 0;
}

// the VJP: dxp [T, B, 4U] and dWh [U, 4U] for each direction. wh0/wh1 are
// Wh [U, 4U] for the float32 gates GEMM, wht0/wht1 Wh^T [4U, U] for the bf16
// one (null in float32 mode), whg0/whg1 the loop's tiles of Wh^T (see
// bwd_layout; the grid layout's: ops/lstm.py::grid_wht); cluster, bt, ksplit
// and route (as plt_lstm_recurrence's) are the caller's plan for the loop;
// the grid layout (route 3) reads the cuts of its npass passes of rows from
// `cuts` (npass x 12 ints: GridCut's fields in order) and takes pass i's
// zeroed workspace at ws + i ws_pass bytes (the barrier's counter, then two
// dgates buffers), and ignores cluster, bt and ksplit; fac0/fac1 are scratch
// of T*B*2U floats each, partials of nd*dwh_split*U*4U floats; clocks is null
// or the loop's cycle counters (5; the grid layout's GRID_BWD_CLOCKS); part_ms
// is null or 4 floats on the host for the milliseconds of the four kernels
// (the call then waits for the stream).
extern "C" int plt_lstm_bwd(const float* xp0, const float* xp1, const float* mask,
                            const void* wh0, const void* wh1, const void* whg0,
                            const void* whg1, const void* wht0, const void* wht1,
                            const void* hprev0, const void* hprev1,
                            const void* cprev0, const void* cprev1, const float* dout0,
                            const float* dout1, const float* dhfin0, const float* dhfin1,
                            const float* dcfin0, const float* dcfin1, int nd, int rev_bits,
                            int wh_bf16, float* dxp0, float* dxp1, float* fac0, float* fac1,
                            float* dwh0, float* dwh1, float* partials, int dwh_split, int T, int B, int U,
                            float forget_bias, int cluster, int bt, int ksplit, int route, int npass,
                            const int* cuts, void* ws, long long ws_pass, long long* clocks, float* part_ms,
                            void* stream) {
  const BwdPlan p = bwd_plan(cluster, bt, ksplit, route);
  const bool bf = wh_bf16 != 0;
  if (bad_shape(nd, T, B, U) || dwh_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (route == ROUTE_GRID) {
    if (cuts == nullptr || ws == nullptr || npass < 1) return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < npass; ++i) {
      const GridCut g = grid_cut(cuts + 12 * i);
      if (bad_grid(nd, B, U, g, bf) || (long long)grid_bwd_ws_bytes(nd, g, bf) > ws_pass)
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (bad_bwd_plan(U, p, bf)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a{{xp0, xp1},       {wh0, wh1},       {whg0, whg1},   {wht0, wht1},     {hprev0, hprev1},
            {cprev0, cprev1}, {dout0, dout1},   {dhfin0, dhfin1}, {dcfin0, dcfin1},
            {dxp0, dxp1},     {fac0, fac1},     {dwh0, dwh1},
            {rev_bits & 1, (rev_bits >> 1) & 1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cp = route == ROUTE_GRID ? cuts : nullptr;
  unsigned char* wb = static_cast<unsigned char*>(ws);
  if (bf)
    return launch_bwd<__nv_bfloat16>(a, mask, partials, nd, dwh_split, T, B, U, forget_bias, p, cp, npass, wb,
                                     ws_pass, clocks, part_ms, s);
  return launch_bwd<float>(a, mask, partials, nd, dwh_split, T, B, U, forget_bias, p, cp, npass, wb, ws_pass,
                           clocks, part_ms, s);
}
