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
// streams from L2). The caller chooses C, Bt and the k split from the
// shape (ops/lstm.py::backward_plan); this file refuses what does not
// fit: there is no second route.
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

// what the loop of the VJP takes: as bad_plan
bool bad_bwd_plan(int U, BwdPlan p, bool bf) {
  if (p.C < 1 || p.C > 16 || U % p.C || (U / p.C) % 8) return true;
  if (p.Bt != 8 && p.Bt != 16) return true;
  if (p.KS < 1 || p.KS > 16 || (bf && p.KS != 1)) return true;
  if (!p.resident && p.C != 1) return true;
  return bwd_layout(U, p, bf).total > SMEM_MAX;
}

// a launch of `kernel` as clusters of C blocks with `smem` dynamic bytes
template <typename K>
cudaError_t prepare_cluster(K kernel, size_t smem, int C, cudaLaunchConfig_t* cfg,
                            cudaLaunchAttribute* attr) {
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
  cfg->blockDim = dim3(FWD_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename W, bool SAVE_RES>
cudaError_t prepare_fwd(int U, FwdPlan p, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const bool bf = std::is_same<W, __nv_bfloat16>::value;
  return prepare_cluster(lstm_fwd_kernel<W, SAVE_RES>, fwd_layout(U, p, bf).total, p.C, cfg, attr);
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
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = prepare_fwd<W, SAVE_RES>(U, p, &cfg, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return cluster_info(lstm_fwd_kernel<W, SAVE_RES>, &cfg, p.C, out);
}

template <typename W>
int info_bwd(int U, BwdPlan p, int* out) {
  const bool bf = std::is_same<W, __nv_bfloat16>::value;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = prepare_cluster(lstm_bwd_kernel<W>, bwd_layout(U, p, bf).total, p.C, &cfg, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return cluster_info(lstm_bwd_kernel<W>, &cfg, p.C, out);
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

// the four kernels of the VJP on one stream. part_ms is null or 4 floats on
// the host that receive the milliseconds of each kernel (CUDA events; the
// call then waits for the stream)
template <typename W>
int launch_bwd(const BwdArgs& a, const float* mask, float* partials, int nd, int dwh_split,
               int T, int B, int U, float fb, BwdPlan p, long long* clocks, float* part_ms,
               cudaStream_t stream) {
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
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  e = prepare_cluster(lstm_bwd_kernel<W>, bwd_layout(U, p, bf).total, p.C, &cfg, &attr);
  if (e != cudaSuccess) return finish(e);
  cfg.gridDim = dim3(p.C * ((B + p.Bt - 1) / p.Bt), nd);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, lstm_bwd_kernel<W>, a, mask, T, B, U, p, clocks);
  if (e != cudaSuccess || (e = cudaGetLastError()) != cudaSuccess) return finish(e);
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

// what the card gives a plan of the VJP's loop kernel: info as plt_lstm_fwd_info
extern "C" int plt_lstm_bwd_info(int U, int wh_bf16, int cluster, int bt, int ksplit,
                                 int resident, int* info) {
  const BwdPlan p{cluster, bt, ksplit, resident};
  if (bad_bwd_plan(U, p, wh_bf16 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  return wh_bf16 ? info_bwd<__nv_bfloat16>(U, p, info) : info_bwd<float>(U, p, info);
}

// the VJP: dxp [T, B, 4U] and dWh [U, 4U] for each direction. wh0/wh1 are
// Wh [U, 4U] for the float32 gates GEMM, wht0/wht1 Wh^T [4U, U] for the bf16
// one (null in float32 mode), whg0/whg1 the loop's slices of Wh^T for
// `cluster` blocks (see bwd_layout); cluster, bt, ksplit and resident are
// the caller's plan for the loop; fac0/fac1 are scratch of T*B*2U
// floats each, partials of nd*dwh_split*U*4U floats; clocks is null or 5 cycle counters the loop
// adds to; part_ms is null or 4 floats on the host for the milliseconds of
// the four kernels (the call then waits for the stream).
extern "C" int plt_lstm_bwd(const float* xp0, const float* xp1, const float* mask,
                            const void* wh0, const void* wh1, const void* whg0,
                            const void* whg1, const void* wht0, const void* wht1,
                            const void* hprev0, const void* hprev1,
                            const void* cprev0, const void* cprev1, const float* dout0,
                            const float* dout1, const float* dhfin0, const float* dhfin1,
                            const float* dcfin0, const float* dcfin1, int nd, int rev_bits,
                            int wh_bf16, float* dxp0, float* dxp1, float* fac0, float* fac1,
                            float* dwh0, float* dwh1, float* partials, int dwh_split, int T, int B, int U,
                            float forget_bias, int cluster, int bt, int ksplit, int resident,
                            long long* clocks, float* part_ms, void* stream) {
  const BwdPlan p{cluster, bt, ksplit, resident};
  if (bad_shape(nd, T, B, U) || dwh_split < 1 || bad_bwd_plan(U, p, wh_bf16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{{xp0, xp1},       {wh0, wh1},       {whg0, whg1},   {wht0, wht1},     {hprev0, hprev1},
            {cprev0, cprev1}, {dout0, dout1},   {dhfin0, dhfin1}, {dcfin0, dcfin1},
            {dxp0, dxp1},     {fac0, fac1},     {dwh0, dwh1},
            {rev_bits & 1, (rev_bits >> 1) & 1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wh_bf16)
    return launch_bwd<__nv_bfloat16>(a, mask, partials, nd, dwh_split, T, B, U, forget_bias, p,
                                     clocks, part_ms, s);
  return launch_bwd<float>(a, mask, partials, nd, dwh_split, T, B, U, forget_bias, p, clocks,
                           part_ms, s);
}
