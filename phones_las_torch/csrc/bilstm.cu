// Fused bidirectional LSTM recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel phones_las_tpu/ops/lstm.py:
// _recurrence_pallas_bidir (kernel body _make_bilstm_kernel), reached
// through pallas_bidir_recurrence on the listener's inference path.
//
// What it computes, for each direction d (forward walks t = 0..T-1, backward
// walks t = T-1..0, outputs land at their original time index):
//   gates = xp_d[t] + h @ Wh_d                  [B, 4U], gate order (i,f,g,o)
//   c'    = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(g)
//   h'    = sigmoid(o) * tanh(c')
//   h, c  = m*h' + (1-m)*h, m*c' + (1-m)*c     (m = mask[t, b]: frozen past the length)
//   out_d[t] = m * h'
// and the final (h, c) of each direction.
//
// Design. The TPU kernel walks time as its sequential grid; here the loop
// over t runs inside the block. One block runs one direction for R = 4 batch
// rows (grid = ceil(B/4) x 2), so the two directions run concurrently on
// different SMs; at B = 64 that is 32 blocks. R = 4 balances the block's own
// FMA work per step (R*U*4U) against the L2 traffic of Wh, which every block
// reads in full at every step: Wh is 1 MB in float32 (512 KB in bf16), more
// than the 227 KB of shared memory a block can hold, so it streams from L2
// with one thread per gate column (4U = 1024 threads, coalesced along 4U).
// h is kept in shared memory (the dot reads it as a broadcast), the block's
// gates go through shared memory to the cell update, and each thread keeps
// the c and h of the one (row, unit) pair it updates in registers.
//
// Bound at the main path's first layer (T = 999, B = 64, U = 256): the
// recurrent dots are 2*2*T*B*U*4U = 67 GFLOP of float32 (about 1.0 ms at
// 67 TFLOP/s) against 0.65 GB of xp, mask and output (about 0.2 ms at
// 3.35 TB/s): operations bound it. In this simple form the per-step reads
// of Wh from L2 are what the block waits on; keeping Wh resident across the
// SMs of a cluster is the next step.
//
// Precision: wh_bf16 = 0 is float32 throughout. wh_bf16 = 1 takes Wh in
// bf16 and rounds h to bf16 before the dot; products of two bf16 values are
// exact in float32 and are accumulated in float32, and the gate math and c
// stay float32 (the reference's prec="bf16").

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int R = 4;  // batch rows per block

__device__ __forceinline__ float load_w(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float dot_in(float h, const float*) { return h; }
__device__ __forceinline__ float dot_in(float h, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(h));
}
__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename W>
__global__ void __launch_bounds__(1024)
bilstm_kernel(const float* __restrict__ xpf, const float* __restrict__ xpb,
              const float* __restrict__ mask, const W* __restrict__ whf,
              const W* __restrict__ whb, float* __restrict__ outf,
              float* __restrict__ outb, float* __restrict__ hf,
              float* __restrict__ cf, float* __restrict__ hb,
              float* __restrict__ cb, int T, int B, int U, float forget_bias) {
  extern __shared__ float smem[];
  const int dir = blockIdx.y;
  const float* xp = dir ? xpb : xpf;
  const W* wh = dir ? whb : whf;
  float* out = dir ? outb : outf;
  float* hfin = dir ? hb : hf;
  float* cfin = dir ? cb : cf;

  const int G = 4 * U;  // gate columns == blockDim.x
  const int row0 = blockIdx.x * R;
  float* hdot_s = smem;          // [R, U] h as the dot reads it
  float* gates_s = smem + R * U;  // [R, 4U]
  const int j = threadIdx.x;

  // this thread's (row, unit) pair for the cell update: p = j (R*U <= 4U)
  const bool owns = j < R * U;
  const int pr = j / U, pu = j - (j / U) * U;
  const int prow = row0 + pr;
  const bool live = owns && prow < B;
  float h = 0.0f, c = 0.0f;
  if (owns) hdot_s[j] = 0.0f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = dir ? T - 1 - step : step;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < U; ++k) {
      const float w = load_w(wh + (long)k * G + j);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(hdot_s[r * U + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      if (row < B) gates_s[r * G + j] = xp[((long)t * B + row) * G + j] + acc[r];
    }
    __syncthreads();

    if (live) {
      const float* g = gates_s + pr * G;
      const float gi = g[pu], gf = g[U + pu], gg = g[2 * U + pu], go = g[3 * U + pu];
      const float c_new = sigmoidf(gf + forget_bias) * c + sigmoidf(gi) * tanhf(gg);
      const float h_new = sigmoidf(go) * tanhf(c_new);
      const float m = mask[(long)t * B + prow];
      h = m * h_new + (1.0f - m) * h;
      c = m * c_new + (1.0f - m) * c;
      out[((long)t * B + prow) * U + pu] = m * h_new;
      hdot_s[j] = dot_in(h, wh);
    }
    __syncthreads();
  }
  if (live) {
    hfin[(long)prow * U + pu] = h;
    cfin[(long)prow * U + pu] = c;
  }
}

template <typename W>
int launch(const float* xpf, const float* xpb, const float* mask, const void* whf,
           const void* whb, float* outf, float* outb, float* hf, float* cf,
           float* hb, float* cb, int T, int B, int U, float forget_bias,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)R * 5 * U;
  dim3 grid((B + R - 1) / R, 2);
  bilstm_kernel<W><<<grid, 4 * U, smem, stream>>>(
      xpf, xpb, mask, static_cast<const W*>(whf), static_cast<const W*>(whb),
      outf, outb, hf, cf, hb, cb, T, B, U, forget_bias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int plt_bilstm(const float* xpf, const float* xpb, const float* mask,
                          const void* whf, const void* whb, int wh_bf16,
                          float* outf, float* outb, float* hf, float* cf,
                          float* hb, float* cb, int T, int B, int U,
                          float forget_bias, void* stream) {
  // one thread per gate column, and R*U <= 4U so each thread owns at most
  // one (row, unit) pair of the cell update
  if (4 * U > 1024 || (4 * U) % 32 != 0 || R > 4 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wh_bf16)
    return launch<__nv_bfloat16>(xpf, xpb, mask, whf, whb, outf, outb, hf, cf,
                                 hb, cb, T, B, U, forget_bias, s);
  return launch<float>(xpf, xpb, mask, whf, whb, outf, outb, hf, cf, hb, cb, T,
                       B, U, forget_bias, s);
}
