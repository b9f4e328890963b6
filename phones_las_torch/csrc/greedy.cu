// Fused greedy attention decoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel phones_las_tpu/decode/pallas_greedy.py:
// greedy_decode_fused (kernel body _kernel).
//
// What it computes: the whole greedy decode of one utterance, state kept
// across steps. Each step, from the previous token (first <bos>):
//   x      = [embedding[token]; attention vector]
//   cells  = n LSTM cells, gates = x@wx + b + h@wh, forget bias 1.0
//            (hard-coded, as in the reference kernel), gate order (i,f,g,o)
//   q      = cell_out @ wq
//   score  = tanh(keys[t] + q) . v + (1 - mask[t]) * -1e9
//   probs  = exp(score - max) * mask / max(sum, 1e-30)
//   ctx    = probs @ memory
//   attn   = [cell_out; ctx] @ attention_layer
//   token  = argmax(attn @ out_w + out_b)       (first index of the maximum)
// A row stops computing once it has emitted <eos> and writes <eos> for the
// remaining steps. This masked softmax differs from attention_scores's
// where(mask, s, -1e9) softmax only for a row with no valid position, where
// it gives zero weights instead of uniform ones; it is reproduced exactly.
//
// Design. The TPU kernel runs groups of 8 rows one after another on its one
// core and keeps state in VMEM across the step axis of its grid. Here one
// block decodes one batch row and loops over the steps inside the block, so
// rows decode in parallel on different SMs and each block stops on its own
// <eos>. The token, the finished flag, the attention vector and every cell's
// h and c live in shared memory. The row's keys [T, A] and memory [T, M] are
// staged in shared memory when they fit (T = 41: 42 KB + 84 KB) and read from
// L2 otherwise (T = 250: 768 KB). The embedding row is gathered, which is
// bit-identical to the reference's one-hot product. The weights (about 5.5 MB
// in float32 for the flagship speller) are read from L2 at every step with
// one thread per output column, coalesced.
//
// Bound at the main path's shape (B = 64, T = 250, up to 200 steps, the
// checkpoint's 2 x 256 cells): per row and step about 3.3 MFLOP of float32
// (the cell dots dominate), so operations bound it when rows run to the cap
// (about 0.6 ms at 67 TFLOP/s for 64 x 200 row-steps); the keys and memory
// are 49 MB. This simple form waits on the per-step weight reads from L2.
//
// Precision: float32 throughout, as the reference kernel's HIGHEST dots.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float NEG = -1e9f;
constexpr int THREADS = 1024;
// bytes of dynamic shared memory a block may use: the 232448 of the card
// less room for the kernel's static token and finished flags
constexpr size_t SMEM_MAX = 232448 - 64;

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t state_floats(int T, int A, int M, int V, int E, int AL, int U, int n_cells) {
  return (size_t)(E + AL) + 2 * n_cells * U + 4 * U + A + T + U + M + V + 1;
}

__global__ void __launch_bounds__(THREADS)
greedy_kernel(const float* __restrict__ keys, const float* __restrict__ mem,
              const float* __restrict__ mask, const float* __restrict__ emb,
              const float* __restrict__ wq, const float* __restrict__ v,
              const float* __restrict__ attn_w, const float* __restrict__ out_w,
              const float* __restrict__ out_b, const float* const* __restrict__ cells,
              int T, int A, int M, int V, int E, int AL, int U, int n_cells,
              int bos, int eos, int steps, int staged, int* __restrict__ tokens) {
  extern __shared__ float smem[];
  __shared__ int tok_s, fin_s;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int G = 4 * U;

  float* x_s = smem;                       // [E + AL]: embedding | attention vector
  float* hc_s = x_s + E + AL;              // [n_cells][h U | c U]
  float* gates_s = hc_s + 2 * n_cells * U;  // [4U]
  float* q_s = gates_s + G;                // [A]
  float* sc_s = q_s + A;                   // [T] scores, then weights
  float* cat_s = sc_s + T;                 // [U + M]: cell output | context
  float* lg_s = cat_s + U + M;             // [V]
  float* sum_s = lg_s + V;                 // [1] softmax denominator
  float* kv_s = sum_s + 1;                 // staged keys [T, A] | memory [T, M]

  const float* K = keys + (long)b * T * A;
  const float* Mm = mem + (long)b * T * M;
  const float* mk = mask + (long)b * T;
  if (staged) {
    for (int i = tid; i < T * A; i += nthreads) kv_s[i] = K[i];
    for (int i = tid; i < T * M; i += nthreads) kv_s[T * A + i] = Mm[i];
    K = kv_s;
    Mm = kv_s + T * A;
  }
  for (int i = tid; i < AL; i += nthreads) x_s[E + i] = 0.0f;
  for (int i = tid; i < 2 * n_cells * U; i += nthreads) hc_s[i] = 0.0f;
  if (tid == 0) {
    tok_s = bos;
    fin_s = 0;
  }
  __syncthreads();

  int* out = tokens + (long)b * steps;
  for (int s = 0; s < steps; ++s) {
    if (fin_s) {  // uniform: read after a barrier, written before one
      for (int i = s + tid; i < steps; i += nthreads) out[i] = eos;
      break;
    }
    for (int e = tid; e < E; e += nthreads) x_s[e] = emb[(long)tok_s * E + e];
    __syncthreads();

    // LSTM cell stack
    const float* xin = x_s;
    int din = E + AL;
    for (int l = 0; l < n_cells; ++l) {
      const float* wx = cells[3 * l];
      const float* wh = cells[3 * l + 1];
      const float* bb = cells[3 * l + 2];
      float* h = hc_s + 2 * l * U;
      float* c = h + U;
      for (int j = tid; j < G; j += nthreads) {
        float ax = 0.0f, ah = 0.0f;
#pragma unroll 8
        for (int k = 0; k < din; ++k) ax = fmaf(xin[k], wx[(long)k * G + j], ax);
#pragma unroll 8
        for (int k = 0; k < U; ++k) ah = fmaf(h[k], wh[(long)k * G + j], ah);
        gates_s[j] = (ax + bb[j]) + ah;
      }
      __syncthreads();
      for (int u = tid; u < U; u += nthreads) {
        const float gi = gates_s[u], gf = gates_s[U + u];
        const float gg = gates_s[2 * U + u], go = gates_s[3 * U + u];
        const float c_new = sigmoidf(gf + 1.0f) * c[u] + sigmoidf(gi) * tanhf(gg);
        c[u] = c_new;
        h[u] = sigmoidf(go) * tanhf(c_new);
      }
      __syncthreads();
      xin = h;
      din = U;
    }

    // query, and the cell output into [cell_out; ctx]
    for (int a = tid; a < A; a += nthreads) {
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < U; ++k) acc = fmaf(xin[k], wq[(long)k * A + a], acc);
      q_s[a] = acc;
    }
    for (int u = tid; u < U; u += nthreads) cat_s[u] = xin[u];
    __syncthreads();

    // additive scores: one warp per encoder position
    for (int t = warp; t < T; t += nwarps) {
      float acc = 0.0f;
      for (int a = lane; a < A; a += 32) acc += tanhf(K[(long)t * A + a] + q_s[a]) * v[a];
      acc = warp_sum(acc);
      if (lane == 0) sc_s[t] = acc + (1.0f - mk[t]) * NEG;
    }
    __syncthreads();

    // masked softmax: exp(s - max) * mask / max(sum, 1e-30)
    if (warp == 0) {
      float mx = -CUDART_INF_F;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, sc_s[t]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int t = lane; t < T; t += 32) {
        const float e = expf(sc_s[t] - mx) * mk[t];
        sc_s[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) sum_s[0] = fmaxf(sum, 1e-30f);
    }
    __syncthreads();
    for (int t = tid; t < T; t += nthreads) sc_s[t] = sc_s[t] / sum_s[0];
    __syncthreads();

    // context
    for (int m = tid; m < M; m += nthreads) {
      float acc = 0.0f;
      for (int t = 0; t < T; ++t) acc = fmaf(sc_s[t], Mm[(long)t * M + m], acc);
      cat_s[U + m] = acc;
    }
    __syncthreads();

    // attention vector, written where the next step's cell input reads it
    for (int n = tid; n < AL; n += nthreads) {
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < U + M; ++k) acc = fmaf(cat_s[k], attn_w[(long)k * AL + n], acc);
      x_s[E + n] = acc;
    }
    __syncthreads();

    // logits: one warp per vocabulary entry
    for (int o = warp; o < V; o += nwarps) {
      float acc = 0.0f;
      for (int k = lane; k < AL; k += 32) acc += x_s[E + k] * out_w[(long)k * V + o];
      acc = warp_sum(acc);
      if (lane == 0) lg_s[o] = acc + out_b[o];
    }
    __syncthreads();

    if (tid == 0) {
      int best = 0;
      for (int o = 1; o < V; ++o)
        if (lg_s[o] > lg_s[best]) best = o;
      out[s] = best;
      tok_s = best;
      fin_s = best == eos;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int plt_greedy_decode(const float* keys, const float* mem, const float* mask,
                                 int B, int T, int A, int M, const float* emb, int V,
                                 int E, const float* wq, const float* v,
                                 const float* attn_w, int AL, const float* out_w,
                                 const float* out_b, const void* cell_ptrs, int n_cells,
                                 int U, int bos, int eos, int steps, int* tokens,
                                 void* stream) {
  if (B <= 0 || n_cells <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t base = sizeof(float) * state_floats(T, A, M, V, E, AL, U, n_cells);
  const size_t with_kv = base + sizeof(float) * (size_t)T * (A + M);
  const int staged = with_kv <= SMEM_MAX;
  const size_t smem = staged ? with_kv : base;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  greedy_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, mem, mask, emb, wq, v, attn_w, out_w, out_b,
      static_cast<const float* const*>(cell_ptrs), T, A, M, V, E, AL, U, n_cells,
      bos, eos, steps, staged, tokens);
  return static_cast<int>(cudaGetLastError());
}
