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
// and the final (h, c). The TPU kernel walks time as its sequential grid;
// here the loop over t runs inside the block. One block runs one direction
// for R = 4 batch rows (grid = ceil(B/4) x nd, so two directions run
// concurrently on different SMs), one thread per gate column (4U threads).
// R = 4 balances the block's own FMA work per step (R*U*4U) against the L2
// traffic of Wh, which every block reads in full at every step: Wh is 1 MB
// in float32 (512 KB in bf16), more than a block's 227 KB of shared memory,
// so it streams from L2, coalesced along 4U. h sits in shared memory for
// the dot (read as a broadcast), and each thread keeps the c and h of its
// one (row, unit) pair in registers. With SAVE_RES the kernel writes the
// carried state before each step, hprev[t] and cprev[t], in the type of Wh
// (bf16 in bf16 mode, as the reference stores them).
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
//      laid out as the forward: R = 4 rows a block, thread j owns the
//      (row j/U, unit j%U) pair, and for the dot sums quarter j/U of the 4U
//      gate columns for unit j%U over all R rows; the four partial sums meet
//      in shared memory;
//   3. dWh = sum_t hprev_t^T dgates_t over T*B rows as a split-K GEMM: each
//      block writes the partial sum of its row range, and a second kernel
//      adds the partials in a fixed order, so repeated runs are bitwise
//      equal (no float atomics).
// In bf16 mode (Wh in bf16) the operands of every dot are bf16 values (h,
// hprev and dgates rounded) with float32 accumulation; xp and dxp stay
// float32 (the reference streams them bf16).
//
// Bounds (67 TFLOP/s float32, 3.35 TB/s). Serving's first layer (B = 64,
// U = 256, T = 999, both directions): 2*2*T*B*U*4U = 67 GFLOP (1.0 ms)
// against 0.65 GB (0.2 ms). The training shape (B = 32): the forward's
// dots are 33.5 GFLOP (0.50 ms) against 0.46 GB moved (0.14 ms); the VJP
// does three products of that size (1.5 ms) against 0.72 GB (0.21 ms).
// Operations bound them all. In this simple form the serial loops wait on
// the per-step L2 reads of Wh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int R = 4;  // batch rows per block of the serial kernels

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

struct FwdArgs {
  const float* xp[2];  // [T, B, 4U]
  const void* wh[2];   // [U, 4U] W
  float* out[2];       // [T, B, U]
  void* hprev[2];      // [T, B, U] W (SAVE_RES only)
  void* cprev[2];
  float* hfin[2];      // [B, U]
  float* cfin[2];
  int reverse[2];
};

template <typename W, bool SAVE_RES>
__global__ void __launch_bounds__(1024)
lstm_fwd_kernel(FwdArgs a, const float* __restrict__ mask, int T, int B, int U,
                float forget_bias) {
  extern __shared__ float smem[];
  const int d = blockIdx.y;
  const float* __restrict__ xp = a.xp[d];
  const W* __restrict__ wh = static_cast<const W*>(a.wh[d]);
  float* __restrict__ out = a.out[d];
  W* hprev = static_cast<W*>(a.hprev[d]);
  W* cprev = static_cast<W*>(a.cprev[d]);
  const bool reverse = a.reverse[d] != 0;

  const int G = 4 * U;  // gate columns == blockDim.x
  const int row0 = blockIdx.x * R;
  float* hdot_s = smem;           // [R, U] h as the dot reads it
  float* gates_s = smem + R * U;  // [R, 4U]
  const int j = threadIdx.x;

  // this thread's (row, unit) pair for the cell update (R*U == 4U)
  const int pr = j / U, pu = j - (j / U) * U;
  const int prow = row0 + pr;
  const bool live = prow < B;
  float h = 0.0f, c = 0.0f;
  hdot_s[j] = 0.0f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < U; ++k) {
      const float w = to_f(wh[(long)k * G + j]);
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
      const long pair = ((long)t * B + prow) * U + pu;
      if (SAVE_RES) {
        hprev[pair] = from_f<W>(h);
        cprev[pair] = from_f<W>(c);
      }
      const float* g = gates_s + pr * G;
      const float gi = g[pu], gf = g[U + pu], gg = g[2 * U + pu], go = g[3 * U + pu];
      const float c_new = sigmoidf_(gf + forget_bias) * c + sigmoidf_(gi) * tanhf(gg);
      const float h_new = sigmoidf_(go) * tanhf(c_new);
      const float m = mask[(long)t * B + prow];
      h = m * h_new + (1.0f - m) * h;
      c = m * c_new + (1.0f - m) * c;
      out[pair] = m * h_new;
      hdot_s[j] = dot_in<W>(h);
    }
    __syncthreads();
  }
  if (live) {
    a.hfin[d][(long)prow * U + pu] = h;
    a.cfin[d][(long)prow * U + pu] = c;
  }
}

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
  // one thread per gate column, and R*U == 4U: each thread owns exactly one
  // (row, unit) pair of the cell update
  return nd < 1 || nd > 2 || T <= 0 || B <= 0 || 4 * U > 1024 || (4 * U) % 32 != 0;
}

template <typename W, bool SAVE_RES>
int launch_fwd(const FwdArgs& a, const float* mask, int nd, int T, int B, int U,
               float fb, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)R * 5 * U;
  dim3 grid((B + R - 1) / R, nd);
  lstm_fwd_kernel<W, SAVE_RES><<<grid, 4 * U, smem, stream>>>(a, mask, T, B, U, fb);
  return static_cast<int>(cudaGetLastError());
}

template <bool SAVE_RES>
int fwd_entry(const float* xp0, const float* xp1, const float* mask, const void* wh0,
              const void* wh1, int nd, int rev_bits, int wh_bf16, float* out0,
              float* out1, void* hprev0, void* hprev1, void* cprev0, void* cprev1,
              float* hfin0, float* hfin1, float* cfin0, float* cfin1, int T, int B,
              int U, float fb, void* stream) {
  if (bad_shape(nd, T, B, U)) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{{xp0, xp1}, {wh0, wh1}, {out0, out1}, {hprev0, hprev1},
            {cprev0, cprev1}, {hfin0, hfin1}, {cfin0, cfin1},
            {rev_bits & 1, (rev_bits >> 1) & 1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wh_bf16) return launch_fwd<__nv_bfloat16, SAVE_RES>(a, mask, nd, T, B, U, fb, s);
  return launch_fwd<float, SAVE_RES>(a, mask, nd, T, B, U, fb, s);
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

// one or two directions of the recurrence -> out, final (h, c)
extern "C" int plt_lstm_recurrence(const float* xp0, const float* xp1, const float* mask,
                                   const void* wh0, const void* wh1, int nd, int rev_bits,
                                   int wh_bf16, float* out0, float* out1, void* hprev0,
                                   void* hprev1, void* cprev0, void* cprev1, float* hfin0,
                                   float* hfin1, float* cfin0, float* cfin1, int T, int B,
                                   int U, float forget_bias, void* stream) {
  return fwd_entry<false>(xp0, xp1, mask, wh0, wh1, nd, rev_bits, wh_bf16, out0, out1,
                          hprev0, hprev1, cprev0, cprev1, hfin0, hfin1, cfin0, cfin1, T,
                          B, U, forget_bias, stream);
}

// as plt_lstm_recurrence, plus the carried state before each step
extern "C" int plt_lstm_residual(const float* xp0, const float* xp1, const float* mask,
                                 const void* wh0, const void* wh1, int nd, int rev_bits,
                                 int wh_bf16, float* out0, float* out1, void* hprev0,
                                 void* hprev1, void* cprev0, void* cprev1, float* hfin0,
                                 float* hfin1, float* cfin0, float* cfin1, int T, int B,
                                 int U, float forget_bias, void* stream) {
  return fwd_entry<true>(xp0, xp1, mask, wh0, wh1, nd, rev_bits, wh_bf16, out0, out1,
                         hprev0, hprev1, cprev0, cprev1, hfin0, hfin1, cfin0, cfin1, T,
                         B, U, forget_bias, stream);
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
