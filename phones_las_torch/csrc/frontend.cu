// Fused log-mel front-end for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel phones_las_tpu/frontend/pallas_frontend.py:
// fused_logmel (kernel body _kernel, helper _split_dot).
//
// What it computes, per utterance b and frame t (frames of a signal that is
// already pre-emphasised and masked, zero past the buffer):
//   re/im[k] = sum_i x[b, t*hop + i] * basis[i, k | nbins + k]   (i < win)
//   power[k] = (re^2 + im^2) / nfft
//   energy   = sum_k power[k]
//   logmel[m] = log(max(sum_k power[k] * mel[k, m], eps64))
//
// Design. One block per (utterance, tile of FT = 16 frames). The tile's
// sample window, (FT-1)*hop + win floats (2800 at 16 kHz, 11 KB), is staged
// in shared memory and the frames are read from there: the [B, T, win]
// framed tensor never exists in device memory. The windowed DFT basis
// [win, 2*nbins] (822 KB in float32) does not fit in shared memory; each
// thread owns one frequency bin k and streams its two basis columns through
// L2 (coalesced across the warp), accumulating re/im for all 16 frames in
// registers, so each basis element read feeds 16 FMAs. The power tile goes
// to shared memory, where the energy row sums and the mel product are taken.
//
// Bound at the main path's shape (B = 64 x 10 s, T = 999): 2*B*T*win*2*nbins
// = 26 GFLOP of float32 against ~52 MB of device-memory traffic: operations
// bound it (about 0.4 ms at 67 TFLOP/s of float32 outside the tensor cores).
//
// Precision: everything is float32 with float32 accumulation, for both the
// 'highest' and the 'high' front-end setting. The reference's 'high' mode is
// a 3-pass bf16 Dekker split of each operand, a device of the TPU's matrix
// unit, which has no float32 pass; CUDA cores multiply float32 directly.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 16;  // frames per block
constexpr float LOG_FLOOR = 2.220446049250313e-16f;  // float64 eps, as float32

__global__ void logmel_kernel(const float* __restrict__ x, int S,
                              const float* __restrict__ basis,
                              const float* __restrict__ mel,
                              float* __restrict__ logmel,
                              float* __restrict__ energy, int T, int win,
                              int hop, int nbins, int nmel, float nfft) {
  extern __shared__ float smem[];
  const int chunk = (FT - 1) * hop + win;
  float* chunk_s = smem;          // [chunk] samples of this tile
  float* power_s = smem + chunk;  // [FT, nbins]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FT;
  const long start = (long)t0 * hop;
  const float* xb = x + (long)b * S;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const long s = start + i;
    chunk_s[i] = s < S ? xb[s] : 0.0f;
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k < nbins) {
    float re[FT], im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) re[f] = im[f] = 0.0f;
    const int ld = 2 * nbins;
#pragma unroll 4
    for (int i = 0; i < win; ++i) {
      const float c = basis[(long)i * ld + k];
      const float s = basis[(long)i * ld + nbins + k];
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const float v = chunk_s[f * hop + i];
        re[f] = fmaf(v, c, re[f]);
        im[f] = fmaf(v, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f)
      power_s[f * nbins + k] = (re[f] * re[f] + im[f] * im[f]) / nfft;
  }
  __syncthreads();

  // frame energy: one warp per frame, lanes over bins
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int f = warp; f < FT; f += nwarps) {
    float acc = 0.0f;
    for (int j = lane; j < nbins; j += 32) acc += power_s[f * nbins + j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0 && t0 + f < T) energy[(long)b * T + t0 + f] = acc;
  }

  // mel projection and log floor: one thread per (frame, mel channel)
  for (int o = threadIdx.x; o < FT * nmel; o += blockDim.x) {
    const int f = o / nmel, m = o - f * nmel;
    if (t0 + f >= T) continue;
    float acc = 0.0f;
    for (int j = 0; j < nbins; ++j) acc = fmaf(power_s[f * nbins + j], mel[j * nmel + m], acc);
    logmel[((long)b * T + t0 + f) * nmel + m] = logf(fmaxf(acc, LOG_FLOOR));
  }
}

}  // namespace

extern "C" const char* plt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int plt_fused_logmel(const float* x, int B, int S, const float* basis,
                                const float* mel, float* logmel, float* energy,
                                int T, int win, int hop, int nbins, int nmel,
                                int nfft, void* stream) {
  const int threads = ((nbins + 31) / 32) * 32;
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((FT - 1) * hop + win + FT * nbins);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((T + FT - 1) / FT, B);
  logmel_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, S, basis, mel, logmel, energy, T, win, hop, nbins, nmel, (float)nfft);
  return static_cast<int>(cudaGetLastError());
}
