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
// Bound at the main path's shape (B = 64 x 10 s, T = 999): 2*B*T*win*2*nbins
// = 26 GFLOP of float32 against ~52 MB of device-memory traffic: operations
// bound it (about 0.4 ms at 67 TFLOP/s of float32 outside the tensor cores).
// So the DFT product has to run near the FMA rate: few shared-memory loads
// and no L2 wait per FMA.
//
// Design: the DFT product as a register-tiled GEMM. One block of 256
// threads per (utterance, tile of FM = 64 frames; for an nfft of 1024 and
// more, whose power tile would not fit beside the stages, the caller picks
// FM = 32, 16 or 8 and the block has 4 * FM threads). The tile's sample
// window, (FM-1)*hop + winp floats (42 KB at 16 kHz), is staged in shared
// memory and the frames are read from there: the [B, T, win] framed tensor
// never exists in device memory. The basis comes regrouped by the caller
// (frontend/fused_frontend.py::kernel_basis): bins 0 .. nfft/2 - 1 as
// [winp][2][nfft/2] (per window row the cos row, then the sin row; the
// window zero padded to winp, a multiple of KC = 16), the last bin, nfft/2,
// as [win][2]. The block walks the window in chunks of KC rows; a chunk of
// a panel of 256 bins (32 KB) is copied into one of three shared-memory
// stages by cp.async two chunks ahead of its use, so the basis is read from
// L2 once per 64 frames (the first kernel: once per 16) and not waited for.
// A thread owns 8 frames x 8 bins, re and im: 128 accumulators. Per pair of
// window rows it loads 8 float2 of samples (all lanes of a warp the same
// address) and 8 float4 of the basis (neighbouring lanes, neighbouring
// addresses) for 256 FMAs. Each sum runs over the window in ascending
// order, one FMA a sample: the order of a plain matrix product, so the
// kernel agrees with its plain version to the last bits even in bins that
// hold a millionth of a frame's power. (Folding bin k and its mirror
// nfft/2 - k, whose products differ only by the sign (-1)^i of sample i,
// halves the FMAs and was measured at 0.54 ms; but the sums over even and
// odd samples grow with the mirror's power, and on white noise the weak low
// bins then miss the 1e-4 gate by a factor of 10. It is not used.)
// The last bin is a warp reduction. The power tile [FM][nbins] stays in
// shared memory; the frame energy is summed by four threads a frame, and
// the mel product runs only over the bins where a channel's filter is not
// zero (mel_range from the caller: the filters are narrow triangles), a
// thread taking one channel for eleven frames.
//
// Prediction, made before the first run on the card (H100, B = 64,
// S = 160000): the product is 64*400*512 FMA a block at 128 FMA a cycle and
// SM, 102 k cycles, 1024 blocks on 132 SMs in 8 waves; at 70-80 % of the
// FMA rate with the mel product and the staging on top the kernel should
// take 0.55-0.75 ms, against 1.295 ms for the first kernel and a bound of
// 0.413 ms (0.394 with the mel product counted over its non-zero entries
// only). The measurements, and what the cycle counters said, are in
// PERF.md.
//
// Precision: everything is float32 with float32 accumulation, for both the
// 'highest' and the 'high' front-end setting. The reference's 'high' mode is
// a 3-pass bf16 Dekker split of each operand, a device of the TPU's matrix
// unit, which has no float32 pass; CUDA cores multiply float32 directly.

#include <cuda_runtime.h>

namespace {

constexpr int FR = 8;         // frames of a thread
constexpr int PANEL = 256;    // bins of a panel: two halves of 32 groups of 4
constexpr int HALF = PANEL / 2;
constexpr int KC = 16;        // window rows of a basis chunk
constexpr int NST = 3;         // stages: a chunk is fetched two chunks ahead of its use
constexpr int AW = 2;          // window rows of one sample load
constexpr int UNR = 4;         // sample loads unrolled in a chunk
constexpr int STAGE = KC * 2 * PANEL;  // floats of one stage
constexpr int MF = 6;                  // mel product: frames f, f + MF, ... a thread
constexpr size_t SMEM_MAX = 232448;
constexpr float LOG_FLOOR = 2.220446049250313e-16f;  // float64 eps, as float32

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// all of this thread's groups but the newest have landed
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// offsets into a block's shared memory, in floats
struct Layout {
  int winp, nbs;  // win up to KC, nbins up to 4
  int nchunk;          // floats of the tile's samples
  int chunk, stages, power, tail, total;
};

__host__ __device__ inline Layout layout(int FM, int win, int hop, int nbins) {
  Layout L;
  L.winp = (win + KC - 1) / KC * KC;
  L.nbs = (nbins + 3) / 4 * 4;
  L.nchunk = ((FM - 1) * hop + L.winp + 3) / 4 * 4;
  L.chunk = 0;
  L.stages = L.chunk + L.nchunk;
  L.power = L.stages + NST * STAGE;
  L.tail = L.power + FM * L.nbs;
  L.total = L.tail + 2 * L.winp;
  return L;
}

// FM frames a block (a multiple of FR), four threads a frame
template <int FM>
__global__ void __launch_bounds__(FM * 4, 1)
logmel_kernel(const float* __restrict__ x, int S, const float* __restrict__ basis,
              const float* __restrict__ tail, const float* __restrict__ mel,
              const int* __restrict__ mel_range, float* __restrict__ logmel,
              float* __restrict__ energy, int T, int win, int hop, int nbm, int nmel,
              float nfft, long long* __restrict__ clocks) {
  constexpr int THREADS = (FM / FR) * (HALF / 4);
  constexpr int NWARPS = THREADS / 32;
  static_assert(FM % FR == 0 && FM * 4 == THREADS, "the energy sum takes four threads a frame");
  extern __shared__ __align__(16) float smem[];
  const int nbins = nbm + 1;
  const Layout L = layout(FM, win, hop, nbins);
  float* chunk_s = smem + L.chunk;   // samples of this tile
  float* stage_s = smem + L.stages;  // [NST][KC][2][PANEL] basis chunks
  float* power_s = smem + L.power;   // [FM][nbs]
  float* tail_s = smem + L.tail;     // [winp][2]: the last bin, zero past win
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FM;
  // clocks (optional, 4 counters): SM cycles thread 0 of one block of the
  // last wave spent staging, in the DFT product, on the last bin, and in the
  // energy and mel epilogue
  const bool timed =
      clocks != nullptr && tid == 0 && blockIdx.x == 0 && blockIdx.y == gridDim.y - 1;
  long long tick = timed ? clock64() : 0;
  auto lap = [&](int i) {
    if (timed) {
      const long long now = clock64();
      clocks[i] += now - tick;
      tick = now;
    }
  };

  // the tile's samples, 16 bytes a copy where the source allows it; nothing
  // waits for them before the first basis chunk does
  const long start = (long)t0 * hop;
  const float* xb = x + (long)b * S;
  const bool x16 = reinterpret_cast<size_t>(xb + start) % 16 == 0;
  for (int g = tid; g < L.nchunk / 4; g += THREADS) {
    const long s = start + 4 * g;
    if (x16 && s + 3 < S) {
      cp_async16(chunk_s + 4 * g, xb + s);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) chunk_s[4 * g + e] = s + e < S ? xb[s + e] : 0.0f;
    }
  }
  cp_async_commit();
  for (int i = tid; i < 2 * L.winp; i += THREADS) tail_s[i] = i < 2 * win ? tail[i] : 0.0f;
  for (int i = tid; i < FM * (L.nbs - nbins); i += THREADS) {
    const int f = i / (L.nbs - nbins);
    power_s[f * L.nbs + nbins + i - f * (L.nbs - nbins)] = 0.0f;
  }
  lap(0);

  // the DFT product: frames fg*8 .. fg*8+7; of each panel the bins
  // bg*4 .. bg*4+3 of both halves (a warp is one fg: its lanes read one
  // sample address and neighbouring 16 bytes of a basis row)
  const int bg = tid % (HALF / 4), fg = tid / (HALF / 4);
  const bool aligned = hop % AW == 0;
  const int nkc = L.winp / KC;
  const float* a0 = chunk_s + fg * FR * hop;
  for (int p0 = 0; p0 < nbm; p0 += PANEL) {
    // chunk kc of this panel -> stage kc % NST: per window row cos, then sin
    auto fetch = [&](int kc) {
      if (kc < nkc) {
        float* dst = stage_s + (kc % NST) * STAGE;
        for (int i = tid; i < KC * 2 * (PANEL / 4); i += THREADS) {
          const int row = i / (PANEL / 4), j = i - row * (PANEL / 4);
          if (p0 + 4 * j < nbm)
            cp_async16(dst + row * PANEL + 4 * j,
                       basis + ((size_t)kc * KC * 2 + row) * nbm + p0 + 4 * j);
        }
      }
      cp_async_commit();  // an empty group keeps the count of groups per chunk
    };
    float re[FR][8], im[FR][8];
#pragma unroll
    for (int f = 0; f < FR; ++f)
#pragma unroll
      for (int e = 0; e < 8; ++e) re[f][e] = im[f][e] = 0.0f;
    __syncthreads();  // the last panel's stages are free
    fetch(0);
    fetch(1);
    for (int kc = 0; kc < nkc; ++kc) {
      cp_async_wait_but_one();
      __syncthreads();  // chunk kc has landed; chunk kc - 1 is no longer read
      fetch(kc + NST - 1);
      const float* bs = stage_s + (kc % NST) * STAGE + bg * 4;
      const float* ak = a0 + kc * KC;
#pragma unroll UNR
      for (int kk = 0; kk < KC; kk += AW) {
        float av[FR][AW];
#pragma unroll
        for (int f = 0; f < FR; ++f) {
          const float* ap = ak + f * hop + kk;
          if (aligned) {
            const float2 v = *reinterpret_cast<const float2*>(ap);
            av[f][0] = v.x, av[f][1] = v.y;
          } else {
#pragma unroll
            for (int j = 0; j < AW; ++j) av[f][j] = ap[j];
          }
        }
#pragma unroll
        for (int j = 0; j < AW; ++j) {
          const float* row = bs + (size_t)(kk + j) * 2 * PANEL;
          float c[8], sn[8];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 cv = *reinterpret_cast<const float4*>(row + h * HALF);
            const float4 sv = *reinterpret_cast<const float4*>(row + PANEL + h * HALF);
            c[4 * h] = cv.x, c[4 * h + 1] = cv.y, c[4 * h + 2] = cv.z, c[4 * h + 3] = cv.w;
            sn[4 * h] = sv.x, sn[4 * h + 1] = sv.y, sn[4 * h + 2] = sv.z, sn[4 * h + 3] = sv.w;
          }
#pragma unroll
          for (int f = 0; f < FR; ++f) {
            const float a = av[f][j];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              re[f][e] = fmaf(a, c[e], re[f][e]);
              im[f][e] = fmaf(a, sn[e], im[f][e]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int bin = p0 + h * HALF + bg * 4;
      if (bin >= nbm) continue;
#pragma unroll
      for (int f = 0; f < FR; ++f) {
        float pw[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pw[e] = (re[f][4 * h + e] * re[f][4 * h + e] + im[f][4 * h + e] * im[f][4 * h + e]) / nfft;
        *reinterpret_cast<float4*>(power_s + (fg * FR + f) * L.nbs + bin) =
            make_float4(pw[0], pw[1], pw[2], pw[3]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  lap(1);

  // the last bin: a warp takes FM / NWARPS frames, lanes over the window
  const int warp = tid >> 5, lane = tid & 31;
  {
    constexpr int WF = FM / NWARPS;
    float re[WF] = {}, im[WF] = {};
    for (int i = lane; i < win; i += 32) {
      const float c = tail_s[2 * i], s = tail_s[2 * i + 1];
#pragma unroll
      for (int ff = 0; ff < WF; ++ff) {
        const float v = chunk_s[(warp + NWARPS * ff) * hop + i];
        re[ff] = fmaf(v, c, re[ff]);
        im[ff] = fmaf(v, s, im[ff]);
      }
    }
#pragma unroll
    for (int ff = 0; ff < WF; ++ff) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        re[ff] += __shfl_xor_sync(0xffffffffu, re[ff], o);
        im[ff] += __shfl_xor_sync(0xffffffffu, im[ff], o);
      }
      if (lane == 0)
        power_s[(warp + NWARPS * ff) * L.nbs + nbm] = (re[ff] * re[ff] + im[ff] * im[ff]) / nfft;
    }
  }
  __syncthreads();
  lap(2);

  // frame energy: four threads a frame, each every fourth bin
  {
    const int f = tid >> 2, part = tid & 3;  // FM * 4 == THREADS
    float acc = 0.0f;
    for (int j = part; j < nbins; j += 4) acc += power_s[f * L.nbs + j];
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0 && t0 + f < T) energy[(long)b * T + t0 + f] = acc;
  }

  // mel projection and log floor: a thread takes one channel for the frames
  // f0, f0 + MF, ..., over the bins where the channel's filter is not zero
  for (int item = tid; item < MF * nmel; item += THREADS) {
    const int m = item % nmel, f0 = item / nmel;
    constexpr int NF = (FM + MF - 1) / MF;
    float acc[NF] = {};
    const int lo = mel_range[m], hi = mel_range[nmel + m];
    for (int j = lo; j < hi; ++j) {
      const float w = mel[j * nmel + m];
#pragma unroll
      for (int i = 0; i < NF; ++i)
        if (f0 + MF * i < FM) acc[i] = fmaf(power_s[(f0 + MF * i) * L.nbs + j], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int f = f0 + MF * i;
      if (f < FM && t0 + f < T)
        logmel[((long)b * T + t0 + f) * nmel + m] = logf(fmaxf(acc[i], LOG_FLOOR));
    }
  }
  lap(3);
}

}  // namespace

extern "C" const char* plt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

template <int FM>
int launch_logmel(const float* x, int B, int S, const float* basis, const float* tail,
                  const float* mel, const int* mel_range, float* logmel, float* energy, int T,
                  int win, int hop, int nfft, int nmel, long long* clocks, void* stream) {
  const int nbm = nfft / 2;
  const size_t smem = sizeof(float) * (size_t)layout(FM, win, hop, nbm + 1).total;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      logmel_kernel<FM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((T + FM - 1) / FM, B);
  logmel_kernel<FM><<<grid, FM * 4, smem, static_cast<cudaStream_t>(stream)>>>(
      x, S, basis, tail, mel, mel_range, logmel, energy, T, win, hop, nbm, nmel, (float)nfft,
      clocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// basis: bins 0 .. nfft/2 - 1 as [winp][2][nfft/2]; tail: bin nfft/2 as
// [win][2] (see the header; frontend/fused_frontend.py::kernel_basis);
// mel: [nfft/2 + 1][nmel]; mel_range: [2][nmel] ints, the first bin of each
// channel's filter and one past its last (mel is zero outside); frame_tile:
// 64, 32, 16 or 8 frames a block, chosen by the caller so that the block's
// shared memory fits (fused_frontend.py::frame_tile; refused here if it
// does not); clocks is null or 4 cycle counters the kernel adds to (see
// the kernel)
extern "C" int plt_fused_logmel(const float* x, int B, int S, const float* basis,
                                const float* tail, const float* mel, const int* mel_range,
                                float* logmel, float* energy, int T, int win, int hop,
                                int nfft, int nmel, int frame_tile, long long* clocks,
                                void* stream) {
  if (B <= 0 || T <= 0 || win <= 0 || hop <= 0 || nmel <= 0 || nfft < 8 || nfft % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define PLT_LOGMEL_TILE(FM)                                                                 \
  case FM:                                                                                  \
    return launch_logmel<FM>(x, B, S, basis, tail, mel, mel_range, logmel, energy, T, win, \
                             hop, nfft, nmel, clocks, stream);
  switch (frame_tile) {
    PLT_LOGMEL_TILE(64)
    PLT_LOGMEL_TILE(32)
    PLT_LOGMEL_TILE(16)
    PLT_LOGMEL_TILE(8)
  }
#undef PLT_LOGMEL_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
