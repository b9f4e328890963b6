// Fused greedy attention decoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel phones_las_tpu/decode/pallas_greedy.py:
// greedy_decode_fused (kernel body _kernel).
//
// What it computes: the whole greedy decode of a batch, state kept across
// steps. Each step, from the previous token (first <bos>), for every row:
//   x      = [embedding[token]; attention vector]
//   cells  = n LSTM cells, gates = x@wx + b + h@wh, forget bias 1.0
//            (hard-coded, as in the reference kernel), gate order (i,f,g,o)
//   q      = cell_out @ wq
//   score  = tanh(keys[t] + q) . v + (1 - mask[t]) * -1e9
//   probs  = exp(score - max) * mask / max(sum, 1e-30)
//   ctx    = probs @ memory
//   attn   = [cell_out; ctx] @ attention_layer
//   token  = argmax(attn @ out_w + out_b)       (first index of the maximum)
// A row that has emitted <eos> writes <eos> for the remaining steps. This
// masked softmax differs from attention_scores's where(mask, s, -1e9)
// softmax only for a row with no valid position, where it gives zero weights
// instead of uniform ones; it is reproduced exactly.
//
// What bounds it on this card. At the main path's shape (B = 64, T = 250,
// up to 200 steps, the checkpoint's 2 x 256 cells) a row and step is about
// 3.3 MFLOP of float32, so the operations bound is about 0.6 ms at
// 67 TFLOP/s for 64 x 200 row-steps. That bound assumes the operands lie
// on chip. They do not: the speller's weights are 5.6 MB in float32 and a
// row's keys and memory 768 KB, more than a cluster's shared memory
// (8 x 227 KB), so both stream from L2 at every step. The first port ran
// one block a row, each re-reading all weights (408 MB of L2 traffic a step
// at B = 64) with one thread per output column and a serial k loop: 200 us
// a step, latency of dependent L2 loads.
//
// Design: a cluster of C blocks decodes a group of R = 8 rows (the TPU
// kernel's own group) and loops over the steps inside the kernel; groups
// run in parallel (grid = C * ceil(B/8)).
//   - Dense stages (each cell, wq, the attention layer): block c owns a
//     slice of the output columns (for a cell a slice of units with their
//     four gates, so the cell update is local) and computes it for all 8
//     rows: each weight element is loaded once per cluster and step, as
//     16-byte loads with several in flight, and used 8 times from
//     registers (8 rows x 4 columns a thread, k split over the warps, the
//     partial sums met in shared memory). Weight traffic is B/8 x 5.6 MB a
//     step (45 MB at B = 64). The caller regroups the weights so that a
//     block's slice is contiguous (decode/fused_greedy.py).
//   - Activations move through distributed shared memory: a block stores
//     its slice of h, q, the context and the attention vector into the
//     shared memory of the blocks that read it, and one cluster barrier
//     ends the stage; h is double-buffered, because a cell reads the last
//     step's h while its peers already write this step's.
//   - Attention is per row: block c takes row c of the group (rows c,
//     c + C, ... when C < 8). Scores: a warp per encoder position, lanes
//     over A in 16-byte loads; block-wide max and sum; the context is split
//     over T as well as M; positions past the last valid one are skipped
//     (their weight is exactly zero). Keys and memory stream from L2:
//     768 KB a row and step, 49 MB a step at B = 64.
//   - The logits are sliced over the cluster like a dense stage: block c
//     holds ceil(V / C) columns of out_w (rounded up to 4) in shared memory
//     and computes those logits for the 8 rows; each row's (maximum, first
//     index) over the block's columns goes to every block of the cluster,
//     and after one more cluster barrier (six a step) every block reduces
//     the C pairs in block order, the smallest index winning a tie, so all
//     blocks hold the same tokens and finished flags; block 0 writes the
//     tokens. The embedding row of each fed token is read from global
//     memory (L2-resident) in 16-byte loads. So the shared memory a block
//     needs grows by about (AL + 4 + 16 * 8 + 8) / C floats a vocabulary
//     entry, and the phone vocabularies (65, 120) fit beside the 256-unit
//     cells at every encoder length up to a few thousand.
//   - A group stops when all its rows have emitted <eos> (the TPU kernel's
//     predicate); a finished row in a live group writes <eos>, skips its
//     attention, and its other results are discarded. Rows past B in the
//     last group start finished.
//   - Three layouts (DecLayout). The held one keeps in every block what every
//     block reads whole: h of each cell (double-buffered), the attention
//     vector and the context, each [8][width], and its out_w slice. Past
//     what a block holds (the LAS-4-1024 speller, U = A = 1024, M = 2048:
//     about 430 KB a block), the streamed layout keeps those activations in
//     global memory, one set a group (act): a block stores its slice there
//     instead of into its peers, the cluster barrier that ends the stage
//     orders the stores, and the readers copy the rows a stage multiplies
//     into their stage from L2 (ld.global.cg, past the SM's own L1); q is
//     held only for the rows a block attends for, and the logits read out_w
//     from L2, a lane a column. Both layouts run the same stages in the same
//     order with the same sums; the held one where it fits
//     (decode/fused_greedy.py::decoder_plan picks). Both still hold a row's
//     scores and mask ([T] each) and a dense stage's whole input row, so
//     past about T_enc = 17,000 (the 256-unit speller) or U + M = 5,000
//     neither fits. The tiled layout, last, holds nothing that grows with
//     T: each row's scores live in a workspace in global memory (ws), which
//     the block reads back for the max and the sum (each thread its own
//     positions, as before) and streams through a tile of TTILE weights for
//     the context; a dense stage's input, and the logits' rows, come KTILE
//     floats a row at a time, a tile holding the next float4s of every k
//     part, the sums carried from tile to tile in the partial-sum buffer.
//     Every reduction keeps the streamed layout's order, so the tiled
//     layout's tokens are the streamed one's. The widths: U, A, AL up to
//     1024, M up to 2048, V up to 120 and T_enc up to 2000 (every
//     combination, one or two cells) fit the streamed layout at C = 8, U =
//     A = AL = 2048 with M = 4096 the tiled one, at every T_enc; the
//     wrapper pads any width to a multiple of the cut (E, U, A, M of 4, AL
//     of 8, U, A and AL of 4 C) with zeros.
// With the weights, ~94 MB of L2 traffic a step at B = 64 is this design's
// own floor: ~17 us a step at ~5.5 TB/s, 3.4 ms for 200 steps. At the
// LAS-4-1024 widths the speller's weights are about 77 MB, more than the
// L2 holds, so every group streams them from device memory at each step.
//
// Prediction, made before the first run on the card: 25-40 us a step at
// B = 64 (5-8 ms for 200 steps against 40.9 ms), the scores' 64 k tanhf a
// row (~9 us on one SM) and the L2 streams the largest parts, and B = 8
// (one cluster) no slower than B = 64.
//
// Every offset into keys, memory, the mask, the workspace and the tokens is
// taken in 64 bits: B T M passes 2^32 at B = 64, T = 17,100, M = 4096.
//
// Precision: float32 throughout, as the reference kernel's HIGHEST dots.
// Sums run in another order than the plain version's (k split in parts).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e9f;
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int DR = 8;  // rows of a group = rows of a thread's register tile
constexpr int SCORE_T = 8;  // encoder positions a warp scores at a time
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may use

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

struct DecArgs {
  const float* keys;    // [B, T, A]
  const float* mem;     // [B, T, M]
  const float* mask;    // [B, T]
  const float* emb;     // [V, E]
  const float* wq;      // [C][U][A/C]
  const float* v;       // [A]
  const float* attn_w;  // [C][U + M][AL/C]
  const float* out_w;   // [AL, V]
  const float* out_b;   // [V]
  const float* const* cells;  // per cell: [C][din + U][4U/C] (wx over wh), [C][4U/C] bias
  float* act;  // streamed and tiled layouts: a group's activations in global memory (act_floats each)
  float* ws;   // tiled layout: each row's scores, then exp(score - max) * mask [rows of the groups][T]
  int B, T, A, M, V, E, AL, U, n_cells, bos, eos, steps, C;
};

// The three layouts of a block's shared memory, in the order the plan tries
// them (decode/fused_greedy.py::decoder_plan).
constexpr int LAYOUT_HELD = 0;      // every activation a block reads whole in its own shared memory
constexpr int LAYOUT_STREAMED = 1;  // those activations and out_w in global memory (L2)
constexpr int LAYOUT_TILED = 2;     // as streamed, and nothing that grows with T, or with K past KTILE
constexpr int KTILE = 2048;  // tiled: floats of a row of the stage (a tile of a dense stage's k)
constexpr int TTILE = 2048;  // tiled: encoder positions of a tile of attention weights

// float offsets of a block's shared memory; decode/fused_greedy.py::
// decoder_smem_bytes mirrors it. The streamed layout (STREAMED) holds none
// of the activations that every block reads whole (h of every cell, the
// attention vector, the context) and no out_w slice: they lie in global
// memory (act, out_w), and a stage copies what it multiplies into `stage`.
// The tiled layout (TILED) also keeps a row's scores in global memory (ws)
// and stages a dense stage's input KTILE floats a row at a time and the
// attention weights TTILE positions at a time, so that its size is bounded
// whatever T, and whatever the widths up to KTILE.
struct DecLayout {
  int Kmax;  // widest staged input: max(E + AL + U, 2U, U + M)
  int kt;    // floats of a row of the stage: Kmax, or (tiled) at most KTILE
  int Vc;    // vocabulary columns a block owns: ceil(V / C) rounded up to 4
  int ldo;   // row stride of the transposed out_w slice: AL + 4, so that the
             // rows of neighbouring vocabulary entries start in different banks
  size_t stage, hbuf, cst, attn, q, ctx, part, outw, outb, bias, sc, mk, v, lg, pair, flags, red,
      total;  // in floats
};

__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline size_t smax(size_t x, size_t y) { return x > y ? x : y; }

__host__ __device__ inline DecLayout dec_layout(int T, int A, int M, int V, int E, int AL,
                                                int U, int n_cells, int C, int layout) {
  DecLayout L;
  L.Kmax = (int)smax(smax(E + AL + U, 2 * U), U + M);
  L.kt = layout == LAYOUT_TILED && L.Kmax > KTILE ? KTILE : L.Kmax;
  L.Vc = (int)pad4((V + C - 1) / C);
  const size_t qrows = layout != LAYOUT_HELD ? (DR + C - 1) / C : DR;  // all 8, or the rows the block attends for
  const size_t held = layout == LAYOUT_HELD ? 1 : 0;  // the activations every block reads whole
  const size_t tiled = layout == LAYOUT_TILED ? 1 : 0;
  size_t off = 0;
  L.stage = off, off += (size_t)DR * L.kt;
  L.hbuf = off, off += held * n_cells * 2 * DR * U;
  L.cst = off, off += (size_t)n_cells * DR * (U / C);
  L.attn = off, off += held * DR * AL;
  L.q = off, off += qrows * A;
  L.ctx = off, off += held * DR * M;
  const size_t widest = smax(smax(4 * U / C, A / C), AL / C);  // columns of a dense stage
  // partial sums: a dense stage's [k parts][8][columns], the context's [T
  // parts][M], the logits' [k parts][8][Vc]
  L.part = off, off += smax(smax((size_t)THREADS * 4 * DR, DR * widest),
                            smax(smax((size_t)THREADS * 4, (size_t)M), (size_t)NWARPS * DR * L.Vc));
  // small operands that every step reads: this block's columns of out_w
  // (transposed) and out_b, its slices of the cells' biases
  L.ldo = AL + 4;
  L.outw = off, off += held * L.Vc * L.ldo;
  L.outb = off, off += L.Vc;
  L.bias = off, off += (size_t)n_cells * 4 * (U / C);
  L.sc = off, off += tiled ? TTILE : pad4(T);  // a row's scores, or (tiled) a tile of its weights
  L.mk = off, off += tiled ? 0 : pad4(T);
  L.v = off, off += pad4(A);
  L.lg = off, off += (size_t)DR * L.Vc;
  // each block's (maximum, index) of each row, written by that block:
  // [8 blocks][8 rows] floats, then as many ints
  L.pair = off, off += (size_t)2 * 8 * DR;
  L.flags = off, off += (size_t)4 * DR;  // ints: the fed token, finished, tl of each row
  L.red = off, off += 64;
  L.total = off;
  return L;
}

// part[ks][r][col] = sum over k part ks of in[r][k] * w[k][col] for the 8
// rows of the group; w [K, ncols] streams from L2, an item = (k part, 4
// columns) a thread -> the number of k parts
__device__ __forceinline__ int dense(const float* __restrict__ w, int K, int ncols,
                                     const float* __restrict__ in, int ldin,
                                     float* __restrict__ part) {
  const int ncg = ncols / 4, k4n = K / 4;
  const int KS = max(1, min(THREADS / ncg, k4n));
  const int kper = (k4n + KS - 1) / KS;
  for (int item = threadIdx.x; item < ncg * KS; item += THREADS) {
    const int cgi = item % ncg, ks = item / ncg;
    const int kb = ks * kper, ke = min(k4n, kb + kper);
    float acc[DR][4];
#pragma unroll
    for (int r = 0; r < DR; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
    const float* wp = w + cgi * 4;
#pragma unroll 2
    for (int k4 = kb; k4 < ke; ++k4) {
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(wp + (size_t)(4 * k4) * ncols));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(wp + (size_t)(4 * k4 + 1) * ncols));
      const float4 w2 = __ldg(reinterpret_cast<const float4*>(wp + (size_t)(4 * k4 + 2) * ncols));
      const float4 w3 = __ldg(reinterpret_cast<const float4*>(wp + (size_t)(4 * k4 + 3) * ncols));
#pragma unroll
      for (int r = 0; r < DR; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(in + r * ldin + 4 * k4);
        acc[r][0] = fmaf(x.x, w0.x, acc[r][0]);
        acc[r][1] = fmaf(x.x, w0.y, acc[r][1]);
        acc[r][2] = fmaf(x.x, w0.z, acc[r][2]);
        acc[r][3] = fmaf(x.x, w0.w, acc[r][3]);
        acc[r][0] = fmaf(x.y, w1.x, acc[r][0]);
        acc[r][1] = fmaf(x.y, w1.y, acc[r][1]);
        acc[r][2] = fmaf(x.y, w1.z, acc[r][2]);
        acc[r][3] = fmaf(x.y, w1.w, acc[r][3]);
        acc[r][0] = fmaf(x.z, w2.x, acc[r][0]);
        acc[r][1] = fmaf(x.z, w2.y, acc[r][1]);
        acc[r][2] = fmaf(x.z, w2.z, acc[r][2]);
        acc[r][3] = fmaf(x.z, w2.w, acc[r][3]);
        acc[r][0] = fmaf(x.w, w3.x, acc[r][0]);
        acc[r][1] = fmaf(x.w, w3.y, acc[r][1]);
        acc[r][2] = fmaf(x.w, w3.z, acc[r][2]);
        acc[r][3] = fmaf(x.w, w3.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < DR; ++r)
      *reinterpret_cast<float4*>(part + ((size_t)(ks * DR + r) * ncols + cgi * 4)) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  return KS;
}

// The tiled layout's dense stage: the same items, k parts and k order as
// dense(), with the input rows [8][K] read through src(r, k4) (a float4 of
// global memory) and staged a tile at a time: tile j holds, of every k
// part, its float4s [j S4, (j + 1) S4), so every item works in every tile
// (a tile of consecutive k would leave most parts idle); an item's sums are
// carried from tile to tile in `part` (stored and reloaded exactly). One
// tile where the rows fit kt (the streamed layout's sums, bit for bit).
template <class Src>
__device__ __forceinline__ int dense_tiled(const float* __restrict__ w, int K, int ncols, Src src,
                                           int kt, float* __restrict__ stage,
                                           float* __restrict__ part) {
  const int ncg = ncols / 4, k4n = K / 4;
  const int KS = max(1, min(THREADS / ncg, k4n));
  const int kper = (k4n + KS - 1) / KS;
  const int S4 = max(1, min(kper, kt / 4 / KS));  // float4s of a part in a tile
  const int ld = 4 * KS * S4, ntiles = (kper + S4 - 1) / S4;
  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // the last tile has been read
    for (int i = threadIdx.x; i < DR * KS * S4; i += THREADS) {
      const int r = i / (KS * S4), rem = i - r * KS * S4, ks = rem / S4, q = rem - ks * S4;
      const int k4 = ks * kper + j * S4 + q;
      *reinterpret_cast<float4*>(stage + r * ld + 4 * rem) =
          j * S4 + q < kper && k4 < k4n ? src(r, k4) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    for (int item = threadIdx.x; item < ncg * KS; item += THREADS) {
      const int cgi = item % ncg, ks = item / ncg;
      const int kb = ks * kper + j * S4, ke = min(min(k4n, (ks + 1) * kper), kb + S4);
      float* pp = part + (size_t)ks * DR * ncols + cgi * 4;
      float acc[DR][4];
#pragma unroll
      for (int r = 0; r < DR; ++r) {
        const float4 p0 = j > 0 ? *reinterpret_cast<const float4*>(pp + (size_t)r * ncols)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        acc[r][0] = p0.x, acc[r][1] = p0.y, acc[r][2] = p0.z, acc[r][3] = p0.w;
      }
      const float* wp = w + cgi * 4;
      const float* xs = stage + 4 * ks * S4;
#pragma unroll 2
      for (int k4 = kb; k4 < ke; ++k4) {
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(wp + (size_t)(4 * k4) * ncols));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(wp + (size_t)(4 * k4 + 1) * ncols));
        const float4 w2 = __ldg(reinterpret_cast<const float4*>(wp + (size_t)(4 * k4 + 2) * ncols));
        const float4 w3 = __ldg(reinterpret_cast<const float4*>(wp + (size_t)(4 * k4 + 3) * ncols));
#pragma unroll
        for (int r = 0; r < DR; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(xs + r * ld + 4 * (k4 - kb));
          acc[r][0] = fmaf(x.x, w0.x, acc[r][0]);
          acc[r][1] = fmaf(x.x, w0.y, acc[r][1]);
          acc[r][2] = fmaf(x.x, w0.z, acc[r][2]);
          acc[r][3] = fmaf(x.x, w0.w, acc[r][3]);
          acc[r][0] = fmaf(x.y, w1.x, acc[r][0]);
          acc[r][1] = fmaf(x.y, w1.y, acc[r][1]);
          acc[r][2] = fmaf(x.y, w1.z, acc[r][2]);
          acc[r][3] = fmaf(x.y, w1.w, acc[r][3]);
          acc[r][0] = fmaf(x.z, w2.x, acc[r][0]);
          acc[r][1] = fmaf(x.z, w2.y, acc[r][1]);
          acc[r][2] = fmaf(x.z, w2.z, acc[r][2]);
          acc[r][3] = fmaf(x.z, w2.w, acc[r][3]);
          acc[r][0] = fmaf(x.w, w3.x, acc[r][0]);
          acc[r][1] = fmaf(x.w, w3.y, acc[r][1]);
          acc[r][2] = fmaf(x.w, w3.z, acc[r][2]);
          acc[r][3] = fmaf(x.w, w3.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < DR; ++r)
        *reinterpret_cast<float4*>(pp + (size_t)r * ncols) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  return KS;
}

// sum over the k parts of one output, in a fixed order: four chains, so
// that the loads of a chain do not wait for its adds
__device__ __forceinline__ float gather(const float* part, int KS, int ncols, int r, int col) {
  const float* p = part + (size_t)r * ncols + col;
  const size_t stride = (size_t)DR * ncols;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int ks = 0;
  for (; ks + 4 <= KS; ks += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] += p[(ks + j) * stride];
  }
  for (; ks < KS; ++ks) s[0] += p[ks * stride];
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// n floats (a multiple of 4, 16-byte aligned) by 64 threads, l0 this one's index
__device__ __forceinline__ void copy_row(float* dst, const float* src, int n, int l0) {
  for (int i = l0; i < n / 4; i += 64)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
}

// the same from global memory, through the read-only path
__device__ __forceinline__ void load_row(float* dst, const float* __restrict__ src, int n, int l0) {
  for (int i = l0; i < n / 4; i += 64)
    reinterpret_cast<float4*>(dst)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
}

// ... from global memory that the blocks of the cluster write during the
// kernel: from L2, past the SM's own L1 (which another block's stores do not
// reach); the cluster barrier since those stores orders them
__device__ __forceinline__ void load_row_cg(float* dst, const float* src, int n, int l0) {
  for (int i = l0; i < n / 4; i += 64)
    reinterpret_cast<float4*>(dst)[i] = __ldcg(reinterpret_cast<const float4*>(src) + i);
}

// floats of one group's activations in the streamed layout: h of every cell
// [n_cells][2][8][U], the attention vector [8][AL], the context [8][M]
__host__ __device__ inline size_t act_floats(int n_cells, int U, int AL, int M) {
  return (size_t)n_cells * 2 * DR * U + (size_t)DR * AL + (size_t)DR * M;
}

// This block's columns [c0, c0 + n) of a [8][ld] buffer, already written
// in its own copy, to the same place in every other block of the cluster,
// as 16-byte stores (n a multiple of 4). The caller synchronises the block
// before and the cluster after.
__device__ __forceinline__ void share_columns(cg::cluster_group& cluster, float* buf, int ld,
                                              int c0, int n, int C, int rank) {
  const int nq = n / 4, total = DR * nq * (C - 1);
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int p = i / (DR * nq), j = i - p * DR * nq;
    const int r = j / nq, q = j - r * nq;
    float* mine = buf + r * ld + c0 + 4 * q;
    const int peer = p + (p >= rank);
    *reinterpret_cast<float4*>(cluster.map_shared_rank(mine, peer)) =
        *reinterpret_cast<const float4*>(mine);
  }
}

// block-wide max or sum of one value a thread; red holds 32 floats
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read from the last reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < NWARPS ? red[lane] : (MAX ? -CUDART_INF_F : 0.0f);
  return MAX ? warp_max(v) : warp_sum(v);
}

template <int LAYOUT>
__global__ void __launch_bounds__(THREADS, 1)
greedy_kernel(DecArgs a, int* __restrict__ tokens, long long* __restrict__ clocks) {
  constexpr bool STREAMED = LAYOUT != LAYOUT_HELD, TILED = LAYOUT == LAYOUT_TILED;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C, rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / C) * DR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = a.T, A = a.A, M = a.M, V = a.V, E = a.E, AL = a.AL, U = a.U;
  const int Us = U / C, Nc = 4 * Us, Ac = A / C, ALc = AL / C;
  const DecLayout L = dec_layout(T, A, M, V, E, AL, U, a.n_cells, C, LAYOUT);
  const int Vc = L.Vc, v0 = rank * Vc, nv = max(0, min(V - v0, Vc));  // this block's vocabulary columns
  float* stage_s = smem + L.stage;  // [8][kt] a dense stage's input (tiled: a tile of it)
  // the activations every block reads whole: in its own shared memory, or
  // (streamed) the group's in global memory, read through load_row_cg
  float* act = STREAMED ? a.act + (size_t)(blockIdx.x / C) * act_floats(a.n_cells, U, AL, M) : nullptr;
  float* hbuf = STREAMED ? act : smem + L.hbuf;                                    // [n_cells][2][8][U]
  float* attn = STREAMED ? act + (size_t)a.n_cells * 2 * DR * U : smem + L.attn;   // [8][AL]
  float* ctx = STREAMED ? attn + (size_t)DR * AL : smem + L.ctx;                   // [8][M]
  float* c_s = smem + L.cst;        // [n_cells][8][Us] this block's units
  float* q_s = smem + L.q;          // [qrows][A] (the rows this block attends for: row qrow(r))
  float* part_s = smem + L.part;
  float* outw_s = smem + L.outw;    // [Vc][ldo] columns v0.. of out_w, transposed (held layout)
  float* outb_s = smem + L.outb;    // [Vc]
  float* bias_s = smem + L.bias;    // [n_cells][4 Us] this block's slices
  float* sc_s = smem + L.sc;        // [T] scores, then weights; tiled: [TTILE] a tile of weights
  float* mk_s = smem + L.mk;        // [T] (not tiled: the mask is read from global memory)
  float* v_s = smem + L.v;          // [A]
  float* lg_s = smem + L.lg;        // [8][Vc]
  float* pmax_s = smem + L.pair;    // [8 blocks][8] each block's maximum of each row
  int* pidx_s = reinterpret_cast<int*>(smem + L.pair + 8 * DR);  // [8 blocks][8] its index
  int* tok_s = reinterpret_cast<int*>(smem + L.flags);  // [8] the token fed to each row
  int* fin_s = tok_s + DR;                              // [8] finished
  int* tlen_s = fin_s + DR;                             // [8] one past the last valid position
  float* red_s = smem + L.red;

  for (size_t i = tid; i < L.total; i += THREADS) smem[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < A; i += THREADS) v_s[i] = a.v[i];
  if (!STREAMED)
    for (int i = tid; i < nv * AL; i += THREADS)
      outw_s[(i / AL) * L.ldo + i % AL] = a.out_w[(size_t)(i % AL) * V + v0 + i / AL];
  for (int i = tid; i < nv; i += THREADS) outb_s[i] = a.out_b[v0 + i];
  for (int i = tid; i < a.n_cells * Nc; i += THREADS)
    bias_s[i] = a.cells[2 * (i / Nc) + 1][(size_t)rank * Nc + i % Nc];
  if (tid < DR) {
    tok_s[tid] = a.bos;
    fin_s[tid] = row0 + tid >= a.B;  // rows past the batch start finished
  }
  // one past the last valid encoder position of the rows this block attends
  // for (0, as zeroed above, for a row past the batch); at C < 8 a row's
  // warp is not warp 0, so no store here may race with one of warp 0's
  for (int r = rank + C * warp; r < DR; r += C * NWARPS) {
    if (row0 + r >= a.B) continue;
    int last = 0;
    for (int t = lane; t < T; t += 32)
      if (a.mask[(size_t)(row0 + r) * T + t] != 0.0f) last = t + 1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
    if (lane == 0) tlen_s[r] = last;
  }
  __syncthreads();
  // no block may store into a peer before that peer has zeroed its buffers
  cluster.sync();

  // clocks (optional, 16 counters): SM cycles thread 0 of block 0 spent in
  // 0-3 the cells (input staging, product, cell update and stores, barrier),
  // 4-5 the query (product, exchange and barrier), 6 the scores, 7 the
  // softmax, 8 the context, 9 its exchange and barrier, 10-12 the attention
  // layer (staging, product, exchange and barrier), 13 the logits, 14 the
  // argmax (the block's columns, the exchange of the pairs and its barrier,
  // the reduction); 15 counts the steps
  const bool timed = clocks != nullptr && tid == 0 && blockIdx.x == 0;
  // an activation row into the stage: from shared memory, or (streamed) from L2
  auto fill = [&](float* dst, const float* src, int n, int l0) {
    if (STREAMED) load_row_cg(dst, src, n, l0);
    else copy_row(dst, src, n, l0);
  };
  auto qrow = [&](int r) { return STREAMED ? r / C : r; };
  long long tick = timed ? clock64() : 0;
  auto lap = [&](int i) {
    if (timed) {
      const long long now = clock64();
      clocks[i] += now - tick;
      tick = now;
    }
  };
  int s = 0;
  for (; s < a.steps; ++s) {
    bool all_fin = true;
#pragma unroll
    for (int r = 0; r < DR; ++r) all_fin = all_fin && fin_s[r];
    if (all_fin) break;  // the same in every block of the cluster
    const int cur = s & 1, nxt = cur ^ 1;

    // LSTM cell stack: block `rank` owns units [rank*Us, (rank+1)*Us)
    for (int l = 0; l < a.n_cells; ++l) {
      const int din = l == 0 ? E + AL : U, K = din + U;
      float* hl = hbuf + (size_t)l * 2 * DR * U;
      const float* wl = a.cells[2 * l] + (size_t)rank * K * Nc;
      int KS;
      if (TILED) {
        // [input; h of the last step] from global memory, k4 a float4 of the row
        auto src = [&](int r, int k4) {
          const int k = 4 * k4;
          const float* p = l > 0 ? (k < U ? hl - 2 * DR * U + (nxt * DR + r) * U + k
                                          : hl + (cur * DR + r) * U + k - U)
                                 : (k < E ? nullptr
                                          : k < E + AL ? attn + r * AL + k - E
                                                       : hl + (cur * DR + r) * U + k - E - AL);
          return p ? __ldcg(reinterpret_cast<const float4*>(p))
                   : __ldg(reinterpret_cast<const float4*>(a.emb + (size_t)tok_s[r] * E + k));
        };
        lap(0);
        KS = dense_tiled(wl, K, Nc, src, L.kt, stage_s, part_s);
      } else {
        // [input; h of the last step], a row a pair of warps
        for (int r = warp >> 1; r < DR; r += NWARPS / 2) {
          const int l0 = lane + 32 * (warp & 1);
          float* dst = stage_s + r * K;
          if (l > 0) {
            fill(dst, hl - 2 * DR * U + (nxt * DR + r) * U, U, l0);
          } else {
            load_row(dst, a.emb + (size_t)tok_s[r] * E, E, l0);
            fill(dst + E, attn + r * AL, AL, l0);
          }
          fill(dst + din, hl + (cur * DR + r) * U, U, l0);
        }
        __syncthreads();
        lap(0);
        KS = dense(wl, K, Nc, stage_s, K, part_s);
      }
      const float* bias = bias_s + l * Nc;
      __syncthreads();
      lap(1);
      float* cl = c_s + (size_t)l * DR * Us;
      for (int i = tid; i < DR * Us; i += THREADS) {
        const int r = i / Us, u = i - r * Us;
        const float gi = gather(part_s, KS, Nc, r, u) + bias[u];
        const float gf = gather(part_s, KS, Nc, r, Us + u) + bias[Us + u];
        const float gg = gather(part_s, KS, Nc, r, 2 * Us + u) + bias[2 * Us + u];
        const float go = gather(part_s, KS, Nc, r, 3 * Us + u) + bias[3 * Us + u];
        const float c_new = sigmoidf(gf + 1.0f) * cl[i] + sigmoidf(gi) * tanhf(gg);
        const float h_new = sigmoidf(go) * tanhf(c_new);
        cl[i] = c_new;
        hl[(nxt * DR + r) * U + rank * Us + u] = h_new;
      }
      __syncthreads();
      if (!STREAMED) share_columns(cluster, hl + nxt * DR * U, U, rank * Us, Us, C, rank);
      lap(2);
      cluster.sync();
      lap(3);
    }
    const float* hout = hbuf + ((size_t)(a.n_cells - 1) * 2 + nxt) * DR * U;  // [8][U]

    // query: block `rank` owns A/C columns; row r's go to the block that attends for it
    {
      const float* hin = hout;
      const float* wq = a.wq + (size_t)rank * U * Ac;
      int KS;
      if (TILED) {
        auto src = [&](int r, int k4) { return __ldcg(reinterpret_cast<const float4*>(hout + r * U) + k4); };
        KS = dense_tiled(wq, U, Ac, src, L.kt, stage_s, part_s);
      } else {
        if (STREAMED) {
          for (int r = warp >> 1; r < DR; r += NWARPS / 2) load_row_cg(stage_s + r * U, hout + r * U, U, lane + 32 * (warp & 1));
          __syncthreads();
          hin = stage_s;
        }
        KS = dense(wq, U, Ac, hin, U, part_s);
      }
      __syncthreads();
      lap(4);
      for (int i = tid; i < DR * Ac; i += THREADS) {
        const int r = i / Ac, c = i - r * Ac;
        *cluster.map_shared_rank(q_s + qrow(r) * A + rank * Ac + c, r % C) =
            gather(part_s, KS, Ac, r, c);
      }
      cluster.sync();
      lap(5);
    }

    // attention of this block's rows: scores, masked softmax, context
    for (int r = rank; r < DR; r += C) {
      if (fin_s[r]) continue;
      const int tl = tlen_s[r];
      const float* Kr = a.keys + (size_t)(row0 + r) * T * A;
      const float* Mr = a.mem + (size_t)(row0 + r) * T * M;
      const float* mkr = a.mask + (size_t)(row0 + r) * T;
      float* scr = TILED ? a.ws + (size_t)(row0 + r) * T : sc_s;  // the row's scores
      if (!TILED) {
        for (int t = tid; t < tl; t += THREADS) mk_s[t] = mkr[t];
        __syncthreads();
      }
      // a warp takes SCORE_T positions at a time, so that many key loads are
      // in flight before the first tanhf
      for (int t0 = warp * SCORE_T; t0 < tl; t0 += NWARPS * SCORE_T) {
        float acc[SCORE_T];
#pragma unroll
        for (int j = 0; j < SCORE_T; ++j) acc[j] = 0.0f;
        for (int a4 = lane; a4 < A / 4; a4 += 32) {
          float4 k[SCORE_T];
#pragma unroll
          for (int j = 0; j < SCORE_T; ++j)
            k[j] = __ldg(reinterpret_cast<const float4*>(Kr + (size_t)min(t0 + j, tl - 1) * A) + a4);
          const float4 q = *reinterpret_cast<const float4*>(q_s + qrow(r) * A + 4 * a4);
          const float4 vv = *reinterpret_cast<const float4*>(v_s + 4 * a4);
#pragma unroll
          for (int j = 0; j < SCORE_T; ++j) {
            if (t0 + j >= tl) break;
            acc[j] += tanhf(k[j].x + q.x) * vv.x;
            acc[j] += tanhf(k[j].y + q.y) * vv.y;
            acc[j] += tanhf(k[j].z + q.z) * vv.z;
            acc[j] += tanhf(k[j].w + q.w) * vv.w;
          }
        }
#pragma unroll
        for (int j = 0; j < SCORE_T; ++j) {
          const float sum = warp_sum(acc[j]);
          if (lane == 0 && t0 + j < tl) scr[t0 + j] = sum + (1.0f - (TILED ? mkr : mk_s)[t0 + j]) * NEG;
        }
      }
      __syncthreads();
      lap(6);
      // exp(s - max) * mask / max(sum, 1e-30); a row with no valid position has tl = 0
      // (tiled: each thread reads back only the scores it wrote, or that the
      // block barrier above has made visible; exp(s - max) * mask stays there)
      float mx = -CUDART_INF_F;
      for (int t = tid; t < tl; t += THREADS) mx = fmaxf(mx, scr[t]);
      mx = block_reduce<true>(mx, red_s);
      float sum = 0.0f;
      for (int t = tid; t < tl; t += THREADS) {
        const float e = expf(scr[t] - mx) * (TILED ? mkr : mk_s)[t];
        scr[t] = e;
        sum += e;
      }
      sum = fmaxf(block_reduce<false>(sum, red_s), 1e-30f);
      if (!TILED)
        for (int t = tid; t < tl; t += THREADS) sc_s[t] = sc_s[t] / sum;
      __syncthreads();
      lap(7);
      // context: an item = (part of T, 4 columns of M); tiled, the weights
      // e / sum come in tiles that hold, of every part of T, its positions
      // [j St, (j + 1) St), each item's sums carried in part_s from tile to
      // tile, in the same order
      const int mq = M / 4;
      const int TS = max(1, THREADS / mq), tper = (tl + TS - 1) / TS;
      const int St = TILED ? max(1, min(tper, TTILE / TS)) : max(1, tper);
      const int ntiles = TILED ? max(1, (tper + St - 1) / St) : 1;
      for (int j = 0; j < ntiles; ++j) {
        const float* wt = sc_s;  // the weights of positions tb.. at wt[tb - base]
        if (TILED) {
          __syncthreads();  // the last tile has been read
          for (int i = tid; i < TS * St; i += THREADS) {
            const int ts = i / St, q = i - ts * St, t = ts * tper + j * St + q;
            sc_s[i] = j * St + q < tper && t < tl ? scr[t] / sum : 0.0f;
          }
          __syncthreads();
        }
        for (int item = tid; item < mq * TS; item += THREADS) {
          const int m4 = item % mq, ts = item / mq;
          const int tb = ts * tper + j * St, te = min(min(tl, (ts + 1) * tper), tb + St);
          float* pp = part_s + (size_t)ts * M + 4 * m4;
          float4 acc = TILED && j > 0 ? *reinterpret_cast<const float4*>(pp) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const int at = TILED ? ts * St - tb : 0;  // position t's weight at wt[t + at]
#pragma unroll 8
          for (int t = tb; t < te; ++t) {
            const float p = wt[t + at];
            const float4 mv = __ldg(reinterpret_cast<const float4*>(Mr + (size_t)t * M) + m4);
            acc.x = fmaf(p, mv.x, acc.x);
            acc.y = fmaf(p, mv.y, acc.y);
            acc.z = fmaf(p, mv.z, acc.z);
            acc.w = fmaf(p, mv.w, acc.w);
          }
          *reinterpret_cast<float4*>(pp) = acc;
        }
      }
      __syncthreads();
      lap(8);
      for (int m = tid; m < M; m += THREADS) {
        float c = part_s[m];
        for (int ts = 1; ts < TS; ++ts) c += part_s[(size_t)ts * M + m];
        ctx[r * M + m] = c;
      }
      __syncthreads();  // part_s, sc_s and mk_s are reused by the next row
      for (int i = tid; !STREAMED && i < (C - 1) * (M / 4); i += THREADS) {  // the row to every block
        const int p = i / (M / 4), q = i - p * (M / 4);
        float* mine = ctx + r * M + 4 * q;
        *reinterpret_cast<float4*>(cluster.map_shared_rank(mine, p + (p >= rank))) =
            *reinterpret_cast<const float4*>(mine);
      }
    }
    cluster.sync();
    lap(9);

    // attention vector: block `rank` owns AL/C columns, written where the
    // next step's first cell and the logits read it
    {
      const int K = U + M;
      const float* wa = a.attn_w + (size_t)rank * K * ALc;
      int KS;
      if (TILED) {
        auto src = [&](int r, int k4) {
          const int k = 4 * k4;
          return __ldcg(reinterpret_cast<const float4*>(k < U ? hout + r * U + k : ctx + r * M + k - U));
        };
        lap(10);
        KS = dense_tiled(wa, K, ALc, src, L.kt, stage_s, part_s);
      } else {
        for (int r = warp >> 1; r < DR; r += NWARPS / 2) {
          const int l0 = lane + 32 * (warp & 1);
          fill(stage_s + r * K, hout + r * U, U, l0);
          fill(stage_s + r * K + U, ctx + r * M, M, l0);
        }
        __syncthreads();
        lap(10);
        KS = dense(wa, K, ALc, stage_s, K, part_s);
      }
      __syncthreads();
      lap(11);
      for (int i = tid; i < DR * ALc; i += THREADS) {
        const int r = i / ALc, c = i - r * ALc;
        attn[r * AL + rank * ALc + c] = gather(part_s, KS, ALc, r, c);
      }
      __syncthreads();
      if (!STREAMED) share_columns(cluster, attn, AL, rank * ALc, ALc, C, rank);
      cluster.sync();
      lap(12);
    }

    // logits of this block's columns for all 8 rows: a warp per part of k,
    // a lane per vocabulary entry, all 8 rows a thread; streamed, the rows
    // are staged and the columns of out_w read from L2, a lane a column
    {
      const float* xs = attn;
      int ldx = AL;
      const int kq = AL / 4, kper = (kq + NWARPS - 1) / NWARPS;  // in float4s
      // tiled: the rows come in tiles that hold, of every warp's part of k,
      // its float4s [j S4, (j + 1) S4), the sums carried in part_s
      const int S4 = TILED ? max(1, min(kper, L.kt / 4 / NWARPS)) : max(1, kper);
      const int ntiles = TILED ? (kper + S4 - 1) / S4 : 1;
      if (STREAMED && !TILED) {
        for (int r = warp >> 1; r < DR; r += NWARPS / 2) load_row_cg(stage_s + r * AL, attn + r * AL, AL, lane + 32 * (warp & 1));
        __syncthreads();
        xs = stage_s;
      }
      for (int j = 0; j < ntiles; ++j) {
        if (TILED) {
          ldx = 4 * NWARPS * S4;
          __syncthreads();  // the last tile has been read
          for (int i = tid; i < DR * NWARPS * S4; i += THREADS) {
            const int r = i / (NWARPS * S4), rem = i - r * NWARPS * S4, ks = rem / S4, q = rem - ks * S4;
            const int k4 = ks * kper + j * S4 + q;
            *reinterpret_cast<float4*>(stage_s + r * ldx + 4 * rem) =
                j * S4 + q < kper && k4 < kq ? __ldcg(reinterpret_cast<const float4*>(attn + r * AL) + k4)
                                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
          __syncthreads();
          xs = stage_s + 4 * warp * S4;
        }
        const int kb = warp * kper + j * S4, ke = min(min(kq, (warp + 1) * kper), kb + S4);
        const int at = TILED ? -kb : 0;  // the float4 k of a row at xs[r * ldx + 4 (k + at)]
        for (int o = lane; o < nv; o += 32) {
          const float4* w = reinterpret_cast<const float4*>(outw_s + o * L.ldo);
          const float* wg = a.out_w + v0 + o;  // streamed: column v0 + o of out_w [AL, V]
          float acc[DR];
#pragma unroll
          for (int r = 0; r < DR; ++r) acc[r] = TILED && j > 0 ? part_s[(warp * DR + r) * Vc + o] : 0.0f;
          for (int k = kb; k < ke; ++k) {
            const float4 wv = STREAMED ? make_float4(__ldg(wg + (size_t)(4 * k) * V), __ldg(wg + (size_t)(4 * k + 1) * V),
                                                     __ldg(wg + (size_t)(4 * k + 2) * V), __ldg(wg + (size_t)(4 * k + 3) * V))
                                       : w[k];
#pragma unroll
            for (int r = 0; r < DR; ++r) {
              const float4 x = reinterpret_cast<const float4*>(xs + r * ldx)[k + at];
              acc[r] = fmaf(x.x, wv.x, acc[r]);
              acc[r] = fmaf(x.y, wv.y, acc[r]);
              acc[r] = fmaf(x.z, wv.z, acc[r]);
              acc[r] = fmaf(x.w, wv.w, acc[r]);
            }
          }
#pragma unroll
          for (int r = 0; r < DR; ++r) part_s[(warp * DR + r) * Vc + o] = acc[r];
        }
      }
      __syncthreads();
      for (int i = tid; i < DR * nv; i += THREADS) {
        const int r = i / nv, o = i - r * nv;
        float sum = 0.0f;
#pragma unroll
        for (int ks = 0; ks < NWARPS; ++ks) sum += part_s[(ks * DR + r) * Vc + o];
        lg_s[r * Vc + o] = sum + outb_s[o];
      }
    }
    __syncthreads();
    lap(13);
    // argmax, the first index of the maximum: a warp per row over this
    // block's columns (index V: none), the pair to every block, then the C
    // pairs in block order, so that the smallest index wins a tie
    if (warp < DR) {
      const int r = warp;
      float best = -CUDART_INF_F;
      int bi = V;
      for (int o = lane; o < nv; o += 32) {
        const float x = lg_s[r * Vc + o];
        if (x > best || bi == V) best = x, bi = v0 + o;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (oi < V && (bi == V || ob > best || (ob == best && oi < bi))) best = ob, bi = oi;
      }
      if (lane < C) {
        *cluster.map_shared_rank(pmax_s + rank * DR + r, lane) = best;
        *cluster.map_shared_rank(pidx_s + rank * DR + r, lane) = bi;
      }
    }
    cluster.sync();
    if (tid < DR) {
      const int r = tid;
      float best = -CUDART_INF_F;
      int bi = V;
      for (int p = 0; p < C; ++p) {
        const float ob = pmax_s[p * DR + r];
        const int oi = pidx_s[p * DR + r];
        if (oi < V && (bi == V || ob > best || (ob == best && oi < bi))) best = ob, bi = oi;
      }
      const int token = fin_s[r] ? a.eos : bi;
      tok_s[r] = token;
      fin_s[r] = fin_s[r] || token == a.eos;
      if (rank == 0 && row0 + r < a.B) tokens[(size_t)(row0 + r) * a.steps + s] = token;
    }
    __syncthreads();
    lap(14);
    if (timed) clocks[15] += 1;
  }
  // <eos> for the steps the group did not run
  if (rank == 0)
    for (int r = 0; r < DR && row0 + r < a.B; ++r)
      for (int i = s + tid; i < a.steps; i += THREADS)
        tokens[(size_t)(row0 + r) * a.steps + i] = a.eos;
}

bool bad_shape(const DecArgs& a, int layout) {
  const int C = a.C;
  if (a.B <= 0 || a.T <= 0 || a.n_cells <= 0 || a.steps < 0 || a.V <= 0) return true;
  if (C < 1 || C > 8) return true;
  // 16-byte loads of every input row and weight slice
  if (a.E % 4 || a.AL % 8 || a.U % 4 || a.A % 4 || a.M % 4) return true;
  if (a.U % C || a.A % (4 * C) || a.AL % (4 * C)) return true;
  if (layout < LAYOUT_HELD || layout > LAYOUT_TILED) return true;
  if (layout != LAYOUT_HELD && a.act == nullptr) return true;
  if (layout == LAYOUT_TILED && a.ws == nullptr) return true;
  const DecLayout L = dec_layout(a.T, a.A, a.M, a.V, a.E, a.AL, a.U, a.n_cells, C, layout);
  return L.total * sizeof(float) > SMEM_MAX;
}

template <int LAYOUT>
cudaError_t prepare(const DecArgs& a, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const DecLayout L = dec_layout(a.T, a.A, a.M, a.V, a.E, a.AL, a.U, a.n_cells, a.C, LAYOUT);
  const size_t smem = L.total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(greedy_kernel<LAYOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3(a.C * ((a.B + DR - 1) / DR));
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int LAYOUT>
int launch(const DecArgs& a, int* tokens, int* info, long long* clocks, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = prepare<LAYOUT>(a, &cfg, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.stream = stream;
  if (info) {
    e = cudaOccupancyMaxActiveClusters(&info[0], greedy_kernel<LAYOUT>, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, greedy_kernel<LAYOUT>);
    if (e != cudaSuccess) return static_cast<int>(e);
    info[1] = (int)cfg.dynamicSmemBytes;
    info[2] = fa.numRegs;
    info[3] = (int)fa.sharedSizeBytes;
  }
  e = cudaLaunchKernelEx(&cfg, greedy_kernel<LAYOUT>, a, tokens, clocks);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// The whole greedy decode -> tokens [B, steps]. wq, attn_w and the cells'
// weights are regrouped into `cluster` column slices (see DecArgs);
// `layout` picks the held (0), streamed (1) or tiled (2) layout: the latter
// two keep the activations every block reads whole in `act` (ceil(B / 8)
// groups of act_floats, zeroed by the caller) and out_w in global memory
// (null `act` otherwise), the tiled one also each row's scores in `ws`
// (ceil(B / 8) * 8 rows of T floats, zeroed by the caller; null otherwise);
// info, if not null,
// receives what the card gives this launch: info[0] = clusters it can run at
// once (cudaOccupancyMaxActiveClusters), info[1] = dynamic shared memory
// bytes a block (dec_layout's, all the shared memory the kernel uses),
// info[2] = registers a thread, info[3] = static shared memory bytes (0);
// clocks is null or 16 cycle counters the kernel adds to (see the kernel). A
// shape whose layout passes SMEM_MAX returns cudaErrorInvalidValue; the
// wrapper's decoder_plan refuses it first.
extern "C" int plt_greedy_decode(const float* keys, const float* mem, const float* mask,
                                 int B, int T, int A, int M, const float* emb, int V,
                                 int E, const float* wq, const float* v,
                                 const float* attn_w, int AL, const float* out_w,
                                 const float* out_b, const void* cell_ptrs, int n_cells,
                                 int U, int bos, int eos, int steps, int cluster, int layout,
                                 float* act, float* ws, int* tokens, int* info, long long* clocks,
                                 void* stream) {
  DecArgs a{keys, mem, mask, emb, wq, v, attn_w, out_w, out_b,
            static_cast<const float* const*>(cell_ptrs), act, ws,
            B, T, A, M, V, E, AL, U, n_cells, bos, eos, steps, cluster};
  if (bad_shape(a, layout)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == LAYOUT_TILED) return launch<LAYOUT_TILED>(a, tokens, info, clocks, s);
  return layout == LAYOUT_STREAMED ? launch<LAYOUT_STREAMED>(a, tokens, info, clocks, s)
                                   : launch<LAYOUT_HELD>(a, tokens, info, clocks, s);
}
