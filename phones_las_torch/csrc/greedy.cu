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
// Two layouts: the held one (greedy_kernel) runs clusters, the grid one
// (greedy_grid_kernel, below) the whole card. The plan takes, at each shape, the
// layout a step model fitted to the card's readings says is the faster
// (decode/fused_greedy.py::decoder_plan, ::step_us): on an NVIDIA H100
// 80GB HBM3 the held layout at the serving shapes (the flagship B = 64,
// T_enc 250: 81.4 us a step against the grid's 105.7), the grid at
// offline B = 256 (204.7 against 250.1), at the LAS paper's 2 x 512
// speller and wherever the held layout does not fit.
//
// The held layout: a cluster of C blocks decodes a group of R = 8 rows (the
// TPU kernel's own group) and loops over the steps inside the kernel;
// groups run in parallel (grid = C * ceil(B/8)).
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
//     step's h while its peers already write this step's. Every block holds
//     what every block reads whole (DecLayout): h of each cell, the
//     attention vector and the context, each [8][width], its out_w slice,
//     and a row's scores and mask [T].
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
// What bounds it: ~94 MB of L2 traffic a step at B = 64 is the design's own
// floor, ~17 us a step at ~5.5 TB/s, 3.4 ms for 200 steps. Prediction, made
// before its first run on the card: 25-40 us a step at B = 64 (5-8 ms for
// 200 steps against 40.9 ms), the scores' 64 k tanhf a row (~9 us on one
// SM) and the L2 streams the largest parts, and B = 8 (one cluster) no
// slower than B = 64. Past what a block holds (the LAS-4-1024 speller,
// U = A = 1024, M = 2048: about 430 KB a block; a row's scores past a few
// thousand positions; vocabularies past a few thousand entries) the layout
// does not fit, and a cluster could only have streamed those operands: every
// group reading every weight every step through the 8 SMs of its cluster
// (64.0 MB at W1024: cells 23.1 + 33.6, wq 4.2, the attention layer 3.1;
// 256 MB a step at B = 32 through 32 SMs) and each row's attention on one SM
// (52 MB of keys and memory a step at T_enc = 17,100), the SMs' intake at
// ~40 GB/s each. Hence the grid layout there.
//
// The grid layout (greedy_grid_kernel): one cooperative launch of one block
// an SM, every block in every stage of a step; the activations [B][width]
// in global memory (act: grid_ws); no grid barrier in the steps: each
// stage's writers raise readiness counters (a row tile's or a row's) and
// its readers wait on those of the rows they read (see the kernel).
//   - Dense stages (each cell, wq, the attention layer, the logits): the
//     output columns are cut into column blocks over the grid (a cell's by
//     units with their four gates), the rows into as many row groups as
//     the block's intake k (width + rows) is least (decode/fused_greedy.py
//     ::StageCut, ::grid_cuts): each weight is read once a step for the
//     whole batch, its rows in a bulk copy a tile (the Tensor Memory
//     Accelerator, counted on the slot's transaction barrier). (Holding
//     each block's weights in shared memory for the launch was measured
//     slower at every shape: the ring it leaves is smaller.) A block takes
//     its rows in passes of up to 8 P rows; a thread holds 8 rows x 4
//     columns of one k part; each tile of k comes through a ring of three
//     slots (of up to 64 KB: few tiles, each a round trip), its input rows
//     16 bytes a thread (cp.async; a bulk copy a row segment costs the copy
//     engine more than its bytes), two tiles in flight while one is
//     multiplied; the parts meet in shared memory and each output's parts
//     are added in a fixed order (four chains) by a thread of its own.
//   - Attention: each live row's valid positions are cut into chunks in
//     proportion to its length, 1 + floor((blocks - live rows) tl / sum tl)
//     a row (one each past as many live rows as blocks), recut only when a
//     row finishes; chunk idx goes to block idx % grid. Pass 1: a chunk's
//     keys come through the ring in bulk copies (issued before q is ready),
//     a warp a position scores them into ws and the block writes the
//     chunk's maximum. Pass 2, once every chunk maximum of the row is
//     published: the row's maximum (exact in any order), e = exp(s - max)
//     * mask as the chunk's memory rows come through the ring, the chunk's
//     sum of e and its unnormalised part of the context; once the row's
//     parts are all stored, each chunk's block merges a slice of the
//     row's context columns, each chunk's part divided by the row's sum
//     (its chunks' sums in chunk order), added in chunk order. Nothing
//     grows with T but the workspace. Where they fit
//     the L2 with room to spare, a step's keys are prefetched into L2 at its
//     start and each chunk's memory rows at its scores.
//   - The logits are a dense stage; each column block writes each row's
//     (maximum, first index), and every block, once every row tile's pairs
//     are published (the one wait on the whole grid a step), merges them in
//     column block order, the smallest index winning a tie, so all hold the
//     same tokens and stop together (when every row has emitted <eos>; a
//     finished row writes <eos>, skips its attention, and its other results
//     are discarded).
//   - Every block keeps every row's fed token, finished flag, length,
//     chunks and chunks so far in its shared memory (six ints a row), so a
//     launch takes at most a few thousand rows (2,920 at A = 1024); the
//     wrapper decodes a larger batch in passes of rows, a launch each.
//   - The order of the sums differs from the held layout's (k parts,
//     chunks, the context's parts divided by the row's sum), fixed by the
//     shape, so a launch is bitwise repeatable.
// What bounds it: a step's chain of dependent stages (two cells, the
// query, the scores, the context, the merge, the attention layer, the
// logits, the argmax), each a publication, a wait and a round trip of its
// first tile through L2; then the attention's keys and memory (49 MB a
// step at the flagship shape, from L2 where prefetched, else device
// memory: 9-15 us a step) and the dense stages' input rows (each row read
// by every column block of its group). Measured on an NVIDIA H100 80GB HBM3
// (PERF.md, section 6; chip_smoke.py --sweep-decoder gives each part's
// cycles): the flagship 105.7 us a step (115.9 with the weights held in
// shared memory), the chain's waits and fixed costs most of it; W1024 at
// B = 32, T_enc 219 165 us (178 when nine grid barriers a step ended its
// stages, in turns).
//
// Every offset into keys, memory, the mask, the workspace and the tokens is
// taken in 64 bits: B T M passes 2^32 at B = 64, T = 17,100, M = 4096.
//
// Precision: float32 throughout, as the reference kernel's HIGHEST dots (no
// TF32 anywhere). Sums run in another order than the plain version's (k
// split in parts; the grid layout's chunks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "grid_sync.cuh"

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

// the grid layout: a dense stage's cut over the grid (decode/fused_greedy.py::
// StageCut): block g < cols * groups computes column block g % cols (a
// contiguous slice of width floats of every row of the stage's weights) for
// the rows [g / cols * rows, + rows) of its row group, tiles row tiles of 8
// a pass
struct StageCut {
  int cols, width, groups, rows, tiles;
};
constexpr int N_STAGES = 5;  // the first cell, the other cells, the query, the attention layer, the logits
enum GridStage { ST_CELL0 = 0, ST_CELLS = 1, ST_QUERY = 2, ST_LAYER = 3, ST_LOGITS = 4 };
struct GridCut {
  StageCut st[N_STAGES];
  int slot;  // floats of a slot of the ring
};
constexpr int CUT_INTS = 5 * N_STAGES + 1;  // the C API's cut: each stage's five numbers, then slot

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
  float* act;  // grid layout: the workspace in global memory (grid_ws)
  float* ws;   // grid layout: each row's scores, then exp(score - max) * mask [rows][T]
  int B, T, A, M, V, E, AL, U, n_cells, bos, eos, steps, C;  // grid layout: C = blocks of the grid
  GridCut g;   // grid layout: the cut
};

// The two layouts, in the order the plan tries them (decode/fused_greedy.py::
// decoder_plan).
constexpr int LAYOUT_HELD = 0;  // clusters: every activation a block reads whole in its own shared memory
constexpr int LAYOUT_GRID = 1;  // no clusters: every block of the grid in every stage (greedy_grid_kernel)
constexpr int NSLOT = 3;       // grid: slots of the ring (two tiles in flight while one is used)
constexpr int KS_MAX = 32;     // grid: most k parts of a dense stage
constexpr long long L2_PREFETCH_BYTES = 40LL << 20;  // grid: most bytes a step prefetches into the 50 MB L2
constexpr int MAX_TILES = 128; // grid: most row tiles of 8 in a pass

// float offsets of a held block's shared memory; decode/fused_greedy.py::
// decoder_smem_bytes mirrors it
struct DecLayout {
  int Kmax;  // widest staged input: max(E + AL + U, 2U, U + M)
  int Vc;    // vocabulary columns a block owns: ceil(V / C) rounded up to 4
  int ldo;   // row stride of the transposed out_w slice: AL + 4, so that the
             // rows of neighbouring vocabulary entries start in different banks
  size_t stage, hbuf, cst, attn, q, ctx, part, outw, outb, bias, sc, mk, v, lg, pair, flags, red,
      total;  // in floats
};

__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline size_t smax(size_t x, size_t y) { return x > y ? x : y; }

__host__ __device__ inline DecLayout dec_layout(int T, int A, int M, int V, int E, int AL,
                                                int U, int n_cells, int C) {
  DecLayout L;
  L.Kmax = (int)smax(smax(E + AL + U, 2 * U), U + M);
  L.Vc = (int)pad4((V + C - 1) / C);
  size_t off = 0;
  L.stage = off, off += (size_t)DR * L.Kmax;
  L.hbuf = off, off += (size_t)n_cells * 2 * DR * U;
  L.cst = off, off += (size_t)n_cells * DR * (U / C);
  L.attn = off, off += (size_t)DR * AL;
  L.q = off, off += (size_t)DR * A;
  L.ctx = off, off += (size_t)DR * M;
  const size_t widest = smax(smax(4 * U / C, A / C), AL / C);  // columns of a dense stage
  // partial sums: a dense stage's [k parts][8][columns], the context's [T
  // parts][M], the logits' [k parts][8][Vc]
  L.part = off, off += smax(smax((size_t)THREADS * 4 * DR, DR * widest),
                            smax(smax((size_t)THREADS * 4, (size_t)M), (size_t)NWARPS * DR * L.Vc));
  // small operands that every step reads: this block's columns of out_w
  // (transposed) and out_b, its slices of the cells' biases
  L.ldo = AL + 4;
  L.outw = off, off += (size_t)L.Vc * L.ldo;
  L.outb = off, off += L.Vc;
  L.bias = off, off += (size_t)n_cells * 4 * (U / C);
  L.sc = off, off += pad4(T);  // a row's scores, then its weights
  L.mk = off, off += pad4(T);
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

__global__ void __launch_bounds__(THREADS, 1)
greedy_kernel(DecArgs a, int* __restrict__ tokens, long long* __restrict__ clocks) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C, rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / C) * DR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = a.T, A = a.A, M = a.M, V = a.V, E = a.E, AL = a.AL, U = a.U;
  const int Us = U / C, Nc = 4 * Us, Ac = A / C, ALc = AL / C;
  const DecLayout L = dec_layout(T, A, M, V, E, AL, U, a.n_cells, C);
  const int Vc = L.Vc, v0 = rank * Vc, nv = max(0, min(V - v0, Vc));  // this block's vocabulary columns
  float* stage_s = smem + L.stage;  // [8][Kmax] a dense stage's input
  float* hbuf = smem + L.hbuf;      // [n_cells][2][8][U]
  float* c_s = smem + L.cst;        // [n_cells][8][Us] this block's units
  float* attn = smem + L.attn;      // [8][AL]
  float* q_s = smem + L.q;          // [8][A]
  float* ctx = smem + L.ctx;        // [8][M]
  float* part_s = smem + L.part;
  float* outw_s = smem + L.outw;    // [Vc][ldo] columns v0.. of out_w, transposed
  float* outb_s = smem + L.outb;    // [Vc]
  float* bias_s = smem + L.bias;    // [n_cells][4 Us] this block's slices
  float* sc_s = smem + L.sc;        // [T] scores, then weights
  float* mk_s = smem + L.mk;        // [T]
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
      // [input; h of the last step], a row a pair of warps
      for (int r = warp >> 1; r < DR; r += NWARPS / 2) {
        const int l0 = lane + 32 * (warp & 1);
        float* dst = stage_s + r * K;
        if (l > 0) {
          copy_row(dst, hl - 2 * DR * U + (nxt * DR + r) * U, U, l0);
        } else {
          load_row(dst, a.emb + (size_t)tok_s[r] * E, E, l0);
          copy_row(dst + E, attn + r * AL, AL, l0);
        }
        copy_row(dst + din, hl + (cur * DR + r) * U, U, l0);
      }
      __syncthreads();
      lap(0);
      const int KS = dense(wl, K, Nc, stage_s, K, part_s);
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
      share_columns(cluster, hl + nxt * DR * U, U, rank * Us, Us, C, rank);
      lap(2);
      cluster.sync();
      lap(3);
    }
    const float* hout = hbuf + ((size_t)(a.n_cells - 1) * 2 + nxt) * DR * U;  // [8][U]

    // query: block `rank` owns A/C columns; row r's go to the block that attends for it
    {
      const float* wq = a.wq + (size_t)rank * U * Ac;
      const int KS = dense(wq, U, Ac, hout, U, part_s);
      __syncthreads();
      lap(4);
      for (int i = tid; i < DR * Ac; i += THREADS) {
        const int r = i / Ac, c = i - r * Ac;
        *cluster.map_shared_rank(q_s + r * A + rank * Ac + c, r % C) = gather(part_s, KS, Ac, r, c);
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
      for (int t = tid; t < tl; t += THREADS) mk_s[t] = mkr[t];
      __syncthreads();
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
          const float4 q = *reinterpret_cast<const float4*>(q_s + r * A + 4 * a4);
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
          if (lane == 0 && t0 + j < tl) sc_s[t0 + j] = sum + (1.0f - mk_s[t0 + j]) * NEG;
        }
      }
      __syncthreads();
      lap(6);
      // exp(s - max) * mask / max(sum, 1e-30); a row with no valid position has tl = 0
      float mx = -CUDART_INF_F;
      for (int t = tid; t < tl; t += THREADS) mx = fmaxf(mx, sc_s[t]);
      mx = block_reduce<true>(mx, red_s);
      float sum = 0.0f;
      for (int t = tid; t < tl; t += THREADS) {
        const float e = expf(sc_s[t] - mx) * mk_s[t];
        sc_s[t] = e;
        sum += e;
      }
      sum = fmaxf(block_reduce<false>(sum, red_s), 1e-30f);
      for (int t = tid; t < tl; t += THREADS) sc_s[t] = sc_s[t] / sum;
      __syncthreads();
      lap(7);
      // context: an item = (part of T, 4 columns of M)
      const int mq = M / 4;
      const int TS = max(1, THREADS / mq), tper = (tl + TS - 1) / TS;
      for (int item = tid; item < mq * TS; item += THREADS) {
        const int m4 = item % mq, ts = item / mq;
        const int tb = ts * tper, te = min(tl, tb + tper);
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
        for (int t = tb; t < te; ++t) {
          const float p = sc_s[t];
          const float4 mv = __ldg(reinterpret_cast<const float4*>(Mr + (size_t)t * M) + m4);
          acc.x = fmaf(p, mv.x, acc.x);
          acc.y = fmaf(p, mv.y, acc.y);
          acc.z = fmaf(p, mv.z, acc.z);
          acc.w = fmaf(p, mv.w, acc.w);
        }
        *reinterpret_cast<float4*>(part_s + (size_t)ts * M + 4 * m4) = acc;
      }
      __syncthreads();
      lap(8);
      for (int m = tid; m < M; m += THREADS) {
        float c = part_s[m];
        for (int ts = 1; ts < TS; ++ts) c += part_s[(size_t)ts * M + m];
        ctx[r * M + m] = c;
      }
      __syncthreads();  // part_s, sc_s and mk_s are reused by the next row
      for (int i = tid; i < (C - 1) * (M / 4); i += THREADS) {  // the row to every block
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
      for (int r = warp >> 1; r < DR; r += NWARPS / 2) {
        const int l0 = lane + 32 * (warp & 1);
        copy_row(stage_s + r * K, hout + r * U, U, l0);
        copy_row(stage_s + r * K + U, ctx + r * M, M, l0);
      }
      __syncthreads();
      lap(10);
      const int KS = dense(wa, K, ALc, stage_s, K, part_s);
      __syncthreads();
      lap(11);
      for (int i = tid; i < DR * ALc; i += THREADS) {
        const int r = i / ALc, c = i - r * ALc;
        attn[r * AL + rank * ALc + c] = gather(part_s, KS, ALc, r, c);
      }
      __syncthreads();
      share_columns(cluster, attn, AL, rank * ALc, ALc, C, rank);
      cluster.sync();
      lap(12);
    }

    // logits of this block's columns for all 8 rows: a warp per part of k,
    // a lane per vocabulary entry, all 8 rows a thread
    {
      const int kq = AL / 4, kper = (kq + NWARPS - 1) / NWARPS;  // in float4s
      const int kb = warp * kper, ke = min(kq, kb + kper);
      for (int o = lane; o < nv; o += 32) {
        const float4* w = reinterpret_cast<const float4*>(outw_s + o * L.ldo);
        float acc[DR];
#pragma unroll
        for (int r = 0; r < DR; ++r) acc[r] = 0.0f;
        for (int k = kb; k < ke; ++k) {
          const float4 wv = w[k];
#pragma unroll
          for (int r = 0; r < DR; ++r) {
            const float4 x = reinterpret_cast<const float4*>(attn + r * AL)[k];
            acc[r] = fmaf(x.x, wv.x, acc[r]);
            acc[r] = fmaf(x.y, wv.y, acc[r]);
            acc[r] = fmaf(x.z, wv.z, acc[r]);
            acc[r] = fmaf(x.w, wv.w, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < DR; ++r) part_s[(warp * DR + r) * Vc + o] = acc[r];
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

// ---- the grid layout: one block an SM, every block in every stage of a step

__host__ __device__ inline int imin(int x, int y) { return x < y ? x : y; }
__host__ __device__ inline int imax(int x, int y) { return x > y ? x : y; }
__host__ __device__ inline size_t round8(size_t n) { return (n + 7) / 8 * 8; }

// float offsets of a grid block's shared memory; decode/fused_greedy.py::
// decoder_smem_bytes(grid=) mirrors it
struct GridLayout {
  size_t ring, mbar, pw, q, v, tok, fin, tl, nch, base, off, flag, red, tile, total;
};
__host__ __device__ inline GridLayout grid_layout(int B, int A, const GridCut& g) {
  GridLayout L;
  size_t off = 0;
  // the ring's slots: a dense stage's tiles of input rows and weights, the
  // scores' tiles of keys, the context's tiles of memory rows; after a
  // dense stage's last tile its partial sums, after the context's its
  // parts, in the merge its staged parts
  L.ring = off, off += (size_t)NSLOT * g.slot;
  L.mbar = off, off += pad4(2 * NSLOT);        // the slots' transaction barriers (8 bytes each; 16-byte aligned after)
  L.pw = off, off += (size_t)NSLOT * THREADS;  // each slot's mask (the scores) or exp(score - max) * mask (the context)
  L.q = off, off += pad4(A);                   // q of the row being scored
  L.v = off, off += pad4(A);
  L.tok = off, off += round8(B);      // ints: the token fed to every row
  L.fin = off, off += round8(B);      // ints: every row's finished flag
  L.tl = off, off += round8(B);       // ints: one past every row's last valid position
  L.nch = off, off += round8(B);      // ints: every row's chunks this step
  L.base = off, off += round8(B);     // ints: every row's chunks over the steps before this one
  L.off = off, off += round8(B + 1);  // ints: its first chunk's index among all rows' chunks
  L.flag = off, off += 4;             // ints: a row finished at the last step (the chunks are cut anew); the
                                      // step's reads are prefetched into L2
  L.red = off, off += 64;
  L.tile = off, off += 4 * N_STAGES;  // ints: each dense stage's DenseTile
  L.total = off;
  return L;
}

// float offsets of the grid layout's workspace in global memory (act), B
// rows padded to 8; decode/fused_greedy.py::grid_act_floats mirrors it
struct GridWs {
  size_t h, c, attn, q, ctx, cmax, csum, pctx, pmax, pidx, tl, cnt, total;
};
__host__ __device__ inline GridWs grid_ws(int B, int A, int M, int AL, int U, int n_cells, int G, int lcols) {
  const size_t bp = round8(B), chunks = pad4(bp > (size_t)G ? bp : (size_t)G), nt = bp / 8;
  GridWs W;
  size_t off = 0;
  W.h = off, off += (size_t)n_cells * 2 * bp * U;  // [n_cells][2][B][U], double-buffered by step
  W.c = off, off += (size_t)n_cells * bp * U;      // [n_cells][B][U], each unit's owner's own
  W.attn = off, off += bp * AL;                    // [B][AL]
  W.q = off, off += bp * A;                        // [B][A]
  W.ctx = off, off += bp * M;                      // [B][M]
  W.cmax = off, off += chunks;                     // [chunks of all rows] each chunk's maximum score
  W.csum = off, off += chunks;                     // each chunk's sum of exp(score - max) * mask
  W.pctx = off, off += chunks * M;                 // [chunks][M] each chunk's part of its row's context
  W.pmax = off, off += 2 * pad4(bp * lcols);       // [2][B][logits' column blocks] each block's maximum, by step parity
  W.pidx = off, off += 2 * pad4(bp * lcols);       // ints, its first index
  W.tl = off, off += bp;                           // ints: every row's length
  // unsigned counters: the prologue's grid barrier, the argmax's arrivals
  // by step parity, one unused; then the readiness counters of each row
  // tile of 8: h of each cell [n_cells][B / 8], q, the attention vector,
  // the logits' pairs; then of each row: its chunks' maxima, its chunks'
  // parts of the context, its context's merged slices
  W.cnt = off, off += pad4(4 + (n_cells + 3) * nt + 3 * bp);
  W.total = off;
  return W;
}

// How a pass of a dense stage cuts its k (decode/fused_greedy.py::
// grid_tile): a thread an item (k part, row tile, column group of 4), at
// most KS_MAX parts; tile j holds float4s [j KS S4, (j + 1) KS S4) of k,
// part ks its float4s [ks S4, (ks + 1) S4) of each tile; a slot of `slot`
// floats holds a tile's input rows (Rp rows of ld floats) and its weight
// rows (kt rows of wc floats). Of the cuts a slot
// holds, the one of the fewest tiles, then of the most parts. The kernel
// takes each stage's from the block's shared memory (made once).
struct DenseTile {
  int KS, S4, ld, ntiles;
};
__host__ __device__ inline DenseTile grid_tile(int k4n, int wc, int tiles, int slot) {
  const int Rp = 8 * tiles, ncg = wc / 4, per4 = 4 * (Rp + wc);  // a float4 of k in the slot
  const int avail = (slot - 4 * Rp) / per4;  // float4s of k a slot holds
  DenseTile d{0, 0, 0, 0x7fffffff};
  // the fewest tiles (each a round trip through the ring), then the most parts
  for (int ks = imax(1, imin(imin(KS_MAX, THREADS / (ncg * tiles)), k4n)); ks >= 1; --ks) {
    const int s4 = imax(1, imin((k4n + ks - 1) / ks, avail / ks)), n = (k4n + ks * s4 - 1) / (ks * s4);
    if (n < d.ntiles) d = DenseTile{ks, s4, 4 * ks * s4 + 4, n};
  }
  return d;
}

// The ring's copies are bulk copies (the Tensor Memory Accelerator), each
// counted in bytes on its slot's transaction barrier (mbarrier): an SM keeps
// far more bytes in flight so than with 16-byte copies a thread.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}
// this thread's arrival, with the bytes its copies will add to the phase
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
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
// wait for the phase of `parity`; a wait of seconds means a lost copy, and
// the kernel ends with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_done(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_done(bar, parity))
    if (clock64() - t0 > 4000000000LL) __trap();
}
// 16 bytes from global memory (from L2, past this SM's L1) into shared memory
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
// `bytes` (a multiple of 16) of global memory into L2, ahead of their reads
__device__ __forceinline__ void l2_prefetch(const float* src, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}
// `bytes` (a multiple of 16) from global memory (through L2) into this
// block's shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes, unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Readiness (grid_sync.cuh's chunk_publish is the release): warp 0 waits
// until counter ctr[i] has reached target(i) for every i < n (target 0: no
// wait), its lanes polling 32 counters at once. Each lane's acquire orders
// its counters' writers' stores before its later operations, the warp
// barrier before every lane's, and the block barrier the caller passes next
// before every thread's (which read the data through L2: ld.cg,
// cp.async.cg). A wait of seconds ends the kernel with an error, as
// grid_wait's.
template <class Target>
__device__ __forceinline__ void ready_wait(const unsigned* ctr, int n, Target target) {
  const int lane = threadIdx.x & 31;
  const long long t0 = clock64();
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const unsigned tg = i < n ? target(i) : 0u;
    for (;;) {
      unsigned seen = tg;
      if (tg != 0) asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(ctr + i) : "memory");
      if (__all_sync(0xffffffffu, (int)(seen - tg) >= 0)) break;
      if (clock64() - t0 > 4000000000LL) __trap();
    }
  }
  __syncwarp();
}

// The ring: NSLOT slots of `slot` floats, a transaction barrier each (a
// phase: thread 0's arrival with the bytes of the tile's bulk copies), and
// the parity each barrier's next phase completes with.
struct Ring {
  float* slots;
  unsigned bar0;   // shared address of slot 0's barrier; slot s's at bar0 + 8 s
  unsigned phase;  // bit s: the parity of slot s's next phase
  int slot;        // floats of a slot
};

// ntiles tiles through the ring: fill(j, slot, bar) issues tile j's copies
// (thread 0 its bulk copies and its arrival on the slot's barrier with
// their bytes, every thread its cp.async copies, committed as one group
// here) and may store beside them; use(j, slot) reads the tile once its
// bytes have landed; the next NSLOT - 1 tiles are in flight while one is
// used. Every thread of the block calls it alike.
template <class Fill>
__device__ __forceinline__ void ring_start(int ntiles, Ring& rg, Fill fill) {  // the first NSLOT - 1 fills
  for (int j = 0; j < NSLOT - 1; ++j) {
    if (j < ntiles) fill(j, rg.slots + (size_t)j * rg.slot, rg.bar0 + 8 * j);
    cp_async_commit();
  }
}
// the rest of ring_run, after ring_start (which a caller may issue before a
// wait that the first tiles' copies do not depend on)
template <class Fill, class Use>
__device__ __forceinline__ void ring_rest(int ntiles, Ring& rg, Fill fill, Use use, long long* clocks, int fills) {
  long long t0 = clocks ? clock64() : 0;
  auto lap = [&](int i) {  // the cycles of each part of the ring: `fills` its fills, 5 the first tile's wait, 2
                           // the others', 10 uses
    if (clocks) {
      const long long now = clock64();
      clocks[i] += now - t0;
      t0 = now;
    }
  };
  for (int j = 0; j < ntiles; ++j) {
    if (j + NSLOT - 1 < ntiles) {
      const int f = (j + NSLOT - 1) % NSLOT;
      fill(j + NSLOT - 1, rg.slots + (size_t)f * rg.slot, rg.bar0 + 8 * f);
    }
    cp_async_commit();
    lap(fills);
    const int sl = j % NSLOT;
    cp_async_wait<NSLOT - 1>();
    mbar_wait(rg.bar0 + 8 * sl, (rg.phase >> sl) & 1u);
    rg.phase ^= 1u << sl;
    __syncthreads();  // and what the fills stored beside the copies
    lap(j == 0 ? 5 : 2);
    use(j, rg.slots + (size_t)sl * rg.slot);
    __syncthreads();  // the slot is refilled with tile j + NSLOT
    lap(10);
  }
}
template <class Fill, class Use>
__device__ __forceinline__ void ring_run(int ntiles, Ring& rg, Fill fill, Use use, long long* clocks, int fills = 0) {
  long long t0 = clocks ? clock64() : 0;
  ring_start(ntiles, rg, fill);
  if (clocks) clocks[fills] += clock64() - t0;
  ring_rest(ntiles, rg, fill, use, clocks, fills);
}

// sum over the k parts of one output of a pass, in a fixed order: four
// chains (parts ks = 4 i + j on chain j, the rest on chain 0), as gather()
__device__ __forceinline__ float grid_gather(const float* part, int KS, int Rp, int wc, int rl, int col) {
  const float* p = part + (size_t)rl * wc + col;
  const size_t stride = (size_t)Rp * wc;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int ks = 0;
  for (; ks + 4 <= KS; ks += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] += p[(ks + j) * stride];
  }
  for (; ks < KS; ++ks) s[0] += p[ks * stride];
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// One pass of a dense stage: part[ks][rl][col] = the sum over k part ks of
// in[rl][k] * w[k][col] for the rows [rb, re) of the pass (Rp = 8 P slots
// of rows), w [K][wc] this block's column block, read once a pass
// through the ring. Tile j (grid_tile's cut)
// brings each row's k range [j kt, (j + 1) kt) through src(r, k, n) (the
// address of input float k of row r, n floats on from it contiguous), 16
// bytes a thread (cp.async: a bulk copy a row segment costs the copy
// engine more than the bytes), and the weight rows of that range in one
// bulk copy. A
// thread an item (k part, row tile, column group): 8 rows x 4 columns in
// registers across the tiles. Staged row rl lies at row (rl % 8) P + rl / 8
// of a slot, so that a warp's row tiles read other banks; the slots of rows
// past re are not written, and their sums not read. The parts' sums land in
// the ring once every tile has been read, and each output's sum of its
// parts in part 0; returns 1, the parts the epilogue reads.
template <class Src>
__device__ __forceinline__ int grid_dense(const float* __restrict__ w, int K, int wc, int P, const DenseTile d, int rb,
                                          int re, Src src, Ring& rg, long long* clocks) {
  const int ncg = wc / 4, k4n = K / 4, Rp = 8 * P;
  const int KS = d.KS, S4 = d.S4, ld = d.ld, kt = 4 * KS * S4;
  const int tid = threadIdx.x, nv = re - rb;
  const int cg = tid % ncg, rt = (tid / ncg) % P, ks = tid / (ncg * P);
  const bool active = ks < KS;
  auto fill = [&](int j, float* slot, unsigned bar) {
    const int kb = j * kt, kl = imin(kt, K - kb), kq = kl / 4;  // the tile's k
    if (tid == 0) {
      mbar_expect(bar, (unsigned)kl * wc * 4);
      bulk_load(slot + (size_t)Rp * ld, w + (size_t)kb * wc, (unsigned)kl * wc * 4, bar);
    }
    // the input rows, a float4 a thread at a time (L2 hits, shared by the grid)
    for (int i = tid; i < nv * kq; i += THREADS) {
      const int rl = i / kq, k = kb + 4 * (i - rl * kq);
      int n;
      cp_async16(slot + (size_t)((rl & 7) * P + (rl >> 3)) * ld + (k - kb), src(rb + rl, k, n));
    }
  };
  float acc[DR][4];
#pragma unroll
  for (int r = 0; r < DR; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
  auto use = [&](int j, const float* slot) {
    if (!active) return;
    const int qn = imin(S4, k4n - j * KS * S4 - ks * S4);  // this part's float4s in the tile
    // float4 k4 of row tile rt's row r at xs[r P ld + 4 k4], its 4 weight rows at wr[4 k4 wc]
    const float* xs = slot + (size_t)rt * ld + 4 * ks * S4;
    const float* wr = slot + (size_t)Rp * ld + (size_t)ks * S4 * 4 * wc + 4 * cg;
    for (int k4 = 0; k4 < qn; ++k4) {
      const float* wk = wr + (size_t)k4 * 4 * wc;
      const float4 w0 = *reinterpret_cast<const float4*>(wk);
      const float4 w1 = *reinterpret_cast<const float4*>(wk + wc);
      const float4 w2 = *reinterpret_cast<const float4*>(wk + 2 * wc);
      const float4 w3 = *reinterpret_cast<const float4*>(wk + 3 * wc);
#pragma unroll
      for (int r = 0; r < DR; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(xs + (size_t)r * P * ld + 4 * k4);
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
  };
  ring_run(d.ntiles, rg, fill, use, clocks);
  if (active)
#pragma unroll
    for (int r = 0; r < DR; ++r)
      *reinterpret_cast<float4*>(rg.slots + ((size_t)(ks * Rp + rt * DR + r) * wc + 4 * cg)) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  // each output's k parts summed (grid_gather's order) by a thread of its
  // own, into part 0: the epilogue then reads one sum an output
  for (int o = tid; o < nv * wc; o += THREADS) {
    const int rl = o / wc, col = o - rl * wc;
    rg.slots[o] = grid_gather(rg.slots, KS, Rp, wc, rl, col);
  }
  __syncthreads();
  return 1;
}

// a warp's (maximum, first index) pairs merged into every lane's (index V:
// none): the larger maximum, the smaller index on a tie, so the merge is
// the first index of the maximum in any order
__device__ __forceinline__ void pair_max(float& best, int& bi, int V) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (oi < V && (bi == V || ob > best || (ob == best && oi < bi))) best = ob, bi = oi;
  }
}

// A pass's row tiles published on their counters, one thread, after a
// block barrier that gathered the others' stores: one fence, then a
// relaxed add a counter (a release pattern, as chunk_publish's release).
__device__ __forceinline__ void tiles_publish(unsigned* ctr, int t0, int t1) {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  for (int t = t0; t < t1; ++t) asm volatile("red.relaxed.gpu.global.add.u32 [%0], 1;\n" ::"l"(ctr + t) : "memory");
}

// the row whose chunks hold chunk index idx: the last r with off[r] <= idx
// (a finished row has no chunks, off[r] == off[r + 1])
__device__ __forceinline__ int chunk_row(const int* off, int B, int idx) {
  int lo = 0, hi = B - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= idx) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The grid layout's steps. One grid barrier in the prologue; in the steps,
// none: each stage's writers raise a readiness counter for each row tile
// (or row) they wrote, once a block barrier has gathered their stores
// (chunk_publish or tiles_publish, a release), and each stage's reader
// waits (ready_wait, an acquire) on the counters of the rows it reads:
//   cell l     h of cell l - 1 of its row tiles, this step (l > 0);
//   query      h of the last cell of its row tiles;
//   scores     q of the chunk's row tile;
//   context    every chunk maximum of the chunk's row (pass 1's counter);
//   the merge  every chunk's part of the chunk's row (pass 2's counter);
//   the layer  h of the last cell of its row tiles and every slice of the
//              context of each live row of them (the merge's counter);
//   logits     the attention vector of its row tiles, and every block's
//              arrival after the argmax of two steps before (the pairs
//              are double-buffered by step parity; the arrivals are
//              counted by step parity too, or a fast block's arrivals of
//              later steps would stand in for a lagging block's);
//   argmax     the pairs of every row tile: the one wait on the whole grid
//              a step (every block needs every row's token and finished
//              flag: the chunks are cut from them).
// A row's context is merged in slices of its columns, one by each of its
// chunks' blocks: the chunks' sums added in chunk order, then each chunk's
// part divided by that sum and the parts added in chunk order. A row's
// counters count its chunks over the steps (base_s), so a row's target is
// its chunks so far and this step's.
// Why no write overwrites what another block still reads. A block starts
// step s + 1 only after its argmax of step s, which waited on every row
// tile's logits of step s; those waited (through the chain above) on every
// read of step s but the argmax's own: each dense stage's input rows, the
// query's and the chunks' reads (a finished row has no chunks and no
// reader of its context; a dense stage's reads of a row tile whose rows
// have all finished may lag, and their results are discarded). So every
// write of step s + 1 comes after every read of step s whose result is
// used but those of the pairs, which are double-buffered and
// written at step s + 2 only once every block has arrived after its argmax
// of step s. Within a step, a buffer is written before it is read, but h:
// a cell reads its own h of the last step while its peers write this
// step's, so h is double-buffered by step parity. The same chain orders
// the writes of step s before the reads of step s + 1 that wait on no
// counter of their own (the first cell's input, each cell's h of the last
// step): their writers' stores reached the logits' writers before the
// argmax's acquire. tests/test_torch_decoder_resident.py models the waits
// over three steps.
__global__ void __launch_bounds__(THREADS, 1)
greedy_grid_kernel(DecArgs a, int* __restrict__ tokens, long long* __restrict__ clocks) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int G = gridDim.x, blk = blockIdx.x;
  const int B = a.B, T = a.T, A = a.A, M = a.M, V = a.V, E = a.E, AL = a.AL, U = a.U, NC = a.n_cells;
  const size_t Bp = round8(B);
  const int NT = (int)(Bp / 8);
  const GridLayout L = grid_layout(B, A, a.g);
  const int lcols = a.g.st[ST_LOGITS].cols;
  const GridWs W = grid_ws(B, A, M, AL, U, NC, G, lcols);
  Ring rg{smem + L.ring, smem_addr(smem + L.mbar), 0u, a.g.slot};
  float* pw_s = smem + L.pw;
  float* q_s = smem + L.q;
  float* v_s = smem + L.v;
  int* tok_s = reinterpret_cast<int*>(smem + L.tok);
  int* fin_s = reinterpret_cast<int*>(smem + L.fin);
  int* tl_s = reinterpret_cast<int*>(smem + L.tl);
  int* nch_s = reinterpret_cast<int*>(smem + L.nch);
  int* base_s = reinterpret_cast<int*>(smem + L.base);
  int* off_s = reinterpret_cast<int*>(smem + L.off);
  int* changed_s = reinterpret_cast<int*>(smem + L.flag);
  int* pf_s = changed_s + 1;
  DenseTile* tile_s = reinterpret_cast<DenseTile*>(smem + L.tile);
  const int K_of[N_STAGES] = {E + AL + U, 2 * U, U, U + M, AL};
  float* red_s = smem + L.red;
  float* h = a.act + W.h;
  float* cst = a.act + W.c;
  float* attn = a.act + W.attn;
  float* qg = a.act + W.q;
  float* ctx = a.act + W.ctx;
  float* cmax = a.act + W.cmax;
  float* csum = a.act + W.csum;
  float* pctx = a.act + W.pctx;
  float* pmax = a.act + W.pmax;
  int* pidx = reinterpret_cast<int*>(a.act + W.pidx);
  int* tlg = reinterpret_cast<int*>(a.act + W.tl);
  unsigned* cnt = reinterpret_cast<unsigned*>(a.act + W.cnt);
  unsigned* bar = cnt;                // the prologue's grid barrier
  unsigned* done = cnt + 1;           // [2] each block's arrival after its argmax, by step parity
  unsigned* c_h = cnt + 4;            // [NC][NT]
  unsigned* c_q = c_h + (size_t)NC * NT;
  unsigned* c_attn = c_q + NT;
  unsigned* c_lg = c_attn + NT;
  unsigned* c_p1 = c_lg + NT;         // [Bp]
  unsigned* c_p2 = c_p1 + Bp;
  unsigned* c_ctx = c_p2 + Bp;
  unsigned epoch = 0;

  for (int i = tid; i < A; i += THREADS) v_s[i] = a.v[i];
  for (int r = tid; r < (int)Bp; r += THREADS) {
    tok_s[r] = a.bos;
    fin_s[r] = r >= B;
    base_s[r] = 0;
  }
  if (tid < N_STAGES) tile_s[tid] = grid_tile(K_of[tid] / 4, a.g.st[tid].width, a.g.st[tid].tiles, a.g.slot);
  if (tid == 0) {
    *changed_s = 1;
    for (int i = 0; i < NSLOT; ++i) mbar_init(rg.bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // one past the last valid position of every row: block g scans rows g, g + G, ...
  for (int r = blk; r < B; r += G) {
    const float* mkr = a.mask + (size_t)r * T;
    float last = 0.0f;
    for (int t = tid; t < T; t += THREADS)
      if (mkr[t] != 0.0f) last = (float)(t + 1);
    last = block_reduce<true>(last, red_s);
    if (tid == 0) tlg[r] = (int)last;
  }
  grid_sync(bar, epoch);
  for (int r = tid; r < B; r += THREADS) tl_s[r] = __ldcg(tlg + r);
  __syncthreads();

  // clocks (optional, 19; GRID_CLOCK_NAMES): SM cycles thread 0 of block
  // 0 spent in 1 the cells' rings and products, 3 the dense stages' waits
  // on their inputs' counters, 4 the query's, 18 the dense stages'
  // epilogues (the k parts' sums, the cell update, the stores), 17 their
  // publications, 6 the scores, 7 the softmax and the context's parts, 8
  // the attention's waits on counters, 9 the context's merge, 11 the
  // attention layer's ring and product, 12 the logits', 13 the argmax's wait
  // on every row tile's pairs, 14 the argmax; inside those, 0 the dense
  // rings' fills, 16 the attention rings' fills, 5 the rings' first tile's
  // waits (their start-up), 2 their other tiles' waits, 10 their uses; 15
  // counts the steps
  const bool timed = clocks != nullptr && tid == 0 && blk == 0;
  long long* rclk = timed ? clocks : nullptr;  // the ring's own parts
  long long tick = timed ? clock64() : 0;
  auto lap = [&](int i) {
    if (timed) {
      const long long now = clock64();
      clocks[i] += now - tick;
      tick = now;
    }
  };
  // a dense stage: this block's column block for its row group's rows, in
  // passes; wait(rb, re) (warp 0) waits on the counters of the pass's input
  // rows, epi(first row, end row, k parts, column block, rows of the pass)
  // reads the pass's sums, then the block publishes each row tile of the
  // pass on pub
  auto dense_stage = [&](int si, int K, const float* w, auto src, auto wait, auto epi, unsigned* pub, int part) {
    const StageCut sc = a.g.st[si];
    const int grp = blk / sc.cols, cb = blk - grp * sc.cols;
    if (grp >= sc.groups) return;
    const float* wb = w + (size_t)cb * K * sc.width;
    const int rend = imin(B, (grp + 1) * sc.rows), Rp = 8 * sc.tiles;
    for (int rb = grp * sc.rows; rb < rend; rb += Rp) {
      const int re = imin(rend, rb + Rp);
      if (warp == 0) wait(rb, re);
      __syncthreads();  // warp 0's acquire, before every thread's copies of the rows
      lap(3);
      const int KS = grid_dense(wb, K, sc.width, sc.tiles, tile_s[si], rb, re, src, rg, rclk);
      lap(part);
      epi(rb, re, KS, cb, Rp);
      __syncthreads();  // the pass's stores are made, and its sums read before the next pass stages over them
      lap(18);
      if (tid == 0) tiles_publish(pub, rb / 8, (re + 7) / 8);
      lap(17);
    }
  };
  const StageCut last_cut = a.g.st[NC > 1 ? ST_CELLS : ST_CELL0];
  unsigned* c_hout = c_h + (size_t)(NC - 1) * NT;

  int s = 0;
  for (; s < a.steps; ++s) {
    bool live = false;
    for (int r = tid; r < B; r += THREADS) live = live || !fin_s[r];
    if (!__syncthreads_or(live)) break;  // the same in every block
    const int cur = s & 1, nxt = cur ^ 1;
    const unsigned now = (unsigned)s + 1;  // the counters' rounds once this step is written
    // each live row's attention in 1 + floor((G - live rows) tl / sum of tl)
    // chunks (1 each past G live rows), in row order: chunk index idx is
    // taken by block idx % G; the same in every block
    if (*changed_s) {
      __syncthreads();
      if (tid == 0) {
        int nlive = 0;
        long long wsum = 0;
        for (int r = 0; r < B; ++r)
          if (!fin_s[r]) nlive += 1, wsum += tl_s[r];
        const long long spare = imax(0, G - nlive);
        int off = 0;
        for (int r = 0; r < B; ++r) {
          const int n = fin_s[r] ? 0 : 1 + (wsum > 0 ? (int)(spare * tl_s[r] / wsum) : 0);
          off_s[r] = off;
          nch_s[r] = n;
          off += n;
        }
        off_s[B] = off;
        *changed_s = 0;
        // prefetch (below) a step's keys, or its memory rows, only while
        // they fit L2 with room to spare beside the weights
        long long wbytes = 0;
        for (int st = 0; st < N_STAGES; ++st)
          wbytes += (long long)(st == ST_CELLS ? NC - 1 : 1) * K_of[st] * a.g.st[st].cols * a.g.st[st].width * 4;
        *pf_s = (wsum * A * 4 + wbytes <= L2_PREFETCH_BYTES) | (wsum * M * 4 + wbytes <= L2_PREFETCH_BYTES) << 1;
      }
      __syncthreads();
    }
    const int nchunks = off_s[B];
    // this block's chunks' keys into L2 while the dense stages run, and
    // (at its scores) each chunk's memory rows: the attention's reads then
    // hit L2
    if (tid == 0 && (*pf_s & 1))
      for (int idx = blk; idx < nchunks; idx += G) {
        const int r = chunk_row(off_s, B, idx), n = nch_s[r], tl = tl_s[r], cs = (tl + n - 1) / n;
        const int t0 = imin(tl, (idx - off_s[r]) * cs), t1 = imin(tl, t0 + cs);
        if (t1 > t0) l2_prefetch(a.keys + ((size_t)r * T + t0) * A, (unsigned)(t1 - t0) * A * 4);
      }

    // the cells: each block its column block's units (4 gates each) for its rows
    for (int l = 0; l < NC; ++l) {
      const int si = l == 0 ? ST_CELL0 : ST_CELLS;
      const StageCut sc = a.g.st[si];
      const int K = (l == 0 ? E + AL : U) + U, Us = sc.width / 4;
      float* hl = h + (size_t)l * 2 * Bp * U;
      const float* below = hl - 2 * Bp * U + (size_t)nxt * Bp * U;  // h of cell l - 1, this step
      const float* mine = hl + (size_t)cur * Bp * U;                // h of cell l, the last step
      const unsigned below_n = now * (unsigned)a.g.st[l == 1 ? ST_CELL0 : ST_CELLS].cols;
      auto src = [&](int r, int k, int& n) -> const float* {
        if (l > 0) return k < U ? (n = U - k, below + (size_t)r * U + k) : (n = K - k, mine + (size_t)r * U + k - U);
        if (k < E) return n = E - k, a.emb + (size_t)tok_s[r] * E + k;
        if (k < E + AL) return n = E + AL - k, attn + (size_t)r * AL + k - E;
        return n = K - k, mine + (size_t)r * U + k - E - AL;
      };
      auto wait = [&](int rb, int re) {
        if (l > 0) ready_wait(c_h + (size_t)(l - 1) * NT + rb / 8, (re + 7) / 8 - rb / 8, [&](int) { return below_n; });
      };
      auto epi = [&](int rb, int re, int KS, int cb, int Rp) {
        const float* bias = a.cells[2 * l + 1] + (size_t)cb * sc.width;
        for (int i = tid; i < (re - rb) * Us; i += THREADS) {
          const int rl = i / Us, j = i - rl * Us, r = rb + rl, unit = cb * Us + j;
          if (unit >= U) continue;
          const float gi = grid_gather(rg.slots, KS, Rp, sc.width, rl, j) + __ldg(bias + j);
          const float gf = grid_gather(rg.slots, KS, Rp, sc.width, rl, Us + j) + __ldg(bias + Us + j);
          const float gg = grid_gather(rg.slots, KS, Rp, sc.width, rl, 2 * Us + j) + __ldg(bias + 2 * Us + j);
          const float go = grid_gather(rg.slots, KS, Rp, sc.width, rl, 3 * Us + j) + __ldg(bias + 3 * Us + j);
          float* cp = cst + ((size_t)l * Bp + r) * U + unit;
          const float c_new = sigmoidf(gf + 1.0f) * *cp + sigmoidf(gi) * tanhf(gg);
          *cp = c_new;
          hl[((size_t)nxt * Bp + r) * U + unit] = sigmoidf(go) * tanhf(c_new);
        }
      };
      dense_stage(si, K, a.cells[2 * l], src, wait, epi, c_h + (size_t)l * NT, 1);
    }
    const float* hout = h + ((size_t)(NC - 1) * 2 + nxt) * Bp * U;  // [B][U]
    const unsigned hout_n = now * (unsigned)last_cut.cols;

    // the query
    {
      const StageCut sc = a.g.st[ST_QUERY];
      auto src = [&](int r, int k, int& n) -> const float* { return n = U - k, hout + (size_t)r * U + k; };
      auto wait = [&](int rb, int re) { ready_wait(c_hout + rb / 8, (re + 7) / 8 - rb / 8, [&](int) { return hout_n; }); };
      auto epi = [&](int rb, int re, int KS, int cb, int Rp) {
        for (int i = tid; i < (re - rb) * sc.width; i += THREADS) {
          const int rl = i / sc.width, j = i - rl * sc.width, col = cb * sc.width + j;
          if (col < A) qg[(size_t)(rb + rl) * A + col] = grid_gather(rg.slots, KS, Rp, sc.width, rl, j);
        }
      };
      dense_stage(ST_QUERY, U, a.wq, src, wait, epi, c_q, 4);
    }
    const unsigned q_n = now * (unsigned)a.g.st[ST_QUERY].cols;

    // attention pass 1: chunk c of row r, a contiguous run of its valid
    // positions, its keys and mask staged TP positions a tile through the
    // ring; a warp a position, its lanes over A: the scores into ws, the
    // chunk's maximum into cmax
    const int TP = imax(1, imin(THREADS, rg.slot / A));
    for (int idx = blk; idx < nchunks; idx += G) {
      const int r = chunk_row(off_s, B, idx), c = idx - off_s[r], n = nch_s[r];
      const int tl = tl_s[r], cs = (tl + n - 1) / n, t0 = imin(tl, c * cs), t1 = imin(tl, t0 + cs);
      const float* Kr = a.keys + (size_t)r * T * A;
      const float* mkr = a.mask + (size_t)r * T;
      float* scr = a.ws + (size_t)r * T;
      const int ntiles = (t1 - t0 + TP - 1) / TP;
      if (tid == 0 && (*pf_s & 2) && t1 > t0) l2_prefetch(a.mem + ((size_t)r * T + t0) * M, (unsigned)(t1 - t0) * M * 4);
      float mx = -CUDART_INF_F;
      float mk = 0.0f;  // the mask of this thread's position of the tile NSLOT - 1 ahead
      auto fill = [&](int j, float* slot, unsigned bar) {
        const int tb = t0 + j * TP, np = imin(TP, t1 - tb);
        if (tid == 0) {
          mbar_expect(bar, (unsigned)np * A * 4);
          bulk_load(slot, Kr + (size_t)tb * A, (unsigned)np * A * 4, bar);
        }
        const float x = tid < np ? __ldg(mkr + tb + tid) : 0.0f;
        if (j < NSLOT - 1) pw_s[j * THREADS + tid] = x;
        else mk = x;
      };
      auto use = [&](int j, const float* slot) {
        const int lane = tid & 31;
        const int tb = t0 + j * TP, np = imin(TP, t1 - tb);
        const float* mks = pw_s + (j % NSLOT) * THREADS;
        for (int p = warp; p < np; p += NWARPS) {
          float acc = 0.0f;
          for (int a4 = lane; a4 < A / 4; a4 += 32) {
            const float4 k = reinterpret_cast<const float4*>(slot + (size_t)p * A)[a4];
            const float4 q = reinterpret_cast<const float4*>(q_s)[a4];
            const float4 vv = reinterpret_cast<const float4*>(v_s)[a4];
            acc += tanhf(k.x + q.x) * vv.x;
            acc += tanhf(k.y + q.y) * vv.y;
            acc += tanhf(k.z + q.z) * vv.z;
            acc += tanhf(k.w + q.w) * vv.w;
          }
          const float sum = warp_sum(acc);
          if (lane == 0) {
            const float sc = sum + (1.0f - mks[p]) * NEG;
            scr[tb + p] = sc;
            mx = fmaxf(mx, sc);
          }
        }
        if (j + NSLOT - 1 < ntiles) pw_s[((j + NSLOT - 1) % NSLOT) * THREADS + tid] = mk;
      };
      ring_start(ntiles, rg, fill);  // the keys and the mask, before q is ready
      lap(16);
      if (warp == 0) ready_wait(c_q + r / 8, 1, [&](int) { return q_n; });
      lap(8);
      __syncthreads();  // q is published
      for (int i = tid; i < A / 4; i += THREADS)
        reinterpret_cast<float4*>(q_s)[i] = __ldcg(reinterpret_cast<const float4*>(qg + (size_t)r * A) + i);
      ring_rest(ntiles, rg, fill, use, rclk, 16);  // its first wait's barrier orders q_s before the uses
      mx = block_reduce<true>(mx, red_s);
      if (tid == 0) {
        cmax[idx] = mx;
        chunk_publish(c_p1 + r);  // after block_reduce's barriers: the scores are stored
      }
      lap(6);
    }

    // pass 2: once every chunk maximum of the row is published, the row's
    // maximum over them (exact in any order); each position's e = exp(s -
    // max) * mask, formed as its memory row comes through the ring; the
    // chunk's sum of e and its part of the context, the sum over its
    // positions of e times the memory row (an item a thread: part ts of the
    // tile's positions, those q with q % TS == ts, and 4 columns; the parts
    // added in order), unnormalised, into csum and pctx; each chunk's block
    // then merges a slice of the row's context (below).
    const int mq = M / 4, TS = imax(1, THREADS / mq), TM = imax(1, imin(THREADS, rg.slot / M));
    for (int idx = blk; idx < nchunks; idx += G) {
      const int r = chunk_row(off_s, B, idx), c = idx - off_s[r], n = nch_s[r];
      const int tl = tl_s[r], cs = (tl + n - 1) / n, t0 = imin(tl, c * cs), t1 = imin(tl, t0 + cs);
      const float* Mr = a.mem + (size_t)r * T * M;
      const float* mkr = a.mask + (size_t)r * T;
      const float* scr = a.ws + (size_t)r * T;
      const unsigned row_n = (unsigned)(base_s[r] + n);
      const int ntiles = (t1 - t0 + TM - 1) / TM;
      const int ts = tid / imin(mq, THREADS), m4 = tid - ts * imin(mq, THREADS);
      const bool active = ts < TS;
      float mx = -CUDART_INF_F, esum = 0.0f;
      // the score and mask of this thread's position of each tile in
      // flight, loaded with its copy and turned into e (once the row's
      // maximum is known, then as each tile is used)
      float xr = 0.0f, mr = 0.0f, x0 = 0.0f, m0 = 0.0f;
      auto weight = [&](int j, float x, float mk) {  // e of this thread's position of tile j, into its slot's weights
        const float e = tid < imin(TM, t1 - t0 - j * TM) ? expf(x - mx) * mk : 0.0f;
        esum += e;
        pw_s[(j % NSLOT) * THREADS + tid] = e;
      };
      auto fill = [&](int j, float* slot, unsigned bar) {
        const int tb = t0 + j * TM, np = imin(TM, t1 - tb);
        if (tid == 0) {
          mbar_expect(bar, (unsigned)np * M * 4);
          bulk_load(slot, Mr + (size_t)tb * M, (unsigned)np * M * 4, bar);
        }
        if (j == 1) x0 = xr, m0 = mr;  // ring_start's first tile, held while its second loads
        xr = tid < np ? __ldcg(scr + tb + tid) : 0.0f;
        mr = tid < np ? __ldg(mkr + tb + tid) : 0.0f;
      };
      __syncthreads();  // pw_s and the ring of the last chunk have been read
      ring_start(ntiles, rg, fill);  // the memory rows, before the maxima are ready
      if (ntiles == 1) x0 = xr, m0 = mr;
      lap(16);
      if (warp == 0) ready_wait(c_p1 + r, 1, [&](int) { return row_n; });
      lap(8);
      __syncthreads();  // the maxima are published
      float* mxs = pw_s + (NSLOT - 1) * THREADS;  // the last slot's weights, not yet written: n <= G maxima
      for (int cc = tid; cc < n; cc += THREADS) mxs[cc] = __ldcg(cmax + off_s[r] + cc);
      __syncthreads();
      for (int cc = 0; cc < n; ++cc) mx = fmaxf(mx, mxs[cc]);
      if (ntiles > 0) weight(0, x0, m0);
      if (ntiles > 1) weight(1, xr, mr);
      float4 acc[2] = {make_float4(0.0f, 0.0f, 0.0f, 0.0f), make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
      auto use = [&](int j, const float* slot) {
        const int np = imin(TM, t1 - t0 - j * TM);
        const float* pw = pw_s + (j % NSLOT) * THREADS;
        if (active)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int col = m4 + h2 * THREADS;  // past THREADS float4 columns a thread takes two
            if (col >= mq) break;
            float4 s4 = acc[h2];
            for (int q = ts; q < np; q += TS) {
              const float pv = pw[q];
              const float4 mv = reinterpret_cast<const float4*>(slot + (size_t)q * M)[col];
              s4.x = fmaf(pv, mv.x, s4.x);
              s4.y = fmaf(pv, mv.y, s4.y);
              s4.z = fmaf(pv, mv.z, s4.z);
              s4.w = fmaf(pv, mv.w, s4.w);
            }
            acc[h2] = s4;
          }
        if (j + NSLOT - 1 < ntiles) weight(j + NSLOT - 1, xr, mr);
      };
      ring_rest(ntiles, rg, fill, use, rclk, 16);  // its first wait's barrier orders the weights before the uses
      float* part = rg.slots;  // [TS][M], every tile read
      if (active)
        for (int h2 = 0; h2 < 2 && m4 + h2 * THREADS < mq; ++h2)
          reinterpret_cast<float4*>(part + (size_t)ts * M)[m4 + h2 * THREADS] = acc[h2];
      esum = block_reduce<false>(esum, red_s);  // its barriers also order the parts' stores before their reads
      for (int m = tid; m < M; m += THREADS) {
        float cv = part[m];
        for (int p = 1; p < TS; ++p) cv += part[(size_t)p * M + m];
        pctx[(size_t)idx * M + m] = cv;
      }
      if (tid == 0) csum[idx] = esum;
      __syncthreads();  // part is read before the ring is filled again; the chunk's stores are made
      if (tid == 0) chunk_publish(c_p2 + r);
      lap(7);
    }
    // the merge, once every chunk of a row is stored: each chunk's block its
    // slice of the row's context columns, each element the chunks' parts
    // over the row's sum (its chunks' sums in chunk order), added in chunk
    // order. After every part of this block's chunks: a block that waited
    // here between its chunks could wait on one of its own later chunks
    // through another block doing the same.
    for (int idx = blk; idx < nchunks; idx += G) {
      const int r = chunk_row(off_s, B, idx), c = idx - off_s[r], n = nch_s[r], o = off_s[r];
      const unsigned row_n = (unsigned)(base_s[r] + n);
      const int per = (mq + n - 1) / n, q0 = imin(mq, c * per), q1 = imin(mq, q0 + per);  // this chunk's float4s
      if (warp == 0) ready_wait(c_p2 + r, 1, [&](int) { return row_n; });
      lap(8);
      __syncthreads();  // every part of the row is published; the ring and pw_s are free
      // the slice's parts ([n][w] float4s) and the chunks' sums staged by
      // every thread at once, then added in chunk order from shared memory
      const int w = q1 - q0;
      float4* stg = reinterpret_cast<float4*>(rg.slots);  // n w <= mq + n float4s
      for (int i = tid; i < n * w; i += THREADS) {
        const int cc = i / w;
        stg[i] = __ldcg(reinterpret_cast<const float4*>(pctx + (size_t)(o + cc) * M) + q0 + i - cc * w);
      }
      for (int cc = tid; cc < n; cc += THREADS) pw_s[cc] = __ldcg(csum + o + cc);
      __syncthreads();
      float sum = 0.0f;
      for (int cc = 0; cc < n; ++cc) sum += pw_s[cc];
      sum = fmaxf(sum, 1e-30f);
      for (int q = tid; q < w; q += THREADS) {
        float4 cv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int cc = 0; cc < n; ++cc) {
          const float4 x = stg[cc * w + q];
          cv.x += x.x / sum, cv.y += x.y / sum, cv.z += x.z / sum, cv.w += x.w / sum;
        }
        reinterpret_cast<float4*>(ctx + (size_t)r * M)[q0 + q] = cv;
      }
      __syncthreads();  // the slice is stored, the staging read
      if (tid == 0) chunk_publish(c_ctx + r);
      lap(9);
    }
    // the attention vector, from [h; context]
    {
      const StageCut sc = a.g.st[ST_LAYER];
      auto src = [&](int r, int k, int& n) -> const float* {
        return k < U ? (n = U - k, hout + (size_t)r * U + k) : (n = U + M - k, ctx + (size_t)r * M + k - U);
      };
      auto wait = [&](int rb, int re) {
        ready_wait(c_hout + rb / 8, (re + 7) / 8 - rb / 8, [&](int) { return hout_n; });
        ready_wait(c_ctx + rb, re - rb, [&](int i) { return fin_s[rb + i] ? 0u : (unsigned)(base_s[rb + i] + nch_s[rb + i]); });
      };
      auto epi = [&](int rb, int re, int KS, int cb, int Rp) {
        for (int i = tid; i < (re - rb) * sc.width; i += THREADS) {
          const int rl = i / sc.width, j = i - rl * sc.width, col = cb * sc.width + j;
          if (col < AL) attn[(size_t)(rb + rl) * AL + col] = grid_gather(rg.slots, KS, Rp, sc.width, rl, j);
        }
      };
      dense_stage(ST_LAYER, U + M, a.attn_w, src, wait, epi, c_attn, 11);
    }

    // the logits of each column block, and its (maximum, first index) of each row
    float* pmx = pmax + (size_t)cur * pad4(Bp * lcols);
    int* pix = pidx + (size_t)cur * pad4(Bp * lcols);
    {
      const StageCut sc = a.g.st[ST_LOGITS];
      const unsigned attn_n = now * (unsigned)a.g.st[ST_LAYER].cols;
      const unsigned done_n = (unsigned)(s / 2) * (unsigned)G;  // the arrivals after steps s - 2, s - 4, ...
      auto src = [&](int r, int k, int& n) -> const float* { return n = AL - k, attn + (size_t)r * AL + k; };
      auto wait = [&](int rb, int re) {
        ready_wait(done + cur, 1, [&](int) { return done_n; });  // the pairs of step s - 2 are read
        ready_wait(c_attn + rb / 8, (re + 7) / 8 - rb / 8, [&](int) { return attn_n; });
      };
      auto epi = [&](int rb, int re, int KS, int cb, int Rp) {  // a warp a row, its lanes over the columns
        const int lane = tid & 31;
        for (int rl = warp; rl < re - rb; rl += NWARPS) {
          float best = -CUDART_INF_F;
          int bi = V;
          for (int j = lane; j < sc.width && cb * sc.width + j < V; j += 32) {
            const float x = grid_gather(rg.slots, KS, Rp, sc.width, rl, j) + __ldg(a.out_b + cb * sc.width + j);
            if (x > best || bi == V) best = x, bi = cb * sc.width + j;
          }
          pair_max(best, bi, V);
          if (lane == 0) {
            pmx[(size_t)(rb + rl) * lcols + cb] = best;
            pix[(size_t)(rb + rl) * lcols + cb] = bi;
          }
        }
      };
      dense_stage(ST_LOGITS, AL, a.out_w, src, wait, epi, c_lg, 12);
    }
    // every block reduces the pairs of every row in column block order, the
    // smallest index winning a tie: all hold the same tokens and flags
    const unsigned lg_n = now * (unsigned)lcols;
    if (warp == 0) ready_wait(c_lg, NT, [&](int) { return lg_n; });
    lap(13);
    __syncthreads();
    for (int r = tid; r < B; r += THREADS) {
      float best = -CUDART_INF_F;
      int bi = V;
      for (int p = 0; p < lcols; ++p) {
        const float ob = __ldcg(pmx + (size_t)r * lcols + p);
        const int oi = __ldcg(pix + (size_t)r * lcols + p);
        if (oi < V && (bi == V || ob > best || (ob == best && oi < bi))) best = ob, bi = oi;
      }
      const int token = fin_s[r] ? a.eos : bi;
      base_s[r] += nch_s[r];
      tok_s[r] = token;
      if (!fin_s[r] && token == a.eos) fin_s[r] = 1, *changed_s = 1;
      if (blk == 0) tokens[(size_t)r * a.steps + s] = token;
    }
    __syncthreads();
    if (tid == 0) chunk_publish(done + cur);
    lap(14);
    if (timed) clocks[15] += 1;
  }
  // <eos> for the steps the launch did not run
  if (blk == 0)
    for (int r = 0; r < B; ++r)
      for (int i = s + tid; i < a.steps; i += THREADS) tokens[(size_t)r * a.steps + i] = a.eos;
}

// the grid layout's cut: every stage's blocks within the grid, its column
// blocks covering its columns (a cell's units), its row groups the batch,
// an item a thread, each pass's tiles and sums within the ring, the
// scores' and the context's tiles within a slot
bool bad_grid(const DecArgs& a) {
  const GridCut& g = a.g;
  if (a.C < 1 || a.act == nullptr || a.ws == nullptr) return true;
  if (a.M > 8 * THREADS) return true;  // the context: two float4 columns a thread at most
  if (g.slot < a.A || g.slot < a.M || g.slot % 4 || (long long)NSLOT * g.slot < 4LL * THREADS) return true;
  const int outs[N_STAGES] = {a.U, a.U, a.A, a.AL, a.V};  // units (the cells) or columns
  const int ks[N_STAGES] = {a.E + a.AL + a.U, 2 * a.U, a.U, a.U + a.M, a.AL};
  for (int i = 0; i < N_STAGES; ++i) {
    const StageCut& c = g.st[i];
    if (c.cols < 1 || c.groups < 1 || (long long)c.cols * c.groups > a.C) return true;
    if (c.width < 4 || c.width % 4 || c.width / 4 > THREADS) return true;
    if (c.rows < DR || c.rows % DR || (long long)c.rows * c.groups < a.B) return true;
    if (c.tiles < 1 || c.tiles > MAX_TILES || c.tiles * (c.width / 4) > THREADS) return true;
    if ((long long)c.cols * (i < ST_QUERY ? c.width / 4 : c.width) < outs[i]) return true;
    const DenseTile d = grid_tile(ks[i] / 4, c.width, c.tiles, g.slot);
    const long long kt = 4LL * d.KS * d.S4, rp = 8LL * c.tiles;
    if (rp * d.ld + kt * c.width > g.slot) return true;
    if ((long long)d.KS * rp * c.width > (long long)NSLOT * g.slot) return true;
  }
  return grid_layout(a.B, a.A, g).total * sizeof(float) > SMEM_MAX;
}

bool bad_shape(const DecArgs& a, int layout) {
  const int C = a.C;
  if (a.B <= 0 || a.T <= 0 || a.n_cells <= 0 || a.steps < 0 || a.V <= 0) return true;
  // 16-byte loads of every input row and weight slice
  if (a.E % 4 || a.AL % 8 || a.U % 4 || a.A % 4 || a.M % 4) return true;
  if (layout == LAYOUT_GRID) return bad_grid(a);
  if (layout != LAYOUT_HELD || C < 1 || C > 8) return true;
  if (a.U % C || a.A % (4 * C) || a.AL % (4 * C)) return true;
  const DecLayout L = dec_layout(a.T, a.A, a.M, a.V, a.E, a.AL, a.U, a.n_cells, C);
  return L.total * sizeof(float) > SMEM_MAX;
}

// The held layout: clusters of C blocks, a cluster a group of 8 rows.
int launch_held(const DecArgs& a, int* tokens, int* info, long long* clocks, cudaStream_t stream) {
  const DecLayout L = dec_layout(a.T, a.A, a.M, a.V, a.E, a.AL, a.U, a.n_cells, a.C);
  const size_t smem = L.total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(a.C * ((a.B + DR - 1) / DR));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cfg.stream = stream;
  if (info) {
    e = cudaOccupancyMaxActiveClusters(&info[0], greedy_kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, greedy_kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    info[1] = (int)smem;
    info[2] = fa.numRegs;
    info[3] = (int)fa.sharedSizeBytes;
  }
  e = cudaLaunchKernelEx(&cfg, greedy_kernel, a, tokens, clocks);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The grid layout: a cooperative launch of `cluster` blocks, refused
// (cudaErrorCooperativeLaunchTooLarge) unless the card holds them all at once.
int launch_grid(const DecArgs& a, int* tokens, int* info, long long* clocks, cudaStream_t stream) {
  const size_t smem = grid_layout(a.B, a.A, a.g).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(greedy_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, greedy_grid_kernel, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (info) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, greedy_grid_kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    info[0] = per_sm * sms;
    info[1] = (int)smem;
    info[2] = fa.numRegs;
    info[3] = (int)fa.sharedSizeBytes;
  }
  if ((long long)per_sm * sms < a.C) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.gridDim = dim3(a.C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, greedy_grid_kernel, a, tokens, clocks);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// The whole greedy decode -> tokens [B, steps]. `layout` picks the held (0)
// or the grid (1) layout. The held layout: wq, attn_w and the cells' weights
// are regrouped into `cluster` column slices (see DecArgs); `act`, `ws` and
// `cut` are null. The grid layout: `cluster` is the grid's blocks, `cut` its
// GridCut as CUT_INTS ints (each stage's cols, width, groups, rows, tiles;
// then the ring's slot), wq,
// attn_w, each cell's weights and bias, out_w and out_b regrouped into each
// stage's column blocks ([cols][K][width], the bias and out_b
// [cols][width]), `act` the workspace (grid_ws, zeroed by the caller), `ws`
// [B padded to 8][T].
// info, if not null, receives what the card gives this launch: info[0] =
// clusters it can run at once (cudaOccupancyMaxActiveClusters; grid: the
// blocks it holds at once), info[1] = dynamic shared memory bytes a block
// (dec_layout's or grid_layout's, all the shared memory the kernel uses),
// info[2] = registers a thread, info[3] = static shared memory bytes (0);
// clocks is null or 16 cycle counters (the grid layout's: 19) the kernel
// adds to (see the kernels).
// A shape whose layout passes SMEM_MAX, or a cut that does not cover the
// shape, returns cudaErrorInvalidValue; the wrapper's decoder_plan refuses
// it first.
extern "C" int plt_greedy_decode(const float* keys, const float* mem, const float* mask,
                                 int B, int T, int A, int M, const float* emb, int V,
                                 int E, const float* wq, const float* v,
                                 const float* attn_w, int AL, const float* out_w,
                                 const float* out_b, const void* cell_ptrs, int n_cells,
                                 int U, int bos, int eos, int steps, int cluster, int layout,
                                 float* act, float* ws, const int* cut, int* tokens, int* info,
                                 long long* clocks, void* stream) {
  DecArgs a{keys, mem, mask, emb, wq, v, attn_w, out_w, out_b,
            static_cast<const float* const*>(cell_ptrs), act, ws,
            B, T, A, M, V, E, AL, U, n_cells, bos, eos, steps, cluster, {}};
  if (layout == LAYOUT_GRID) {
    if (cut == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < N_STAGES; ++i) a.g.st[i] = StageCut{cut[5 * i], cut[5 * i + 1], cut[5 * i + 2], cut[5 * i + 3],
                                                            cut[5 * i + 4]};
    a.g.slot = cut[CUT_INTS - 1];
  }
  if (bad_shape(a, layout)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return layout == LAYOUT_GRID ? launch_grid(a, tokens, info, clocks, s) : launch_held(a, tokens, info, clocks, s);
}
