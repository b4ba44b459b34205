// Grouped pair executors, templated on the per-pair body (body.cuh), one
// instantiation per (workload, core): K1 (unpaired) and K2 (sibling-paired)
// fetch their source blocks by id; K8 and K9 compute the same sums from
// source blocks gathered contiguous per step, one CTA per segment of a run
// and an ordered reduction of the split runs; K12 is K8's segment kernel
// and reduction at one step per segment; K10 and K11 fetch by id with
// bulk asynchronous copies, K11 two adjacent blocks per copy. K1/K2,
// K8/K9 and K12 run one CTA tile (exec_tile: its pair loop, its ring of
// staged blocks, its order of sums) and differ only in how the tile finds
// its blocks (IdCursor, GatheredCursor).
//
// Offsets into the (NN, rows, B) arrays are 64-bit: at N = 1e8 NN*C*B
// reaches 2^31, and row*od8*B doubles again for vortgrad3d (od8 = 16).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "body.cuh"

namespace onbody {

// ---------------------------------------------------------------------
// The CTA tile of K1/K2, K8/K9 and K12.
//
// The pair loop (body.cuh block_aos): each thread owns kTgts = 2 target
// points (K1/K8: points i and i + ceil(B/2) of the row; K2/K9: point i of
// rows 2q and 2q+1), which keeps a target's sum and its block partial in
// registers without spills (4 per thread measured slower, PERF.md). Every
// block is staged source by source, its kRows values padded to whole float4s,
// so one or two 16-byte broadcast loads bring a source, and it serves both
// targets: the 3D bodies' loops issue 1 shared load per pair and vort2d's
// 0.5, against 3-5 and 2.75 in a loop over one target's rows (chip_smoke.py's
// SASS report; PERF.md). The staging is asynchronous: every thread copies
// single floats with cp.async (coalesced global reads, the transpose done by
// the copy, no alignment needed) into a ring of kPreStages blocks, so the
// next blocks arrive while the current one is summed; a body whose staged
// rows differ rewrites them in place after the copy lands (Body::staged),
// behind a barrier. Three stages and cp.async measured best against two or
// four stages and against bulk copies into a raw ring transposed after they
// land (PERF.md). Tensor cores are not used: the pair terms are elementwise
// fp32 with an rsqrt (or an exp) per pair, no contraction TF32 or bf16 could
// take at the port's 1e-5 parity. No warp-level code either, so the host
// emulation (tests/test_torch_csrc_host.py) still checks these kernels.
//
// Each target sums a block into its own partial in source order, adds the
// partials onto its register accumulator in block order and the
// accumulator onto its output row once (block_aos's order of sums), so
// K1, K8 and K12 (and K2 and K9) give the same bits on the same blocks,
// and K1 gives K10's and K11's, which keep that order on the rows their
// bulk copies land (block_rows).

constexpr int kExecMaxThreads = 256;
constexpr int kPreStages = 3;  // blocks in flight per CTA

// Targets per thread (kTgts), rows per tile (kRowsT) and target points of
// a row per thread (kPts).
template <class Body, bool kPaired>
struct PreTile {
  static constexpr int kTgts = 2;
  static constexpr int kRowsT = kPaired ? 2 : 1;
  static constexpr int kPts = kTgts / kRowsT;
};

// Threads per CTA, CTAs per tile (the grid's y: a row needs
// ceil(B / kPts) threads, more than one CTA's above B = 512 in K1/K8 and
// B = 256 in K2/K9) and dynamic shared memory (the ring) of a tile launch.
template <class Body, bool kPaired>
void tile_config(int B, int* threads, int* grid_y, size_t* smem) {
  const int nthr = (B + PreTile<Body, kPaired>::kPts - 1) /
                   PreTile<Body, kPaired>::kPts;
  *threads = nthr < kExecMaxThreads ? nthr : kExecMaxThreads;
  *grid_y = (nthr + *threads - 1) / *threads;
  *smem = sizeof(float) * kPreStages * B * aos_floats<Body>();
}

// Starts the asynchronous copy of one source block (C rows of B floats
// at blk, rows 0..kRows-1 used) into its staged layout at st: source q's
// row r at st[q * aos_floats + r]. Every thread copies its share.
template <class Body>
__device__ __forceinline__ void stage_block_async(
    const float* __restrict__ blk, int B, float* st) {
  constexpr int kAos = aos_floats<Body>();
#pragma unroll
  for (int r = 0; r < Body::kRows; ++r) {
    for (int q = threadIdx.x; q < B; q += blockDim.x) {
      copy4_async(st + q * kAos + r, blk + r * B + q);
    }
  }
}

// The walks over the blocks a tile sums, in slot order: settle() moves
// onto the first block at or after the current slot, valid() says whether
// one is left, next() moves past it, block() is its address. Every value
// is uniform across the CTA.
//
// K8/K9 and K12: slots [0, n_slots[p]) (all G when n_slots is null) of the
// steps [p, p_end) of a gathered buffer, step p's slot j at src + steps[p] *
// step_floats + j * block_floats. A skipped slot holds the inert row.
struct GatheredCursor {
  int p, j, p_end, G;
  const int* n_slots;
  const int* steps;
  const float* src;
  int64_t step_floats, block_floats;
  __device__ int slots(int q) const { return n_slots ? n_slots[q] : G; }
  __device__ void settle() {
    while (p < p_end && j >= slots(p)) {
      ++p;
      j = 0;
    }
  }
  __device__ bool valid() const { return p < p_end; }
  __device__ void next() {
    ++j;
    settle();
  }
  __device__ const float* block() const {
    return src + steps[p] * step_floats + j * block_floats;
  }
};

// K1/K2: the slots [q, q_end) of a run in the (steps, G) id table (a run's
// steps are contiguous in it), slot q's block at src + ids[q] *
// block_floats; id 0, the inert row, is skipped.
struct IdCursor {
  int64_t q, q_end;
  const int* ids;
  const float* src;
  int64_t block_floats;
  int id;
  __device__ void settle() {
    for (; q < q_end; ++q) {
      id = ids[q];
      if (id != 0) return;
    }
  }
  __device__ bool valid() const { return q < q_end; }
  __device__ void next() {
    ++q;
    settle();
  }
  __device__ const float* block() const {
    return src + (int64_t)id * block_floats;
  }
};

// One CTA's share of a tile: thread i of the row's nthr = ceil(B / kPts)
// owns points i + k * nthr (k < kPts) of each of the kRowsT rows from
// row0. Every block rd walks is copied into the ring (`ring`, kPreStages
// staged blocks) and summed by block_aos; then the sums are added onto
// the output rows or, with `part`, written as partial rows, part[r][o][pt]
// (kRowsT x kOut x B).
template <class Body, bool kPaired, class Cursor>
__device__ __forceinline__ void exec_tile(const float* __restrict__ tgt_geo,
                                          float* __restrict__ out,
                                          float* __restrict__ part,
                                          int64_t row0, Cursor rd, int B,
                                          int od8, float* ring) {
  using T = PreTile<Body, kPaired>;
  constexpr int kAos = aos_floats<Body>();
  const int nthr = (B + T::kPts - 1) / T::kPts;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  typename Body::Tgt t[T::kTgts];
  float acc[T::kTgts][Body::kOut];
#pragma unroll
  for (int n = 0; n < T::kTgts; ++n) {
    const int pt = i + (n % T::kPts) * nthr;
    t[n] = typename Body::Tgt{};
    if (i < nthr && pt < B) {
      t[n] = Body::load_tgt(
          tgt_geo + (row0 + n / T::kPts) * 8 * B + pt, B);
    }
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) acc[n][o] = 0.f;
  }
  rd.settle();
  Cursor wr = rd;
  // the staged block st: restage rows whose staged value differs, sum it
  auto consume = [&](float* st) {
    if (!Body::kRawStage) {
      for (int q = threadIdx.x; q < B; q += blockDim.x) {
#pragma unroll
        for (int r = 0; r < Body::kRows; ++r) {
          st[q * kAos + r] = Body::staged(r, st[q * kAos + r]);
        }
      }
      __syncthreads();
    }
    if (i < nthr) block_aos<Body, T::kTgts>(st, B, t, acc);
    __syncthreads();  // the block is read
  };
  auto issue = [&](int f) {  // block f into stage f % kPreStages
    if (wr.valid()) {
      stage_block_async<Body>(wr.block(), B,
                              ring + (f % kPreStages) * B * kAos);
      wr.next();
    }
    copy_commit();  // one group per block, empty past the end
  };
  for (int f = 0; f < kPreStages - 1; ++f) issue(f);
  for (int f = 0; rd.valid(); ++f) {  // uniform across the CTA
    issue(f + kPreStages - 1);  // its stage was read in iteration f - 1
    copy_wait<kPreStages - 1>();  // block f has landed
    __syncthreads();
    consume(ring + (f % kPreStages) * B * kAos);
    rd.next();
  }
  if (i >= nthr) return;
#pragma unroll
  for (int n = 0; n < T::kTgts; ++n) {
    const int pt = i + (n % T::kPts) * nthr;
    if (pt >= B) continue;
    const int r = n / T::kPts;
    if (part == nullptr) {
      float* o0 = out + (row0 + r) * od8 * B + pt;
#pragma unroll
      for (int o = 0; o < Body::kOut; ++o) o0[o * B] += acc[n][o];
    } else {
      float* p0 = part + (int64_t)r * Body::kOut * B + pt;
#pragma unroll
      for (int o = 0; o < Body::kOut; ++o) p0[o * B] = acc[n][o];
    }
  }
}

// ---------------------------------------------------------------------
// K1 (unpaired) and K2 (sibling-paired): the executors that fetch source
// blocks by id, which pair_fetch "dma_i" (the DTT main path) runs, K2
// also for "dma" and "dma_p". Replace onbody_tpu/ops/pallas_pairs.py:
// _exec_chunk with _body_interleaved (K1) and :_exec_chunk_t2 with
// _body_interleaved_t2 (K2).
//
// The TPU kernels walk the step list sequentially on one core, keep the
// current target row resident in VMEM across a run of steps and hide the
// scalar-issued source DMAs behind the MXU work. Hopper runs blocks in
// parallel and in no order, so the sequential grid becomes one CTA per
// RUN of equal target keys (the wrapper's run table): the CTA owns its
// output row(s) outright, keeps the sums in registers and adds them onto
// the rows once, with no atomics and a result fixed by the list alone. The
// CTA is exec_tile over the run's slots in order, each block fetched by
// its id (pair_s[p * G + j], the block at src_fm + id * C * B) into the
// cp.async ring. Id 0 is the inert pad row and contributes exactly zero,
// so the walk skips it; pad steps never form a run and are never visited
// (in K2 this is what keeps rows 0 and 1, the root accumulator, untouched,
// for every body). The copies are 4 bytes, so any B and any src_fm offset
// work.
//
// What bounds it: a block of B sources staged once serves B targets (2B
// in K2), so device-memory traffic is ~kRows * 4 / B bytes per pair and
// the kernel is bound by the SM's FP32/MUFU rates over the operations each
// pair needs (counted in the body's header; PERF.md gives the bound).
// Against that the tile issues 1 shared load per pair (vort2d 0.5), keeps
// two blocks in flight while it sums a third, and takes each id from a
// load uniform across the CTA. Runs are not split over CTAs: the DTT's
// runs of 1-4 steps give thousands of CTAs, several waves of the card
// (chip_smoke.py prints the waves of its lists).
//
// The run count: the eager wrappers trim the list on the host and launch
// n_runs CTAs (n_runs_dev null). The fused solve (traverse/dtt.py
// solve_dtt_fused) keeps the list at its static capacity and makes the
// run table on the card, so the count lives in device memory: the grid is
// the capacity, and a CTA at or past *n_runs_dev exits before it touches
// shared memory (K10/K11 the same). A CTA's run, its order of sums and
// its output are those of the trimmed launch, bit for bit.

template <class Body, bool kPaired>
__global__ void exec_runs(const float* __restrict__ tgt_geo,
                          const float* __restrict__ src_fm,
                          float* __restrict__ out,
                          const int* __restrict__ run_tgt,
                          const int* __restrict__ run_off,
                          const int* __restrict__ pair_s,
                          const int* __restrict__ n_runs_dev, int B, int C,
                          int G, int od8) {
  extern __shared__ __align__(16) float ring[];  // kPreStages staged blocks
  const int run = blockIdx.x;
  if (n_runs_dev != nullptr && run >= *n_runs_dev) return;  // past the list
  // K2 keys are parent ids q: the run covers rows 2q and 2q+1
  const int64_t row0 =
      kPaired ? 2 * (int64_t)run_tgt[run] : (int64_t)run_tgt[run];
  const IdCursor rd{(int64_t)run_off[run] * G, (int64_t)run_off[run + 1] * G,
                    pair_s, src_fm, (int64_t)C * B, 0};
  exec_tile<Body, kPaired>(tgt_geo, out, nullptr, row0, rd, B, od8, ring);
}

template <class Body, bool kPaired>
int launch_exec(const float* tgt_geo, const float* src_fm, float* out,
                const int* run_tgt, const int* run_off, const int* pair_s,
                const int* n_runs_dev, int n_runs, int B, int C, int G,
                int od8, void* stream) {
  if (n_runs <= 0) return (int)cudaSuccess;
  int threads, grid_y;
  size_t smem;
  tile_config<Body, kPaired>(B, &threads, &grid_y, &smem);
  const dim3 grid(n_runs, grid_y);
  // always: an occupancy query at another B may have set a smaller limit
  const cudaError_t err = cudaFuncSetAttribute(
      exec_runs<Body, kPaired>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  exec_runs<Body, kPaired><<<grid, threads, smem, (cudaStream_t)stream>>>(
      tgt_geo, src_fm, out, run_tgt, run_off, pair_s, n_runs_dev, B, C, G,
      od8);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// K8 (unpaired) and K9 (sibling-paired): the executors on PRE-GATHERED
// sources, a segment kernel (exec_pre_segs) and an ordered reduction
// (reduce_segs). Replace onbody_tpu/ops/pallas_pairs.py:_exec_chunk_pre
// with _body_pre (K8) and :_exec_chunk_pre_t2 with _body_pre_t2 (K9).
//
// A torch row gather (ops/cuda_pairs.py:_pregather) has laid step p's G
// source blocks side by side at src_gathered + p*G*C*B, C rows of B
// floats each. The TPU kernels walk that buffer in one sequential grid,
// carrying a target row's sum in VMEM from step to step. Here the
// wrapper cuts every run of equal target keys into SEGMENTS of at most
// S consecutive steps (ops/cuda_pairs.py:_plan_segments; S is chosen so
// that a chunk fills about two waves of CTAs, so a treecode leaf's run of
// 27-77 steps no longer leaves the card to a few hundred CTAs). One CTA
// per segment (exec_tile) sums its steps' blocks in slot order into
// registers. A run of one segment adds its sums onto its output row(s),
// as K1/K2 do; a segment of a split run writes them as a partial row
// (kOut x B; two in K9) into `partials`, a scratch the wrapper allocates
// per chunk (one row, or two, per segment: bounded by the chunk, not by
// N). The reduction then adds each split run's partials onto its output
// row(s) in segment order. No atomics: the result depends on the list and
// S only, never on the schedule, and a run cut by a chunk boundary
// continues from the accumulator in the next launch. On runs of one
// segment K8 gives K1's sums and K9 K2's, bit for bit (the same tile).
//
// The kernels have no source ids, so they cannot see the inert pad row:
// n_slots[p] (or G when the pointer is null) says how many leading slots
// of step p to evaluate; the wrapper sets it to the last real slot, and a
// skipped slot holds the inert row, whose contribution is exactly zero.
// Pad steps are never part of a run, which is what keeps K9's rows 0 and
// 1 (the root accumulator) untouched. Bodies read rows 0..kRows-1 of a
// block of C rows, so the lean layout (C = kRows) and the layout padded
// to 8 rows both work.
//
// What bounds it: per step G*B*B pairs (twice that in K9) against
// G*C*B*4 gathered bytes read once, plus the gather pass outside that
// wrote them, and the partial rows written and read back once; the
// operations are the larger (PERF.md states both per instantiation).
// Offsets are 64-bit as above: a chunk stays under 2^31 floats, the
// row*od8*B output offsets at 1e8 do not.
//
// The segment and split-run counts: the eager wrappers plan a chunk on
// the host and launch n_seg segment CTAs and n_split reduction rows
// (n_seg_dev, n_split_dev null). The fused solve plans each chunk on the
// card (ops/cuda_pairs.py capped_segments), so both counts live in device
// memory: the segment grid is the chunk's capacity, a CTA at or past the
// count exiting (exec_pre_segs_capped), and the reduction's rows, fewer
// than a chunk's split runs can be, walk the split runs below the count
// (reduce_segs_capped). Every segment and every split run is summed as in
// the eager launches, bit for bit.
//
// K12 (pair_fetch "static"): K8 at one step per segment. Replaces
// onbody_tpu/ops/pallas_pairs.py:_exec_chunk_static with _body_static.
// The TPU kernel gathers a chunk's targets and sources so that every index
// map is the grid index, writes one output row per step, and its caller
// segment-adds the rows into the accumulator. Here step p's blocks sit at
// src_gathered + steps[p]*G*C*B, so no id is loaded before a copy, and one
// CTA per step spreads a long run over the whole card: exec_pre_segs on a
// plan of one step per segment (ops/cuda_pairs.py:_seg_plan). A step whose
// run has one step adds its sums onto its row, of which it is the only
// CTA; a step of a longer run writes a kOut x B partial row, and
// reduce_segs adds a run's partials onto its row in step order over the
// list of split runs. No atomics: K12 gives K8's bits at S = 1, fixed by
// the list alone. Its bound is K8's: the pairs' operations, the bytes
// adding each split run's partial rows, written once and read back once.

template <class Body, bool kPaired>
__global__ void exec_pre_segs(const float* __restrict__ tgt_geo,
                              const float* __restrict__ src_gathered,
                              float* __restrict__ out,
                              float* __restrict__ partials,
                              const int* __restrict__ run_tgt,
                              const int* __restrict__ run_seg,
                              const int* __restrict__ seg_run,
                              const int* __restrict__ seg_off,
                              const int* __restrict__ steps,
                              const int* __restrict__ n_slots, int B, int C,
                              int G, int od8) {
  using T = PreTile<Body, kPaired>;
  extern __shared__ __align__(16) float ring[];  // kPreStages staged blocks
  const int seg = blockIdx.x;
  const int run = seg_run[seg];
  const bool whole = run_seg[run + 1] - run_seg[run] == 1;
  const int64_t row0 =
      kPaired ? 2 * (int64_t)run_tgt[run] : (int64_t)run_tgt[run];
  const GatheredCursor rd{seg_off[seg], 0, seg_off[seg + 1], G, n_slots,
                          steps, src_gathered, (int64_t)G * C * B,
                          (int64_t)C * B};
  exec_tile<Body, kPaired>(
      tgt_geo, out,
      whole ? nullptr
            : partials + (int64_t)seg * T::kRowsT * Body::kOut * B,
      row0, rd, B, od8, ring);
}

// The fused solve's launch of exec_pre_segs: the grid is the chunk's
// capacity and the plan's segment count is read from *n_seg_dev; a CTA at
// or past it exits before it touches memory, every other one is
// exec_pre_segs' CTA. A kernel of its own, so the eager launch's code is
// unchanged.
template <class Body, bool kPaired>
__global__ void exec_pre_segs_capped(const float* __restrict__ tgt_geo,
                                     const float* __restrict__ src_gathered,
                                     float* __restrict__ out,
                                     float* __restrict__ partials,
                                     const int* __restrict__ run_tgt,
                                     const int* __restrict__ run_seg,
                                     const int* __restrict__ seg_run,
                                     const int* __restrict__ seg_off,
                                     const int* __restrict__ steps,
                                     const int* __restrict__ n_slots,
                                     const int* __restrict__ n_seg_dev,
                                     int B, int C, int G, int od8) {
  using T = PreTile<Body, kPaired>;
  extern __shared__ __align__(16) float ring[];  // kPreStages staged blocks
  const int seg = blockIdx.x;
  if (seg >= *n_seg_dev) return;  // past the plan
  const int run = seg_run[seg];
  const bool whole = run_seg[run + 1] - run_seg[run] == 1;
  const int64_t row0 =
      kPaired ? 2 * (int64_t)run_tgt[run] : (int64_t)run_tgt[run];
  const GatheredCursor rd{seg_off[seg], 0, seg_off[seg + 1], G, n_slots,
                          steps, src_gathered, (int64_t)G * C * B,
                          (int64_t)C * B};
  exec_tile<Body, kPaired>(
      tgt_geo, out,
      whole ? nullptr
            : partials + (int64_t)seg * T::kRowsT * Body::kOut * B,
      row0, rd, B, od8, ring);
}

template <class Body, bool kPaired>
int launch_exec_pre_seg(const float* tgt_geo, const float* src_gathered,
                        float* out, float* partials, const int* run_tgt,
                        const int* run_seg, const int* seg_run,
                        const int* seg_off, const int* steps,
                        const int* n_slots, const int* n_seg_dev, int n_seg,
                        int B, int C, int G, int od8, void* stream) {
  if (n_seg <= 0) return (int)cudaSuccess;
  int threads, grid_y;
  size_t smem;
  tile_config<Body, kPaired>(B, &threads, &grid_y, &smem);
  const dim3 grid(n_seg, grid_y);
  // always: an occupancy query at another B may have set a smaller limit
  const cudaError_t err = cudaFuncSetAttribute(
      n_seg_dev ? (const void*)exec_pre_segs_capped<Body, kPaired>
                : (const void*)exec_pre_segs<Body, kPaired>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_seg_dev) {
    exec_pre_segs_capped<Body, kPaired><<<grid, threads, smem,
                                          (cudaStream_t)stream>>>(
        tgt_geo, src_gathered, out, partials, run_tgt, run_seg, seg_run,
        seg_off, steps, n_slots, n_seg_dev, B, C, G, od8);
  } else {
    exec_pre_segs<Body, kPaired><<<grid, threads, smem,
                                   (cudaStream_t)stream>>>(
        tgt_geo, src_gathered, out, partials, run_tgt, run_seg, seg_run,
        seg_off, steps, n_slots, B, C, G, od8);
  }
  return (int)cudaGetLastError();
}

// K8/K9's and K12's ordered reduction: one CTA row per split run (split_runs
// lists the runs of more than one segment; a run of one segment has nothing
// to add and gets no CTA), one thread per value of the run's `rows` partial
// rows (rows x kOut x B). Each value is the sum of the run's partials in
// segment order, then added onto the output row. Bound by bytes: the
// partials read once, the output rows read and written once.
template <class Body>
__global__ void reduce_segs(float* __restrict__ out,
                            const float* __restrict__ partials,
                            const int* __restrict__ run_tgt,
                            const int* __restrict__ run_seg,
                            const int* __restrict__ split_runs, int rows,
                            int B, int od8) {
  const int run = split_runs[blockIdx.x];
  const int s0 = run_seg[run], s1 = run_seg[run + 1];
  const int per = rows * Body::kOut * B;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= per) return;
  const float* p = partials + (int64_t)s0 * per + e;
  float v = p[0];
  int s = 1;
  for (; s + 4 <= s1 - s0; s += 4) {  // four loads in flight, added in order
    const float a = p[(int64_t)s * per], b = p[(int64_t)(s + 1) * per];
    const float c = p[(int64_t)(s + 2) * per], d = p[(int64_t)(s + 3) * per];
    v += a;
    v += b;
    v += c;
    v += d;
  }
  for (; s < s1 - s0; ++s) v += p[(int64_t)s * per];
  const int r = e / (Body::kOut * B);
  const int64_t row = (int64_t)run_tgt[run] * rows + r;
  out[row * od8 * B + (e - r * Body::kOut * B)] += v;
}

constexpr int kReduceThreads = 256;

// The fused solve's launch of the reduction: the plan's count of split
// runs is read from *n_split_dev, and the grid's rows (a quarter of the
// chunk's step slots, half the most split runs it can hold) take the
// split runs k, k + gridDim.x, ... below it; each value is summed as
// reduce_segs sums it. A row past the count exits, and a row takes a
// second run only where a chunk holds more split runs than rows. The
// kernel is a chain of dependent loads, so a row's first entry of
// split_runs and its run's segment bounds (the tables have a slot for
// every row) are loaded before the count is compared: the count adds no
// step to the chain. Of six launch shapes timed against the trimmed
// launch (PERF.md), this was the fastest. A kernel of its own, so the
// eager launch's code is unchanged.
template <class Body>
__global__ void reduce_segs_capped(float* __restrict__ out,
                                   const float* __restrict__ partials,
                                   const int* __restrict__ run_tgt,
                                   const int* __restrict__ run_seg,
                                   const int* __restrict__ split_runs,
                                   const int* __restrict__ n_split_dev,
                                   int rows, int B, int od8) {
  const int count = *n_split_dev;
  int k = blockIdx.x;
  int run = split_runs[k];
  int s0 = run_seg[run], s1 = run_seg[run + 1];
  const int per = rows * Body::kOut * B;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= per) return;
  const int r = e / (Body::kOut * B);
  while (k < count) {
    const float* p = partials + (int64_t)s0 * per + e;
    float v = p[0];
    int s = 1;
    for (; s + 4 <= s1 - s0; s += 4) {  // four loads in flight, in order
      const float a = p[(int64_t)s * per], b = p[(int64_t)(s + 1) * per];
      const float c = p[(int64_t)(s + 2) * per];
      const float d = p[(int64_t)(s + 3) * per];
      v += a;
      v += b;
      v += c;
      v += d;
    }
    for (; s < s1 - s0; ++s) v += p[(int64_t)s * per];
    const int64_t row = (int64_t)run_tgt[run] * rows + r;
    out[row * od8 * B + (e - r * Body::kOut * B)] += v;
    k += gridDim.x;
    if (k >= count) break;
    run = split_runs[k];
    s0 = run_seg[run];
    s1 = run_seg[run + 1];
  }
}

template <class Body>
int launch_reduce_segs(float* out, const float* partials, const int* run_tgt,
                       const int* run_seg, const int* split_runs,
                       const int* n_split_dev, int n_split, int rows, int B,
                       int od8, void* stream) {
  if (n_split <= 0) return (int)cudaSuccess;
  const int per = rows * Body::kOut * B;
  const dim3 grid(n_split, (per + kReduceThreads - 1) / kReduceThreads);
  if (n_split_dev) {
    reduce_segs_capped<Body><<<grid, kReduceThreads, 0,
                               (cudaStream_t)stream>>>(
        out, partials, run_tgt, run_seg, split_runs, n_split_dev, rows, B,
        od8);
  } else {
    reduce_segs<Body><<<grid, kReduceThreads, 0, (cudaStream_t)stream>>>(
        out, partials, run_tgt, run_seg, split_runs, rows, B, od8);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// K10 (pair_fetch "dma") and K11 ("dma_p"): the unpaired executor with
// source blocks fetched by id through bulk asynchronous copies. Replace
// onbody_tpu/ops/pallas_pairs.py:_exec_chunk with _body (K10) and with
// _body_pair (K11).
//
// The TPU kernels start a step's G source DMAs together and double-buffer
// them by step; K11 fetches two adjacent ids (a, a+1) with one 2-block
// DMA. Here the CTA keeps K1's design (one CTA per run of a target row,
// each thread owning two of its points, i and i + B/2, the sums in
// registers, one write per run, no atomics) and changes the fetch: one
// thread walks the run's slots and starts one 1D bulk copy per block
// (K11: per bundle of two adjacent blocks, which are contiguous in
// src_fm) into a ring of kPreStages shared-memory stages, K1's depth,
// each completing on its own mbarrier (async_copy.cuh). While the CTA
// sums one stage, the copies of the next two are in flight. Id 0, the
// inert row, starts no copy and takes no stage, so the k-th copy of a run
// always uses stage k % kPreStages with parity (k / kPreStages) & 1,
// however the slots are skipped; every copy started is waited on exactly
// once, because the readers and the issuing thread walk the same slot
// sequence with the same planner (copy_blocks).
//
// A copy lands a block as stored, kRows rows of B floats: a body whose
// staged rows differ (a core term, vort2d's sr^2) rewrites them in place
// behind a barrier before the sums (Body::staged, what the bodies' stage
// applies). block_rows (body.cuh) then reads the rows where they lie,
// one broadcast load of four consecutive sources per row, each source
// serving the thread's two targets: kRows / 8 shared loads a pair (3 to 5
// in a loop over one target's rows, K1's 1 from its transposed float4
// layout). Each block is
// summed into its own partials in source order, in slot order, so on the
// same groups K10 and K11 give K1's result bit for bit.
//
// Shared memory: the reference's two banks of G blocks would take
// 160-224 KiB at B 256 / G 16. A stage holds one block's kRows rows (K11:
// C + kRows rows, a bundle's first block whole and the second one's used
// rows), 12-45 KiB in three stages at B 256, and a CTA has B/2 threads
// (at most kExecMaxThreads), so several CTAs stay resident per SM
// (chip_smoke.py prints how many). Bulk copies need 16-byte aligned
// addresses and sizes: the wrapper raises unless B is a multiple of 4 and
// src_fm is aligned, which also aligns block_rows' loads.
//
// What bounds it: as K1, the FP32/MUFU operations of the pairs; the
// copies take the loads off the SM's load pipe and the barrier pair per
// block becomes a wait plus one release barrier (two with a restage).

// K11's bundle planner (reference pallas_pairs.py:_body_pair, its greedy
// head/consumed scan :316-330), one slot at a time: the blocks fetched by
// the copy that starts at slot j of a step's G ids, given that slot j is
// not the second half of a bundle. 0 for the inert id 0 (no copy); 2 when
// slot j + 1 holds the next id (one copy of both blocks); else 1. The last
// slot never heads a bundle. Advancing j by max(1, copy_blocks()) is the
// reference's scan: ids a, a+1, a+2 give the bundle (a, a+1), then a+2.
__host__ __device__ inline int copy_blocks(const int* ids, int j, int G) {
  const int a = ids[j];
  if (a == 0) return 0;
  return (j + 1 < G && ids[j + 1] == a + 1) ? 2 : 1;
}

// The copy of a run's slot sequence ids[0..n) that starts at slot q or
// after it: moves q onto its first slot and returns its block count (0
// when no copy is left). Steps are G slots each; K10 never bundles.
template <bool kBundle>
__device__ __forceinline__ int next_copy(const int* __restrict__ ids, int n,
                                         int G, int& q) {
  while (q < n && ids[q] == 0) ++q;
  if (q >= n) return 0;
  if (!kBundle) return 1;
  const int j = q % G;
  return copy_blocks(ids + (q - j), j, G);
}

template <class Body, bool kBundle>
__host__ __device__ constexpr int fetch_stage_rows(int C) {
  return kBundle ? C + Body::kRows : Body::kRows;
}

template <class Body, bool kBundle>
__global__ void exec_fetch_runs(const float* __restrict__ tgt_geo,
                                const float* __restrict__ src_fm,
                                float* __restrict__ out,
                                const int* __restrict__ run_tgt,
                                const int* __restrict__ run_off,
                                const int* __restrict__ pair_s,
                                const int* __restrict__ n_runs_dev, int B,
                                int C, int G, int od8) {
  constexpr int kTgts = 2;
  extern __shared__ __align__(16) float ring[];  // kPreStages stages
  __shared__ uint64_t bar[kPreStages];
  const int run = blockIdx.x;
  if (n_runs_dev != nullptr && run >= *n_runs_dev) return;  // past the list
  // thread i of the row's B / 2 (B is a multiple of 4) owns points i and
  // i + B / 2
  const int nthr = B / kTgts;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  const bool act = i < nthr;
  const int64_t row0 = run_tgt[run];
  typename Body::Tgt t[kTgts];
  float acc[kTgts][Body::kOut];
#pragma unroll
  for (int j = 0; j < kTgts; ++j) {
    t[j] = typename Body::Tgt{};
    if (act) t[j] = Body::load_tgt(tgt_geo + row0 * 8 * B + i + j * nthr, B);
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) acc[j][o] = 0.f;
  }
  const int* ids = pair_s + (int64_t)run_off[run] * G;
  const int n = (run_off[run + 1] - run_off[run]) * G;
  const int stage_floats = fetch_stage_rows<Body, kBundle>(C) * B;

  // the issuing thread's cursor: next slot, copies started
  int q_issue = 0, issued = 0;
  auto issue = [&]() {
    const int k = next_copy<kBundle>(ids, n, G, q_issue);
    if (k == 0) return;
    const int s = issued % kPreStages;
    const uint32_t bytes =
        (uint32_t)sizeof(float) * (k == 2 ? C + Body::kRows : Body::kRows) *
        B;
    expect_copy(bar + s, bytes);
    bulk_copy(ring + s * stage_floats, src_fm + (int64_t)ids[q_issue] * C * B,
              bytes, bar + s);
    q_issue += k;
    ++issued;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPreStages; ++s) mbar_init(bar + s, 1);
    for (int s = 0; s < kPreStages; ++s) issue();
  }
  __syncthreads();  // the barriers are initialised

  int q = 0;
  for (int f = 0;; ++f) {
    const int k = next_copy<kBundle>(ids, n, G, q);  // uniform
    if (k == 0) break;
    float* blk = ring + (f % kPreStages) * stage_floats;
    mbar_wait(bar + f % kPreStages, (f / kPreStages) & 1);
    if (!Body::kRawStage) {
      for (int c = threadIdx.x; c < k * B; c += blockDim.x) {
        float* col = blk + (c / B) * C * B + c % B;
#pragma unroll
        for (int r = 0; r < Body::kRows; ++r) {
          col[r * B] = Body::staged(r, col[r * B]);
        }
      }
      __syncthreads();
    }
    if (act) {
      block_rows<Body, kTgts>(blk, B, t, acc);
      if (k == 2) block_rows<Body, kTgts>(blk + C * B, B, t, acc);
    }
    __syncthreads();  // the stage is read: it may be refilled
    if (threadIdx.x == 0) {
      fence_before_copy();
      issue();
    }
    q += k;
  }
  if (!act) return;
#pragma unroll
  for (int j = 0; j < kTgts; ++j) {
    float* o0 = out + row0 * od8 * B + i + j * nthr;
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) o0[o * B] += acc[j][o];
  }
}

// Threads, CTAs per row (the grid's y: a row needs B / 2 threads, more
// than one CTA's above B = 512) and dynamic shared memory (the ring) of a
// K10/K11 launch.
template <class Body, bool kBundle>
void fetch_config(int B, int C, int* threads, int* grid_y, size_t* smem) {
  const int nthr = B / 2;
  *threads = nthr < kExecMaxThreads ? nthr : kExecMaxThreads;
  *grid_y = (nthr + *threads - 1) / *threads;
  *smem = sizeof(float) * kPreStages * fetch_stage_rows<Body, kBundle>(C) *
          B;
}

template <class Body, bool kBundle>
int launch_exec_fetch(const float* tgt_geo, const float* src_fm, float* out,
                      const int* run_tgt, const int* run_off,
                      const int* pair_s, const int* n_runs_dev, int n_runs,
                      int B, int C, int G, int od8, void* stream) {
  if (n_runs <= 0) return (int)cudaSuccess;
  int threads, grid_y;
  size_t smem;
  fetch_config<Body, kBundle>(B, C, &threads, &grid_y, &smem);
  const dim3 grid(n_runs, grid_y);
  // always: an occupancy query at another B may have set a smaller limit
  const cudaError_t err = cudaFuncSetAttribute(
      exec_fetch_runs<Body, kBundle>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  exec_fetch_runs<Body, kBundle><<<grid, threads, smem,
                                   (cudaStream_t)stream>>>(
      tgt_geo, src_fm, out, run_tgt, run_off, pair_s, n_runs_dev, B, C, G,
      od8);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per CTA, resident CTAs per SM and ring stages of
// one launch configuration, and the kernel's registers per thread and
// local (spill) bytes per thread, into info[0..4].
inline int occupancy_of(const void* fn, int threads, size_t smem,
                        int n_stages, int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  info[0] = (int)smem;
  info[1] = ctas;
  info[2] = n_stages;
  info[3] = attr.numRegs;
  info[4] = (int)attr.localSizeBytes;
  return (int)err;
}

// occupancy_of a K10 (kBundle false) or K11 launch at (B, C).
template <class Body, bool kBundle>
int fetch_occupancy(int B, int C, int* info) {
  int threads, grid_y;
  size_t smem;
  fetch_config<Body, kBundle>(B, C, &threads, &grid_y, &smem);
  return occupancy_of((const void*)exec_fetch_runs<Body, kBundle>, threads,
                      smem, kPreStages, info);
}

// occupancy_of a tile launch at B: K1's or K2's exec_runs, or K8's or
// K9's segment kernel (fn, the instantiation with the same kPaired).
template <class Body, bool kPaired>
int tile_occupancy(const void* fn, int B, int* info) {
  int threads, grid_y;
  size_t smem;
  tile_config<Body, kPaired>(B, &threads, &grid_y, &smem);
  return occupancy_of(fn, threads, smem, kPreStages, info);
}

// occupancy_of K10 (kind 0), K11 (1), K12 (2: K8's segment kernel, the
// launch K12 makes), the segment kernel of K8 (3) or K9 (4), K1 (5) or K2
// (6) at (B, C, G).
template <class Body>
int occupancy(int kind, int B, int C, int G, int* info) {
  switch (kind) {
    case 0:
      return fetch_occupancy<Body, false>(B, C, info);
    case 1:
      return fetch_occupancy<Body, true>(B, C, info);
    case 2:
    case 3:
      return tile_occupancy<Body, false>(
          (const void*)exec_pre_segs<Body, false>, B, info);
    case 4:
      return tile_occupancy<Body, true>(
          (const void*)exec_pre_segs<Body, true>, B, info);
    case 5:
      return tile_occupancy<Body, false>((const void*)exec_runs<Body, false>,
                                         B, info);
    case 6:
      return tile_occupancy<Body, true>((const void*)exec_runs<Body, true>,
                                        B, info);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace onbody
