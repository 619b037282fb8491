// Row/lane Bellman backup for Hopper (sm_90a), lane-separable mode, over a
// batch of channels in one launch.
//
// Replaces the TPU kernel ocdp_tpu/ops/pallas_backup6.py::PallasBackup6D.
// _kernel in its lane-separable branch, followed by _action_phase_generic
// and the after-argmin cost add, as PermutedRowLaneBackup runs it on the
// pos-att channels. One sweep of value iteration over a 4-D state grid
// whose axes are split into 2 ROW axes (next state depends on the action;
// pos-att: v, omega) and 2 LANE axes (next state depends only on the row
// and the lane's own coordinate; pos-att: x' = x + h v, theta' = theta +
// h omega). The value table is the (NW, NE) matrix V[row][lane], lanes
// c = i0 * n_l1 + i1. Per cell (r, c):
//
//   A_j   = sum_{t0} w0[t0](r, i0) * B_j(c + t0 * n_l1)        (lane axis 0)
//   B_j(c') = sum_{t1} w1[t1](r, i1) * V[r + D_j][c' + t1]       (lane axis 1)
//   tot_a = sum_j (ww0[combo0_j](r, a) * ww1[combo1_j](r, a)) * A_j
//           (+ c_act[a] when it is not 0) (+ c_rowact[r][a])
//   V'[r][c] = ((min_a tot_a) + c_row[r]) + c_lane[c] + (c_rowlane[r][c] or 0)
//
// with j over the live row combos (flat row shift D_j), t0/t1 over each lane
// axis's live taps in ascending order, and every tap weight
// (off == t ? 1 - f : 0) + (off == t - 1 ? f : 0), as at
// pallas_backup6.py:1044. B_j(c') is 0 when c' leaves [0, NE), and a read of
// V outside the table (a row outside [0, NW), a lane outside [0, NE)) is
// 0.0; such terms always carry an exactly zero weight, because a live tap
// keeps every coordinate in range. They are summed all the same, as the
// plain version sums them, so the two cannot differ even in a zero's sign.
// B_j's weights at lane c' = c + t0 * n_l1 equal those at c: c' has the
// same axis-1 coordinate and the same row.
//
// Arithmetic, bitwise equal to ocdp_tpu_torch/ops/rowlane.py::
// rowlane_backup_plain: every product and sum is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts
// into an FMA, in the plain version's order and association (a sum starts
// from its first term, not from 0).
//
// Minimum and ties: the running minimum starts at action 0's total and a
// later action wins only when strictly smaller (better = tot < best), the
// chain of _action_phase_generic. A NaN total at action 0 therefore stays,
// and a later NaN never wins; the plain version runs the same chain.
//
// Layout and what bounds it. A first kernel (one thread a cell over the
// flat cells) ran at about 60x its operation bound: every cell read
// its 81-153 table values from L1/L2 through runtime-bounded tap loops and
// formed every row tap weight of every (action, row combo) again, 9 x 9
// weight pairs a cell, although they depend on the row and the action only.
// Here a block owns a tile of R consecutive rows x L consecutive lanes of
// one channel (blockIdx.z), and before any cell:
//
//   * stages in dynamic shared memory every table row its cells read, over
//     the lanes [c0 - reach_lo, c0 + L + reach_hi), with cp.async (16-byte
//     chunks where the rows are 4-lane aligned). The row shifts are
//     D = t0 * n_r1 + t1, so each live row-axis-0 tap t0 reads one run of
//     R + (t1 span) consecutive rows: 3 R + 8 rows for the pos-att
//     channels. A stage entry outside the table is zero-filled by the copy
//     itself (src-size 0): exactly the 0.0 the plain version reads there.
//     The host planner (ops/rowlane.py::plan_tiles) picks R and L and hands
//     the kernel its index map (row groups and each combo's stage slot);
//     the launch refuses a map that misses a read (cudaErrorInvalidValue);
//   * forms the joint row weight of each (tile row, action, combo),
//     __fmul_rn(tap_weight(o0, g0, combo0), tap_weight(o1, g1, combo1)) as
//     the first kernel rounded it, once, into shared memory, 4 to a 16-byte
//     row so that the action phase reads them as float4 broadcasts;
//   * forms the lane tap weights of each (tile row, lane coordinate, tap)
//     of the tile's lane coordinates once into shared memory.
//
// Then each thread takes two cells of one tile row at a time, which share
// the row weights, each weight read and every uniform value. Where both
// lane axes' live taps are exactly (-1, 0, 1) (every pos-att plan) the two
// cells are lanes c and c + n_l1: same axis-1 coordinate, so their
// axis-1 passes at c - n_l1 .. c + 2 n_l1 overlap and four are formed
// instead of six (lane_pair), unrolled with constant offsets; and where a
// block's channel has 9, 10, 11 or 17 row combos (the pos-att channels)
// the combo loops have that compile-time length, so nothing in them is
// predicated. Other plans take lanes l and l + L/2, runtime tap loops and
// predicated combo loops up to the kernel's capacity, 32 or 40 combos: 40
// is the TPU kernel's max_flat_taps (pallas_backup6.py:478), which a finer
// omega grid reaches (PosAttConfig(n_mesh_w=120): 35 combos). Past 20
// combos the (-1, 0, 1)-tap plans take a 40-combo kernel too, their lane
// pairs kept, their combo loops predicated.
// Registers are capped at 64 so that four blocks of 256 threads fit an SM.
// At PosAttConfig() the planner takes 4 rows x 600 lanes (a 20 x 648
// stage, 56 KB a block, 452 blocks for the four channels). Measured on an
// H100 (PERF.md §6): the four channels in one launch 0.044 ms on the
// device, 9.9x the operation bound, against 4 x 0.067 ms for the first
// kernel; what bounds it is the instruction stream of the unfused
// arithmetic and the stage reads, not memory.
//
// A launch takes a batch of up to kMaxBatch channels, each with its own
// pointers, shapes, tap structure, action count and stage map (x_failure
// has 6 actions, the others 9), as one __grid_constant__ parameter block
// (1,312 B a channel, 5.3 KB for 4: above the 4 KB of parameters a launch
// took before CUDA 12.1, inside the 32,764 B it takes since on sm_70 and
// later). The grid covers the largest channel; a
// block past its own channel's rows or lanes returns. The launch sets no
// function attribute: rowlane_backup_configure raises the dynamic shared
// memory limit beforehand, so a launch may be captured into a CUDA graph
// (the batched converged engine replays the 50 sweeps between two checks
// as one).
//
// Lane taps: the any-tap kinds (2 and 4) run their lane loops to each
// axis's tap count, reading the tap weights from the stage, so they take a
// lane axis of up to kMaxLaneTaps = 40 live taps, as many as the TPU
// kernel's 40 live lane combos allow; the stage's lane window grows to the
// taps' reach on each side (ops/rowlane.py::plan_tiles). A simplified
// attitude axis on a finer theta grid has more than the 5 lane taps of the
// default: AttitudeConfig(n_mesh_t=1000)'s three axes 11, 15 and 9.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// registers capped at 64 a thread, so that 4 blocks fit an SM (measured on
// an H100: 7-13% faster than the uncapped 80-128 registers at 2-3 blocks)
constexpr int kMinBlocks = 4;
constexpr int kMaxBatch = 4;        // MAX_BATCH in ops/rowlane.py
constexpr int kMaxLaneTaps = 40;    // MAX_LANE_TAPS
constexpr int kMaxRowCombos = 40;   // MAX_ROW_COMBOS
constexpr int kMaxActions = 64;     // MAX_ACTIONS
constexpr int kMaxGroups = 8;       // MAX_GROUPS
constexpr int kPtrs = 13;           // device pointers a channel
constexpr int kChanInts = 12 + 3 * kMaxGroups + 3 * kMaxRowCombos +
                          2 * kMaxLaneTaps;   // CHAN_INTS

// One channel of a launch: its pointers, shapes, taps and stage map.
struct Chan {
  const float* values;
  float* out_v;
  int* out_a;
  const int* row_off;
  const float* row_frac;
  const int* lane_off0;
  const float* lane_frac0;
  const int* lane_off1;
  const float* lane_frac1;
  const float* c_row;
  const float* c_lane;
  const float* c_rowact;    // may be null
  const float* c_rowlane;   // may be null
  int n_rows, n_r1, n_l0, n_l1, n_lanes, n_actions, n_combos, n_taps0,
      n_taps1, jp, n_groups;
  int n_x0, n_x1;   // lane coordinates a tile keeps weights of, per axis
  int g_delta[kMaxGroups];   // a stage row group's first row shift
  int g_rows[kMaxGroups];    // its rows
  int g_slot[kMaxGroups];    // its first stage row
  int combo0[kMaxRowCombos];  // row-axis-0 tap of combo j
  int combo1[kMaxRowCombos];  // row-axis-1 tap of combo j
  int slot[kMaxRowCombos];    // stage row of combo j at tile row 0
  int taps0[kMaxLaneTaps];    // live taps of lane axis 0, ascending
  int taps1[kMaxLaneTaps];    // live taps of lane axis 1, ascending
  float c_act[kMaxActions];   // per-action cost
};

struct Batch {
  int rows, lanes, reach_lo, width, rw_at, lw_at, vec4;
  Chan ch[kMaxBatch];
};

__device__ __forceinline__ float tap_weight(int off, float f, int t) {
  return __fadd_rn(off == t ? __fsub_rn(1.0f, f) : 0.0f,
                   off == t - 1 ? f : 0.0f);
}

// one 4-byte cp.async into the stage; ok false: a zero, nothing read
__device__ __forceinline__ void stage_copy(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// one 16-byte cp.async into the stage (both addresses 16-byte aligned)
__device__ __forceinline__ void stage_copy16(float* dst, const float* src,
                                             bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// the exact combo counts of the (-1, 0, 1)-tap kernels: capacity 12, 20
constexpr int kExactJ[2][3] = {{9, 10, 11}, {10, 11, 17}};

// The lane phase of two cells of one tile row whose lanes are c and
// c + n_l1 (the same axis-1 coordinate i1, axis-0 coordinates i0 and
// i0 + 1), for lane taps of exactly (-1, 0, 1) on both axes: A0 and A1,
// the interpolated shifted rows of every live row combo. A cell's axis-1
// pass at lane c' is b(c') = w1[0] V[c' - 1] + w1[1] V[c'] + w1[2]
// V[c' + 1] with the weights of (row, i1), the same for both cells, so the
// two cells need b at c - n_l1, c, c + n_l1 and c + 2 n_l1 only: four
// passes instead of six, each formed exactly as the cell that reads it
// would form it. The axis-0 pass A = (w0[0] b_m + w0[1] b_0) + w0[2] b_p
// takes b_m and b_p as 0.0 where their lane leaves the table (i0 - 1 < 0,
// i0 + 1 >= n_l0), as the plain version's zero fill does. col: the
// shared-memory index of lane c in tile row 0 of the stage; slotw[j]: combo
// j's stage row offset; lw0, lw1: where the tile's lane tap weights start.
// kExact: the channel has exactly kJ row combos (no step is predicated),
// else at most kJ.
template <int kJ, bool kExact>
__device__ __forceinline__ void lane_pair(
    const Chan& ch, int col, const int (&slotw)[kJ], int lw0, int lw1,
    int rr, int c, int x0_lo, float (&A0)[kJ], float (&A1)[kJ]) {
  extern __shared__ __align__(16) float smem[];
  const int n_l1 = ch.n_l1;
  const int i0 = c / n_l1;
  const int i1 = c - i0 * n_l1;
  const int u0 = i0 - x0_lo;
  float w0a[3], w0b[3], w1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w0a[k] = smem[lw0 + (rr * 3 + k) * ch.n_x0 + u0];
    w0b[k] = smem[lw0 + (rr * 3 + k) * ch.n_x0 + u0 + 1];
    w1[k] = smem[lw1 + (rr * 3 + k) * ch.n_x1 + i1];
  }
  const bool in_m = i0 > 0;              // lane c - n_l1 is in the table
  const bool in_p = i0 + 1 < ch.n_l0;    // lane c + n_l1 is
  const bool in_q = i0 + 2 < ch.n_l0;    // lane c + 2 n_l1 is
  const float* sm = smem + col - n_l1;   // the four runs of three lanes
  const float* s0 = smem + col;
  const float* sp = smem + col + n_l1;
  const float* sq = smem + col + 2 * n_l1;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    A0[j] = A1[j] = 0.0f;
    if (kExact || j < ch.n_combos) {
      const int o = slotw[j];
      float bm = __fadd_rn(__fadd_rn(__fmul_rn(w1[0], sm[o - 1]),
                                     __fmul_rn(w1[1], sm[o])),
                           __fmul_rn(w1[2], sm[o + 1]));
      const float b0 = __fadd_rn(__fadd_rn(__fmul_rn(w1[0], s0[o - 1]),
                                           __fmul_rn(w1[1], s0[o])),
                                 __fmul_rn(w1[2], s0[o + 1]));
      const float bp = __fadd_rn(__fadd_rn(__fmul_rn(w1[0], sp[o - 1]),
                                           __fmul_rn(w1[1], sp[o])),
                                 __fmul_rn(w1[2], sp[o + 1]));
      float bq = __fadd_rn(__fadd_rn(__fmul_rn(w1[0], sq[o - 1]),
                                     __fmul_rn(w1[1], sq[o])),
                           __fmul_rn(w1[2], sq[o + 1]));
      bm = in_m ? bm : 0.0f;
      bq = in_q ? bq : 0.0f;
      A0[j] = __fadd_rn(__fadd_rn(__fmul_rn(w0a[0], bm),
                                  __fmul_rn(w0a[1], b0)),
                        __fmul_rn(w0a[2], in_p ? bp : 0.0f));
      A1[j] = __fadd_rn(__fadd_rn(__fmul_rn(w0b[0], b0),
                                  __fmul_rn(w0b[1], bp)),
                        __fmul_rn(w0b[2], bq));
    }
  }
}

// The lane phase of one cell (tile row rr, lane c, tile lane cl) for any
// live taps, in runtime loops: A_j of every live row combo, as lane_pair
// forms them.
template <int kJ, bool kExact>
__device__ __forceinline__ void lane_phase(
    const Chan& ch, int col, const int (&slotw)[kJ], int lw0, int lw1,
    int rr, int c, int cl, int x0_lo, bool whole1, float (&A)[kJ]) {
  extern __shared__ __align__(16) float smem[];
  const int n_l1 = ch.n_l1;
  const int i0 = c / n_l1;
  const int i1 = c - i0 * n_l1;
  const int u0 = i0 - x0_lo;
  const int u1 = whole1 ? i1 : cl;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    A[j] = 0.0f;
    if (kExact || j < ch.n_combos) {
      const int srow = col + slotw[j];
      float acc = 0.0f;
#pragma unroll 1
      for (int k0 = 0; k0 < ch.n_taps0; ++k0) {
        const int s0 = ch.taps0[k0] * n_l1;
        float bsum = 0.0f;
        if (c + s0 >= 0 && c + s0 < ch.n_lanes) {
#pragma unroll 1
          for (int k1 = 0; k1 < ch.n_taps1; ++k1) {
            const float term =
                __fmul_rn(smem[lw1 + (rr * ch.n_taps1 + k1) * ch.n_x1 + u1],
                          smem[srow + s0 + ch.taps1[k1]]);
            bsum = k1 == 0 ? term : __fadd_rn(bsum, term);
          }
        }
        const float term = __fmul_rn(
            smem[lw0 + (rr * ch.n_taps0 + k0) * ch.n_x0 + u0], bsum);
        acc = k0 == 0 ? term : __fadd_rn(acc, term);
      }
      A[j] = acc;
    }
  }
}

// The action phase of two cells of tile row r (their A_j in A0, A1; the
// row's joint weights from the float4 index w_row): each one's strict-'<'
// first minimum from action 0, sharing every weight read.
template <int kJ, bool kExact>
__device__ __forceinline__ void action_pair(
    const Chan& ch, int w_row, int r, const float (&A0)[kJ],
    const float (&A1)[kJ], float& best0, int& ba0, float& best1, int& ba1) {
  extern __shared__ __align__(16) float smem[];
  const float4* rw4 = reinterpret_cast<const float4*>(smem);
  const int n_act = ch.n_actions;
  best0 = best1 = 0.0f;
  ba0 = ba1 = 0;
  for (int a = 0; a < n_act; ++a) {
    const int w_at = w_row + a * (ch.jp / 4);
    float tot0 = 0.0f, tot1 = 0.0f;
#pragma unroll
    for (int q = 0; q < (kJ + 3) / 4; ++q) {
      if (kExact || 4 * q < ch.n_combos) {
        const float4 w = rw4[w_at + q];
        const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * q + e;
          if (j < kJ && (kExact || j < ch.n_combos)) {
            const float t0 = __fmul_rn(ws[e], A0[j]);
            const float t1 = __fmul_rn(ws[e], A1[j]);
            tot0 = j == 0 ? t0 : __fadd_rn(tot0, t0);
            tot1 = j == 0 ? t1 : __fadd_rn(tot1, t1);
          }
        }
      }
    }
    const float ca = ch.c_act[a];
    if (ca != 0.0f) {
      tot0 = __fadd_rn(tot0, ca);
      tot1 = __fadd_rn(tot1, ca);
    }
    if (ch.c_rowact != nullptr) {
      const float cr = ch.c_rowact[static_cast<long long>(r) * n_act + a];
      tot0 = __fadd_rn(tot0, cr);
      tot1 = __fadd_rn(tot1, cr);
    }
    if (a == 0 || tot0 < best0) {  // strict: the first minimum wins
      best0 = tot0;
      ba0 = a;
    }
    if (a == 0 || tot1 < best1) {
      best1 = tot1;
      ba1 = a;
    }
  }
}

// The after-argmin cost add and the stores of cell (r, c).
__device__ __forceinline__ void store_cell(const Chan& ch, int r, int c,
                                           float best, int best_a) {
  const long long cell = static_cast<long long>(r) * ch.n_lanes + c;
  float out = __fadd_rn(__fadd_rn(best, ch.c_row[r]), ch.c_lane[c]);
  out = __fadd_rn(out, ch.c_rowlane != nullptr ? ch.c_rowlane[cell] : 0.0f);
  ch.out_v[cell] = out;
  ch.out_a[cell] = best_a;
}

// The cells of one tile, two a thread, after the block's prologue staged
// its table rows and weights (row weights from rw, lane tap weights from
// lw0 and lw1). kTaps3: the pairs are lanes c and c + n_l1 of one tile row
// (lane_pair; the planner makes the tile's lanes a multiple of 2 n_l1 and
// each tile's first lane one of n_l1); else lanes cl and cl + L/2. Either
// pair shares the row weights, every uniform value and each weight read.
template <bool kTaps3, int kJ, bool kExact>
__device__ __forceinline__ void tile_cells(const Batch& b, const Chan& ch,
                                           int r0, int c0, int rw, int lw0,
                                           int lw1, int x0_lo, bool whole1) {
  const int n_rows = ch.n_rows, n_lanes = ch.n_lanes;
  int slotw[kJ];   // each combo's stage row offset
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    slotw[j] = kExact || j < ch.n_combos ? ch.slot[j] * b.width : 0;
  }
  const int half = b.lanes / 2;
  const int n_l1 = ch.n_l1;
  for (int i = threadIdx.x; i < b.rows * half; i += kThreads) {
    const int rr = i / half;
    const int p = i - rr * half;
    // the pair's tile lanes: cl and cl + step
    const int step = kTaps3 ? n_l1 : half;
    const int cl = kTaps3 ? (p / n_l1) * 2 * n_l1 + p % n_l1 : p;
    const int r = r0 + rr;
    const int c = c0 + cl;
    if (r >= n_rows || c >= n_lanes) continue;
    const int col = b.reach_lo + rr * b.width + cl;
    float A0[kJ], A1[kJ];
    if constexpr (kTaps3) {
      lane_pair<kJ, kExact>(ch, col, slotw, lw0, lw1, rr, c, x0_lo, A0, A1);
    } else {
      lane_phase<kJ, kExact>(ch, col, slotw, lw0, lw1, rr, c, cl, x0_lo,
                             whole1, A0);
      lane_phase<kJ, kExact>(ch, col + half, slotw, lw0, lw1, rr, c + half,
                             cl + half, x0_lo, whole1, A1);
    }
    float best0, best1;
    int ba0, ba1;
    action_pair<kJ, kExact>(ch, (rw + rr * ch.n_actions * ch.jp) / 4, r, A0,
                            A1, best0, ba0, best1, ba1);
    store_cell(ch, r, c, best0, ba0);
    if (c + step < n_lanes) store_cell(ch, r, c + step, best1, ba1);
  }
}

template <bool kTaps3, int kJMax>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rowlane_tiles(const __grid_constant__ Batch b) {
  extern __shared__ __align__(16) float smem[];
  const Chan& ch = b.ch[blockIdx.z];
  const int r0 = blockIdx.x * b.rows;
  const int c0 = blockIdx.y * b.lanes;
  if (r0 >= ch.n_rows || c0 >= ch.n_lanes) return;   // the whole block
  const int n_rows = ch.n_rows, n_lanes = ch.n_lanes, n_l0 = ch.n_l0,
            n_l1 = ch.n_l1, n_act = ch.n_actions, jp = ch.jp;
  const int lane0 = c0 - b.reach_lo;   // the table lane of stage column 0

  // stage every table row the tile reads, zero outside the table
  for (int g = 0; g < ch.n_groups; ++g) {
    for (int i = 0; i < ch.g_rows[g]; ++i) {
      const int tr = r0 + ch.g_delta[g] + i;
      const bool row_in = tr >= 0 && tr < n_rows;
      const float* src =
          ch.values + static_cast<long long>(row_in ? tr : 0) * n_lanes;
      float* dst = smem + (ch.g_slot[g] + i) * b.width;
      if (b.vec4) {
        for (int j = 4 * threadIdx.x; j < b.width; j += 4 * kThreads) {
          const int c = lane0 + j;
          const bool ok = row_in && c >= 0 && c < n_lanes;
          stage_copy16(dst + j, ok ? src + c : ch.values, ok);
        }
      } else {
        for (int j = threadIdx.x; j < b.width; j += kThreads) {
          const int c = lane0 + j;
          const bool ok = row_in && c >= 0 && c < n_lanes;
          stage_copy(dst + j, ok ? src + c : ch.values, ok);
        }
      }
    }
  }
  // the joint row weights [tile row][action][combo, padded to jp]
  float* rw = smem + b.rw_at;
  const long long plane = static_cast<long long>(n_rows) * n_act;
  for (int i = threadIdx.x; i < b.rows * n_act * jp; i += kThreads) {
    const int rr = i / (n_act * jp);
    const int a = (i / jp) % n_act;
    const int j = i % jp;
    const int r = r0 + rr;
    float w = 0.0f;
    if (r < n_rows && j < ch.n_combos) {
      const long long at = static_cast<long long>(r) * n_act + a;
      w = __fmul_rn(tap_weight(ch.row_off[at], ch.row_frac[at], ch.combo0[j]),
                    tap_weight(ch.row_off[plane + at],
                               ch.row_frac[plane + at], ch.combo1[j]));
    }
    rw[i] = w;
  }
  // the lane tap weights [tile row][tap][coordinate slot] of the tile's
  // coordinates: on axis 0 the n_x0 from x0_lo on, on axis 1 every
  // coordinate in order when a tile spans a whole axis-1 run (n_x1 ==
  // n_l1), else one slot a tile lane
  const int x0_lo = c0 / n_l1;
  const bool whole1 = ch.n_x1 == n_l1;
  const int lw0_at = b.lw_at;
  const int lw1_at = lw0_at + b.rows * ch.n_taps0 * ch.n_x0;
  float* lw0 = smem + lw0_at;
  float* lw1 = smem + lw1_at;
  for (int i = threadIdx.x; i < b.rows * ch.n_taps0 * ch.n_x0;
       i += kThreads) {
    const int rr = i / (ch.n_taps0 * ch.n_x0);
    const int k = (i / ch.n_x0) % ch.n_taps0;
    const int x = x0_lo + i % ch.n_x0;
    const int r = r0 + rr;
    lw0[i] = r < n_rows && x < n_l0
                 ? tap_weight(ch.lane_off0[r * n_l0 + x],
                              ch.lane_frac0[r * n_l0 + x], ch.taps0[k])
                 : 0.0f;
  }
  for (int i = threadIdx.x; i < b.rows * ch.n_taps1 * ch.n_x1;
       i += kThreads) {
    const int rr = i / (ch.n_taps1 * ch.n_x1);
    const int k = (i / ch.n_x1) % ch.n_taps1;
    const int u = i % ch.n_x1;
    const int x = whole1 ? u : (c0 + u) % n_l1;
    const int r = r0 + rr;
    lw1[i] = r < n_rows ? tap_weight(ch.lane_off1[r * n_l1 + x],
                                     ch.lane_frac1[r * n_l1 + x],
                                     ch.taps1[k])
                        : 0.0f;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // the cells, with the combo count a compile-time constant where it is
  // one of the pos-att channels'
  if constexpr (kTaps3 && kJMax <= 20) {
    constexpr int kJ0 = kExactJ[kJMax > 12][0];
    constexpr int kJ1 = kExactJ[kJMax > 12][1];
    constexpr int kJ2 = kExactJ[kJMax > 12][2];
    switch (ch.n_combos) {
      case kJ0:
        tile_cells<true, kJ0, true>(b, ch, r0, c0, b.rw_at, lw0_at, lw1_at,
                                    x0_lo, whole1);
        return;
      case kJ1:
        tile_cells<true, kJ1, true>(b, ch, r0, c0, b.rw_at, lw0_at, lw1_at,
                                    x0_lo, whole1);
        return;
      case kJ2:
        tile_cells<true, kJ2, true>(b, ch, r0, c0, b.rw_at, lw0_at, lw1_at,
                                    x0_lo, whole1);
        return;
      default:
        tile_cells<true, kJMax, false>(b, ch, r0, c0, b.rw_at, lw0_at,
                                       lw1_at, x0_lo, whole1);
        return;
    }
  } else {
    tile_cells<kTaps3, kJMax, false>(b, ch, r0, c0, b.rw_at, lw0_at, lw1_at,
                                     x0_lo, whole1);
  }
}

// The instantiations (kernel_of; _kind in ops/rowlane.py): kinds 0, 1 and
// 3, lane taps exactly (-1, 0, 1) on both axes and at most 12, 20 or 40
// row combos, kinds 0 and 1 with exact-count bodies for 9, 10 and 11 or
// for 10, 11 and 17 (the pos-att channels); kinds 2 and 4, any taps (up
// to kMaxLaneTaps an axis) and at most 32 or 40 row combos (a simplified
// attitude axis: 25-27 combos at n_mesh_w=1000, 33-37 at 1400; the 40-combo
// body spills more and runs a 25-combo axis about 10% slower, so the
// 32-combo one stays).
using KernelFn = void (*)(Batch);
KernelFn kernel_of(int kind) {
  switch (kind) {
    case 0: return rowlane_tiles<true, 12>;
    case 1: return rowlane_tiles<true, 20>;
    case 2: return rowlane_tiles<false, 32>;
    case 3: return rowlane_tiles<true, kMaxRowCombos>;
    case 4: return rowlane_tiles<false, kMaxRowCombos>;
    default: return nullptr;
  }
}
constexpr int kComboCap[5] = {12, 20, 32, kMaxRowCombos, kMaxRowCombos};
constexpr bool kTaps3Of[5] = {true, true, false, true, false};

// Fill one channel from its ints (the CHAN_INTS layout of ops/rowlane.py:
// n_r0, n_r1, n_l0, n_l1, n_actions, n_combos, n_taps0, n_taps1, jp,
// n_groups, n_x0, n_x1, g_delta[G], g_rows[G], g_slot[G], combo0[J],
// combo1[J], slot[J], taps0[T], taps1[T]) and check that the tile map
// serves every read of it; false when it does not.
bool fill_chan(Chan& c, const long long* p, const int* v, const float* c_act,
               int rows, int lanes, int reach_lo, int width, int rw_at,
               int lw_at, int smem_floats, int grid_x, int grid_y, int kind) {
  c.values = reinterpret_cast<const float*>(p[0]);
  c.out_v = reinterpret_cast<float*>(p[1]);
  c.out_a = reinterpret_cast<int*>(p[2]);
  c.row_off = reinterpret_cast<const int*>(p[3]);
  c.row_frac = reinterpret_cast<const float*>(p[4]);
  c.lane_off0 = reinterpret_cast<const int*>(p[5]);
  c.lane_frac0 = reinterpret_cast<const float*>(p[6]);
  c.lane_off1 = reinterpret_cast<const int*>(p[7]);
  c.lane_frac1 = reinterpret_cast<const float*>(p[8]);
  c.c_row = reinterpret_cast<const float*>(p[9]);
  c.c_lane = reinterpret_cast<const float*>(p[10]);
  c.c_rowact = reinterpret_cast<const float*>(p[11]);
  c.c_rowlane = reinterpret_cast<const float*>(p[12]);
  for (int k = 0; k < 11; ++k) {
    if (p[k] == 0) return false;   // only c_rowact and c_rowlane may be null
  }
  const int n_r0 = v[0];
  c.n_r1 = v[1];
  c.n_l0 = v[2];
  c.n_l1 = v[3];
  c.n_actions = v[4];
  c.n_combos = v[5];
  c.n_taps0 = v[6];
  c.n_taps1 = v[7];
  c.jp = v[8];
  c.n_groups = v[9];
  c.n_x0 = v[10];
  c.n_x1 = v[11];
  if (n_r0 < 1 || c.n_r1 < 1 || c.n_l0 < 1 || c.n_l1 < 1) return false;
  const long long nw = static_cast<long long>(n_r0) * c.n_r1;
  const long long ne = static_cast<long long>(c.n_l0) * c.n_l1;
  if (nw * ne >= (1LL << 31)) return false;
  c.n_rows = static_cast<int>(nw);
  c.n_lanes = static_cast<int>(ne);
  if (c.n_actions < 1 || c.n_actions > kMaxActions || c.n_combos < 1 ||
      c.n_combos > kComboCap[kind] || c.n_taps0 < 1 ||
      c.n_taps0 > kMaxLaneTaps || c.n_taps1 < 1 ||
      c.n_taps1 > kMaxLaneTaps || c.jp != (c.n_combos + 3) / 4 * 4 ||
      c.n_groups < 1 || c.n_groups > kMaxGroups) {
    return false;
  }
  const int* g = v + 12;
  const int* cb = g + 3 * kMaxGroups;
  const int* tp = cb + 3 * kMaxRowCombos;
  for (int i = 0; i < kMaxGroups; ++i) {
    c.g_delta[i] = g[i];
    c.g_rows[i] = g[kMaxGroups + i];
    c.g_slot[i] = g[2 * kMaxGroups + i];
  }
  for (int j = 0; j < kMaxRowCombos; ++j) {
    c.combo0[j] = cb[j];
    c.combo1[j] = cb[kMaxRowCombos + j];
    c.slot[j] = cb[2 * kMaxRowCombos + j];
  }
  for (int t = 0; t < kMaxLaneTaps; ++t) {
    c.taps0[t] = tp[t];
    c.taps1[t] = tp[kMaxLaneTaps + t];
  }
  for (int a = 0; a < kMaxActions; ++a) c.c_act[a] = c_act[a];
  if (kTaps3Of[kind]) {
    for (int t = 0; t < 3; ++t) {
      if (c.n_taps0 != 3 || c.n_taps1 != 3 || c.taps0[t] != t - 1 ||
          c.taps1[t] != t - 1) {
        return false;
      }
    }
    // lane pairs (c, c + n_l1): whole pairs in every tile
    if (lanes % (2 * c.n_l1) != 0) return false;
  }
  // the grid covers the channel; the stage groups fit before the weights
  if (static_cast<long long>(grid_x) * rows < nw ||
      static_cast<long long>(grid_y) * lanes < ne) {
    return false;
  }
  for (int i = 0; i < c.n_groups; ++i) {
    if (c.g_rows[i] < rows || c.g_slot[i] < 0 ||
        static_cast<long long>(c.g_slot[i] + c.g_rows[i]) * width > rw_at) {
      return false;
    }
  }
  // every row combo's R rows lie in one group, at its slot
  for (int j = 0; j < c.n_combos; ++j) {
    const int d = c.combo0[j] * c.n_r1 + c.combo1[j];
    bool found = false;
    for (int i = 0; i < c.n_groups && !found; ++i) {
      found = c.g_delta[i] <= d && d + rows <= c.g_delta[i] + c.g_rows[i] &&
              c.slot[j] == c.g_slot[i] + d - c.g_delta[i];
    }
    if (!found) return false;
  }
  // every lane read of a tile lies in its stage window
  for (int a = 0; a < c.n_taps0; ++a) {
    for (int t = 0; t < c.n_taps1; ++t) {
      const int s = c.taps0[a] * c.n_l1 + c.taps1[t];
      if (-s > reach_lo || s > width - lanes - reach_lo) return false;
    }
  }
  // a tile's lane coordinates fit their slots: on axis 0 the lanes
  // [c0, c0 + lanes) span at most lanes / n_l1 + 2 coordinates from c0 /
  // n_l1; on axis 1 either all of them in order or one a lane
  if (c.n_x0 < 1 ||
      (c.n_x0 < (lanes - 1) / c.n_l1 + 2 && c.n_x0 < c.n_l0) ||
      !(c.n_x1 == c.n_l1 || (c.n_x1 == lanes && lanes < c.n_l1))) {
    return false;
  }
  // the weights fit: rows x actions x jp, then rows x (taps x slots)
  if (static_cast<long long>(rows) * c.n_actions * c.jp > lw_at - rw_at ||
      static_cast<long long>(rows) *
              (c.n_taps0 * c.n_x0 + c.n_taps1 * c.n_x1) >
          smem_floats - lw_at) {
    return false;
  }
  return true;
}

}  // namespace

// One sweep of a batch of n_batch channels. ptrs: kPtrs device pointers a
// channel (values, out_v, out_a, row_off, row_frac, lane_off0, lane_frac0,
// lane_off1, lane_frac1, c_row, c_lane, c_rowact or 0, c_rowlane or 0);
// ints: kChanInts a channel; c_act: kMaxActions floats a channel; tiles:
// rows, lanes, reach_lo, reach_hi, width, rw_at, lw_at, smem_bytes, grid_x,
// grid_y, kind, pad (TILE_INTS). Returns a cudaError_t (0 on success):
// cudaErrorInvalidValue when a channel, its capacities or the tile map do
// not fit (a map that misses a read), else cudaGetLastError() after the
// launch.
extern "C" int rowlane_backup_f32(int n_batch, const long long* ptrs,
                                  const int* ints, const float* c_act,
                                  const int* tiles, void* stream) {
  const int rows = tiles[0], lanes = tiles[1], reach_lo = tiles[2],
            reach_hi = tiles[3], width = tiles[4], rw_at = tiles[5],
            lw_at = tiles[6], smem_bytes = tiles[7], grid_x = tiles[8],
            grid_y = tiles[9], kind = tiles[10];
  const KernelFn kernel = kernel_of(kind);
  if (kernel == nullptr || n_batch < 1 || n_batch > kMaxBatch || rows < 1 ||
      lanes < 2 || lanes % 8 != 0 || reach_lo < 0 || reach_lo % 4 != 0 ||
      reach_hi < 0 || reach_hi % 4 != 0 ||
      width != lanes + reach_lo + reach_hi ||
      rw_at % 4 != 0 || lw_at < rw_at || smem_bytes % 4 != 0 ||
      grid_x < 1 || grid_y < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Batch b;
  b.rows = rows;
  b.lanes = lanes;
  b.reach_lo = reach_lo;
  b.width = width;
  b.rw_at = rw_at;
  b.lw_at = lw_at;
  b.vec4 = 1;
  for (int i = 0; i < n_batch; ++i) {
    Chan& c = b.ch[i];
    if (!fill_chan(c, ptrs + i * kPtrs, ints + i * kChanInts,
                   c_act + i * kMaxActions, rows, lanes, reach_lo, width,
                   rw_at, lw_at, smem_bytes / 4, grid_x, grid_y, kind)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // 16-byte stage copies: every row and the table 4-lane aligned
    if (c.n_lanes % 4 != 0 ||
        reinterpret_cast<unsigned long long>(c.values) % 16 != 0) {
      b.vec4 = 0;
    }
  }
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(n_batch));
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      b);
  return static_cast<int>(cudaGetLastError());
}

// Let kernel `kind` take smem_bytes of dynamic shared memory (above 48 KB
// it needs the opt-in) on the current device; call before a launch, and
// before a CUDA graph captures one. Returns a cudaError_t.
extern "C" int rowlane_backup_configure(int kind, int smem_bytes) {
  const KernelFn kernel = kernel_of(kind);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  return static_cast<int>(err);
}

// Resident blocks an SM of kernel `kind` with smem_bytes of stage, on the
// current device (after rowlane_backup_configure); -1 on an error.
extern "C" int rowlane_backup_blocks_per_sm(int kind, int smem_bytes) {
  const KernelFn kernel = kernel_of(kind);
  int blocks = 0;
  if (kernel == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, kThreads, smem_bytes) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

extern "C" const char* rowlane_backup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
