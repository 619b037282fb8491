// 6-D coupled-lane Bellman backup for Hopper (sm_90a).
//
// Replaces the TPU kernel ocdp_tpu/ops/pallas_backup6.py::PallasBackup6D.
// _kernel in its coupled-lane branch (the joint lane-combo weights and
// accumulate), followed by _action_phase_factorized (or
// _action_phase_generic when the actions do not factor digit by digit) and
// the after-argmin cost add, on non-flat plans: the full 6-D attitude solve.
// The state grid splits into 3 ROW axes (next state depends on the action;
// attitude: omega1..3) and 3 LANE axes (next state does not, but couples
// across the lane axes and the row; attitude: yaw, pitch, roll through the
// quaternion step). The value table is the (NW, NE) matrix V[row][lane],
// lanes c = (i3 * n4 + i4) * n5 + i5. Per cell (r, c):
//
//   W_e   = (w0[t0](r, c) * w1[t1](r, c)) * w2[t2](r, c)        lane combo e
//   A_j   = sum_e W_e * V[r + D_j][c + dl_e]                     row combo j
//   factorized (A = m^3, row axis k's plan depends on action digit k only):
//     B[t0,t1,d2] = sum_{t2} ww2[t2](r, d2) * A_(t0,t1,t2)
//     C[t0,d1,d2] = sum_{t1} ww1[t1](r, d1 m) * B[t0,t1,d2]
//     tot_a       = sum_{t0} ww0[t0](r, d0 m^2) * C[t0,d1,d2],  a = (d0 m + d1) m + d2
//   generic:
//     tot_a       = sum_j ((ww0[t0_j] * ww1[t1_j]) * ww2[t2_j])(r, a) * A_j
//   tot_a (+ c_act[a] when it is not 0) (+ c_rowact[r][a])
//   V'[r][c] = ((min_a tot_a) + c_row[r]) + c_lane[c] + (c_rowlane[r][c] or 0)
//
// with e over the live lane combos and j over the live row combos, both in
// sorted tap order, (D_j, dl_e) their flat row and lane shifts, and every
// tap weight (off == t ? 1 - f : 0) + (off == t - 1 ? f : 0), as at
// pallas_backup6.py:1044, 1168. A sum skips a combo that is not live and
// starts from its first term. A read of V outside the table (a row outside
// [0, NW), a lane outside [0, NE)) is 0.0; such terms always carry an
// exactly zero weight, because a live tap keeps every coordinate in range,
// and they are summed all the same, as the plain version sums them. The TPU
// kernel reaches the same zero-weight terms through lane rolls that wrap.
//
// Arithmetic, bitwise equal to ocdp_tpu_torch/ops/backup6d.py::
// backup6d_plain: every product and sum is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts into an FMA,
// in the plain version's order and association.
//
// Minimum and ties: the running minimum starts at action 0's total and a
// later action wins only when strictly smaller (better = tot < best), the
// chain of both action phases. A NaN total at action 0 therefore stays, and
// a later NaN never wins; the plain version runs the same chain.
//
// Layout and what bounds it. Per cell the lane phase makes 27 x 27 = 729
// table reads and about 2e3 FP32 operations, each a separately rounded
// __fmul_rn/__fadd_rn that nvcc never contracts into an FMA, so the real
// arithmetic ceiling is half the card's FMA-counted FP32 rate. The first
// kernel (one thread a cell over the flat cells) sent every read to L1/L2
// and ran at 43-50x its bound. Here a block owns a tile of R consecutive
// output rows x L consecutive lanes (the host planner,
// ops/backup6d.py::plan_tiles, picks R, L and the block size and hands the
// kernel its index map as a Tiles) and first stages in dynamic shared
// memory every table row its cells read, over the lanes [c0 - reach_lo,
// c0 + L + reach_hi), with cp.async (16-byte chunks where the table's rows
// are 4-lane aligned). The row shifts are D = (t0 * n_r1 + t1) * n_r2 +
// t2, so for each live (t0, t1) the tile's rows read one run of R + (t2
// span) consecutive table rows: the stage holds at most 9 such row groups,
// about 9 (R + 2) rows for 27 R combo rows. A stage entry outside the table
// (a row outside [0, n_table_rows), a lane outside [0, NE)) is zero-filled
// by the copy itself (src-size 0): exactly the 0.0 the plain version reads
// there, under a zero weight. Beside the rows, the block forms each tile
// row's factorized row tap weights once (27 a row). Then each thread takes
// the tile's cells in turn: its 9 lane tap weights once, each joint weight
// once, and all 729 terms from the stage, every cube slot summed without a
// branch on its liveness (a dead slot reads a stage entry and is never
// used), each sum started at -0.0 (-0 + x == x, so the first term stands
// as the plain version's). Blocks run row tiles fastest (blockIdx.x), so
// the blocks in flight share their staged rows in L2 even where the table
// (442 MB at 30^3 x 16^3) is far larger than L2. The planner sizes a stage
// for two resident blocks of 256 threads an SM, or one of 512 where a wide
// lane reach needs the whole SM (__launch_bounds__ caps the registers at
// 128 for either), so one block's copies overlap the other's arithmetic.
// What bounds it now (measured on an H100, PERF.md §6): not the stage
// reads (half of them cost 7%) but the instruction stream of the unfused
// arithmetic, about 3 instructions a term, and the action phase (about 40%
// of a sweep), at 16 warps an SM; more warps did not help. Cells are
// addressed with 64-bit offsets (row tile, lane tile), so a grid may pass
// 2^31 cells.
//
// The envelope modes (B.4, B.5) are instantiations of the same kernel:
//
// * B.4 replaces the same _kernel in its envelope modes on flat plans
//   (PallasBackup6D.flat, the uint8 argmin_dtype at :1195, track_argmin=
//   False at :1235/:1324, padded carry at :914-947). The lane plan inputs
//   are (NW, NE) views of the flat plan; the argmin is written as int32 or
//   uint8 (ArgT); a min-only sweep (kTrack false) keeps the same strict-'<'
//   running minimum and writes an all-zero argmin; the wrapper hands the
//   kernel output buffers that the engine allocated once ("carry"). Reads
//   outside the table are already 0.0 here, so nothing is padded or
//   carried but the two tables. Bytes: 4 (table) + 24 (lane plan) + 4 + 1
//   (outputs) per cell; past the 50 MB L2 the table's row windows come from
//   device memory, as the TPU kernel's table_hbm/win_dma windows did.
// * B.5 replaces the lane-recompute mode (LaneRecompute :102,
//   RecomputePlan :158, _affine_locate :78, the recompute branch
//   :1003-1036, ops/kernelmath.py): no lane plan exists; each thread reads
//   the three omegas of its row and the four kirk-q components of its lane,
//   runs the quaternion Euler step, renormalization and Euler readback
//   (ocdp_tpu_torch/ops/kernelmath.py::quat_step_readback with atan2_f32 /
//   asin_f32) and the affine locate of each Euler axis once, before the
//   lane phase. Every operation is an explicitly rounded intrinsic
//   (__fdiv_rn and __fsqrt_rn included) in the plain version's order, with
//   floorf and fminf/fmaxf clamps and float32-rounded constants, so the
//   recomputed (off, frac) equal the plain version's bit for bit. Bytes:
//   9 per cell; the recompute adds about 200 FP32 operations per cell.
//
// B.7, the modes of the row-sharded engines (ocdp_tpu_torch/parallel/
// halo6.py), are one more parameter of the same kernel, a Block:
//
// * row-block mode replaces the row-block layout of the same _kernel
//   (row_pad_to :750-757, pad_top/pad_bot :910-931, _sweep_padded :1390, as
//   parallel/halo6.py::_build_rowsharded drives it). The kernel writes one
//   rank's output rows [r0, r1) of the global table and reads a local table
//   of lo + (r1 - r0) + hi rows that starts lo rows above r0: output row r
//   reads table row r + lo + D_j, and a table row outside [0, lo + (r1 - r0)
//   + hi) reads 0.0. The per-row inputs (row plan, lane plan or the rows'
//   omegas, c_row, c_rowact, c_rowlane) are the block's own rows; the
//   per-lane ones stay whole. lo = max(-min D_j, 0) and hi = max(max D_j,
//   0) are the exact reach of the live row combos; the halo rows of an edge
//   rank are zeros, which is what the one-device kernel reads outside
//   [0, NW), so every term, and so every result, is the one-device kernel's.
// * action-slice mode replaces digit_slice (:696-724): the kernel takes the
//   full-width row plan and costs and an action range [a_lo, a_hi), and
//   returns the first minimum over that range as a global action index.
//   When the actions factor (A = m^3) and the range is whole fixed-d0 slices
//   of m^2 actions, the factorized phase runs for those d0 only: its B and C
//   partials depend on digits 1-2 alone, so each action's total is the one
//   the full sweep forms, bit for bit. Otherwise the generic phase runs over
//   the range, which is also each action's own full-sweep total when the
//   full sweep is generic. The engines combine the ranges by the first
//   minimum in ascending order, so the combined argmin is the full sweep's.
//
// The cube body. At the attitude solve's tap structure (3 live taps (-1, 0,
// 1) on every row and lane axis, all 27 row and 27 lane combos, digit base 3)
// a tracking sweep of the whole table over every action, in any of the modes
// above (stored or recomputed lanes, int32 or uint8 argmin; the host's
// planner picks it from the inputs, ops/backup6d.py::cube_body), runs one
// body compiled for that structure: no liveness, digit or tap test, no pick
// and no loop bound is left to run time. Its two entries differ only in the
// prologue that forms the lane tap weights: backup6d_sweep_cube loads the
// stored lane plan, and backup6d_sweep_recompute_cube recomputes the Euler
// lanes (the lane's four kirk-q loads and its index on each Euler axis once
// for the thread's cells, then each row's omegas and recompute_lanes'
// operations in its order). A thread takes two cells, tile rows k and k + 1
// at one lane. Row combo (i0, i1, i2) of tile row k reads the stage row k +
// i2 of its (i0, i1) row group, so for each lane combo the two cells' six
// rows come from four stage rows, and each (t0, t1) lane pair's three t2
// lanes are three adjacent columns: 12 stage reads serve 18 terms. The stage
// rows' addresses sit in registers and each group's and lane pair's offset is
// warp-uniform, so a read is one LDS. The lane phase loops over t0 (its
// weights shifted a step a pass) and is straight-line over (t1, t2) and the 9
// row groups; the action phase (B, C and the 27 totals on registers, then the
// strict-'<' first minimum) is straight-line per cell. Sums, their order and
// their -0.0 starts are backup6d_sweep's. What bounds it (measured on an
// H100, PERF.md §6): its instruction stream, about 3,000 instructions a cell,
// three quarters of them the separately rounded products and sums (without
// its action phase it is 19% faster, with half its stage reads 3%), at 123
// registers and two blocks of 256 an SM; 0.188 ms a reference sweep against
// backup6d_sweep's 0.321, and with the lanes recomputed 15.7 ms a sweep at
// 48^3 x 10^3 against backup6d_sweep's 25.7. Its tiles are whole two-row
// chunks, planned over whole rounds of the card's resident blocks
// (ops/backup6d.py::plan_tiles).
//
// Two kernels take the tap structures. backup6d_sweep, every mode above,
// takes at most 3 live taps an axis (kMaxTaps): its row combos are the slots
// of a 3 x 3 x 3 cube, summed without a branch, and its weights sit in
// registers. backup6d_wide takes any taps an axis up to kWideCombos = 40
// live row combos and 40 live lane combos, the TPU kernel's max_flat_taps
// (pallas_backup6.py:478, checked at :732-736): a lighter roll axis or an
// asymmetric rate range gives a 4 x 3 x 3 row structure (36 combos at
// AttitudeConfig(n_mesh_w=15, h=0.02, w_min_deg=-50, w_max_deg=30,
// inertia_diag=(0.0225, ...))). It runs the same modes (the <ArgT, kTrack,
// kRecompute> instantiations, B.7's Block) and the same sums in the same
// order, by combo instead of by cube slot: the lane phase sums its A_j in a
// register array of 40 that its unrolled combo loop indexes with
// constants, each lane combo's joint weight formed from its three tap
// weights where it is used (no register array of every tap); the action
// phases walk the sorted row combos in a runtime loop, their code written
// once rather than once a combo (unrolled 40 times they make this source
// many times slower to build), reading A_j from a copy in local memory
// (160 B a thread, no spills). The factorized
// phase folds each (t0, t1) run into C and each t0 run into the totals at
// the run's last combo (the marks kOpen*/kClose*, set on the host), with
// each combo's nine row weights (w_k of its tap k and digit d) read from
// the stage, where the block formed them once a tile row. Its stage holds
// up to 40 row groups. It is slower per term than backup6d_sweep and
// right: the host picks it only for a plan backup6d_sweep does not take
// (ops/backup6d.py::TilePlan.wide).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxTaps = 3;       // MAX_TAPS in ops/backup6d.py
constexpr int kCube = kMaxTaps * kMaxTaps * kMaxTaps;
constexpr int kMaxLaneCombos = kCube;
constexpr int kMaxActions = 64;   // MAX_ACTIONS
constexpr int kMaxDigits = 3;     // MAX_DIGITS
constexpr int kMaxGroups = kMaxTaps * kMaxTaps;  // live (t0, t1) pairs
constexpr int kMaxThreads = 512;  // threads of a block (TilePlan.threads)
constexpr int kRowWeights = 3 * kMaxTaps * kMaxDigits;  // ROW_WEIGHTS
// backup6d_wide: live row and lane combos (MAX_COMBOS), a row combo's
// factorized weights (3 axes x kMaxDigits; COMBO_WEIGHTS), the totals of
// the factorized phase (kMaxDigits^3)
constexpr int kWideCombos = 40;
constexpr int kComboWeights = 3 * kMaxDigits;
constexpr int kDigitCube = kMaxDigits * kMaxDigits * kMaxDigits;

// The tap structure, passed by value (it lives in the constant bank).
struct Taps6 {
  int n_row_taps[3];
  int row_taps[3][kMaxTaps];      // live taps of each row axis, ascending
  int row_live;                   // bit (i0 * 3 + i1) * 3 + i2: combo live
  int row_delta[kCube];           // flat row shift of cube slot p
  int n_lane_combos;
  int lane_taps[3][kMaxTaps];     // live taps of each lane axis
  int lane_idx[kMaxLaneCombos][3];  // live lane combos (sorted) as indices
                                    // into lane_taps
  int lane_delta[kMaxLaneCombos];   // flat lane shift of lane combo e
  int digits;                     // action digit base m, 0: generic phase
  float c_act[kMaxActions];       // per-action cost
  float c_act_q[kCube];           // c_act of action (d0, d1, d2) at slot
                                  // (d0 * 3 + d1) * 3 + d2 (digits > 0)
};

__device__ __forceinline__ float tap_weight(int off, float f, int t) {
  return __fadd_rn(off == t ? __fsub_rn(1.0f, f) : 0.0f,
                   off == t - 1 ? f : 0.0f);
}

__device__ __forceinline__ bool live(const Taps6& tp, int p) {
  return (tp.row_live >> p) & 1;
}

// B.5's lane generators (ops/backup6d.py::LaneRecompute): per-row omegas,
// per-lane kirk-q components, and each Euler axis's affine locate.
struct LaneRec {
  const float* w[3];      // (NW,) omega1..3 of each row
  const float* q[4];      // (NE,) kirk q1..q4 of each lane
  float start[3];         // float32 first grid point of each Euler axis
  float inv_step[3];      // float32 1 / spacing
  float top[3];           // n_k - 2, the last cell
  int size[3];            // n_k
  int stride[3];          // flat lane stride of axis k
  float half_h;           // float32(h * 0.5)
  int clamp;              // edge='clamp': fracs clipped to [0, 1]
};

// B.7: the output rows' frame in the table and the action range.
struct Block {
  int n_table_rows;       // rows of the table the kernel reads
  int table_row0;         // the table row of output row 0 (the halo above)
  int a_lo, a_hi;         // the actions [a_lo, a_hi) the minimum runs over
};

// A block's tile and its stage (ops/backup6d.py::plan_tiles): output rows
// [r0, r0 + rows) and lanes [c0, c0 + lanes), r0 = blockIdx.x * rows, c0 =
// blockIdx.y * lanes. Stage row g_slot[g] + i holds table row r0 +
// table_row0 + g_delta[g] + i over the lanes [c0 - reach_lo, c0 - reach_lo
// + width); row combo p of tile row rr reads stage row p's slot + rr, at
// byte offset row_base[p] + 4 * rr * width. After the table rows, the
// factorized phase's row tap weights of each tile row: kRowWeights floats,
// w_k[i][d] of row axis k, tap i, digit d at (k * 3 + i) * 3 + d.
struct Tiles {
  int rows, lanes;
  int reach_lo, width;
  int weights_at;         // the rows' tap weights: stage + weights_at
  int vec4;               // copy in 16-byte chunks (aligned, NE % 4 == 0)
  int n_groups;
  int g_delta[kMaxGroups], g_rows[kMaxGroups], g_slot[kMaxGroups];
  int row_base[kCube];    // byte offset of combo p's tile row 0 in the stage
};

// backup6d_wide's tap structure (constant bank): the live row and lane
// combos in sorted tap order, each by its own taps.
struct TapsW {
  int n_row_combos;
  int row_tap[kWideCombos][3];   // the taps of row combo j
  int row_mark[kWideCombos];     // kOpen*/kClose* of combo j
  int n_lane_combos;
  int lane_tap[kWideCombos][3];  // the taps of lane combo e
  int lane_delta[kWideCombos];   // its flat lane shift
  int digits;                    // action digit base m, 0: generic phase
  float c_act[kMaxActions];
  float c_act_q[kDigitCube];     // c_act of (d0, d1, d2) at (d0 * 3 + d1) *
                                 // 3 + d2 (digits > 0)
};

// The factorized phase's run marks of a sorted row combo j: it opens or
// closes its (t0, t1) run, its run is the first of its t0 (the C sums start
// there), it closes its t0 run, its t0 is the first (the totals start).
constexpr int kOpenPair = 1, kClosePair = 2, kOpenT0 = 4, kCloseT0 = 8,
              kFirstT0 = 16;

// backup6d_wide's tile: Tiles with up to kWideCombos row groups, each row
// combo's stage offset by combo, and row_weights (kComboWeights a row
// combo) a tile row after the table rows.
struct TilesW {
  int rows, lanes;
  int reach_lo, width;
  int weights_at;
  int vec4;
  int n_groups;
  int row_weights;
  int g_delta[kWideCombos], g_rows[kWideCombos], g_slot[kWideCombos];
  int row_base[kWideCombos];  // byte offset of row combo j's tile row 0
};

// ops/kernelmath.py, op by op (Cephes atanf); constants are the float32
// roundings of the same double values the plain version rounds.
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kPi2 = static_cast<float>(3.14159265358979323846 / 2.0);
constexpr float kPi4 = static_cast<float>(3.14159265358979323846 / 4.0);
constexpr float kTan3Pi8 = static_cast<float>(2.414213562373095);
constexpr float kTanPi8 = static_cast<float>(0.4142135623730950);
constexpr float kTiny = static_cast<float>(1e-30);
constexpr float kP0 = static_cast<float>(8.05374449538e-2);
constexpr float kP1 = static_cast<float>(1.38776856032e-1);
constexpr float kP2 = static_cast<float>(1.99777106478e-1);
constexpr float kP3 = static_cast<float>(3.33329491539e-1);

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

__device__ __forceinline__ float atan_f32(float x) {
  const float sign = x < 0.0f ? -1.0f : 1.0f;
  const float ax = fabsf(x);
  const bool big = ax > kTan3Pi8;
  const bool mid = ax > kTanPi8;
  const float safe = fmaxf(ax, kTiny);
  const float z = big ? __fdiv_rn(-1.0f, safe)
                      : (mid ? __fdiv_rn(__fsub_rn(ax, 1.0f),
                                         __fadd_rn(ax, 1.0f))
                             : ax);
  const float y0 = big ? kPi2 : (mid ? kPi4 : 0.0f);
  const float z2 = sq(z);
  const float p = __fsub_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(z2, kP0), kP1), z2),
                          kP2),
                z2),
      kP3);
  const float core = __fadd_rn(__fmul_rn(__fmul_rn(p, z2), z), z);
  return __fmul_rn(sign, __fadd_rn(y0, core));
}

__device__ __forceinline__ float atan2_f32(float y, float x) {
  const float safe_x = x == 0.0f ? 1.0f : x;
  const float base = atan_f32(__fdiv_rn(y, safe_x));
  const float ysign = y < 0.0f ? -1.0f : 1.0f;
  const float out = x > 0.0f ? base : __fadd_rn(base, __fmul_rn(ysign, kPi));
  const float out_x0 = y == 0.0f ? 0.0f : __fmul_rn(ysign, kPi2);
  return x == 0.0f ? out_x0 : out;
}

__device__ __forceinline__ float asin_f32(float x) {
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  return atan2_f32(x, __fsqrt_rn(fmaxf(__fsub_rn(1.0f, sq(x)), 0.0f)));
}

// _affine_locate: t = (coord - start) * (1 / step), lo = clip(floor(t)),
// frac = t - lo; then the offset from the lane's own index own on the axis
__device__ __forceinline__ void locate(const LaneRec& rec, int k, float coord,
                                       int own, int& off, float& frac) {
  const float t = __fmul_rn(__fsub_rn(coord, rec.start[k]), rec.inv_step[k]);
  const float lo = fminf(fmaxf(floorf(t), 0.0f), rec.top[k]);
  frac = __fsub_rn(t, lo);
  if (rec.clamp) frac = fminf(fmaxf(frac, 0.0f), 1.0f);
  off = static_cast<int>(lo) - own;
}

// The lane's share of the recompute: lane c's kirk-q components and its
// index on each Euler axis
__device__ __forceinline__ void lane_inputs(const LaneRec& rec, int c,
                                            float (&q)[4], int (&own)[3]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = rec.q[k][c];
#pragma unroll
  for (int k = 0; k < 3; ++k) own[k] = (c / rec.stride[k]) % rec.size[k];
}

// kernelmath.quat_step_readback(h, q, w1, w2, w3, atan2_f32, asin_f32)
// followed by the locate of each Euler axis, for a row's omegas and a
// lane's lane_inputs
__device__ __forceinline__ void cell_lanes(const LaneRec& rec, float w1,
                                           float w2, float w3,
                                           const float (&q)[4],
                                           const int (&own)[3], int (&o)[3],
                                           float (&f)[3]) {
  const float q1 = q[0], q2 = q[1], q3 = q[2], q4 = q[3];
  const float h2 = rec.half_h;
  const float a1 = __fadd_rn(
      q1, __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(w3, q2), __fmul_rn(w2, q3)),
                              __fmul_rn(w1, q4)),
                    h2));
  const float a2 = __fadd_rn(
      q2, __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(-w3, q1), __fmul_rn(w1, q3)),
                              __fmul_rn(w2, q4)),
                    h2));
  const float a3 = __fadd_rn(
      q3, __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(w2, q1), __fmul_rn(w1, q2)),
                              __fmul_rn(w3, q4)),
                    h2));
  const float a4 = __fadd_rn(
      q4, __fmul_rn(__fsub_rn(__fsub_rn(__fmul_rn(-w1, q1), __fmul_rn(w2, q2)),
                              __fmul_rn(w3, q3)),
                    h2));
  const float norm =
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fadd_rn(sq(a1), sq(a2)), sq(a3)), sq(a4)));
  const float n1 = __fdiv_rn(a1, norm), n2 = __fdiv_rn(a2, norm),
              n3 = __fdiv_rn(a3, norm), n4 = __fdiv_rn(a4, norm);
  const float yaw = atan2_f32(
      __fmul_rn(__fadd_rn(__fmul_rn(n3, n2), __fmul_rn(n4, n1)), 2.0f),
      __fsub_rn(__fsub_rn(__fadd_rn(sq(n4), sq(n3)), sq(n2)), sq(n1)));
  const float pitch = asin_f32(fminf(
      fmaxf(__fmul_rn(__fsub_rn(__fmul_rn(n3, n1), __fmul_rn(n4, n2)), -2.0f),
            -1.0f),
      1.0f));
  const float roll = atan2_f32(
      __fmul_rn(__fadd_rn(__fmul_rn(n2, n1), __fmul_rn(n4, n3)), 2.0f),
      __fadd_rn(__fsub_rn(__fsub_rn(sq(n4), sq(n3)), sq(n2)), sq(n1)));
  locate(rec, 0, yaw, own[0], o[0], f[0]);
  locate(rec, 1, pitch, own[1], o[1], f[1]);
  locate(rec, 2, roll, own[2], o[2], f[2]);
}

// The recompute of cell (r, c)
__device__ __forceinline__ void recompute_lanes(const LaneRec& rec, int r,
                                                int c, int& o0, int& o1,
                                                int& o2, float& f0,
                                                float& f1, float& f2) {
  float q[4];
  int own[3], o[3];
  float f[3];
  lane_inputs(rec, c, q, own);
  cell_lanes(rec, rec.w[0][r], rec.w[1][r], rec.w[2][r], q, own, o, f);
  o0 = o[0], o1 = o[1], o2 = o[2];
  f0 = f[0], f1 = f[1], f2 = f[2];
}

// w[i] for a tap index i uniform across the warp (no local memory)
__device__ __forceinline__ float pick(const float (&w)[kMaxTaps], int i) {
  return i == 0 ? w[0] : (i == 1 ? w[1] : w[2]);
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

// Stage every table row the tile of output rows [r0, r0 + tl.rows) reads,
// zero outside the table: in 16-byte chunks where the rows and the window
// are 4-lane aligned (a chunk then lies wholly inside or outside the
// table), else by lane. lane0: the table lane of stage column 0. The
// caller waits for the copies (cp.async.wait_all).
template <typename TilesT>
__device__ __forceinline__ void stage_tile(float* stage,
                                           const float* __restrict__ values,
                                           const TilesT& tl, const Block& blk,
                                           int r0, int lane0, int n_lanes) {
  for (int g = 0; g < tl.n_groups; ++g) {
    for (int i = 0; i < tl.g_rows[g]; ++i) {
      const int tr = r0 + blk.table_row0 + tl.g_delta[g] + i;
      const bool row_in = tr >= 0 && tr < blk.n_table_rows;
      const float* src = values + static_cast<long long>(row_in ? tr : 0) *
                                      n_lanes;
      float* dst = stage + (tl.g_slot[g] + i) * tl.width;
      if (tl.vec4) {
        for (int j = 4 * threadIdx.x; j < tl.width; j += 4 * blockDim.x) {
          const int c = lane0 + j;
          const bool ok = row_in && c >= 0 && c < n_lanes;
          stage_copy16(dst + j, ok ? src + c : values, ok);
        }
      } else {
        for (int j = threadIdx.x; j < tl.width; j += blockDim.x) {
          const int c = lane0 + j;
          const bool ok = row_in && c >= 0 && c < n_lanes;
          stage_copy(dst + j, ok ? src + c : values, ok);
        }
      }
    }
  }
}

template <typename ArgT, bool kTrack, bool kRecompute>
__global__ void __launch_bounds__(kMaxThreads)
backup6d_sweep(const float* __restrict__ values,
               const int* __restrict__ row_off,
               const float* __restrict__ row_frac,
               const int* __restrict__ lane_off0,
               const float* __restrict__ lane_frac0,
               const int* __restrict__ lane_off1,
               const float* __restrict__ lane_frac1,
               const int* __restrict__ lane_off2,
               const float* __restrict__ lane_frac2,
               const float* __restrict__ c_row,
               const float* __restrict__ c_lane,
               const float* __restrict__ c_rowact,
               const float* __restrict__ c_rowlane,
               float* __restrict__ out_v, ArgT* __restrict__ out_a,
               int n_rows, int n_lanes, int n_actions,
               const __grid_constant__ Taps6 tp,
               const __grid_constant__ LaneRec rec, const Block blk,
               const __grid_constant__ Tiles tl) {
  extern __shared__ __align__(16) float stage[];
  const int r0 = blockIdx.x * tl.rows;
  const int c0 = blockIdx.y * tl.lanes;
  const int lane0 = c0 - tl.reach_lo;     // the table lane of stage column 0

  stage_tile(stage, values, tl, blk, r0, lane0, n_lanes);
  // the factorized phase's row tap weights of each tile row, once a block
  float* row_w = stage + tl.weights_at;
  const long long plane = static_cast<long long>(n_rows) * n_actions;
  if (tp.digits > 0) {
    const int m = tp.digits;
    for (int j = threadIdx.x; j < tl.rows * kRowWeights; j += blockDim.x) {
      const int rr = j / kRowWeights, k = (j / 9) % 3, i = (j / 3) % 3;
      const int d = j % 3, r = r0 + rr;
      float w = 0.0f;
      if (r < n_rows && d < m && i < tp.n_row_taps[k]) {
        // the canonical action of digit d on axis k
        const int a = k == 0 ? d * m * m : (k == 1 ? d * m : d);
        const long long at =
            k * plane + static_cast<long long>(r) * n_actions + a;
        w = tap_weight(row_off[at], row_frac[at], tp.row_taps[k][i]);
      }
      row_w[j] = w;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  for (int i = threadIdx.x; i < tl.rows * tl.lanes; i += blockDim.x) {
    const int rr = i / tl.lanes;
    const int cl = i - rr * tl.lanes;
    const int r = r0 + rr;
    const int c = c0 + cl;
    if (r >= n_rows || c >= n_lanes) continue;
    const long long cell = static_cast<long long>(r) * n_lanes + c;
    int o0, o1, o2;
    float f0, f1, f2;
    if constexpr (kRecompute) {
      recompute_lanes(rec, r, c, o0, o1, o2, f0, f1, f2);
    } else {
      o0 = lane_off0[cell], o1 = lane_off1[cell], o2 = lane_off2[cell];
      f0 = lane_frac0[cell], f1 = lane_frac1[cell], f2 = lane_frac2[cell];
    }

    // lane phase: A[p] for each row combo (cube slot p), summed over the
    // lane combos in order from the stage. Each sum starts at -0.0, which
    // adds to its first term exactly (-0 + x == x); each tap weight and
    // each joint weight is formed once for all p. Every slot p is summed,
    // with no branch on its liveness: a slot that is not live reads the
    // stage at offset 0 from the cell's column and is never used.
    float ew[3][kMaxTaps];
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) {
      ew[0][i] = tap_weight(o0, f0, tp.lane_taps[0][i]);
      ew[1][i] = tap_weight(o1, f1, tp.lane_taps[1][i]);
      ew[2][i] = tap_weight(o2, f2, tp.lane_taps[2][i]);
    }
    const char* cell_stage = reinterpret_cast<const char*>(
        stage + rr * tl.width + cl + tl.reach_lo);
    float A[kCube];
#pragma unroll
    for (int p = 0; p < kCube; ++p) A[p] = -0.0f;
    for (int e = 0; e < tp.n_lane_combos; ++e) {
      const float w = __fmul_rn(
          __fmul_rn(pick(ew[0], tp.lane_idx[e][0]),
                    pick(ew[1], tp.lane_idx[e][1])),
          pick(ew[2], tp.lane_idx[e][2]));
      const char* col = cell_stage + 4 * tp.lane_delta[e];
#pragma unroll
      for (int p = 0; p < kCube; ++p) {
        const float v = *reinterpret_cast<const float*>(col + tl.row_base[p]);
        A[p] = __fadd_rn(A[p], __fmul_rn(w, v));
      }
    }

    const int* off_r = row_off + static_cast<long long>(r) * n_actions;
    const float* frac_r = row_frac + static_cast<long long>(r) * n_actions;
    const float* rowact_r =
        c_rowact != nullptr ? c_rowact + static_cast<long long>(r) * n_actions
                            : nullptr;
    float best = 0.0f;
    int best_a = 0;

    if (tp.digits > 0) {
      // factorized action phase over the whole d0 slices [d0_lo, d0_hi); the
      // totals sit in tot[(d0 * 3 + d1) * 3 + d2]
      const int m = tp.digits;
      const int d0_lo = blk.a_lo / (m * m), d0_hi = blk.a_hi / (m * m);
      const float* w_r = row_w + rr * kRowWeights;
      float w1[kMaxTaps][kMaxDigits], w2[kMaxTaps][kMaxDigits];
#pragma unroll
      for (int i = 0; i < kMaxTaps; ++i) {
#pragma unroll
        for (int d = 0; d < kMaxDigits; ++d) {
          w1[i][d] = w_r[(3 + i) * 3 + d];
          w2[i][d] = w_r[(6 + i) * 3 + d];
        }
      }
      float tot[kCube];
#pragma unroll
      for (int q = 0; q < kCube; ++q) tot[q] = 0.0f;
#pragma unroll
      for (int i0 = 0; i0 < kMaxTaps; ++i0) {
        if (i0 < tp.n_row_taps[0]) {
          float B[kMaxTaps][kMaxDigits];
          bool has_b[kMaxTaps];
#pragma unroll
          for (int i1 = 0; i1 < kMaxTaps; ++i1) {
            has_b[i1] = ((tp.row_live >> ((i0 * 3 + i1) * 3)) & 7) != 0;
#pragma unroll
            for (int d2 = 0; d2 < kMaxDigits; ++d2) {
              float acc = 0.0f;
              bool have = false;
#pragma unroll
              for (int i2 = 0; i2 < kMaxTaps; ++i2) {
                const int p = (i0 * 3 + i1) * 3 + i2;
                if (d2 < m && live(tp, p)) {
                  const float term = __fmul_rn(w2[i2][d2], A[p]);
                  acc = have ? __fadd_rn(acc, term) : term;
                  have = true;
                }
              }
              B[i1][d2] = acc;
            }
          }
#pragma unroll
          for (int d1 = 0; d1 < kMaxDigits; ++d1) {
#pragma unroll
            for (int d2 = 0; d2 < kMaxDigits; ++d2) {
              if (d1 < m && d2 < m) {
                float cc = 0.0f;
                bool have = false;
#pragma unroll
                for (int i1 = 0; i1 < kMaxTaps; ++i1) {
                  if (has_b[i1]) {
                    const float term = __fmul_rn(w1[i1][d1], B[i1][d2]);
                    cc = have ? __fadd_rn(cc, term) : term;
                    have = true;
                  }
                }
#pragma unroll
                for (int d0 = 0; d0 < kMaxDigits; ++d0) {
                  if (d0 >= d0_lo && d0 < d0_hi) {
                    const float term = __fmul_rn(w_r[i0 * 3 + d0], cc);
                    const int q = (d0 * 3 + d1) * 3 + d2;
                    tot[q] = i0 == 0 ? term : __fadd_rn(tot[q], term);
                  }
                }
              }
            }
          }
        }
      }
      // strict-'<' first minimum over a = (d0 * m + d1) * m + d2, ascending
#pragma unroll
      for (int d0 = 0; d0 < kMaxDigits; ++d0) {
#pragma unroll
        for (int d1 = 0; d1 < kMaxDigits; ++d1) {
#pragma unroll
          for (int d2 = 0; d2 < kMaxDigits; ++d2) {
            if (d0 >= d0_lo && d0 < d0_hi && d1 < m && d2 < m) {
              const int a = (d0 * m + d1) * m + d2;
              const int q = (d0 * 3 + d1) * 3 + d2;
              float t = tot[q];
              if (tp.c_act_q[q] != 0.0f) t = __fadd_rn(t, tp.c_act_q[q]);
              if (rowact_r != nullptr) t = __fadd_rn(t, rowact_r[a]);
              // strict: the first minimum wins
              if (a == blk.a_lo || t < best) {
                best = t;
                if (kTrack) best_a = a;
              }
            }
          }
        }
      }
    } else {
      // generic action phase: every live row combo per action
      for (int a = blk.a_lo; a < blk.a_hi; ++a) {
        float w[3][kMaxTaps];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int o = off_r[k * plane + a];
          const float g = frac_r[k * plane + a];
#pragma unroll
          for (int i = 0; i < kMaxTaps; ++i) {
            w[k][i] = i < tp.n_row_taps[k]
                          ? tap_weight(o, g, tp.row_taps[k][i])
                          : 0.0f;
          }
        }
        float t = 0.0f;
        bool have = false;
#pragma unroll
        for (int p = 0; p < kCube; ++p) {
          if (live(tp, p)) {
            const float ww = __fmul_rn(
                __fmul_rn(w[0][p / 9], w[1][(p / 3) % 3]), w[2][p % 3]);
            const float term = __fmul_rn(ww, A[p]);
            t = have ? __fadd_rn(t, term) : term;
            have = true;
          }
        }
        if (tp.c_act[a] != 0.0f) t = __fadd_rn(t, tp.c_act[a]);
        if (rowact_r != nullptr) t = __fadd_rn(t, rowact_r[a]);
        if (a == blk.a_lo || t < best) {  // strict: the first minimum wins
          best = t;
          if (kTrack) best_a = a;
        }
      }
    }
    float out = __fadd_rn(__fadd_rn(best, c_row[r]), c_lane[c]);
    out = __fadd_rn(out, c_rowlane != nullptr ? c_rowlane[cell] : 0.0f);
    out_v[cell] = out;
    out_a[cell] = static_cast<ArgT>(best_a);   // 0 in a min-only sweep
  }
}

// The cube body for the attitude solve's own tap structure (see the head of
// this file). Thread (q, cl) of a tile takes the kCubeCells cells of tile
// rows q kCubeCells + k at lane cl. Its lane phase runs over the lane taps
// t0 in a loop and is one straight line over the (t1, t2) lane taps and
// the 9 (i0, i1) row groups; its action phase is one straight line per
// cell. ArgT: the argmin's type; kRowAct: c_rowact is given; kRecompute:
// the prologue recomputes the Euler lanes from rec (the lane plan's
// pointers are null), else it loads the stored lane plan (rec is unused).
// tp.c_act holds -0.0 where the action cost is 0, so that the add is
// unconditional and exact (x + -0.0 == x for every x, as the plain
// version's skipped add).
constexpr int kCubeCells = 2;                // CUBE_CELLS in ops/backup6d.py
constexpr int kCubeThreads = 256;            // CUBE_THREADS
constexpr int kCubeRows = kCubeCells + 2;    // stage rows a group reads

template <typename ArgT, bool kRowAct, bool kRecompute>
__device__ __forceinline__ void cube_sweep(
    const float* __restrict__ values, const int* __restrict__ row_off,
    const float* __restrict__ row_frac, const int* __restrict__ lane_off0,
    const float* __restrict__ lane_frac0, const int* __restrict__ lane_off1,
    const float* __restrict__ lane_frac1, const int* __restrict__ lane_off2,
    const float* __restrict__ lane_frac2, const float* __restrict__ c_row,
    const float* __restrict__ c_lane, const float* __restrict__ c_rowact,
    const float* __restrict__ c_rowlane, float* __restrict__ out_v,
    ArgT* __restrict__ out_a, int n_rows, int n_lanes, const Taps6& tp,
    const LaneRec& rec, const Tiles& tl) {
  extern __shared__ __align__(16) float stage[];
  const int r0 = blockIdx.x * tl.rows;
  const int c0 = blockIdx.y * tl.lanes;
  stage_tile(stage, values, tl, Block{n_rows, 0, 0, kCube}, r0,
             c0 - tl.reach_lo, n_lanes);
  // the row tap weights of each tile row: w_k[i][d] at (k * 3 + i) * 3 + d
  float* row_w = stage + tl.weights_at;
  const long long plane = static_cast<long long>(n_rows) * kCube;
  for (int j = threadIdx.x; j < tl.rows * kRowWeights; j += blockDim.x) {
    const int rr = j / kRowWeights, k = (j / 9) % 3, i = (j / 3) % 3;
    const int d = j % 3, r = r0 + rr;
    float w = 0.0f;
    if (r < n_rows) {
      const int a = k == 0 ? d * 9 : (k == 1 ? d * 3 : d);
      const long long at = k * plane + static_cast<long long>(r) * kCube + a;
      w = tap_weight(row_off[at], row_frac[at], i - 1);
    }
    row_w[j] = w;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int chunks = tl.rows / kCubeCells * tl.lanes;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int q = i / tl.lanes;
    const int cl = i - q * tl.lanes;
    const int rr0 = q * kCubeCells;
    const int c = c0 + cl;
    if (r0 + rr0 >= n_rows || c >= n_lanes) continue;

    // prologue: each cell's lane (off, frac), stored or recomputed (the
    // lane's kirk-q and own indices read and formed once for the chunk),
    // and its lane tap weights ew[k][axis][tap]; a cell past the table's
    // last row takes zeros and writes nothing
    [[maybe_unused]] float qv[4];
    [[maybe_unused]] int own[3];
    if constexpr (kRecompute) lane_inputs(rec, c, qv, own);
    float ew[kCubeCells][3][3];
#pragma unroll
    for (int k = 0; k < kCubeCells; ++k) {
      const int r = r0 + rr0 + k;
      int o[3] = {0, 0, 0};
      float f[3] = {0.0f, 0.0f, 0.0f};
      if (r < n_rows) {
        if constexpr (kRecompute) {
          cell_lanes(rec, rec.w[0][r], rec.w[1][r], rec.w[2][r], qv, own, o,
                     f);
        } else {
          const long long cell = static_cast<long long>(r) * n_lanes + c;
          o[0] = lane_off0[cell], o[1] = lane_off1[cell];
          o[2] = lane_off2[cell];
          f[0] = lane_frac0[cell], f[1] = lane_frac1[cell];
          f[2] = lane_frac2[cell];
        }
      }
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          ew[k][ax][t] = tap_weight(o[ax], f[ax], t - 1);
        }
      }
    }

    // lane phase: A[k][p] of cell k and row combo p = (i0 * 3 + i1) * 3 +
    // i2, summed over the lane combos e = (t0 * 3 + t1) * 3 + t2 in order,
    // each sum started at -0.0. Row group g = (i0, i1) stages its rows at
    // row_base[3 g] + 4 i2 width, so cell k's row i2 is the group's stage
    // row k + i2 from the chunk's first: one read serves each (k, i2) of
    // the same stage row. The stage rows' addresses stay in registers, the
    // group's and the lane pair's offsets are uniform.
    const char* rowp[kCubeRows];
#pragma unroll
    for (int s = 0; s < kCubeRows; ++s) {
      rowp[s] = reinterpret_cast<const char*>(
          stage + (rr0 + s) * tl.width + cl + tl.reach_lo);
    }
    float A[kCubeCells][kCube];
#pragma unroll
    for (int k = 0; k < kCubeCells; ++k) {
#pragma unroll
      for (int p = 0; p < kCube; ++p) A[k][p] = -0.0f;
    }
    float w0[kCubeCells][3];   // lane tap t0's weights, shifted a step a pass
#pragma unroll
    for (int k = 0; k < kCubeCells; ++k) {
#pragma unroll
      for (int t = 0; t < 3; ++t) w0[k][t] = ew[k][0][t];
    }
#pragma unroll 1
    for (int e0 = 0; e0 < 3; ++e0) {
#pragma unroll
      for (int e1 = 0; e1 < 3; ++e1) {
        const int e01 = e0 * 3 + e1;
        float W[kCubeCells][3];
#pragma unroll
        for (int k = 0; k < kCubeCells; ++k) {
          const float w01 = __fmul_rn(w0[k][0], ew[k][1][e1]);
#pragma unroll
          for (int t2 = 0; t2 < 3; ++t2) {
            W[k][t2] = __fmul_rn(w01, ew[k][2][t2]);
          }
        }
#pragma unroll
        for (int g = 0; g < 9; ++g) {
          const int off = tl.row_base[g * 3] + 4 * tp.lane_delta[e01 * 3 + 1];
          float v[kCubeRows][3];
#pragma unroll
          for (int s = 0; s < kCubeRows; ++s) {
#pragma unroll
            for (int t2 = 0; t2 < 3; ++t2) {
              v[s][t2] = *reinterpret_cast<const float*>(rowp[s] + off +
                                                         4 * (t2 - 1));
            }
          }
#pragma unroll
          for (int t2 = 0; t2 < 3; ++t2) {
#pragma unroll
            for (int k = 0; k < kCubeCells; ++k) {
#pragma unroll
              for (int i2 = 0; i2 < 3; ++i2) {
                float& a = A[k][g * 3 + i2];
                a = __fadd_rn(a, __fmul_rn(W[k][t2], v[k + i2][t2]));
              }
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kCubeCells; ++k) {
        w0[k][0] = w0[k][1];
        w0[k][1] = w0[k][2];
      }
    }

    // action phase of each cell: B over i2, C over i1, the totals over i0,
    // then the strict-'<' first minimum over a = (d0 * 3 + d1) * 3 + d2
#pragma unroll
    for (int k = 0; k < kCubeCells; ++k) {
      const int r = r0 + rr0 + k;
      if (r >= n_rows) break;
      const float* w_r = row_w + (rr0 + k) * kRowWeights;
      float tot[kCube];
#pragma unroll
      for (int i0 = 0; i0 < 3; ++i0) {
        float B[3][3], C[3][3];
#pragma unroll
        for (int i1 = 0; i1 < 3; ++i1) {
#pragma unroll
          for (int d2 = 0; d2 < 3; ++d2) {
            const int p = (i0 * 3 + i1) * 3;
            float acc = __fmul_rn(w_r[18 + d2], A[k][p]);
            acc = __fadd_rn(acc, __fmul_rn(w_r[21 + d2], A[k][p + 1]));
            B[i1][d2] = __fadd_rn(acc, __fmul_rn(w_r[24 + d2], A[k][p + 2]));
          }
        }
#pragma unroll
        for (int d1 = 0; d1 < 3; ++d1) {
#pragma unroll
          for (int d2 = 0; d2 < 3; ++d2) {
            float cc = __fmul_rn(w_r[9 + d1], B[0][d2]);
            cc = __fadd_rn(cc, __fmul_rn(w_r[12 + d1], B[1][d2]));
            C[d1][d2] = __fadd_rn(cc, __fmul_rn(w_r[15 + d1], B[2][d2]));
          }
        }
#pragma unroll
        for (int d0 = 0; d0 < 3; ++d0) {
#pragma unroll
          for (int q9 = 0; q9 < 9; ++q9) {
            const float term = __fmul_rn(w_r[i0 * 3 + d0], C[q9 / 3][q9 % 3]);
            float& t = tot[d0 * 9 + q9];
            t = i0 == 0 ? term : __fadd_rn(t, term);
          }
        }
      }
      float best = 0.0f;
      int best_a = 0;
#pragma unroll
      for (int a = 0; a < kCube; ++a) {
        float t = __fadd_rn(tot[a], tp.c_act[a]);
        if constexpr (kRowAct) {
          t = __fadd_rn(t, c_rowact[static_cast<long long>(r) * kCube + a]);
        }
        if (a == 0 || t < best) {   // strict: the first minimum wins
          best = t;
          best_a = a;
        }
      }
      const long long cell = static_cast<long long>(r) * n_lanes + c;
      float out = __fadd_rn(__fadd_rn(best, c_row[r]), c_lane[c]);
      out = __fadd_rn(out, c_rowlane != nullptr ? c_rowlane[cell] : 0.0f);
      out_v[cell] = out;
      out_a[cell] = static_cast<ArgT>(best_a);
    }
  }
}

// The cube body's two entries, one for each prologue. They keep two names
// because the benchmark's kernel metrics tell B.3 and B.5 apart by name.
template <typename ArgT, bool kRowAct>
__global__ void __launch_bounds__(kCubeThreads, 2) backup6d_sweep_cube(
    const float* __restrict__ values, const int* __restrict__ row_off,
    const float* __restrict__ row_frac, const int* __restrict__ lane_off0,
    const float* __restrict__ lane_frac0, const int* __restrict__ lane_off1,
    const float* __restrict__ lane_frac1, const int* __restrict__ lane_off2,
    const float* __restrict__ lane_frac2, const float* __restrict__ c_row,
    const float* __restrict__ c_lane, const float* __restrict__ c_rowact,
    const float* __restrict__ c_rowlane, float* __restrict__ out_v,
    ArgT* __restrict__ out_a, int n_rows, int n_lanes,
    const __grid_constant__ Taps6 tp, const __grid_constant__ LaneRec rec,
    const __grid_constant__ Tiles tl) {
  cube_sweep<ArgT, kRowAct, false>(
      values, row_off, row_frac, lane_off0, lane_frac0, lane_off1, lane_frac1,
      lane_off2, lane_frac2, c_row, c_lane, c_rowact, c_rowlane, out_v, out_a,
      n_rows, n_lanes, tp, rec, tl);
}

template <typename ArgT, bool kRowAct>
__global__ void __launch_bounds__(kCubeThreads, 2)
backup6d_sweep_recompute_cube(
    const float* __restrict__ values, const int* __restrict__ row_off,
    const float* __restrict__ row_frac, const int* __restrict__ lane_off0,
    const float* __restrict__ lane_frac0, const int* __restrict__ lane_off1,
    const float* __restrict__ lane_frac1, const int* __restrict__ lane_off2,
    const float* __restrict__ lane_frac2, const float* __restrict__ c_row,
    const float* __restrict__ c_lane, const float* __restrict__ c_rowact,
    const float* __restrict__ c_rowlane, float* __restrict__ out_v,
    ArgT* __restrict__ out_a, int n_rows, int n_lanes,
    const __grid_constant__ Taps6 tp, const __grid_constant__ LaneRec rec,
    const __grid_constant__ Tiles tl) {
  cube_sweep<ArgT, kRowAct, true>(
      values, row_off, row_frac, lane_off0, lane_frac0, lane_off1, lane_frac1,
      lane_off2, lane_frac2, c_row, c_lane, c_rowact, c_rowlane, out_v, out_a,
      n_rows, n_lanes, tp, rec, tl);
}

// The kernel for any taps an axis (see the head of this file): the modes,
// the stage and the sums of backup6d_sweep, by row combo j and lane combo e
// in sorted tap order.
template <typename ArgT, bool kTrack, bool kRecompute>
__global__ void __launch_bounds__(kMaxThreads)
backup6d_wide(const float* __restrict__ values,
              const int* __restrict__ row_off,
              const float* __restrict__ row_frac,
              const int* __restrict__ lane_off0,
              const float* __restrict__ lane_frac0,
              const int* __restrict__ lane_off1,
              const float* __restrict__ lane_frac1,
              const int* __restrict__ lane_off2,
              const float* __restrict__ lane_frac2,
              const float* __restrict__ c_row,
              const float* __restrict__ c_lane,
              const float* __restrict__ c_rowact,
              const float* __restrict__ c_rowlane,
              float* __restrict__ out_v, ArgT* __restrict__ out_a,
              int n_rows, int n_lanes, int n_actions,
              const __grid_constant__ TapsW tp,
              const __grid_constant__ LaneRec rec, const Block blk,
              const __grid_constant__ TilesW tl) {
  extern __shared__ __align__(16) float stage[];
  const int r0 = blockIdx.x * tl.rows;
  const int c0 = blockIdx.y * tl.lanes;
  stage_tile(stage, values, tl, blk, r0, c0 - tl.reach_lo, n_lanes);
  // the factorized phase's weights of each tile row: row combo j's w_k of
  // its tap on axis k and digit d at j * kComboWeights + k * 3 + d
  float* row_w = stage + tl.weights_at;
  const long long plane = static_cast<long long>(n_rows) * n_actions;
  if (tp.digits > 0) {
    const int m = tp.digits;
    for (int i = threadIdx.x; i < tl.rows * tl.row_weights;
         i += blockDim.x) {
      const int rr = i / tl.row_weights, s = i - rr * tl.row_weights;
      const int j = s / kComboWeights, k = (s / 3) % 3, d = s % 3;
      const int r = r0 + rr;
      float w = 0.0f;
      if (r < n_rows && d < m && j < tp.n_row_combos) {
        // the canonical action of digit d on axis k
        const int a = k == 0 ? d * m * m : (k == 1 ? d * m : d);
        const long long at =
            k * plane + static_cast<long long>(r) * n_actions + a;
        w = tap_weight(row_off[at], row_frac[at], tp.row_tap[j][k]);
      }
      row_w[i] = w;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  for (int i = threadIdx.x; i < tl.rows * tl.lanes; i += blockDim.x) {
    const int rr = i / tl.lanes;
    const int cl = i - rr * tl.lanes;
    const int r = r0 + rr;
    const int c = c0 + cl;
    if (r >= n_rows || c >= n_lanes) continue;
    const long long cell = static_cast<long long>(r) * n_lanes + c;
    int o0, o1, o2;
    float f0, f1, f2;
    if constexpr (kRecompute) {
      recompute_lanes(rec, r, c, o0, o1, o2, f0, f1, f2);
    } else {
      o0 = lane_off0[cell], o1 = lane_off1[cell], o2 = lane_off2[cell];
      f0 = lane_frac0[cell], f1 = lane_frac1[cell], f2 = lane_frac2[cell];
    }

    // lane phase: A_j of each live row combo, summed over the lane combos
    // in order, each lane combo's joint weight formed from its tap weights
    // where it is used; each sum starts at -0.0 (-0 + x == x)
    const char* cell_stage = reinterpret_cast<const char*>(
        stage + rr * tl.width + cl + tl.reach_lo);
    float A[kWideCombos];
#pragma unroll
    for (int j = 0; j < kWideCombos; ++j) A[j] = -0.0f;
    for (int e = 0; e < tp.n_lane_combos; ++e) {
      const float w = __fmul_rn(
          __fmul_rn(tap_weight(o0, f0, tp.lane_tap[e][0]),
                    tap_weight(o1, f1, tp.lane_tap[e][1])),
          tap_weight(o2, f2, tp.lane_tap[e][2]));
      const char* col = cell_stage + 4 * tp.lane_delta[e];
#pragma unroll
      for (int j = 0; j < kWideCombos; ++j) {
        if (j < tp.n_row_combos) {
          const float v =
              *reinterpret_cast<const float*>(col + tl.row_base[j]);
          A[j] = __fadd_rn(A[j], __fmul_rn(w, v));
        }
      }
    }

    // the action phases walk the combos in a runtime loop (their code
    // once, not once a combo), so they read A_j from a copy that a runtime
    // index may address (local memory, 160 B a thread)
    float Aj[kWideCombos];
#pragma unroll
    for (int j = 0; j < kWideCombos; ++j) Aj[j] = A[j];
    const float* rowact_r =
        c_rowact != nullptr ? c_rowact + static_cast<long long>(r) * n_actions
                            : nullptr;
    float best = 0.0f;
    int best_a = 0;
    if (tp.digits > 0) {
      // factorized action phase over the whole d0 slices [d0_lo, d0_hi):
      // one walk of the sorted row combos, B over each (t0, t1) run, folded
      // into C at the run's last combo, C into the totals at the t0 run's
      const int m = tp.digits;
      const int d0_lo = blk.a_lo / (m * m), d0_hi = blk.a_hi / (m * m);
      const float* w_r = row_w + rr * tl.row_weights;
      float B[kMaxDigits], C[kMaxDigits * kMaxDigits], tot[kDigitCube];
#pragma unroll
      for (int q = 0; q < kMaxDigits; ++q) B[q] = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxDigits * kMaxDigits; ++q) C[q] = 0.0f;
#pragma unroll
      for (int q = 0; q < kDigitCube; ++q) tot[q] = 0.0f;
#pragma unroll 1
      for (int j = 0; j < tp.n_row_combos; ++j) {
        const int mark = tp.row_mark[j];
        const float* wj = w_r + j * kComboWeights;
        const float a_j = Aj[j];
#pragma unroll
        for (int d2 = 0; d2 < kMaxDigits; ++d2) {
          if (d2 < m) {
            const float term = __fmul_rn(wj[6 + d2], a_j);
            B[d2] = (mark & kOpenPair) ? term : __fadd_rn(B[d2], term);
          }
        }
        if (mark & kClosePair) {
#pragma unroll
          for (int d1 = 0; d1 < kMaxDigits; ++d1) {
#pragma unroll
            for (int d2 = 0; d2 < kMaxDigits; ++d2) {
              if (d1 < m && d2 < m) {
                const float term = __fmul_rn(wj[3 + d1], B[d2]);
                float& cc = C[d1 * kMaxDigits + d2];
                cc = (mark & kOpenT0) ? term : __fadd_rn(cc, term);
              }
            }
          }
          if (mark & kCloseT0) {
#pragma unroll
            for (int d0 = 0; d0 < kMaxDigits; ++d0) {
#pragma unroll
              for (int d1 = 0; d1 < kMaxDigits; ++d1) {
#pragma unroll
                for (int d2 = 0; d2 < kMaxDigits; ++d2) {
                  if (d0 >= d0_lo && d0 < d0_hi && d1 < m && d2 < m) {
                    const float term =
                        __fmul_rn(wj[d0], C[d1 * kMaxDigits + d2]);
                    float& t = tot[(d0 * 3 + d1) * 3 + d2];
                    t = (mark & kFirstT0) ? term : __fadd_rn(t, term);
                  }
                }
              }
            }
          }
        }
      }
      // strict-'<' first minimum over a = (d0 * m + d1) * m + d2, ascending
#pragma unroll
      for (int d0 = 0; d0 < kMaxDigits; ++d0) {
#pragma unroll
        for (int d1 = 0; d1 < kMaxDigits; ++d1) {
#pragma unroll
          for (int d2 = 0; d2 < kMaxDigits; ++d2) {
            if (d0 >= d0_lo && d0 < d0_hi && d1 < m && d2 < m) {
              const int a = (d0 * m + d1) * m + d2;
              const int q = (d0 * 3 + d1) * 3 + d2;
              float t = tot[q];
              if (tp.c_act_q[q] != 0.0f) t = __fadd_rn(t, tp.c_act_q[q]);
              if (rowact_r != nullptr) t = __fadd_rn(t, rowact_r[a]);
              if (a == blk.a_lo || t < best) {   // strict: the first wins
                best = t;
                if (kTrack) best_a = a;
              }
            }
          }
        }
      }
    } else {
      // generic action phase: every live row combo per action, its joint
      // weight formed from its three tap weights
      const int* off_r = row_off + static_cast<long long>(r) * n_actions;
      const float* frac_r = row_frac + static_cast<long long>(r) * n_actions;
      for (int a = blk.a_lo; a < blk.a_hi; ++a) {
        const int g0 = off_r[a], g1 = off_r[plane + a],
                  g2 = off_r[2 * plane + a];
        const float h0 = frac_r[a], h1 = frac_r[plane + a],
                    h2 = frac_r[2 * plane + a];
        float t = 0.0f;
#pragma unroll 1
        for (int j = 0; j < tp.n_row_combos; ++j) {
          const float ww = __fmul_rn(
              __fmul_rn(tap_weight(g0, h0, tp.row_tap[j][0]),
                        tap_weight(g1, h1, tp.row_tap[j][1])),
              tap_weight(g2, h2, tp.row_tap[j][2]));
          const float term = __fmul_rn(ww, Aj[j]);
          t = j == 0 ? term : __fadd_rn(t, term);
        }
        if (tp.c_act[a] != 0.0f) t = __fadd_rn(t, tp.c_act[a]);
        if (rowact_r != nullptr) t = __fadd_rn(t, rowact_r[a]);
        if (a == blk.a_lo || t < best) {  // strict: the first minimum wins
          best = t;
          if (kTrack) best_a = a;
        }
      }
    }
    float out = __fadd_rn(__fadd_rn(best, c_row[r]), c_lane[c]);
    out = __fadd_rn(out, c_rowlane != nullptr ? c_rowlane[cell] : 0.0f);
    out_v[cell] = out;
    out_a[cell] = static_cast<ArgT>(best_a);   // 0 in a min-only sweep
  }
}

int tap_index(const int* taps, int n, int t) {
  for (int i = 0; i < n; ++i) {
    if (taps[i] == t) return i;
  }
  return -1;
}

// The tap structure of one plan as the C entries take it (host arrays):
// w_taps (3, kWideCombos) the live row taps of each axis, ascending, n_taps
// (3,) their counts; row_combos (n_row_combos, 3) and lane_combos
// (n_lane_combos, 3) the live combos, sorted; c_act (n_actions,); digits
// the action digit base m (n_actions == m^3), or 0 for the generic phase.
struct TapIn {
  const int* w_taps;
  const int* n_taps;
  const int* row_combos;
  const int* lane_combos;
  const float* c_act;
  int n_r1, n_r2, n_l1, n_l2, n_actions, n_row_combos, n_lane_combos,
      digits;
};

bool counts_fit(const TapIn& in, int max_row, int max_lane) {
  return in.n_actions >= 1 && in.n_actions <= kMaxActions &&
         in.n_row_combos >= 1 && in.n_row_combos <= max_row &&
         in.n_lane_combos >= 1 && in.n_lane_combos <= max_lane &&
         in.digits >= 0 && in.digits <= kMaxDigits &&
         (in.digits == 0 || in.digits * in.digits * in.digits == in.n_actions);
}

// c_act, and with digits c_act_q of (d0, d1, d2) at (d0 * 3 + d1) * 3 + d2
template <typename TapsT>
void fill_costs(TapsT& tp, const TapIn& in) {
  const int m = in.digits;
  tp.digits = m;
  for (int a = 0; a < in.n_actions; ++a) tp.c_act[a] = in.c_act[a];
  for (int d0 = 0; d0 < m; ++d0) {
    for (int d1 = 0; d1 < m; ++d1) {
      for (int d2 = 0; d2 < m; ++d2) {
        tp.c_act_q[(d0 * 3 + d1) * 3 + d2] = in.c_act[(d0 * m + d1) * m + d2];
      }
    }
  }
}

// backup6d_sweep's tap structure into tp; false when it exceeds the
// kernel's capacities (3 live taps an axis).
bool fill_taps(Taps6& tp, const TapIn& in) {
  if (!counts_fit(in, kCube, kMaxLaneCombos)) return false;
  tp = Taps6{};
  for (int k = 0; k < 3; ++k) {
    if (in.n_taps[k] < 1 || in.n_taps[k] > kMaxTaps) return false;
    tp.n_row_taps[k] = in.n_taps[k];
    for (int i = 0; i < in.n_taps[k]; ++i) {
      tp.row_taps[k][i] = in.w_taps[kWideCombos * k + i];
    }
  }
  for (int j = 0; j < in.n_row_combos; ++j) {
    const int* t = in.row_combos + 3 * j;
    int p = 0;
    for (int k = 0; k < 3; ++k) {
      const int i = tap_index(tp.row_taps[k], tp.n_row_taps[k], t[k]);
      if (i < 0) return false;
      p = p * 3 + i;
    }
    tp.row_live |= 1 << p;
    tp.row_delta[p] = (t[0] * in.n_r1 + t[1]) * in.n_r2 + t[2];
  }
  tp.n_lane_combos = in.n_lane_combos;
  int n_lane_taps[3] = {0, 0, 0};
  for (int e = 0; e < in.n_lane_combos; ++e) {
    const int* t = in.lane_combos + 3 * e;
    for (int k = 0; k < 3; ++k) {
      int i = tap_index(tp.lane_taps[k], n_lane_taps[k], t[k]);
      if (i < 0) {
        if (n_lane_taps[k] == kMaxTaps) return false;
        i = n_lane_taps[k]++;
        tp.lane_taps[k][i] = t[k];
      }
      tp.lane_idx[e][k] = i;
    }
    tp.lane_delta[e] = (t[0] * in.n_l1 + t[1]) * in.n_l2 + t[2];
  }
  fill_costs(tp, in);
  return true;
}

// backup6d_wide's tap structure into tp, with the factorized phase's run
// marks of each row combo; false when it exceeds the kernel's capacities
// or the row combos are not sorted and distinct (the runs need the order).
bool fill_taps_wide(TapsW& tp, const TapIn& in) {
  if (!counts_fit(in, kWideCombos, kWideCombos)) return false;
  tp = TapsW{};
  const int n = in.n_row_combos;
  tp.n_row_combos = n;
  const int* rc = in.row_combos;
  for (int j = 0; j < n; ++j) {
    for (int k = 0; k < 3; ++k) tp.row_tap[j][k] = rc[3 * j + k];
    if (j > 0) {
      const int* a = rc + 3 * (j - 1);
      const int* b = rc + 3 * j;
      const bool less = a[0] < b[0] || (a[0] == b[0] && (a[1] < b[1] ||
                                        (a[1] == b[1] && a[2] < b[2])));
      if (!less) return false;
    }
  }
  auto same_pair = [rc](int i, int j) {
    return rc[3 * i] == rc[3 * j] && rc[3 * i + 1] == rc[3 * j + 1];
  };
  int pair_first = 0;
  for (int j = 0; j < n; ++j) {
    if (j > 0 && !same_pair(j - 1, j)) pair_first = j;
    const int t0 = rc[3 * j];
    int mark = 0;
    if (j == pair_first) mark |= kOpenPair;
    if (j == n - 1 || !same_pair(j, j + 1)) mark |= kClosePair;
    if (pair_first == 0 || rc[3 * (pair_first - 1)] != t0) mark |= kOpenT0;
    if (j == n - 1 || rc[3 * (j + 1)] != t0) mark |= kCloseT0;
    if (t0 == rc[0]) mark |= kFirstT0;
    tp.row_mark[j] = mark;
  }
  tp.n_lane_combos = in.n_lane_combos;
  for (int e = 0; e < in.n_lane_combos; ++e) {
    const int* t = in.lane_combos + 3 * e;
    for (int k = 0; k < 3; ++k) tp.lane_tap[e][k] = t[k];
    tp.lane_delta[e] = (t[0] * in.n_l1 + t[1]) * in.n_l2 + t[2];
  }
  fill_costs(tp, in);
  return true;
}

struct SweepIo {
  const float* values;
  const int* row_off;
  const float* row_frac;
  const int* lane_off[3];
  const float* lane_frac[3];
  const float* c_row;
  const float* c_lane;
  const float* c_rowact;
  const float* c_rowlane;
  float* out_v;
  void* out_a;
};

template <bool kWide>
using TapsOf = std::conditional_t<kWide, TapsW, Taps6>;
template <bool kWide>
using TilesOf = std::conditional_t<kWide, TilesW, Tiles>;

template <bool kWide>
struct TileArgs {
  TilesOf<kWide> tl;
  dim3 grid;
  int smem_bytes;
  int threads;
};

// The planner's int32 array (ops/backup6d.py::TilePlan.ints, TILE_INTS =
// kTileHead + 4 kWideCombos + 4 ints): R, L, reach_lo, reach_hi, width,
// staged rows, groups, the row weights a tile row keeps, the plan's kernel
// (at kKindAt: kSweepKind, kWideKind or kCubeKind);
// g_delta, g_rows, g_slot (kWideCombos each); the stage slot of each row
// combo (kWideCombos; backup6d_sweep and the cube body: by cube slot p,
// -1 where not live; backup6d_wide: by combo); the grid's row and lane
// tiles, the shared-memory bytes, the threads of a block.
constexpr int kTileHead = 9;
constexpr int kKindAt = 8;
constexpr int kSweepKind = 0, kWideKind = 1, kCubeKind = 2;

// The fields of the planner's array that both kernels read into ta, with
// the checks that do not depend on the tap structure: the grid must cover
// the output cells once, the groups be consecutive stage rows, the stage
// fit the device. Returns the stage slots, or null when the kernel cannot
// take the plan.
template <bool kWide>
const int* read_tiles(TileArgs<kWide>& ta, const int* in, const float* values,
                      int n_rows, int n_lanes, int max_groups,
                      int row_weights, int kind) {
  const int R = in[0], L = in[1], reach_lo = in[2], reach_hi = in[3];
  const int width = in[4], n_staged = in[5], n_groups = in[6];
  const int* g_delta = in + kTileHead;
  const int* g_rows = g_delta + kWideCombos;
  const int* g_slot = g_rows + kWideCombos;
  const int* slot = g_slot + kWideCombos;
  const int* tail = slot + kWideCombos;
  const long long grid_rows = tail[0], grid_lanes = tail[1];
  const long long smem = tail[2];
  const int threads = tail[3];
  if (in[7] != row_weights || in[kKindAt] != kind ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || R < 1 ||
      L < 32 || L % 32 != 0 || reach_lo < 0 || reach_hi < 0 ||
      width != L + reach_lo + reach_hi || n_groups < 1 ||
      n_groups > max_groups || n_staged < 1) {
    return nullptr;
  }
  if (grid_rows != (static_cast<long long>(n_rows) + R - 1) / R ||
      grid_lanes != (static_cast<long long>(n_lanes) + L - 1) / L ||
      grid_rows > 0x7fffffffLL || grid_lanes > 65535) {
    return nullptr;
  }
  if (smem != 4LL * (static_cast<long long>(n_staged) * width +
                    static_cast<long long>(R) * row_weights)) {
    return nullptr;
  }
  int device = 0, smem_max = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_max,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess ||
      smem > smem_max) {
    return nullptr;
  }
  ta.tl = TilesOf<kWide>{};
  ta.tl.rows = R;
  ta.tl.lanes = L;
  ta.tl.reach_lo = reach_lo;
  ta.tl.width = width;
  ta.tl.n_groups = n_groups;
  ta.tl.weights_at = n_staged * width;
  ta.tl.vec4 = n_lanes % 4 == 0 && reach_lo % 4 == 0 && width % 4 == 0 &&
               reinterpret_cast<unsigned long long>(values) % 16 == 0;
  int next = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (g_rows[g] < 1 || g_slot[g] != next) return nullptr;
    next += g_rows[g];
    ta.tl.g_delta[g] = g_delta[g];
    ta.tl.g_rows[g] = g_rows[g];
    ta.tl.g_slot[g] = g_slot[g];
  }
  if (next != n_staged) return nullptr;
  ta.grid = dim3(static_cast<unsigned>(grid_rows),
                 static_cast<unsigned>(grid_lanes));
  ta.smem_bytes = static_cast<int>(smem);
  ta.threads = threads;
  return slot;
}

// Whether tile row rr of a row combo with flat shift delta, staged from
// stage row s0 on, reads its table rows: each of the R rows must lie in a
// group, at its offset.
template <typename TilesT>
bool rows_staged(const TilesT& tl, int s0, int delta) {
  for (int rr = 0; rr < tl.rows; ++rr) {
    const int s = s0 + rr;
    bool found = false;
    for (int g = 0; g < tl.n_groups && !found; ++g) {
      found = s >= tl.g_slot[g] && s < tl.g_slot[g] + tl.g_rows[g] &&
              tl.g_delta[g] + (s - tl.g_slot[g]) == delta + rr;
    }
    if (!found) return false;
  }
  return true;
}

// The planner's tiles for backup6d_sweep into ta, checked against the tap
// structure: every read of every cell must lie in its block's stage. False
// when the kernel cannot take the plan.
bool fill_tiles(TileArgs<false>& ta, const int* in, const Taps6& tp,
                const float* values, int n_rows, int n_lanes,
                int kind = kSweepKind) {
  const int* slot = read_tiles(ta, in, values, n_rows, n_lanes, kMaxGroups,
                               kRowWeights, kind);
  if (slot == nullptr) return false;
  const int reach_lo = ta.tl.reach_lo;
  const int reach_hi = ta.tl.width - ta.tl.lanes - reach_lo;
  for (int e = 0; e < tp.n_lane_combos; ++e) {
    if (tp.lane_delta[e] < -reach_lo || tp.lane_delta[e] > reach_hi) {
      return false;
    }
  }
  for (int p = 0; p < kCube; ++p) {
    if (!((tp.row_live >> p) & 1)) continue;
    // tile row rr of combo p reads table row r0 + table_row0 + D_p + rr
    if (!rows_staged(ta.tl, slot[p], tp.row_delta[p])) return false;
    ta.tl.row_base[p] = 4 * slot[p] * ta.tl.width;
  }
  return true;
}

// The planner's tiles for backup6d_wide into ta, checked as fill_tiles.
bool fill_tiles_wide(TileArgs<true>& ta, const int* in, const TapsW& tp,
                     const TapIn& tin, const float* values, int n_rows,
                     int n_lanes) {
  const int* slot =
      read_tiles(ta, in, values, n_rows, n_lanes, kWideCombos,
                 kComboWeights * tp.n_row_combos, kWideKind);
  if (slot == nullptr) return false;
  ta.tl.row_weights = kComboWeights * tp.n_row_combos;
  const int reach_lo = ta.tl.reach_lo;
  const int reach_hi = ta.tl.width - ta.tl.lanes - reach_lo;
  for (int e = 0; e < tp.n_lane_combos; ++e) {
    if (tp.lane_delta[e] < -reach_lo || tp.lane_delta[e] > reach_hi) {
      return false;
    }
  }
  for (int j = 0; j < tp.n_row_combos; ++j) {
    const int* t = tp.row_tap[j];
    const int delta = (t[0] * tin.n_r1 + t[1]) * tin.n_r2 + t[2];
    if (slot[j] < 0 || !rows_staged(ta.tl, slot[j], delta)) return false;
    ta.tl.row_base[j] = 4 * slot[j] * ta.tl.width;
  }
  return true;
}

// A kernel's stage: a stage above 48 KB needs the opt-in, and two stages
// share an SM's 228 KB.
template <typename KernelT>
cudaError_t allow_stage(KernelT kernel, int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  return err;
}

template <typename ArgT, bool kTrack, bool kRecompute, bool kWide>
constexpr auto kernel_of() {
  if constexpr (kWide) {
    return backup6d_wide<ArgT, kTrack, kRecompute>;
  } else {
    return backup6d_sweep<ArgT, kTrack, kRecompute>;
  }
}

template <typename ArgT, bool kTrack, bool kRecompute, bool kWide>
int launch(const SweepIo& io, const TapsOf<kWide>& tp, const LaneRec& rec,
           const Block& blk, const TileArgs<kWide>& ta, int n_rows,
           int n_lanes, int n_actions, void* stream) {
  auto kernel = kernel_of<ArgT, kTrack, kRecompute, kWide>();
  const cudaError_t err = allow_stage(kernel, ta.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<ta.grid, ta.threads, ta.smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      io.values, io.row_off, io.row_frac, io.lane_off[0], io.lane_frac[0],
      io.lane_off[1], io.lane_frac[1], io.lane_off[2], io.lane_frac[2],
      io.c_row, io.c_lane, io.c_rowact, io.c_rowlane, io.out_v,
      static_cast<ArgT*>(io.out_a), n_rows, n_lanes, n_actions, tp, rec, blk,
      ta.tl);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations of one kernel: argmin_bytes 4 (int32) or 1 (uint8),
// track 1 (argmin) or 0 (min-only, all-zero argmin).
template <bool kRecompute, bool kWide>
int launch_mode(const SweepIo& io, const TapsOf<kWide>& tp,
                const LaneRec& rec, const Block& blk,
                const TileArgs<kWide>& ta, int n_rows, int n_lanes,
                int n_actions, int argmin_bytes, int track, void* stream) {
  if (argmin_bytes == 4) {
    return track ? launch<int, true, kRecompute, kWide>(
                       io, tp, rec, blk, ta, n_rows, n_lanes, n_actions,
                       stream)
                 : launch<int, false, kRecompute, kWide>(
                       io, tp, rec, blk, ta, n_rows, n_lanes, n_actions,
                       stream);
  }
  if (argmin_bytes == 1) {
    return track ? launch<unsigned char, true, kRecompute, kWide>(
                       io, tp, rec, blk, ta, n_rows, n_lanes, n_actions,
                       stream)
                 : launch<unsigned char, false, kRecompute, kWide>(
                       io, tp, rec, blk, ta, n_rows, n_lanes, n_actions,
                       stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Whether tp is the cube body's structure: 3 live taps (-1, 0, 1) on every
// row and lane axis, every row combo and the 27 lane combos live in sorted
// order, digit base 3.
bool full_cube(const Taps6& tp) {
  if (tp.digits != 3 || tp.row_live != (1 << kCube) - 1 ||
      tp.n_lane_combos != kCube) {
    return false;
  }
  for (int k = 0; k < 3; ++k) {
    if (tp.n_row_taps[k] != kMaxTaps) return false;
    for (int i = 0; i < kMaxTaps; ++i) {
      if (tp.row_taps[k][i] != i - 1 || tp.lane_taps[k][i] != i - 1) {
        return false;
      }
    }
  }
  for (int e = 0; e < kCube; ++e) {
    if (tp.lane_idx[e][0] != e / 9 || tp.lane_idx[e][1] != (e / 3) % 3 ||
        tp.lane_idx[e][2] != e % 3) {
      return false;
    }
  }
  return true;
}

// The cube body's tap structure and the planner's tiles into tp and ta,
// checked as fill_tiles checks them and besides: the full cube, a tracking
// sweep of the whole table over every action, whole chunks of kCubeCells
// rows a tile, kCubeThreads threads, each row group's three t2 rows
// consecutive in the stage; the action costs as the body adds them (-0.0
// for a skipped 0). False when the body cannot take the plan.
bool fill_cube(Taps6& tp, TileArgs<false>& ta, const TapIn& in,
               const int* tiles, const float* values, const Block& blk,
               int track, int n_rows, int n_lanes) {
  if (!track || blk.table_row0 != 0 || blk.n_table_rows != n_rows ||
      blk.a_lo != 0 || blk.a_hi != in.n_actions || !fill_taps(tp, in) ||
      !full_cube(tp) ||
      !fill_tiles(ta, tiles, tp, values, n_rows, n_lanes, kCubeKind) ||
      ta.tl.rows % kCubeCells != 0 || ta.threads != kCubeThreads) {
    return false;
  }
  for (int g = 0; g < kMaxGroups; ++g) {
    for (int i2 = 1; i2 < kMaxTaps; ++i2) {
      if (ta.tl.row_base[3 * g + i2] !=
          ta.tl.row_base[3 * g] + 4 * i2 * ta.tl.width) {
        return false;
      }
    }
  }
  for (int a = 0; a < kCube; ++a) {
    if (tp.c_act[a] == 0.0f) tp.c_act[a] = -0.0f;
  }
  return true;
}

// The cube body's instantiation of one mode: the stored lane plan's or the
// recompute's prologue, with or without c_rowact.
template <typename ArgT>
auto cube_kernel(bool recompute, bool row_act) {
  if (recompute) {
    return row_act ? backup6d_sweep_recompute_cube<ArgT, true>
                   : backup6d_sweep_recompute_cube<ArgT, false>;
  }
  return row_act ? backup6d_sweep_cube<ArgT, true>
                 : backup6d_sweep_cube<ArgT, false>;
}

template <typename ArgT>
int launch_cube(const SweepIo& io, const Taps6& tp, const LaneRec& rec,
                bool recompute, const TileArgs<false>& ta, int n_rows,
                int n_lanes, void* stream) {
  auto kernel = cube_kernel<ArgT>(recompute, io.c_rowact != nullptr);
  const cudaError_t err = allow_stage(kernel, ta.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<ta.grid, ta.threads, ta.smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      io.values, io.row_off, io.row_frac, io.lane_off[0], io.lane_frac[0],
      io.lane_off[1], io.lane_frac[1], io.lane_off[2], io.lane_frac[2],
      io.c_row, io.c_lane, io.c_rowact, io.c_rowlane, io.out_v,
      static_cast<ArgT*>(io.out_a), n_rows, n_lanes, tp, rec, ta.tl);
  return static_cast<int>(cudaGetLastError());
}

// One sweep in one mode through the kernel the planner chose (the tiles'
// kind): its tap structure and tiles filled and checked, then the launch.
// cudaErrorInvalidValue when the kernel cannot take the plan or the mode.
template <bool kRecompute>
int sweep(const SweepIo& io, const TapIn& in, const int* tiles,
          const LaneRec& rec, const Block& blk, int n_rows, int n_lanes,
          int argmin_bytes, int track, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (tiles[kKindAt] == kWideKind) {
    TapsW tp;
    TileArgs<true> ta;
    if (!fill_taps_wide(tp, in) ||
        !fill_tiles_wide(ta, tiles, tp, in, io.values, n_rows, n_lanes)) {
      return invalid;
    }
    return launch_mode<kRecompute, true>(io, tp, rec, blk, ta, n_rows,
                                         n_lanes, in.n_actions, argmin_bytes,
                                         track, stream);
  }
  Taps6 tp;
  TileArgs<false> ta;
  if (tiles[kKindAt] == kCubeKind) {
    if (!fill_cube(tp, ta, in, tiles, io.values, blk, track, n_rows,
                   n_lanes)) {
      return invalid;
    }
    if (argmin_bytes == 4) {
      return launch_cube<int>(io, tp, rec, kRecompute, ta, n_rows, n_lanes,
                              stream);
    }
    if (argmin_bytes == 1) {
      return launch_cube<unsigned char>(io, tp, rec, kRecompute, ta, n_rows,
                                        n_lanes, stream);
    }
    return invalid;
  }
  if (!fill_taps(tp, in) ||
      !fill_tiles(ta, tiles, tp, io.values, n_rows, n_lanes)) {
    return invalid;
  }
  return launch_mode<kRecompute, false>(io, tp, rec, blk, ta, n_rows, n_lanes,
                                        in.n_actions, argmin_bytes, track,
                                        stream);
}

// Resident blocks an SM of one instantiation at this block size and stage.
template <typename KernelT>
int blocks_of_kernel(KernelT kernel, int threads, int smem_bytes) {
  int blocks = 0;
  if (allow_stage(kernel, smem_bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, threads, smem_bytes) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

template <typename ArgT, bool kTrack, bool kRecompute, bool kWide>
int blocks_per_sm(int threads, int smem_bytes) {
  return blocks_of_kernel(kernel_of<ArgT, kTrack, kRecompute, kWide>(),
                          threads, smem_bytes);
}

template <bool kWide>
int blocks_of_mode(int mode, int threads, int smem_bytes) {
  switch (mode) {
    case 0: return blocks_per_sm<int, false, false, kWide>(threads, smem_bytes);
    case 1: return blocks_per_sm<int, false, true, kWide>(threads, smem_bytes);
    case 2: return blocks_per_sm<int, true, false, kWide>(threads, smem_bytes);
    case 3: return blocks_per_sm<int, true, true, kWide>(threads, smem_bytes);
    case 4:
      return blocks_per_sm<unsigned char, false, false, kWide>(threads,
                                                               smem_bytes);
    case 5:
      return blocks_per_sm<unsigned char, false, true, kWide>(threads,
                                                              smem_bytes);
    case 6:
      return blocks_per_sm<unsigned char, true, false, kWide>(threads,
                                                              smem_bytes);
    case 7:
      return blocks_per_sm<unsigned char, true, true, kWide>(threads,
                                                             smem_bytes);
    default: return -1;
  }
}

// B.5's lane generators into rec; false for a lane axis of fewer than 2
// points.
bool fill_rec(LaneRec& rec, const float* w1, const float* w2, const float* w3,
              const float* q1, const float* q2, const float* q3,
              const float* q4, const float* rec_consts, int n_l0, int n_l1,
              int n_l2, int clamp) {
  rec = LaneRec{};
  const int sizes[3] = {n_l0, n_l1, n_l2};
  const int strides[3] = {n_l1 * n_l2, n_l2, 1};
  const float* w[3] = {w1, w2, w3};
  const float* q[4] = {q1, q2, q3, q4};
  for (int k = 0; k < 3; ++k) {
    if (sizes[k] < 2) return false;
    rec.w[k] = w[k];
    rec.start[k] = rec_consts[k];
    rec.inv_step[k] = rec_consts[3 + k];
    rec.top[k] = static_cast<float>(sizes[k] - 2);
    rec.size[k] = sizes[k];
    rec.stride[k] = strides[k];
  }
  for (int k = 0; k < 4; ++k) rec.q[k] = q[k];
  rec.half_h = rec_consts[6];
  rec.clamp = clamp;
  return true;
}

}  // namespace

// One sweep, in every mode. Device pointers: values (n_table_rows, NE), of
// which output row 0 is table row table_row0; row_off/row_frac (3,
// n_out_rows, A); on a stored lane plan lane_off{k}/lane_frac{k}
// (n_out_rows, NE), else (recompute 1, B.5) w1..w3 (n_out_rows,) the rows'
// omegas and q1..q4 (NE,) the lanes' kirk-q components, the other four
// null; c_row (n_out_rows,); c_lane (NE,); c_rowact (n_out_rows, A) and
// c_rowlane (n_out_rows, NE) may be null; out_v/out_a (n_out_rows, NE),
// out_a int32 (argmin_bytes 4) or uint8 (argmin_bytes 1), buffers the
// caller may reuse. Host pointers: rec_consts start[3], inv_step[3] and
// half_h, float32 (null on a stored lane plan); w_taps (3, 40) live row
// taps per axis, ascending, n_taps (3,) their counts; row_combos
// (n_row_combos, 3) and lane_combos (n_lane_combos, 3) the live combos,
// sorted; c_act (A,); tiles the tile planner's TILE_INTS ints, whose kind
// picks backup6d_sweep, backup6d_wide or the cube body. digits: the action
// digit base m (A == m^3), or 0 for the generic action phase; track 0: a
// min-only sweep (all-zero argmin); clamp: edge='clamp'. The first minimum
// runs over the actions [a_lo, a_hi) and out_a holds global action
// indices; with digits > 0, a_lo and a_hi must be multiples of digits^2
// (whole fixed-d0 slices). Returns a cudaError_t (0 on success):
// cudaErrorInvalidValue when the tap structure exceeds the kernel's
// capacities, the tiles do not cover the reads or the kernel does not take
// the mode, else the error of the launch.
extern "C" int backup6d_f32(
    const float* values, const int* row_off, const float* row_frac,
    const int* lane_off0, const float* lane_frac0, const int* lane_off1,
    const float* lane_frac1, const int* lane_off2, const float* lane_frac2,
    const float* c_row, const float* c_lane, const float* c_rowact,
    const float* c_rowlane, float* out_v, void* out_a, const float* w1,
    const float* w2, const float* w3, const float* q1, const float* q2,
    const float* q3, const float* q4, const float* rec_consts,
    const int* w_taps, const int* n_taps, const int* row_combos,
    const int* lane_combos, const float* c_act, const int* tiles, int n_r1,
    int n_r2, int n_l0, int n_l1, int n_l2, int n_actions, int n_row_combos,
    int n_lane_combos, int digits, int argmin_bytes, int track,
    int recompute, int clamp, int n_out_rows, int table_row0,
    int n_table_rows, int a_lo, int a_hi, void* stream) {
  const TapIn in = {w_taps, n_taps, row_combos, lane_combos, c_act, n_r1,
                    n_r2, n_l1, n_l2, n_actions, n_row_combos,
                    n_lane_combos, digits};
  const int n_lanes = n_l0 * n_l1 * n_l2;
  const int slice = digits * digits;
  if (n_out_rows < 1 || table_row0 < 0 ||
      n_table_rows < table_row0 + n_out_rows || a_lo < 0 || a_hi <= a_lo ||
      a_hi > n_actions ||
      (digits > 0 && (a_lo % slice != 0 || a_hi % slice != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Block blk = {n_table_rows, table_row0, a_lo, a_hi};
  if (recompute) {
    LaneRec rec;
    if (!fill_rec(rec, w1, w2, w3, q1, q2, q3, q4, rec_consts, n_l0, n_l1,
                  n_l2, clamp)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const SweepIo io = {values, row_off, row_frac,
                        {nullptr, nullptr, nullptr},
                        {nullptr, nullptr, nullptr}, c_row, c_lane, c_rowact,
                        c_rowlane, out_v, out_a};
    return sweep<true>(io, in, tiles, rec, blk, n_out_rows, n_lanes,
                       argmin_bytes, track, stream);
  }
  const SweepIo io = {values, row_off, row_frac,
                      {lane_off0, lane_off1, lane_off2},
                      {lane_frac0, lane_frac1, lane_frac2},
                      c_row, c_lane, c_rowact, c_rowlane, out_v, out_a};
  return sweep<false>(io, in, tiles, LaneRec{}, blk, n_out_rows, n_lanes,
                      argmin_bytes, track, stream);
}

// The most dynamic shared memory one block of the current device may ask
// for (bytes), the tile planner's limit; 0 when it cannot be read.
extern "C" int backup6d_smem_limit(void) {
  int device = 0, bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return 0;
  }
  return bytes;
}

// Resident blocks an SM of the kernel of one mode (argmin_bytes 4 or 1,
// track, recompute; kind: the plan's kernel, 0 backup6d_sweep, 1
// backup6d_wide, 2 the cube body, its tracking modes alone) at threads a
// block and smem_bytes of stage, on the current device: the occupancy of a
// launch; -1 on an error.
extern "C" int backup6d_blocks_per_sm(int argmin_bytes, int track,
                                      int recompute, int kind, int threads,
                                      int smem_bytes) {
  if (argmin_bytes != 4 && argmin_bytes != 1) return -1;
  const int mode = (argmin_bytes == 1 ? 4 : 0) + (track ? 2 : 0) +
                   (recompute ? 1 : 0);
  switch (kind) {
    case kSweepKind: return blocks_of_mode<false>(mode, threads, smem_bytes);
    case kWideKind: return blocks_of_mode<true>(mode, threads, smem_bytes);
    case kCubeKind:
      if (!track) return -1;
      return argmin_bytes == 4
                 ? blocks_of_kernel(cube_kernel<int>(recompute, false),
                                    threads, smem_bytes)
                 : blocks_of_kernel(
                       cube_kernel<unsigned char>(recompute, false), threads,
                       smem_bytes);
    default: return -1;
  }
}

extern "C" const char* backup6d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
