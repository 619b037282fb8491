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
// Layout and what bounds it: one thread per cell, 256 threads per block
// over the flat (NW * NE) cells, so a warp reads consecutive lanes of one or
// two rows. The live taps sit on a 3 x 3 x 3 cube per group (row, lane), so
// the row combos' A_j, the per-digit row weights and the 27 action totals
// have fixed register slots (kCube). Each cell reads its 3 lane (off, frac)
// pairs once (24 B) and recomputes the joint weight of each lane combo once,
// for all row combos; the per-(row, action) row plan is uniform across a
// row and read per digit in the factorized phase. The table (5.3 MB at
// 11^3 x 10^3) stays in the 50 MB L2: 27 x 27 = 729 reads per cell, served
// from L1/L2. FP32 work is about 2e3 operations per cell, so the function is
// bound by FP32 throughput, not by device memory; this first kernel is bound
// by its load and instruction issue instead. Later work (ROADMAP B.3):
// shared-memory tiles of the row window a block reads, and sharing the lane
// phase across the row shifts.
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 3;       // MAX_TAPS in ops/backup6d.py
constexpr int kCube = kMaxTaps * kMaxTaps * kMaxTaps;
constexpr int kMaxLaneCombos = kCube;
constexpr int kMaxActions = 64;   // MAX_ACTIONS
constexpr int kMaxDigits = 3;     // MAX_DIGITS

// The tap structure, passed by value (it lives in the constant bank).
struct Taps6 {
  int n_row_taps[3];
  int row_taps[3][kMaxTaps];      // live taps of each row axis, ascending
  int row_live;                   // bit (i0 * 3 + i1) * 3 + i2: combo live
  int row_delta[kCube];           // flat row shift of cube slot p
  int n_lane_combos;
  int lane_tap[kMaxLaneCombos][3];  // live lane combos, sorted
  int lane_delta[kMaxLaneCombos];   // flat lane shift of lane combo e
  int digits;                     // action digit base m, 0: generic phase
  float c_act[kMaxActions];       // per-action cost
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
// frac = t - lo; then the offset from the lane's own index on the axis
__device__ __forceinline__ void locate(const LaneRec& rec, int k, float coord,
                                       int c, int& off, float& frac) {
  const float t = __fmul_rn(__fsub_rn(coord, rec.start[k]), rec.inv_step[k]);
  const float lo = fminf(fmaxf(floorf(t), 0.0f), rec.top[k]);
  frac = __fsub_rn(t, lo);
  if (rec.clamp) frac = fminf(fmaxf(frac, 0.0f), 1.0f);
  off = static_cast<int>(lo) - (c / rec.stride[k]) % rec.size[k];
}

// kernelmath.quat_step_readback(h, q, w1, w2, w3, atan2_f32, asin_f32)
// followed by the locate of each Euler axis, for cell (r, c)
__device__ __forceinline__ void recompute_lanes(const LaneRec& rec, int r,
                                                int c, int& o0, int& o1,
                                                int& o2, float& f0,
                                                float& f1, float& f2) {
  const float w1 = rec.w[0][r], w2 = rec.w[1][r], w3 = rec.w[2][r];
  const float q1 = rec.q[0][c], q2 = rec.q[1][c], q3 = rec.q[2][c],
              q4 = rec.q[3][c];
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
  locate(rec, 0, yaw, c, o0, f0);
  locate(rec, 1, pitch, c, o1, f1);
  locate(rec, 2, roll, c, o2, f2);
}

template <typename ArgT, bool kTrack, bool kRecompute>
__global__ void __launch_bounds__(kThreads)
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
               const __grid_constant__ LaneRec rec, const Block blk) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_rows * n_lanes) return;
  const int r = cell / n_lanes;
  const int c = cell - r * n_lanes;
  int o0, o1, o2;
  float f0, f1, f2;
  if constexpr (kRecompute) {
    recompute_lanes(rec, r, c, o0, o1, o2, f0, f1, f2);
  } else {
    o0 = lane_off0[cell], o1 = lane_off1[cell], o2 = lane_off2[cell];
    f0 = lane_frac0[cell], f1 = lane_frac1[cell], f2 = lane_frac2[cell];
  }

  // lane phase: A[p] for each live row combo (cube slot p), summed over the
  // lane combos in order; each joint weight is formed once for all p
  float A[kCube];
#pragma unroll
  for (int p = 0; p < kCube; ++p) A[p] = 0.0f;
  for (int e = 0; e < tp.n_lane_combos; ++e) {
    const float w = __fmul_rn(
        __fmul_rn(tap_weight(o0, f0, tp.lane_tap[e][0]),
                  tap_weight(o1, f1, tp.lane_tap[e][1])),
        tap_weight(o2, f2, tp.lane_tap[e][2]));
    const int c2 = c + tp.lane_delta[e];
    const bool lane_in = c2 >= 0 && c2 < n_lanes;
#pragma unroll
    for (int p = 0; p < kCube; ++p) {
      if (live(tp, p)) {
        const int rr = r + blk.table_row0 + tp.row_delta[p];
        const float v = (lane_in && rr >= 0 && rr < blk.n_table_rows)
                            ? values[static_cast<long long>(rr) * n_lanes + c2]
                            : 0.0f;
        const float term = __fmul_rn(w, v);
        A[p] = e == 0 ? term : __fadd_rn(A[p], term);
      }
    }
  }

  const long long plane = static_cast<long long>(n_rows) * n_actions;
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
    float w1[kMaxTaps][kMaxDigits], w2[kMaxTaps][kMaxDigits];
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) {
#pragma unroll
      for (int d = 0; d < kMaxDigits; ++d) {
        w1[i][d] = w2[i][d] = 0.0f;
        if (d < m && i < tp.n_row_taps[1]) {
          w1[i][d] = tap_weight(off_r[plane + d * m], frac_r[plane + d * m],
                                tp.row_taps[1][i]);
        }
        if (d < m && i < tp.n_row_taps[2]) {
          w2[i][d] = tap_weight(off_r[2 * plane + d], frac_r[2 * plane + d],
                                tp.row_taps[2][i]);
        }
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
                  const int a = d0 * m * m;  // canonical action of d0
                  const float w0 = tap_weight(off_r[a], frac_r[a],
                                              tp.row_taps[0][i0]);
                  const float term = __fmul_rn(w0, cc);
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
            float t = tot[(d0 * 3 + d1) * 3 + d2];
            if (tp.c_act[a] != 0.0f) t = __fadd_rn(t, tp.c_act[a]);
            if (rowact_r != nullptr) t = __fadd_rn(t, rowact_r[a]);
            if (a == blk.a_lo || t < best) {  // strict: the first minimum wins
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
          w[k][i] = i < tp.n_row_taps[k] ? tap_weight(o, g, tp.row_taps[k][i])
                                         : 0.0f;
        }
      }
      float t = 0.0f;
      bool have = false;
#pragma unroll
      for (int p = 0; p < kCube; ++p) {
        if (live(tp, p)) {
          const float ww =
              __fmul_rn(__fmul_rn(w[0][p / 9], w[1][(p / 3) % 3]), w[2][p % 3]);
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

int tap_index(const int* taps, int n, int t) {
  for (int i = 0; i < n; ++i) {
    if (taps[i] == t) return i;
  }
  return -1;
}

// The tap structure of one plan into tp; false when it exceeds the kernel's
// capacities.
bool fill_taps(Taps6& tp, const int* w_taps, const int* n_taps,
               const int* row_combos, const int* lane_combos,
               const float* c_act, int n_r1, int n_r2, int n_l1, int n_l2,
               int n_actions, int n_row_combos, int n_lane_combos,
               int digits) {
  if (n_actions < 1 || n_actions > kMaxActions || n_row_combos < 1 ||
      n_lane_combos < 1 || n_lane_combos > kMaxLaneCombos || digits < 0 ||
      digits > kMaxDigits ||
      (digits > 0 && digits * digits * digits != n_actions)) {
    return false;
  }
  tp = Taps6{};
  for (int k = 0; k < 3; ++k) {
    if (n_taps[k] < 1 || n_taps[k] > kMaxTaps) return false;
    tp.n_row_taps[k] = n_taps[k];
    for (int i = 0; i < n_taps[k]; ++i) tp.row_taps[k][i] = w_taps[3 * k + i];
  }
  for (int j = 0; j < n_row_combos; ++j) {
    const int* t = row_combos + 3 * j;
    int p = 0;
    for (int k = 0; k < 3; ++k) {
      const int i = tap_index(tp.row_taps[k], tp.n_row_taps[k], t[k]);
      if (i < 0) return false;
      p = p * 3 + i;
    }
    tp.row_live |= 1 << p;
    tp.row_delta[p] = (t[0] * n_r1 + t[1]) * n_r2 + t[2];
  }
  tp.n_lane_combos = n_lane_combos;
  for (int e = 0; e < n_lane_combos; ++e) {
    const int* t = lane_combos + 3 * e;
    for (int k = 0; k < 3; ++k) tp.lane_tap[e][k] = t[k];
    tp.lane_delta[e] = (t[0] * n_l1 + t[1]) * n_l2 + t[2];
  }
  tp.digits = digits;
  for (int a = 0; a < n_actions; ++a) tp.c_act[a] = c_act[a];
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

// The whole table, every action: the one-device sweep.
Block full_block(int n_rows, int n_actions) {
  return Block{n_rows, 0, 0, n_actions};
}

template <typename ArgT, bool kTrack, bool kRecompute>
int launch(const SweepIo& io, const Taps6& tp, const LaneRec& rec,
           const Block& blk, int n_rows, int n_lanes, int n_actions,
           void* stream) {
  const long long n_cells = static_cast<long long>(n_rows) * n_lanes;
  backup6d_sweep<ArgT, kTrack, kRecompute>
      <<<static_cast<unsigned>((n_cells + kThreads - 1) / kThreads), kThreads,
         0, static_cast<cudaStream_t>(stream)>>>(
          io.values, io.row_off, io.row_frac, io.lane_off[0],
          io.lane_frac[0], io.lane_off[1], io.lane_frac[1], io.lane_off[2],
          io.lane_frac[2], io.c_row, io.c_lane, io.c_rowact, io.c_rowlane,
          io.out_v, static_cast<ArgT*>(io.out_a), n_rows, n_lanes,
          n_actions, tp, rec, blk);
  return static_cast<int>(cudaGetLastError());
}

// The envelope instantiations: argmin_bytes 4 (int32) or 1 (uint8), track
// 1 (argmin) or 0 (min-only, all-zero argmin).
template <bool kRecompute>
int launch_mode(const SweepIo& io, const Taps6& tp, const LaneRec& rec,
                const Block& blk, int n_rows, int n_lanes, int n_actions,
                int argmin_bytes, int track, void* stream) {
  if (argmin_bytes == 4) {
    return track ? launch<int, true, kRecompute>(io, tp, rec, blk, n_rows,
                                                 n_lanes, n_actions, stream)
                 : launch<int, false, kRecompute>(io, tp, rec, blk, n_rows,
                                                  n_lanes, n_actions, stream);
  }
  if (argmin_bytes == 1) {
    return track ? launch<unsigned char, true, kRecompute>(
                       io, tp, rec, blk, n_rows, n_lanes, n_actions, stream)
                 : launch<unsigned char, false, kRecompute>(
                       io, tp, rec, blk, n_rows, n_lanes, n_actions, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// One sweep (B.3). Device pointers: values (NW, NE); row_off/row_frac (3, NW, A);
// lane_off{k}/lane_frac{k} (NW, NE); c_row (NW,); c_lane (NE,); c_rowact
// (NW, A) and c_rowlane (NW, NE) may be null; out_v/out_a (NW, NE). Host
// pointers: w_taps (3, 3) live row taps per axis, ascending, n_taps (3,)
// their counts; row_combos (n_row_combos, 3) and lane_combos
// (n_lane_combos, 3) the live combos, sorted; c_act (A,). digits: the
// action digit base m (A == m^3), or 0 for the generic action phase.
// Returns a cudaError_t (0 on success): cudaErrorInvalidValue when the tap
// structure exceeds the kernel's capacities, else cudaGetLastError() after
// the launch.
extern "C" int backup6d_f32(
    const float* values, const int* row_off, const float* row_frac,
    const int* lane_off0, const float* lane_frac0, const int* lane_off1,
    const float* lane_frac1, const int* lane_off2, const float* lane_frac2,
    const float* c_row, const float* c_lane, const float* c_rowact,
    const float* c_rowlane, float* out_v, int* out_a, const int* w_taps,
    const int* n_taps, const int* row_combos, const int* lane_combos,
    const float* c_act, int n_r0, int n_r1, int n_r2, int n_l0, int n_l1,
    int n_l2, int n_actions, int n_row_combos, int n_lane_combos, int digits,
    void* stream) {
  Taps6 tp;
  if (!fill_taps(tp, w_taps, n_taps, row_combos, lane_combos, c_act, n_r1,
                 n_r2, n_l1, n_l2, n_actions, n_row_combos, n_lane_combos,
                 digits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SweepIo io = {values, row_off, row_frac,
                      {lane_off0, lane_off1, lane_off2},
                      {lane_frac0, lane_frac1, lane_frac2},
                      c_row, c_lane, c_rowact, c_rowlane, out_v, out_a};
  const int n_rows = n_r0 * n_r1 * n_r2;
  return launch<int, true, false>(io, tp, LaneRec{},
                                  full_block(n_rows, n_actions), n_rows,
                                  n_l0 * n_l1 * n_l2, n_actions, stream);
}

// One sweep on a flat plan (B.4): the arguments of backup6d_f32, with out_a
// int32 (argmin_bytes 4) or uint8 (argmin_bytes 1) and track 0 for a
// min-only sweep. out_v and out_a may be buffers the caller reuses.
extern "C" int backup6d_flat_f32(
    const float* values, const int* row_off, const float* row_frac,
    const int* lane_off0, const float* lane_frac0, const int* lane_off1,
    const float* lane_frac1, const int* lane_off2, const float* lane_frac2,
    const float* c_row, const float* c_lane, const float* c_rowact,
    const float* c_rowlane, float* out_v, void* out_a, const int* w_taps,
    const int* n_taps, const int* row_combos, const int* lane_combos,
    const float* c_act, int n_r0, int n_r1, int n_r2, int n_l0, int n_l1,
    int n_l2, int n_actions, int n_row_combos, int n_lane_combos, int digits,
    int argmin_bytes, int track, void* stream) {
  Taps6 tp;
  if (!fill_taps(tp, w_taps, n_taps, row_combos, lane_combos, c_act, n_r1,
                 n_r2, n_l1, n_l2, n_actions, n_row_combos, n_lane_combos,
                 digits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SweepIo io = {values, row_off, row_frac,
                      {lane_off0, lane_off1, lane_off2},
                      {lane_frac0, lane_frac1, lane_frac2},
                      c_row, c_lane, c_rowact, c_rowlane, out_v, out_a};
  const int n_rows = n_r0 * n_r1 * n_r2;
  return launch_mode<false>(io, tp, LaneRec{}, full_block(n_rows, n_actions),
                            n_rows, n_l0 * n_l1 * n_l2, n_actions,
                            argmin_bytes, track, stream);
}

// One sweep with the Euler lanes recomputed per cell (B.5). Device
// pointers: w1..w3 (NW,) the rows' omegas, q1..q4 (NE,) the lanes' kirk-q
// components; the rest as backup6d_flat_f32, without lane plan arrays.
// Host pointer rec_consts: start[3], inv_step[3] and half_h, float32.
// clamp: edge='clamp'.
extern "C" int backup6d_recompute_f32(
    const float* values, const int* row_off, const float* row_frac,
    const float* w1, const float* w2, const float* w3, const float* q1,
    const float* q2, const float* q3, const float* q4,
    const float* rec_consts, const float* c_row, const float* c_lane,
    const float* c_rowact, const float* c_rowlane, float* out_v, void* out_a,
    const int* w_taps, const int* n_taps, const int* row_combos,
    const int* lane_combos, const float* c_act, int n_r0, int n_r1, int n_r2,
    int n_l0, int n_l1, int n_l2, int n_actions, int n_row_combos,
    int n_lane_combos, int digits, int argmin_bytes, int track, int clamp,
    void* stream) {
  Taps6 tp;
  if (!fill_taps(tp, w_taps, n_taps, row_combos, lane_combos, c_act, n_r1,
                 n_r2, n_l1, n_l2, n_actions, n_row_combos, n_lane_combos,
                 digits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaneRec rec;
  if (!fill_rec(rec, w1, w2, w3, q1, q2, q3, q4, rec_consts, n_l0, n_l1, n_l2,
                clamp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SweepIo io = {values, row_off, row_frac, {nullptr, nullptr, nullptr},
                      {nullptr, nullptr, nullptr}, c_row, c_lane, c_rowact,
                      c_rowlane, out_v, out_a};
  const int n_rows = n_r0 * n_r1 * n_r2;
  return launch_mode<true>(io, tp, rec, full_block(n_rows, n_actions), n_rows,
                           n_l0 * n_l1 * n_l2, n_actions, argmin_bytes, track,
                           stream);
}

// One sweep of one rank's row block and action range (B.7). The arguments
// of backup6d_flat_f32, then B.5's w1..w3, q1..q4 and rec_consts (all null
// on a stored lane plan, whose lane_off/lane_frac are then given; the
// reverse for recompute 1), then the block: values (n_table_rows, NE), of
// which output row 0 is table row table_row0; the per-row device arrays
// (row_off/row_frac (3, n_out_rows, A), the lane plan or w1..w3, c_row,
// c_rowact, c_rowlane) and out_v/out_a hold the n_out_rows output rows; the
// first minimum runs over the actions [a_lo, a_hi) and out_a holds global
// action indices. With digits > 0, a_lo and a_hi must be multiples of
// digits^2 (whole fixed-d0 slices).
extern "C" int backup6d_block_f32(
    const float* values, const int* row_off, const float* row_frac,
    const int* lane_off0, const float* lane_frac0, const int* lane_off1,
    const float* lane_frac1, const int* lane_off2, const float* lane_frac2,
    const float* c_row, const float* c_lane, const float* c_rowact,
    const float* c_rowlane, float* out_v, void* out_a, const float* w1,
    const float* w2, const float* w3, const float* q1, const float* q2,
    const float* q3, const float* q4, const float* rec_consts,
    const int* w_taps, const int* n_taps, const int* row_combos,
    const int* lane_combos, const float* c_act, int n_r1, int n_r2, int n_l0,
    int n_l1, int n_l2, int n_actions, int n_row_combos, int n_lane_combos,
    int digits, int argmin_bytes, int track, int recompute, int clamp,
    int n_out_rows, int table_row0, int n_table_rows, int a_lo, int a_hi,
    void* stream) {
  Taps6 tp;
  if (!fill_taps(tp, w_taps, n_taps, row_combos, lane_combos, c_act, n_r1,
                 n_r2, n_l1, n_l2, n_actions, n_row_combos, n_lane_combos,
                 digits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slice = digits * digits;
  if (n_out_rows < 1 || table_row0 < 0 ||
      n_table_rows < table_row0 + n_out_rows || a_lo < 0 || a_hi <= a_lo ||
      a_hi > n_actions ||
      (digits > 0 && (a_lo % slice != 0 || a_hi % slice != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Block blk = {n_table_rows, table_row0, a_lo, a_hi};
  const int n_lanes = n_l0 * n_l1 * n_l2;
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
    return launch_mode<true>(io, tp, rec, blk, n_out_rows, n_lanes, n_actions,
                             argmin_bytes, track, stream);
  }
  const SweepIo io = {values, row_off, row_frac,
                      {lane_off0, lane_off1, lane_off2},
                      {lane_frac0, lane_frac1, lane_frac2},
                      c_row, c_lane, c_rowact, c_rowlane, out_v, out_a};
  return launch_mode<false>(io, tp, LaneRec{}, blk, n_out_rows, n_lanes,
                            n_actions, argmin_bytes, track, stream);
}

extern "C" const char* backup6d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
