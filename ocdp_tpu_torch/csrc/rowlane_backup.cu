// Row/lane Bellman backup for Hopper (sm_90a), lane-separable mode.
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
// Layout and what bounds it: one thread per cell, 256 threads per block
// over the flat (NW * NE) cells, so a warp reads consecutive lanes of one
// or two rows. The table (1.08 MB for PosAttConfig(), 17.3 MB at high_res)
// stays in the 50 MB L2 and is read from there: 81 (9 row combos x 3 x 3
// lane taps) to 153 reads per cell, each 4 B, plus the per-(row, action)
// row plan (uniform across a warp). The row combos' interpolated rows A_j
// are kept in registers (kMaxRowCombos), reused by every action. Later work
// (ROADMAP B.2): shared-memory tiles of the table rows a block needs, and
// the four channels in one launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLaneTaps = 8;     // MAX_LANE_TAPS in ops/rowlane.py
constexpr int kMaxRowCombos = 32;   // MAX_ROW_COMBOS
constexpr int kMaxActions = 64;     // MAX_ACTIONS

// The tap structure, passed by value (it lives in the constant bank).
struct Taps {
  int n_combos, n_taps0, n_taps1;
  int combo0[kMaxRowCombos];   // row-axis-0 tap of combo j
  int combo1[kMaxRowCombos];   // row-axis-1 tap of combo j
  int delta[kMaxRowCombos];    // flat row shift D_j = combo0 * n_r1 + combo1
  int taps0[kMaxLaneTaps];     // live taps of lane axis 0, ascending
  int taps1[kMaxLaneTaps];     // live taps of lane axis 1, ascending
  float c_act[kMaxActions];    // per-action cost
};

__device__ __forceinline__ float tap_weight(int off, float f, int t) {
  return __fadd_rn(off == t ? __fsub_rn(1.0f, f) : 0.0f,
                   off == t - 1 ? f : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
rowlane_sweep(const float* __restrict__ values,
              const int* __restrict__ row_off,
              const float* __restrict__ row_frac,
              const int* __restrict__ lane_off0,
              const float* __restrict__ lane_frac0,
              const int* __restrict__ lane_off1,
              const float* __restrict__ lane_frac1,
              const float* __restrict__ c_row,
              const float* __restrict__ c_lane,
              const float* __restrict__ c_rowact,
              const float* __restrict__ c_rowlane,
              float* __restrict__ out_v, int* __restrict__ out_a,
              int n_rows, int n_l0, int n_l1, int n_actions,
              const __grid_constant__ Taps tp) {
  const int n_lanes = n_l0 * n_l1;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_rows * n_lanes) return;
  const int r = cell / n_lanes;
  const int c = cell - r * n_lanes;
  const int i0 = c / n_l1;
  const int i1 = c - i0 * n_l1;
  const int off0 = lane_off0[r * n_l0 + i0];
  const float f0 = lane_frac0[r * n_l0 + i0];
  const int off1 = lane_off1[r * n_l1 + i1];
  const float f1 = lane_frac1[r * n_l1 + i1];

  // lane phase: the interpolated shifted row of every live row combo
  float A[kMaxRowCombos];
#pragma unroll
  for (int j = 0; j < kMaxRowCombos; ++j) {
    if (j < tp.n_combos) {
      const int rr = r + tp.delta[j];
      const bool row_in = rr >= 0 && rr < n_rows;
      const long long row_base = static_cast<long long>(rr) * n_lanes;
      float acc = 0.0f;
      for (int a0 = 0; a0 < tp.n_taps0; ++a0) {
        const int t0 = tp.taps0[a0];
        const int c2 = c + t0 * n_l1;
        float b = 0.0f;
        if (c2 >= 0 && c2 < n_lanes) {
          for (int a1 = 0; a1 < tp.n_taps1; ++a1) {
            const int t1 = tp.taps1[a1];
            const int c3 = c2 + t1;
            const float v = (row_in && c3 >= 0 && c3 < n_lanes)
                                ? values[row_base + c3]
                                : 0.0f;
            const float term = __fmul_rn(tap_weight(off1, f1, t1), v);
            b = a1 == 0 ? term : __fadd_rn(b, term);
          }
        }
        const float term = __fmul_rn(tap_weight(off0, f0, t0), b);
        acc = a0 == 0 ? term : __fadd_rn(acc, term);
      }
      A[j] = acc;
    }
  }

  // action phase: strict-'<' first minimum from action 0
  const long long plane = static_cast<long long>(n_rows) * n_actions;
  const int* off_r0 = row_off + static_cast<long long>(r) * n_actions;
  const int* off_r1 = off_r0 + plane;
  const float* frac_r0 = row_frac + static_cast<long long>(r) * n_actions;
  const float* frac_r1 = frac_r0 + plane;
  float best = 0.0f;
  int best_a = 0;
  for (int a = 0; a < n_actions; ++a) {
    const int o0 = off_r0[a];
    const int o1 = off_r1[a];
    const float g0 = frac_r0[a];
    const float g1 = frac_r1[a];
    float tot = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxRowCombos; ++j) {
      if (j < tp.n_combos) {
        const float w = __fmul_rn(tap_weight(o0, g0, tp.combo0[j]),
                                  tap_weight(o1, g1, tp.combo1[j]));
        const float term = __fmul_rn(w, A[j]);
        tot = j == 0 ? term : __fadd_rn(tot, term);
      }
    }
    if (tp.c_act[a] != 0.0f) tot = __fadd_rn(tot, tp.c_act[a]);
    if (c_rowact != nullptr) {
      tot = __fadd_rn(tot, c_rowact[static_cast<long long>(r) * n_actions + a]);
    }
    if (a == 0 || tot < best) {  // strict: the first minimum wins
      best = tot;
      best_a = a;
    }
  }
  float out = __fadd_rn(__fadd_rn(best, c_row[r]), c_lane[c]);
  out = __fadd_rn(out, c_rowlane != nullptr ? c_rowlane[cell] : 0.0f);
  out_v[cell] = out;
  out_a[cell] = best_a;
}

}  // namespace

// One sweep. Device pointers: values (NW, NE); row_off/row_frac (2, NW, A);
// lane_off0/lane_frac0 (NW, n_l0); lane_off1/lane_frac1 (NW, n_l1); c_row
// (NW,); c_lane (NE,); c_rowact (NW, A) and c_rowlane (NW, NE) may be null;
// out_v/out_a (NW, NE). Host pointers: combos (n_combos, 2) row taps per
// combo; taps0 (n_taps0,), taps1 (n_taps1,) lane taps; c_act (A,).
// Returns a cudaError_t (0 on success): cudaErrorInvalidValue when the tap
// structure exceeds the kernel's capacities, else cudaGetLastError() after
// the launch.
extern "C" int rowlane_backup_f32(
    const float* values, const int* row_off, const float* row_frac,
    const int* lane_off0, const float* lane_frac0, const int* lane_off1,
    const float* lane_frac1, const float* c_row, const float* c_lane,
    const float* c_rowact, const float* c_rowlane, float* out_v, int* out_a,
    const int* combos, const int* taps0, const int* taps1, const float* c_act,
    int n_r0, int n_r1, int n_l0, int n_l1, int n_actions, int n_combos,
    int n_taps0, int n_taps1, void* stream) {
  if (n_combos < 1 || n_combos > kMaxRowCombos || n_taps0 < 1 ||
      n_taps0 > kMaxLaneTaps || n_taps1 < 1 || n_taps1 > kMaxLaneTaps ||
      n_actions < 1 || n_actions > kMaxActions) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps tp;
  tp.n_combos = n_combos;
  tp.n_taps0 = n_taps0;
  tp.n_taps1 = n_taps1;
  for (int j = 0; j < n_combos; ++j) {
    tp.combo0[j] = combos[2 * j];
    tp.combo1[j] = combos[2 * j + 1];
    tp.delta[j] = combos[2 * j] * n_r1 + combos[2 * j + 1];
  }
  for (int t = 0; t < n_taps0; ++t) tp.taps0[t] = taps0[t];
  for (int t = 0; t < n_taps1; ++t) tp.taps1[t] = taps1[t];
  for (int a = 0; a < n_actions; ++a) tp.c_act[a] = c_act[a];
  const int n_rows = n_r0 * n_r1;
  const int n_cells = n_rows * n_l0 * n_l1;
  rowlane_sweep<<<(n_cells + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      values, row_off, row_frac, lane_off0, lane_frac0, lane_off1,
      lane_frac1, c_row, c_lane, c_rowact, c_rowlane, out_v, out_a, n_rows,
      n_l0, n_l1, n_actions, tp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rowlane_backup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
