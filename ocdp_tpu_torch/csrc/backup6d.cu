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
               float* __restrict__ out_v, int* __restrict__ out_a,
               int n_rows, int n_lanes, int n_actions,
               const __grid_constant__ Taps6 tp) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_rows * n_lanes) return;
  const int r = cell / n_lanes;
  const int c = cell - r * n_lanes;
  const int o0 = lane_off0[cell], o1 = lane_off1[cell], o2 = lane_off2[cell];
  const float f0 = lane_frac0[cell], f1 = lane_frac1[cell],
              f2 = lane_frac2[cell];

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
        const int rr = r + tp.row_delta[p];
        const float v = (lane_in && rr >= 0 && rr < n_rows)
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
    // factorized action phase; the totals sit in tot[(d0 * 3 + d1) * 3 + d2]
    const int m = tp.digits;
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
                if (d0 < m) {
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
          if (d0 < m && d1 < m && d2 < m) {
            const int a = (d0 * m + d1) * m + d2;
            float t = tot[(d0 * 3 + d1) * 3 + d2];
            if (tp.c_act[a] != 0.0f) t = __fadd_rn(t, tp.c_act[a]);
            if (rowact_r != nullptr) t = __fadd_rn(t, rowact_r[a]);
            if (a == 0 || t < best) {  // strict: the first minimum wins
              best = t;
              best_a = a;
            }
          }
        }
      }
    }
  } else {
    // generic action phase: every live row combo per action
    for (int a = 0; a < n_actions; ++a) {
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
      if (a == 0 || t < best) {  // strict: the first minimum wins
        best = t;
        best_a = a;
      }
    }
  }
  float out = __fadd_rn(__fadd_rn(best, c_row[r]), c_lane[c]);
  out = __fadd_rn(out, c_rowlane != nullptr ? c_rowlane[cell] : 0.0f);
  out_v[cell] = out;
  out_a[cell] = best_a;
}

int tap_index(const int* taps, int n, int t) {
  for (int i = 0; i < n; ++i) {
    if (taps[i] == t) return i;
  }
  return -1;
}

}  // namespace

// One sweep. Device pointers: values (NW, NE); row_off/row_frac (3, NW, A);
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
  if (n_actions < 1 || n_actions > kMaxActions || n_row_combos < 1 ||
      n_lane_combos < 1 || n_lane_combos > kMaxLaneCombos || digits < 0 ||
      digits > kMaxDigits ||
      (digits > 0 && digits * digits * digits != n_actions)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps6 tp = {};
  for (int k = 0; k < 3; ++k) {
    if (n_taps[k] < 1 || n_taps[k] > kMaxTaps) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tp.n_row_taps[k] = n_taps[k];
    for (int i = 0; i < n_taps[k]; ++i) tp.row_taps[k][i] = w_taps[3 * k + i];
  }
  for (int j = 0; j < n_row_combos; ++j) {
    const int* t = row_combos + 3 * j;
    int p = 0;
    for (int k = 0; k < 3; ++k) {
      const int i = tap_index(tp.row_taps[k], tp.n_row_taps[k], t[k]);
      if (i < 0) return static_cast<int>(cudaErrorInvalidValue);
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
  const int n_rows = n_r0 * n_r1 * n_r2;
  const int n_lanes = n_l0 * n_l1 * n_l2;
  const long long n_cells = static_cast<long long>(n_rows) * n_lanes;
  backup6d_sweep<<<static_cast<unsigned>((n_cells + kThreads - 1) / kThreads),
                   kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, row_off, row_frac, lane_off0, lane_frac0, lane_off1,
      lane_frac1, lane_off2, lane_frac2, c_row, c_lane, c_rowact, c_rowlane,
      out_v, out_a, n_rows, n_lanes, n_actions, tp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* backup6d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
