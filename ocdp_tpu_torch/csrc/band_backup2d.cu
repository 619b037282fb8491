// Banded 2-D Bellman backup for Hopper (sm_90a), with a leading batch axis.
//
// Replaces the TPU kernel ocdp_tpu/ops/pallas_backup.py::PallasBackup2D.
// _kernel (pl.pallas_call at :158): one sweep of value iteration on a 2-D
// state grid in one action chunk, the simplified attitude axes (1000 x 300,
// 3 torques) and, as a batch of C = 3 channels, the position problem
// (201 x 201, 3 thrusts). Per cell (c, r, l) and action a:
//
//   total_a = sum over the live taps (t1, t2) of the band, t2 outer and t1
//             inner, of (w1(t1) * w2(t2)) * V_c[r + base1 + t1][l + base2 + t2]
//             + cost[c][a][r][l]
//   w_k(t)  = [off_k == t](1 - f_k) + [off_k == t - 1] f_k
//   V'_c[r][l] = min_a total_a,  argmin = the first a reaching it
//
// as the plain version (ops/band_backup2d.py::band_backup2d_plain) computes
// it on the zero-padded table. Nothing of the TPU kernel's blocking is kept:
// no aligned row window, no pltpu.roll per row tap, no 125-135 masked leaves
// per action. One thread serves one cell and reads the four corners of each
// query straight from the plan's (lo, frac), through the plan's broadcast
// strides (a stride of 0 on a broadcast axis): the simplified plan is
// (rows, 1, A) on the omega axis and (rows, lanes, 1) on the theta axis,
// 8 B per (row, action) and 8 B per (row, lane) instead of B.6's dense 16 B
// per evaluation.
//
// Why the four corners equal the tap loop bit for bit, for finite tables:
//   * a query with cell offset (o1, o2) gives a nonzero weight to four taps
//     only, (o1, o2), (o1 + 1, o2), (o1, o2 + 1), (o1 + 1, o2 + 1), which the
//     loop (t2 outer, t1 inner) visits in that order, with weights
//     ((1-f1)(1-f2)), (f1(1-f2)), ((1-f1)f2), (f1 f2) (the other summand of
//     each w_k is an exact +0);
//   * every other term is (0 * w) * leaf = +-0;
//   * the sum starts at +0, and in round-to-nearest it never becomes -0
//     (+0 + -0 = +0, x - x = +0), so adding +-0 never changes it;
//   * lo lies in [0, n-2], so every corner lies inside the table and no
//     padding is read.
// So the kernel computes
//   acc = 0; acc += ((1-f1)*(1-f2))*V[lo1][lo2]; acc += (f1*(1-f2))*V[lo1+1][lo2];
//   acc += ((1-f1)*f2)*V[lo1][lo2+1]; acc += (f1*f2)*V[lo1+1][lo2+1];
//   total = acc + cost[a]
// with explicitly rounded intrinsics (__fsub_rn, __fmul_rn, __fadd_rn), which
// nvcc never contracts into an FMA. A tap the loop skips as dead has a zero
// weight for every query, so the kernel adds +-0 for it.
//
// Minimum and ties: the running minimum starts at action 0's total and a
// later action wins only when strictly smaller, as the plain version's
// chain does (a NaN at action 0 stays; a later NaN never wins). The argmin
// is int32.
//
// Extrapolation: fracs outside [0, 1] are used as given (MATLAB linear
// extrapolation); edge='clamp' plans carry fracs clipped to [0, 1].
//
// What bounds it: bytes. Per (cell, action) 16 FP32 operations (two
// complements, four weight and four value products, four sums, the cost add
// and the compare) against 4 B of dense cost; the table (1.2 MB) stays in
// the 50 MB L2. One simplified-axis sweep moves ~9.6 MB (table, plan at its
// broadcast shapes, dense cost, values and argmin), ~0.003 ms at 3.35 TB/s,
// so a sweep is launch-bound. Later work (ROADMAP B.6): the three axes in
// one launch, a factorized cost instead of the dense (A, n1, n2) array, a
// CUDA graph over the sweeps.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
band_sweep(const float* __restrict__ values, const int* __restrict__ lo1,
           const float* __restrict__ f1, const int* __restrict__ lo2,
           const float* __restrict__ f2, const float* __restrict__ cost,
           float* __restrict__ out_v, int* __restrict__ out_a, int n_batch,
           int n1, int n2, int n_actions, int r1, int l1, int a1, int r2,
           int l2, int a2) {
  const int n_cells = n1 * n2;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_batch * n_cells) return;
  const int c = cell / n_cells;
  const int s = cell - c * n_cells;
  const int r = s / n2;
  const int l = s - r * n2;
  const float* table = values + static_cast<long long>(c) * n_cells;
  const float* cst = cost + static_cast<long long>(c) * n_actions * n_cells + s;
  const int p1 = r * r1 + l * l1;
  const int p2 = r * r2 + l * l2;

  float best = 0.0f;
  int best_a = 0;
  for (int a = 0; a < n_actions; ++a) {
    const int q1 = p1 + a * a1;
    const int q2 = p2 + a * a2;
    const float g1 = f1[q1];
    const float g2 = f2[q2];
    const float h1 = __fsub_rn(1.0f, g1);
    const float h2 = __fsub_rn(1.0f, g2);
    const float* v = table + lo1[q1] * n2 + lo2[q2];
    float acc = 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(h1, h2), v[0]));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(g1, h2), v[n2]));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(h1, g2), v[1]));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(g1, g2), v[n2 + 1]));
    const float total =
        __fadd_rn(acc, cst[static_cast<long long>(a) * n_cells]);
    if (a == 0 || total < best) {  // strict: the first minimum wins
      best = total;
      best_a = a;
    }
  }
  out_v[cell] = best;
  out_a[cell] = best_a;
}

}  // namespace

// One sweep. Device pointers: values (C, n1, n2); lo1/f1 and lo2/f2, each
// pair one contiguous array broadcastable to (n1, n2, A), read at
// row * r + lane * l + action * a (a stride is 0 on a broadcast axis);
// cost (C, A, n1, n2); out_v/out_a (C, n1, n2). Returns a cudaError_t (0 on
// success): cudaErrorInvalidValue for an empty problem, else
// cudaGetLastError() after the launch.
extern "C" int band_backup2d_f32(const float* values, const int* lo1,
                                 const float* f1, const int* lo2,
                                 const float* f2, const float* cost,
                                 float* out_v, int* out_a, int n_batch, int n1,
                                 int n2, int n_actions, int r1, int l1, int a1,
                                 int r2, int l2, int a2, void* stream) {
  if (n_batch < 1 || n1 < 2 || n2 < 2 || n_actions < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = n_batch * n1 * n2;
  band_sweep<<<(n + kThreads - 1) / kThreads, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      values, lo1, f1, lo2, f2, cost, out_v, out_a, n_batch, n1, n2,
      n_actions, r1, l1, a1, r2, l2, a2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* band_backup2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
