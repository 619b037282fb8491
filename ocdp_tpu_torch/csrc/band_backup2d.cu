// Banded 2-D Bellman backup for Hopper (sm_90a), over a batch of channels,
// with a factorized stage cost.
//
// Replaces the TPU kernel ocdp_tpu/ops/pallas_backup.py::PallasBackup2D.
// _kernel (pl.pallas_call at :158): one sweep of value iteration on a 2-D
// state grid in one action chunk, the simplified attitude axes (1000 x 300,
// 3 torques) and the position problem (201 x 201, 3 thrusts). A launch
// takes a batch of C channels: the three simplified axes, each with its own
// plan, or position's three channels, which share one. Per cell (c, r, l)
// and action a:
//
//   total_a = sum over the live taps (t1, t2) of the band, t2 outer and t1
//             inner, of (w1(t1) * w2(t2)) * V_c[r + base1 + t1][l + base2 + t2]
//             + cost_c(r, l, a)
//   cost_c(r, l, a) = ((0 + term_0) + term_1) + ... (up to 4 terms)
//   w_k(t)  = [off_k == t](1 - f_k) + [off_k == t - 1] f_k
//   V'_c[r][l] = min_a total_a,  argmin = the first a reaching it
//
// as the plain version (ops/band_backup2d.py::band_backup2d_plain) computes
// it on the zero-padded table. Nothing of the TPU kernel's blocking is kept:
// no aligned row window, no pltpu.roll per row tap, no 125-135 masked leaves
// per action. One thread serves one cell and reads the four corners of each
// query straight from the plan's (lo, frac), through the plan's broadcast
// strides over (channel, row, lane, action) (a stride of 0 on a broadcast
// axis): the simplified plan is (C, rows, 1, A) on the omega axis and
// (C, rows, lanes, 1) on the theta axis, position's (1, rows, 1, A) and
// (1, 1, lanes, 1) shared by its channels. The stage cost arrives as up to
// four terms, each read through its own broadcast strides, and is summed
// from +0 in term order: the order and rounding in which the dense cost was
// summed on the host before (after ocdp_tpu/ops/pallas_backup.py:83-88), so
// a dense cost is one term and gives the same bits.
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
//   total = acc + cost
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
// What bounds it: bytes, and before this design the host. Per (cell,
// action) 16 FP32 operations plus one add a cost term, against the table
// read and the values and argmin written; the plan and the cost terms at
// their broadcast shapes are small beside them, all but the theta plan's
// 8 B a cell. Offsets are 32-bit (a launch refuses 2^31 evaluations), each
// array's offset of a cell is formed once and an action adds its stride,
// and the leading cost terms that do not vary with the action (the
// simplified axes' Qw w^2 and Qq t^2, position's Qx x^2 and Qv v^2) are
// summed once a cell, from +0 in order, before the action loop adds the
// rest: the same sum. The three simplified axes in one launch move ~18 MB a
// sweep, ~0.0054 ms at 3.35 TB/s (a dense cost would add 3.6 MB an
// axis). With three actions (every plan here) the action loop is
// unrolled, so the three actions' plan and table reads are in flight
// together. Measured on an H100 (PERF.md §6): the three axes in one launch
// 0.0128 ms, 2.4x the bytes bound, against 3 x 0.0053 ms as three launches.
// A single call still costs the host more than the device (~0.04 ms), so
// the finite engine replays its sweeps as CUDA graphs
// (ocdp_tpu_torch/engine.py): the launch takes its outputs from the caller
// and sets no function attribute, so it may be captured.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTerms = 4;   // MAX_TERMS in ops/band_backup2d.py
// the strided arrays: the two plan axes (lo and frac share strides) and
// the cost terms
constexpr int kArrays = 2 + kMaxTerms;

struct Band {
  const float* values;
  float* out_v;
  int* out_a;
  const int* lo1;
  const float* f1;
  const int* lo2;
  const float* f2;
  const float* term[kMaxTerms];
  int n_batch, n1, n2, n_actions, n_terms;
  int n_lead;          // leading terms that do not vary with the action
  int s[kArrays][4];   // element strides over (channel, row, lane, action)
};

// kA > 0: exactly kA actions, the action loop unrolled, so every action's
// plan and table reads are in flight together; kA = 0: any count.
template <int kA>
__global__ void __launch_bounds__(kThreads)
band_sweep(const __grid_constant__ Band b) {
  const int n_cells = b.n1 * b.n2;
  const int cell = blockIdx.x * kThreads + threadIdx.x;
  if (cell >= b.n_batch * n_cells) return;
  const int c = cell / n_cells;
  const int s = cell - c * n_cells;
  const int r = s / b.n2;
  const int l = s - r * b.n2;
  const float* table = b.values + c * n_cells;
  // each array's offset of this cell; an action adds a * its action stride
  int base[kArrays];
#pragma unroll
  for (int k = 0; k < kArrays; ++k) {
    base[k] = c * b.s[k][0] + r * b.s[k][1] + l * b.s[k][2];
  }
  // the leading terms that do not vary with the action, summed from +0 once
  float lead = 0.0f;
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t) {
    if (t < b.n_lead) lead = __fadd_rn(lead, b.term[t][base[2 + t]]);
  }

  float best = 0.0f;
  int best_a = 0;
  const int n_actions = kA > 0 ? kA : b.n_actions;
#pragma unroll
  for (int a = 0; a < n_actions; ++a) {
    const int q1 = base[0] + a * b.s[0][3];
    const int q2 = base[1] + a * b.s[1][3];
    const float g1 = b.f1[q1];
    const float g2 = b.f2[q2];
    const float h1 = __fsub_rn(1.0f, g1);
    const float h2 = __fsub_rn(1.0f, g2);
    const float* v = table + b.lo1[q1] * b.n2 + b.lo2[q2];
    float acc = 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(h1, h2), v[0]));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(g1, h2), v[b.n2]));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(h1, g2), v[1]));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(g1, g2), v[b.n2 + 1]));
    float cost = lead;
#pragma unroll
    for (int t = 0; t < kMaxTerms; ++t) {
      if (t >= b.n_lead && t < b.n_terms) {
        cost = __fadd_rn(cost, b.term[t][base[2 + t] + a * b.s[2 + t][3]]);
      }
    }
    const float total = __fadd_rn(acc, cost);
    if (a == 0 || total < best) {  // strict: the first minimum wins
      best = total;
      best_a = a;
    }
  }
  b.out_v[cell] = best;
  b.out_a[cell] = best_a;
}

}  // namespace

// One sweep. ptrs (device): values (C, n1, n2), out_v and out_a (C, n1,
// n2), lo1, f1, lo2, f2, then n_terms cost terms (the rest 0); ints:
// n_batch, n1, n2, n_actions, n_terms, then 4 element strides over
// (channel, row, lane, action) for axis 1's plan, axis 2's plan and each
// term (a stride is 0 on a broadcast axis). Returns a cudaError_t (0 on
// success): cudaErrorInvalidValue for an empty problem, one of 2^31
// evaluations or more, a null pointer or too many terms, else
// cudaGetLastError() after the launch.
extern "C" int band_backup2d_f32(const long long* ptrs, const int* ints,
                                 void* stream) {
  Band b;
  b.n_batch = ints[0];
  b.n1 = ints[1];
  b.n2 = ints[2];
  b.n_actions = ints[3];
  b.n_terms = ints[4];
  if (b.n_batch < 1 || b.n1 < 2 || b.n2 < 2 || b.n_actions < 1 ||
      b.n_terms < 0 || b.n_terms > kMaxTerms ||
      static_cast<long long>(b.n_batch) * b.n1 * b.n2 * b.n_actions >=
          (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < 7 + b.n_terms; ++k) {
    if (ptrs[k] == 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  b.values = reinterpret_cast<const float*>(ptrs[0]);
  b.out_v = reinterpret_cast<float*>(ptrs[1]);
  b.out_a = reinterpret_cast<int*>(ptrs[2]);
  b.lo1 = reinterpret_cast<const int*>(ptrs[3]);
  b.f1 = reinterpret_cast<const float*>(ptrs[4]);
  b.lo2 = reinterpret_cast<const int*>(ptrs[5]);
  b.f2 = reinterpret_cast<const float*>(ptrs[6]);
  for (int t = 0; t < kMaxTerms; ++t) {
    b.term[t] = t < b.n_terms ? reinterpret_cast<const float*>(ptrs[7 + t])
                              : nullptr;
  }
  b.n_lead = 0;
  for (int k = 0; k < kArrays; ++k) {
    for (int d = 0; d < 4; ++d) b.s[k][d] = ints[5 + 4 * k + d];
  }
  while (b.n_lead < b.n_terms && b.s[2 + b.n_lead][3] == 0) ++b.n_lead;
  const long long n = static_cast<long long>(b.n_batch) * b.n1 * b.n2;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b.n_actions == 3) {   // the simplified axes' and position's torques
    band_sweep<3><<<blocks, kThreads, 0, st>>>(b);
  } else {
    band_sweep<0><<<blocks, kThreads, 0, st>>>(b);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM of the kernel for n_actions actions (its
// three-action body for 3, else the general one), on the current device;
// -1 on an error.
extern "C" int band_backup2d_blocks_per_sm(int n_actions) {
  int blocks = 0;
  const cudaError_t err =
      n_actions == 3
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, band_sweep<3>, kThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, band_sweep<0>, kThreads, 0);
  return err == cudaSuccess ? blocks : -1;
}

extern "C" const char* band_backup2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
