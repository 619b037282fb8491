// Fused 2-D Bellman backup for Hopper (sm_90a).
//
// Replaces the TPU kernel ocdp_tpu/ops/pallas_shear.py::
// PallasShearBackup._kernel_impl (entry points _kernel for a full cost stack
// and _kernel_sep for a separable state + action cost). It computes what that
// kernel computes, one backward sweep of value iteration on a 2-D state grid:
//
//   total[a, s] = sum_{corners} w_corner(f0, f1) * V[corner(lo0, lo1)]
//                 + cost[a, s]
//   V'[s] = min_a total[a, s],  argmin[s] = the FIRST a reaching it
//
// and nothing of its TPU machinery. The shear-gather layout (band windows,
// the jj == pair select chain) exists on the TPU only because per-query
// gathers are slow there. Here the whole value table (40 KB at 100 x 100)
// is staged in shared memory and each (cell, action) reads its four corners
// straight from the plan's (lo0, lo1, f0, f1).
//
// Layout: the plan and a full cost are action-major, (A, S) with
// S = n0 * n1, so neighbouring threads of a warp read neighbouring cells at
// the same action (coalesced 4 B loads).
//
// Arithmetic, bitwise equal to ocdp_tpu_torch/ops/interp.py::interp_apply
// followed by the cost add:
//   * corner order (0,0), (0,1), (1,0), (1,1); weight = (axis-0 factor) *
//     (axis-1 factor), then weight * value; the four terms summed left to
//     right; then + cost;
//   * a separable cost is formed first as state_cost[s] + action_cost[a] and
//     then added, the association ocdp_tpu_torch/models/kirk.py::build uses
//     to recompose the full stage cost;
//   * every multiply and add is an explicitly rounded intrinsic (__fmul_rn,
//     __fadd_rn, __fsub_rn), which nvcc never contracts into an FMA. A plain
//     a * b + c would be contracted under nvcc's default --fmad=true and
//     would differ from PyTorch's separately rounded ops in the last bit.
//
// Minimum and ties: each thread scans its action range in order with a
// strict '<' (the first minimum of the range wins). The action axis is split
// across blockIdx.y to fill the card (full Kirk has only 10^4 cells); the
// combine pass walks the splits in order, again with a strict '<', so a later
// split wins only when strictly smaller. Together that is exactly the serial
// strict-'<' scan over all actions, i.e. torch.min's first-minimum index.
//
// NaN rule: the running minimum starts at +inf, and a NaN total never
// compares '<', so a NaN never wins: the kernel returns the first minimum
// over the non-NaN totals, as MATLAB's min does. A cell whose totals are all
// NaN or +inf gets +inf and action 0. The plain PyTorch version propagates
// NaN instead; the two agree on finite inputs, which is what is compared.
//
// Extrapolation: fracs outside [0, 1] are used as given (MATLAB linear
// extrapolation); lo is the clamped cell index, so the corner reads stay in
// the table.
//
// What bounds it: the plan stream. Each (cell, action) reads 16 B of plan
// (two int32 indices, two float fracs) that are used once per sweep:
// 160 MB per full-Kirk sweep (10^4 cells x 1000 actions), above the 50 MB L2,
// so every sweep streams it from HBM. The table reads hit shared memory.
// Later work (ROADMAP B.1): recompute the affine queries in-kernel instead of
// streaming the plan, tune occupancy, and capture the sweep loop in a CUDA
// graph.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void backup_partial(const float* __restrict__ values,
                               const int* __restrict__ lo0,
                               const int* __restrict__ lo1,
                               const float* __restrict__ f0,
                               const float* __restrict__ f1,
                               const float* __restrict__ cost,
                               const float* __restrict__ state_cost,
                               const float* __restrict__ action_cost,
                               int n0, int n1, int n_actions,
                               int actions_per_split,
                               float* __restrict__ part_v,
                               int* __restrict__ part_a) {
  extern __shared__ float table[];
  const int n_cells = n0 * n1;
  for (int i = threadIdx.x; i < n_cells; i += blockDim.x) {
    table[i] = values[i];
  }
  __syncthreads();

  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_cells) return;
  const int a_begin = blockIdx.y * actions_per_split;
  const int a_end = min(a_begin + actions_per_split, n_actions);
  const float s_cost = cost == nullptr ? state_cost[cell] : 0.0f;

  float best_v = CUDART_INF_F;
  int best_a = a_begin;
  for (int a = a_begin; a < a_end; ++a) {
    const long long q = static_cast<long long>(a) * n_cells + cell;
    const int base = lo0[q] * n1 + lo1[q];
    const float g0 = f0[q];
    const float g1 = f1[q];
    const float h0 = __fsub_rn(1.0f, g0);
    const float h1 = __fsub_rn(1.0f, g1);
    float t = __fmul_rn(__fmul_rn(h0, h1), table[base]);
    t = __fadd_rn(t, __fmul_rn(__fmul_rn(h0, g1), table[base + 1]));
    t = __fadd_rn(t, __fmul_rn(__fmul_rn(g0, h1), table[base + n1]));
    t = __fadd_rn(t, __fmul_rn(__fmul_rn(g0, g1), table[base + n1 + 1]));
    const float c = cost == nullptr ? __fadd_rn(s_cost, action_cost[a])
                                    : cost[q];
    t = __fadd_rn(t, c);
    if (t < best_v) {  // strict: the first minimum of the range wins
      best_v = t;
      best_a = a;
    }
  }
  const long long o = static_cast<long long>(blockIdx.y) * n_cells + cell;
  part_v[o] = best_v;
  part_a[o] = best_a;
}

__global__ void combine_splits(const float* __restrict__ part_v,
                               const int* __restrict__ part_a,
                               int n_cells, int n_splits,
                               float* __restrict__ out_v,
                               int* __restrict__ out_a) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_cells) return;
  float best_v = part_v[cell];
  int best_a = part_a[cell];
  for (int s = 1; s < n_splits; ++s) {
    const long long o = static_cast<long long>(s) * n_cells + cell;
    const float v = part_v[o];
    if (v < best_v) {  // strict: an earlier split wins ties
      best_v = v;
      best_a = part_a[o];
    }
  }
  out_v[cell] = best_v;
  out_a[cell] = best_a;
}

constexpr int kThreads = 256;

}  // namespace

// One sweep. cost == nullptr selects the separable cost (state_cost (S,) +
// action_cost (A,)). With n_splits > 1 the partial minima go to part_v /
// part_a, (n_splits, S), and a second pass combines them into out_v / out_a;
// with n_splits == 1 the first pass writes out_v / out_a directly.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int fused_backup2d_f32(const float* values, const int* lo0,
                                  const int* lo1, const float* f0,
                                  const float* f1, const float* cost,
                                  const float* state_cost,
                                  const float* action_cost, float* part_v,
                                  int* part_a, float* out_v, int* out_a,
                                  int n0, int n1, int n_actions,
                                  int actions_per_split, void* stream) {
  const int n_cells = n0 * n1;
  const int n_splits = (n_actions + actions_per_split - 1) / actions_per_split;
  const size_t smem = static_cast<size_t>(n_cells) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      backup_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_cells + kThreads - 1) / kThreads, n_splits);
  float* pv = n_splits == 1 ? out_v : part_v;
  int* pa = n_splits == 1 ? out_a : part_a;
  backup_partial<<<grid, kThreads, smem, s>>>(
      values, lo0, lo1, f0, f1, cost, state_cost, action_cost, n0, n1,
      n_actions, actions_per_split, pv, pa);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  combine_splits<<<(n_cells + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part_v, part_a, n_cells, n_splits, out_v, out_a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_backup2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
