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
// gathers are slow there. Here the table rows a block reads are staged in
// shared memory and each (cell, action) reads its four corners there.
//
// Layout (plan-streamed mode): the plan and a full cost are action-major,
// (A, S) with S = n0 * n1, so neighbouring threads of a warp read
// neighbouring cells at the same action (coalesced 4 B loads).
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
// strict '<' (the first minimum of the range wins). The plan-streamed mode
// splits the action axis across blockIdx.y to fill the card (full Kirk has
// only 10^4 cells) and stages the whole table in each block; its combine
// pass walks the splits in order, again with a strict '<', so a later
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
// Two modes share that arithmetic:
//
// * the plan-streamed mode (backup_partial + combine_splits), for any 2-D
//   plan: each (cell, action) reads 16 B of plan (two int32 indices, two
//   float fracs) used once per sweep, 160 MB per full-Kirk sweep (10^4 cells
//   x 1000 actions), above the 50 MB L2, so every sweep streams it from HBM:
//   the bytes bound it;
// * the affine-query mode (affine_sweep, below), for dynamics x' = A x + B u
//   (Kirk): each thread forms its queries, locates them and takes their
//   fracs itself, so a sweep reads only the table, the axes, the controls
//   and the two cost parts (about 100 KB at full Kirk) and writes 80 KB. The
//   operations bound it. One launch a sweep: a block owns a run of cells and
//   all their action splits, and reduces the splits in shared memory.

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

// ---------------------------------------------------------------------------
// Affine-query mode.
//
// Inputs: the two state axes g0 (n0,) and g1 (n1,), strictly ascending; the
// controls u (A,); A = [[a00, a01], [a10, a11]] and B = (b0, b1) as the f32
// values PyTorch uses for the Python scalars (the double rounded to nearest);
// the separable cost. Cell (i, j) sits at (x0, x1) = (g0[i], g1[j]).
//
// Queries, in the rounding steps of ocdp_tpu_torch/models/kirk.py::build
// (x1n = a11 * x1 + a12 * x2 + b1 * u, PyTorch's eager ops left to right):
//   P_k = __fadd_rn(__fmul_rn(a_k0, x0), __fmul_rn(a_k1, x1))   once a cell
//   B_k[a] = __fmul_rn(b_k, u[a])             once a block, in shared memory
//   q_k = __fadd_rn(P_k, B_k[a])                               each action
// Locate, as ocdp_tpu_torch/ops/interp.py::axis_locate:
//   lo_k = searchsorted(g_k, q_k, right=True) - 1 clamped to [0, n_k - 2];
//   frac_k = __fdiv_rn(__fsub_rn(q_k, g[lo]), __fsub_rn(g[lo+1], g[lo]))
//     (two rounded differences and an IEEE-rounded divide; fracs outside
//     [0, 1] are kept: MATLAB's linear extrapolation).
// Then the streamed mode's bilinear sum and cost add. Every step is an
// explicitly rounded intrinsic, never contracted into an FMA, so the result
// equals the streamed mode on the plan kirk.build makes, bitwise. The host
// refuses inputs whose queries could overflow f32, so no query is NaN.
//
// The locate: a thread binary-searches the first query of its action range,
// then moves lo from each query to the next (walk). Each cell keeps g[lo-1]
// .. g[lo+2] and the cell's edges in registers, so the common move, one cell
// up or down, costs a few register moves and one shared load whose result
// only a later move reads; a move of more than one cell takes a loop. For a
// fixed sign of b_k, q_k is monotone in u (rounding is monotone), so on
// Kirk's ascending controls lo moves a cell every ~20 actions. The walk is
// exact from any start, so a negative or zero b_k, or unsorted controls,
// cost steps, not correctness.
//
// What a block keeps in shared memory (the stage, AffineArgs.stage in
// ops/fused_backup2d.py, chosen on the host before any launch, from the
// configuration alone):
//
// * kStageAll (Kirk's default and every configuration that fits): the
//   table rows its queries reach, which the host planner
//   (ops/fused_backup2d.py::plan_rows) finds from the same affine map at the
//   controls' extremes: row0[block], n_rows[block] (~8 rows of 100 at full
//   Kirk, against the 100-row table each streamed-mode block stages); the
//   axes; and the action record (B_0 u, B_1 u, cost) of every action, 16 B
//   an action. Shared memory grows with the actions and the rows;
// * kStageChunks (too many actions for that): the same rows and axes, and
//   the action records in chunks: a __syncthreads-separated loop stages
//   `chunk` records of each split's action range at a time, so the records
//   take 16 B x chunk x n_splits whatever the action count;
// * kTableGlobal (the planned rows do not fit beside the chunk): the action
//   records in chunks, and the table and the axes read from global memory
//   through the read-only path (a 300 x 300 f32 table is 360 KB, far
//   inside the 50 MB L2). Shared memory is then the chunk and the split
//   minima alone, so every configuration fits.
//
// The three read the same values and scan the same actions in the same
// order, so they give the same sweep bitwise.
//
// Work: a block owns cells_per_block consecutive cells and n_splits action
// ranges of each, a thread one cell and one range.
//
// Minimum and ties: a thread scans its action range
// [s * per, (s + 1) * per) in order with a strict '<' (in chunks, the
// chunks in order); after a barrier the split-0 thread of each cell walks
// the splits in order with a strict '<'. That is the serial strict-'<'
// scan over all actions, with the streamed mode's NaN rule.
//
// What bounds it: operations (about 26 an evaluation, an IEEE divide on
// each axis among them); the bytes are the table rows, the axes, the
// controls and costs, and the outputs, ~170 KB a sweep at full Kirk. On an
// H100 it runs at ~11x that bound, held by a long chain of dependent
// instructions an evaluation (the walk's checks and moves, two IEEE
// divides, the bilinear sum); the alternatives tried were no faster
// (PERF.md, B.1).

struct AffineParams {
  const float* g0;           // (n0,) axis 0
  const float* g1;           // (n1,) axis 1
  const float* u;            // (n_actions,) controls
  const float* state_cost;   // (n0 * n1,)
  const float* action_cost;  // (n_actions,)
  const int* row0;           // (n_blocks,) first table row a block stages
  const int* n_rows;         // (n_blocks,) rows it stages
  int n0, n1, n_actions;
  int cells_per_block, n_splits, actions_per_split, max_rows, n_blocks;
  int stage;                 // kStageAll, kStageChunks or kTableGlobal
  int chunk;                 // actions a split stages at a time (chunked)
  float a00, a01, a10, a11, b0, b1;
};

namespace {

constexpr int kAffineMaxThreads = 512;
enum AffineStage { kStageAll = 0, kStageChunks = 1, kTableGlobal = 2 };

// searchsorted(g, q, right=True) - 1, clamped to [0, n - 2]
__device__ __forceinline__ int locate(const float* g, int n, float q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!(g[mid] > q)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return min(max(lo - 1, 0), n - 2);
}

// Past one cell: the cell of q from lo, by a loop (rare).
__device__ __noinline__ int walk_far(const float* g, int n, int lo, float q) {
  while (lo < n - 2 && !(g[lo + 1] > q)) ++lo;
  while (lo > 0 && g[lo] > q) --lo;
  return lo;
}

// One axis's located cell. The cell is q's when !(q >= up_edge) and
// !(down_edge > q): up_edge is g[lo + 1], or +inf at the top cell;
// down_edge is g[lo], or -inf at the bottom one.
struct AxisCell {
  int lo;
  float below, g_lo, g_hi, above;  // g[lo-1], g[lo], g[lo+1], g[lo+2]
  float width;                     // __fsub_rn(g_hi, g_lo)
  float up_edge, down_edge;
};

__device__ __forceinline__ void set_edges(int n, AxisCell& c) {
  c.width = __fsub_rn(c.g_hi, c.g_lo);
  c.up_edge = c.lo < n - 2 ? c.g_hi : CUDART_INF_F;
  c.down_edge = c.lo > 0 ? c.g_lo : -CUDART_INF_F;
}

__device__ __forceinline__ void load_cell(const float* g, int n, int lo,
                                          AxisCell& c) {
  c.lo = lo;
  c.below = g[max(lo - 1, 0)];
  c.g_lo = g[lo];
  c.g_hi = g[lo + 1];
  c.above = g[min(lo + 2, n - 1)];
  set_edges(n, c);
}

// Move c to q's cell, and the table offset t_off by stride a cell moved.
__device__ __forceinline__ void walk(const float* g, int n, float q,
                                     AxisCell& c, int& t_off, int stride) {
  const int lo = c.lo;
  if (q >= c.up_edge) {
    c.lo = lo + 1;
    c.below = c.g_lo;
    c.g_lo = c.g_hi;
    c.g_hi = c.above;
    c.above = g[min(lo + 3, n - 1)];
    set_edges(n, c);
    if (q >= c.up_edge) load_cell(g, n, walk_far(g, n, lo + 1, q), c);
    t_off += (c.lo - lo) * stride;
  } else if (c.down_edge > q) {
    c.lo = lo - 1;
    c.above = c.g_hi;
    c.g_hi = c.g_lo;
    c.g_lo = c.below;
    c.below = g[max(lo - 2, 0)];
    set_edges(n, c);
    if (c.down_edge > q) load_cell(g, n, walk_far(g, n, lo - 1, q), c);
    t_off += (c.lo - lo) * stride;
  }
}

// action a's record: (b0 * u, b1 * u, its cost), each product rounded
__device__ __forceinline__ float4 action_record(const AffineParams& p,
                                                int a) {
  const float u = p.u[a];
  return make_float4(__fmul_rn(p.b0, u), __fmul_rn(p.b1, u),
                     p.action_cost[a], 0.0f);
}

// A table value: from shared memory, or from global memory through the
// read-only path (kGlobal)
template <bool kGlobal>
__device__ __forceinline__ float table_at(const float* t) {
  if constexpr (kGlobal) {
    return __ldg(t);
  } else {
    return *t;
  }
}

// One thread's scan of its cell over its action range: the queries'
// bases, the located cells and the running first minimum.
struct CellScan {
  float base0, base1, s_cost;
  AxisCell c0, c1;
  int t_off;  // corner (0, 0) in the table (or in the block's rows)
  float best_v;
  int best_a;
};

// Locate the scan's first query, action a's (record ab); r0: the table
// row that t_off counts from.
__device__ __forceinline__ void scan_start(const float* g0, int n0,
                                           const float* g1, int n1, int r0,
                                           float4 ab, CellScan& s) {
  load_cell(g0, n0, locate(g0, n0, __fadd_rn(s.base0, ab.x)), s.c0);
  load_cell(g1, n1, locate(g1, n1, __fadd_rn(s.base1, ab.y)), s.c1);
  s.t_off = (s.c0.lo - r0) * n1 + s.c1.lo;
}

// Evaluate action a (record ab): walk both axes to its queries' cells,
// interpolate the table tab, add the cost, keep the first minimum.
template <bool kGlobal>
__device__ __forceinline__ void scan_action(const float* g0, int n0,
                                            const float* g1, int n1,
                                            const float* tab, float4 ab,
                                            int a, CellScan& s) {
  // + b_k * u: one rounded sum
  const float q0 = __fadd_rn(s.base0, ab.x);
  const float q1 = __fadd_rn(s.base1, ab.y);
  walk(g0, n0, q0, s.c0, s.t_off, n1);
  walk(g1, n1, q1, s.c1, s.t_off, 1);
  const float f0 = __fdiv_rn(__fsub_rn(q0, s.c0.g_lo), s.c0.width);
  const float f1 = __fdiv_rn(__fsub_rn(q1, s.c1.g_lo), s.c1.width);
  const float h0 = __fsub_rn(1.0f, f0);
  const float h1 = __fsub_rn(1.0f, f1);
  const float* t4 = tab + s.t_off;
  float t = __fmul_rn(__fmul_rn(h0, h1), table_at<kGlobal>(t4));
  t = __fadd_rn(t, __fmul_rn(__fmul_rn(h0, f1), table_at<kGlobal>(t4 + 1)));
  t = __fadd_rn(t, __fmul_rn(__fmul_rn(f0, h1), table_at<kGlobal>(t4 + n1)));
  t = __fadd_rn(t, __fmul_rn(__fmul_rn(f0, f1),
                             table_at<kGlobal>(t4 + n1 + 1)));
  t = __fadd_rn(t, __fadd_rn(s.s_cost, ab.z));
  if (t < s.best_v) {  // strict: the first minimum of the range wins
    s.best_v = t;
    s.best_a = a;
  }
}

// Shared memory, in order: the table rows (kStageAll, kStageChunks), the
// action records (every action's, or a chunk of each split's), the axes
// (kStageAll, kStageChunks), the split minima. The stage is an argument so
// that the kernel, which passes its template's, folds it.
__host__ __device__ __forceinline__ int affine_row_floats(
    const AffineParams& p, int stage) {
  return stage == kTableGlobal ? 0 : (p.max_rows * p.n1 + 3) / 4 * 4;
}

__host__ __device__ __forceinline__ int affine_records(const AffineParams& p,
                                                       int stage) {
  return stage == kStageAll ? p.n_actions : p.n_splits * p.chunk;
}

__host__ __device__ __forceinline__ int affine_axis_floats(
    const AffineParams& p, int stage) {
  return stage == kTableGlobal ? 0 : p.n0 + p.n1;
}

template <typename ArgT, int kStage>
__global__ void __launch_bounds__(kAffineMaxThreads)
affine_sweep(const AffineParams p, const float* __restrict__ values,
             float* __restrict__ out_v, ArgT* __restrict__ out_a) {
  constexpr bool kChunked = kStage != kStageAll;
  constexpr bool kGlobal = kStage == kTableGlobal;
  extern __shared__ float4 smem4[];
  // the table rows first, so a corner's shared address is its offset
  float* rows_s = reinterpret_cast<float*>(smem4);  // max_rows x n1 rows
  float4* act = smem4 + affine_row_floats(p, kStage) / 4;  // (B_0, B_1, c, 0)
  float* sg0 = reinterpret_cast<float*>(act + affine_records(p, kStage));
  float* sg1 = sg0 + (kGlobal ? 0 : p.n0);
  float* red_v = sg0 + affine_axis_floats(p, kStage);  // a slot a thread
  int* red_a = reinterpret_cast<int*>(red_v + blockDim.x);

  const int tid = threadIdx.x;
  const int n0 = p.n0, n1 = p.n1;
  const int r0 = kGlobal ? 0 : p.row0[blockIdx.x];
  if constexpr (!kChunked) {
    for (int i = tid; i < p.n_actions; i += blockDim.x) {
      act[i] = action_record(p, i);
    }
  }
  if constexpr (!kGlobal) {
    for (int i = tid; i < n0; i += blockDim.x) sg0[i] = p.g0[i];
    for (int i = tid; i < n1; i += blockDim.x) sg1[i] = p.g1[i];
    const int n_stage = p.n_rows[blockIdx.x] * n1;
    const float* rows = values + static_cast<long long>(r0) * n1;
    for (int i = tid; i < n_stage; i += blockDim.x) rows_s[i] = rows[i];
    __syncthreads();
  }
  const float* g0 = kGlobal ? p.g0 : sg0;
  const float* g1 = kGlobal ? p.g1 : sg1;
  const float* tab = kGlobal ? values : rows_s;

  const int n_cells = n0 * n1;
  const int local = tid % p.cells_per_block;
  const int split = tid / p.cells_per_block;
  const int cell = blockIdx.x * p.cells_per_block + local;
  const int per = p.actions_per_split;
  const int a_begin = split * per;
  const int a_end = min(a_begin + per, p.n_actions);
  const bool scans = cell < n_cells && a_begin < a_end;

  CellScan s;
  s.best_v = CUDART_INF_F;
  s.best_a = a_begin;
  if (scans) {
    const int i = cell / n1;
    const float x0 = g0[i];
    const float x1 = g1[cell - i * n1];
    // a_k0 * x0 + a_k1 * x1: two rounded products, one rounded sum
    s.base0 = __fadd_rn(__fmul_rn(p.a00, x0), __fmul_rn(p.a01, x1));
    s.base1 = __fadd_rn(__fmul_rn(p.a10, x0), __fmul_rn(p.a11, x1));
    s.s_cost = p.state_cost[cell];
    scan_start(g0, n0, g1, n1, r0,
               kChunked ? action_record(p, a_begin) : act[a_begin], s);
  }
  if constexpr (kChunked) {
    // chunk k: the records of actions [s * per + k * chunk, ... + chunk)
    // of each split s, at act[s * chunk ..]
    const int chunk = p.chunk;
    const int n_chunks = (per + chunk - 1) / chunk;
    const float4* mine = act + split * chunk;
    for (int k = 0; k < n_chunks; ++k) {
      const int first = k * chunk;
      __syncthreads();  // the previous chunk is read
      for (int i = tid; i < p.n_splits * chunk; i += blockDim.x) {
        const int sp = i / chunk;
        const int j = first + i - sp * chunk;  // its place in the range
        const int a = sp * per + j;
        if (j < per && a < p.n_actions) act[i] = action_record(p, a);
      }
      __syncthreads();
      if (scans) {
        const int a_lo = a_begin + first;
        const int a_hi = min(a_lo + chunk, a_end);
        for (int a = a_lo; a < a_hi; ++a) {
          scan_action<kGlobal>(g0, n0, g1, n1, tab, mine[a - a_lo], a, s);
        }
      }
    }
  } else if (scans) {
    for (int a = a_begin; a < a_end; ++a) {
      scan_action<kGlobal>(g0, n0, g1, n1, tab, act[a], a, s);
    }
  }
  red_v[tid] = s.best_v;
  red_a[tid] = s.best_a;
  __syncthreads();
  if (split != 0 || cell >= n_cells) return;
  float best_v = s.best_v;
  int best_a = s.best_a;
  for (int sp = 1; sp < p.n_splits; ++sp) {
    const int o = sp * p.cells_per_block + local;
    const float v = red_v[o];
    if (v < best_v) {  // strict: an earlier split wins ties
      best_v = v;
      best_a = red_a[o];
    }
  }
  out_v[cell] = best_v;
  out_a[cell] = static_cast<ArgT>(best_a);
}

size_t affine_smem_bytes(const AffineParams& p) {
  return sizeof(float) * static_cast<size_t>(affine_row_floats(p, p.stage)) +
         sizeof(float4) * static_cast<size_t>(affine_records(p, p.stage)) +
         sizeof(float) * static_cast<size_t>(affine_axis_floats(p, p.stage)) +
         (sizeof(float) + sizeof(int)) *
             static_cast<size_t>(p.cells_per_block) * p.n_splits;
}

// The instantiation of the argmin width (1: uint8, 2: int16, 4: int32) and
// the stage; nullptr for others.
template <int kStage>
const void* affine_kernel_of_stage(int argmin_bytes) {
  switch (argmin_bytes) {
    case 1: return reinterpret_cast<const void*>(
        affine_sweep<unsigned char, kStage>);
    case 2: return reinterpret_cast<const void*>(affine_sweep<short, kStage>);
    case 4: return reinterpret_cast<const void*>(affine_sweep<int, kStage>);
    default: return nullptr;
  }
}

const void* affine_kernel_of(int stage, int argmin_bytes) {
  switch (stage) {
    case kStageAll: return affine_kernel_of_stage<kStageAll>(argmin_bytes);
    case kStageChunks:
      return affine_kernel_of_stage<kStageChunks>(argmin_bytes);
    case kTableGlobal:
      return affine_kernel_of_stage<kTableGlobal>(argmin_bytes);
    default: return nullptr;
  }
}

// Raise a kernel's dynamic shared memory limit to smem, never lower it:
// the limit belongs to the function, and backups of other launch shapes
// may need more.
cudaError_t allow_smem(const void* kernel, int smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess || attr.maxDynamicSharedSizeBytes >= smem) {
    return err;
  }
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" int fused_backup2d_affine_params_size() {
  return static_cast<int>(sizeof(AffineParams));
}

// Check the launch shape and let the stage's kernels take its dynamic
// shared memory; call once for each parameter block before its first
// launch (it may set function attributes, so never inside a CUDA graph
// capture). Returns 0 or a CUDA error.
extern "C" int fused_backup2d_affine_configure(const AffineParams* p) {
  if (p->cells_per_block < 1 || p->n_splits < 1 ||
      p->cells_per_block * p->n_splits > kAffineMaxThreads || p->n0 < 2 ||
      p->n1 < 2 || p->max_rows < 2 || p->max_rows > p->n0 ||
      p->n_blocks < 1 || p->actions_per_split < 1 || p->n_actions < 1 ||
      affine_kernel_of(p->stage, 4) == nullptr ||
      (p->stage != kStageAll &&
       (p->chunk < 1 || p->chunk > p->actions_per_split))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(affine_smem_bytes(*p));
  cudaError_t err = cudaSuccess;
  for (int bytes = 1; bytes <= 4 && err == cudaSuccess; bytes *= 2) {
    err = allow_smem(affine_kernel_of(p->stage, bytes), smem);
  }
  return static_cast<int>(err);
}

// Blocks of the launch shape one SM holds at once (the int32-argmin
// instantiation of its stage; the others match it); -1 on an error.
extern "C" int fused_backup2d_affine_blocks_per_sm(const AffineParams* p) {
  const void* kernel = affine_kernel_of(p->stage, 4);
  int blocks = -1;
  if (kernel == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, p->cells_per_block * p->n_splits,
          affine_smem_bytes(*p)) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

// One sweep in one launch: values (n0, n1) -> out_v (n0, n1) and the argmin
// into out_a as argmin_bytes-wide integers (1: uint8, 2: int16, 4: int32),
// by the instantiation of p->stage. values must not alias out_v (blocks
// read it while others write). Returns cudaGetLastError() after the launch.
extern "C" int fused_backup2d_affine_f32(const AffineParams* p,
                                         const float* values, float* out_v,
                                         void* out_a, int argmin_bytes,
                                         void* stream) {
  const void* kernel = affine_kernel_of(p->stage, argmin_bytes);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  AffineParams params = *p;
  void* args[] = {&params, &values, &out_v, &out_a};
  const cudaError_t err = cudaLaunchKernel(
      kernel, dim3(p->n_blocks), dim3(p->cells_per_block * p->n_splits),
      args, affine_smem_bytes(*p), static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

extern "C" const char* fused_backup2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
