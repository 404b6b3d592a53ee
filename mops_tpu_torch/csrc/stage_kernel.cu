// Fused advection steps (RK4 or Euler) for Hopper (sm_90a): the streamline
// step (K1), the pathline step (K2), and their layer-window forms (K3, K4).
//
// K1 replaces the TPU kernel mops_tpu/pallas/stage_kernel.py::_kernel as
// reached through fused_streamline_step (stage_kernel.py:479, body :49-379).
// K2 replaces the same _kernel with pathline=True, as reached through
// fused_pathline_step (stage_kernel.py:502, pallas_call at :537).
// K3 replaces mops_tpu/pallas/window_kernel.py::_wkernel as reached through
// fused_window_streamline_step (window_kernel.py:509, pallas_call at :538,
// body :193-506), together with the step loop's full-column repair of its miss
// lanes (mops_tpu/advect.py:865-937).  K4 replaces the same _wkernel with
// pathline=True, reached through fused_window_pathline_step
// (window_kernel.py:544, pallas_call at :577), and the same repair.
//
// Each particle goes through a whole time step in one launch: spherical
// containment, Wachspress weights over the cell's nv <= K vertices, the
// Wachspress ztop profile with the sequential 1e-9 monotonic clamp, the
// layer search, the vertical lerp of velocity and vertical velocity, and
// RK4 with Rodrigues mid-stage moves and the endpoint renormalised to the
// old radius (or Euler).  K1 searches layers by bisection and guards the
// velocities at 1e-12.  K2 evaluates each stage against two snapshots: one
// weight set, then an independent profile, first-hit linear layer search
// and lerp in each snapshot, blended as a*back + (1-a)*front with the stage
// alphas (a1, a2, a2, a4), no per-snapshot |v| guard, and up to two named
// attributes lerped and blended like the velocity.  All four kernels take
// one grouped form (a group of lanes of one warp a particle, the step's
// values staged once in shared memory) and share its geometry and RK device
// functions.
//
// K3 and K4 read only W layers [s, s+W) of each column per stage, s being a
// per-particle start placed around the layer of the previous step: the
// profile is summed over the window and clamped from its top, layers outside
// read as +BIG above and -BIG below, and the surface and bottom tests use
// the unclamped column ends (the front snapshot's for both snapshots, as the
// TPU kernel reads them from one static row).  A depth within EPS_LAYER of an
// inner window edge could belong to a layer outside: that stage is a miss.
// Off the miss lanes every comparison resolves as on the full column, so the
// step is K1's (K2's).  The window kernel also returns the first stage's
// layer (the next window's centre) and the miss flag.  The TPU step loop
// repairs its miss lanes afterwards with a full-column step; here the
// wrapper launches K1 (K2) right after the window kernel, on the same
// stream, in a masked form: a lane whose miss flag is false is skipped, and
// a miss lane overwrites its outputs with the full-column step and its
// layer with the full column's at the start position.  No host sync.
//
// Input layout.  The TPU kernels take columns pre-gathered by XLA into a
// (K, F, N) lanes-minor block, and K3/K4 a (W, K*C, N) window slice gathered
// from a (cell, window start) table that exists because a TPU gather pays
// per descriptor.  Here each group reads its particle's K vertex rows
// straight from the packed (nV, F) tables by vertex id, so neither materialisation
// exists, and a window is a run of W values inside each row's blocks.  Row
// layout (pack_vertex_table):
//   [xyz(3) | ztop(L) | vel(3L, layer-major) | wvel(L+1) | attrs(A*L)],
//   F = 3 + 4L + L+1 + A*L, attribute ai of layer l at 3+4L+L+1 + A*l + ai
//   (A = 0 for K1 and K3).
// The TPU idioms that stand in for a dynamic lane index (vnext's one-hot
// select, the k == 0 previous-vertex pick, zpick, the one-hot layer and
// attribute picks, zw_at's window select) become plain indexing: (k+1) % nv,
// nv-1, z[layer], z[layer - s].  The TPU's descending first-hit loop (which
// needs no early exit) becomes an ascending loop that stops at the first
// hit: the same layer.
//
// What bounds them on the card: the gathered bytes.  The TPU design moves
// the whole row, K*F*sizeof(T) per particle-step and snapshot (about 8.5 KB
// at K=7, L=60, f32 for K1; K2 moves two rows of F = 424 with two
// attributes).  K1/K2 touch per stage and snapshot only the ztop block (K*L
// values), two velocity layers, two wvel interfaces and two layers of each
// attribute, about K*(L+8+2A) values, and the four RK stages re-read the
// same rows, which stay in L1/L2.  K3/K4 replace the K*L ztop values by K*W
// plus the two column ends, and the L-long profile loop by a W-long one.
// K3/K4 stage every value of the step once, before stage 1, in shared
// memory with coalesced asynchronous copies, and run the stages out of
// shared memory and registers, a group of lanes a particle (see "the layer
// window" below).  K1/K2 stage the same way the values that their stages
// read L at a time, xyz and the ztop columns, spread each profile over the
// group's lanes and read the picks from the tables (see "the full-column
// steps" below).  Measured on the H100, none of the four is bound by its
// bytes: a stage waits on the latency of its chain of sums, shuffles and
// comparisons, so the designs trade lanes a particle against occupancy.
//
// Numerics: IEEE division and square root are required.  Do not build with
// --use_fast_math or -ffast-math-style flags: the containment test relies on
// isfinite(p); Euler divides by |pos x hv| with no guard and the reference
// relies on the resulting NaN for its downstream cleanup; Wachspress divides
// by triangle areas that can be zero.  Implicit FMA contraction is off
// (-fmad=false, see "the layer window" below); the sums call fma()
// explicitly, which moves f64 results by about an ulp against the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int K_MAX = 20;    // reference streamline cap on maxEdges
constexpr int L_MAX = 128;   // layer ceiling (the wrapper raises above)
constexpr int A_MAX = 2;     // named attributes the pathline step carries
constexpr int W_MAX = 32;    // layer-window ceiling (the wrapper raises above)

// The reference's numerical guards, rounded to T like the plain version's.
template <typename T> __device__ __forceinline__ T eps_layer() { return T(1e-8); }
template <typename T> __device__ __forceinline__ T eps_zero() { return T(1e-12); }
template <typename T> __device__ __forceinline__ T ztop_clamp() { return T(1e-9); }
// The window's stand-in for the layers above (+) and below (-) it.
template <typename T> __device__ __forceinline__ T big() { return T(1e30); }

template <typename T>
__device__ inline void cross3(const T* a, const T* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__device__ inline T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__device__ inline T norm3(const T* a) { return sqrt(dot3(a, a)); }

template <typename T>
__device__ inline T tri_area(const T* a, const T* b, const T* c) {
  T e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
  T e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
  T cr[3];
  cross3(e1, e2, cr);
  return T(0.5) * norm3(cr);
}

// Rodrigues rotation of p about unit axis u by theta.
template <typename T>
__device__ inline void rotate(const T* p, const T* u, T theta, T* out) {
  T ct = cos(theta), st = sin(theta);
  T omc = T(1) - ct;
  out[0] = (ct + u[0] * u[0] * omc) * p[0] + (u[0] * u[1] * omc - u[2] * st) * p[1] + (u[0] * u[2] * omc + u[1] * st) * p[2];
  out[1] = (u[1] * u[0] * omc + u[2] * st) * p[0] + (ct + u[1] * u[1] * omc) * p[1] + (u[1] * u[2] * omc - u[0] * st) * p[2];
  out[2] = (u[2] * u[0] * omc - u[1] * st) * p[0] + (u[2] * u[1] * omc + u[0] * st) * p[1] + (ct + u[2] * u[2] * omc) * p[2];
}

// ---------------------------------------------------------------------------
// the step
// ---------------------------------------------------------------------------

// RK mid-stage move: Rodrigues rotation by |v| dtl / |p| about p x v,
// identity when |p| or |v| < 1e-12.
template <typename T>
__device__ void advect_on_sphere(const T* p, const T* v, T dtl, T* out) {
  T rr = norm3(p), speed = norm3(v);
  bool degen = rr < eps_zero<T>() || speed < eps_zero<T>();
  T ax[3];
  cross3(p, v, ax);
  T al = norm3(ax);
  T safe = degen ? T(1) : al;
  T u[3] = {ax[0] / safe, ax[1] / safe, ax[2] / safe};
  T theta = speed * dtl / (rr == T(0) ? T(1) : rr);
  rotate(p, u, theta, out);
  if (degen) { out[0] = p[0]; out[1] = p[1]; out[2] = p[2]; }
}

// One RK4 (or Euler) step from p0.  eval(p, stage, hv, wv, at) evaluates
// stage 0..3 at p and returns its ok; attributes 0..n_attrs-1 are averaged
// like the velocity.
template <typename T, typename Eval>
__device__ __forceinline__ bool rk_step(const T* p0, T dt, int euler,
                                        int n_attrs, Eval eval, T* np_,
                                        T* hv, T& wv, T* at) {
  const T r = norm3(p0);
  if (euler) {
    const bool ok = eval(p0, 0, hv, wv, at);
    T ax[3];
    cross3(p0, hv, ax);
    T al = norm3(ax);
    T theta = norm3(hv) * dt / (r > eps_zero<T>() ? r : eps_zero<T>());
    T u[3] = {ax[0] / al, ax[1] / al, ax[2] / al};
    rotate(p0, u, theta, np_);
    return ok;
  }
  T k1[3], k2[3], k3[3], k4[3], w1, w2, w3, w4, p[3];
  T at1[A_MAX], at2[A_MAX], at3[A_MAX], at4[A_MAX];
  bool ok1 = eval(p0, 0, k1, w1, at1);
  advect_on_sphere(p0, k1, dt * T(0.5), p);
  bool ok2 = eval(p, 1, k2, w2, at2);
  advect_on_sphere(p0, k2, dt * T(0.5), p);
  bool ok3 = eval(p, 2, k3, w3, at3);
  advect_on_sphere(p0, k3, dt, p);
  bool ok4 = eval(p, 3, k4, w4, at4);
  for (int c = 0; c < 3; ++c)
    hv[c] = (k1[c] + T(2) * k2[c] + T(2) * k3[c] + k4[c]) / T(6);
  wv = (w1 + T(2) * w2 + T(2) * w3 + w4) / T(6);
  for (int ai = 0; ai < n_attrs; ++ai)
    at[ai] = (at1[ai] + T(2) * at2[ai] + T(2) * at3[ai] + at4[ai]) / T(6);
  T xt[3] = {p0[0] + hv[0] * dt, p0[1] + hv[1] * dt, p0[2] + hv[2] * dt};
  T xl = sqrt(xt[0] * xt[0] + xt[1] * xt[1] + xt[2] * xt[2]);
  bool good = xl > eps_zero<T>();
  T den = xl == T(0) ? T(1) : xl;
  for (int c = 0; c < 3; ++c) np_[c] = good ? xt[c] / den * r : p0[c];
  return ok1 && ok2 && ok3 && ok4;
}

// ---------------------------------------------------------------------------
// the layer window (K3, K4)
// ---------------------------------------------------------------------------
//
// A group of G lanes of one warp (group_size) advances one particle.
// Before stage 1 the group copies, for each of the cell's nv vertex rows,
// every value a hit lane reads in the whole step into the particle's slot
// of shared memory (cp.async, one element a lane, neighbouring lanes on
// neighbouring addresses): one contiguous run per block of the row layout,
//   front record: xyz(3) | ztop[0] | ztop[L-1] | window part
//   back record (K4):                              window part
//   window part:  ztop[s..s+W) | vel[3s..3(s+W)) | wvel[s..s+W)
//                 | attrs[A*s..A*(s+W))
// A pick outside [s, s+W) is zero (field_pick), so a hit lane reads nothing
// else, and the four stages read only shared memory and registers.  In each
// stage lane j evaluates the edge tests and Wachspress weights of vertices
// j, j+G, ... (the triangle area B_k, which does not depend on the
// position, once per step) into the particle's slot, where every lane
// reads them (in registers they cost occupancy: measured slower).  The
// stage's Wachspress sums (the window profiles and column
// ends, then the picks at the layers found) are independent of each other:
// each lane takes some of them, each summed over k = 0..nv-1 in order with
// explicit fused multiply-adds as K1 and K2 sum them, and shuffles bring
// every result to every lane.  The rest of the stage (clamp, layer search,
// lerp, blend, the RK move) runs on the same values in every lane, so
// nothing else is broadcast, and lane 0 writes the outputs.  The window's
// profile z[W] lives in registers: the kernels are templated on WT, the
// window width at compile time (8, the main path's), or W_MAX with the
// width given at run time.  Miss lanes are not repaired here: the wrapper
// launches K1 (K2) right after, masked by the miss flags.
//
// The sums' order and the absence of implicit contraction (-fmad=false)
// make a hit lane's step bit-equal to K1's (K2's), as the window paths'
// month-long agreement with the full-column paths needs: implicit
// contraction, which the compiler decides by context, left 3 % of the
// pathline month's lanes more than 100 m apart.

constexpr int kBlockThreads = 256;

// Lanes a particle, the fastest of 4, 8, 16 and 32 on the H100 at the main
// path's shapes (PERF.md): a stage's latency falls with the rounds of sums
// a lane takes (K3 has 10 profile and 8 pick sums, K4 20 and 24), while
// occupancy, bounded by each particle's shared memory and registers, falls
// with more lanes.
template <typename T, bool PATH>
__host__ __device__ constexpr int group_size() {
  return PATH ? (sizeof(T) == 8 ? 32 : 16) : 8;
}
// Shared memory a block aims at (four blocks an SM), and its ceiling.
constexpr int kWindowSmemTarget = 56 * 1024;
constexpr int kSmemMax = 232448;

__device__ __forceinline__
uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__device__ __forceinline__
void cp_async(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__
void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Row offset of element e of a window part (see the layout above).
__device__ __forceinline__
int window_offset(int e, int L, int W, int A,
                                  int s) {
  if (e < W) return 3 + s + e;
  if (e < 4 * W) return 3 + L + 3 * s + (e - W);
  if (e < 5 * W) return 3 + 4 * L + s + (e - 4 * W);
  return 4 + 5 * L + A * s + (e - 5 * W);
}

// One particle's staged step data in shared memory.
template <typename T>
struct Staged {
  const T* f;       // front records (stride rsf): header(5) + window part
  const T* b;       // back records (stride rsb): window part
  T* w;             // the stage's Wachspress weights, normalised
  int rsf, rsb, nv, A;
  T d;              // depth, negative down
};

// The group's copy of the particle's rows into its slot (lane = 0..G-1).
template <int G, typename T>
__device__ void stage_rows(T* rec_f, T* rec_b, const T* table_f,
                           const T* table_b, const int32_t* vid, int nv,
                           int F, int L, int W, int A, int s, int lane) {
  const int part = (5 + A) * W;
  const int rsf = 5 + part;
  for (int k = 0; k < nv; ++k) {
    const int64_t row = (int64_t)vid[k] * F;
    const T* src = table_f + row;
    T* dst = rec_f + k * rsf;
    for (int e = lane; e < rsf; e += G) {
      const int o = e < 3 ? e : (e == 3 ? 3 : (e == 4 ? 3 + L - 1
                              : window_offset(e - 5, L, W, A, s)));
      cp_async(dst + e, src + o);
    }
    if (rec_b != nullptr) {
      src = table_b + row;
      dst = rec_b + k * part;
      for (int e = lane; e < part; e += G)
        cp_async(dst + e, src + window_offset(e, L, W, A, s));
    }
  }
  cp_async_wait_all();
}

// The mask of the group of G lanes that holds this thread.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  return G == 32 ? 0xffffffffu
                 : ((1u << (G % 32)) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

// B_k = area(v_{k-1}, v_k, v_{k+1}) of the lane's vertices k = lane,
// lane+G, ... (1 for k >= nv): fixed for the step.
template <int G, typename T>
__device__ __forceinline__ void vertex_bk(const Staged<T>& st, int lane,
                                          T* bk) {
  const int nv = st.nv;
#pragma unroll
  for (int q = 0; q < (K_MAX + G - 1) / G; ++q) {
    const int k = lane + q * G;
    bk[q] = T(1);
    if (k < nv)
      bk[q] = tri_area(st.f + (k == 0 ? nv - 1 : k - 1) * st.rsf,
                       st.f + k * st.rsf,
                       st.f + (k + 1 == nv ? 0 : k + 1) * st.rsf);
  }
}

// Spherical point-in-polygon (inside iff cross(A_k, B_k) . p >= 0 on every
// edge; a non-finite p is outside) and the Wachspress weights
// w_k = B_k / (A_k * A_{k+1}), normalised, spread over the group: lane j
// evaluates vertices j, j+G, ... and writes their weights to st.w, every
// lane sums them in order, and the owners normalise them in place.  bk
// holds B_k of the lane's vertices (vertex_bk).  Returns inside.  Every
// lane of the group must call it.
// The edge test is evaluated as cross(A_k - p, B_k - p) . p, the same
// determinant (subtracting p from two of its columns leaves it unchanged)
// without the cancellation of cross(A_k, B_k): at float32, products of
// 6.4e6-m coordinates misplace the edge plane by tens of metres, so a
// particle that stops that close to an edge fails the test in the cell that
// relocation (nearest centre) gives it, fails every stage at its start
// position and, under FailMode.ZERO, never moves again.
template <int G, typename T>
__device__ __forceinline__
bool geometry_group(const Staged<T>& st, const T* bk, const T* p,
                    unsigned gmask, int lane) {
  const int nv = st.nv;
  bool in = isfinite(p[0]) && isfinite(p[1]) && isfinite(p[2]);
  __syncwarp(gmask);                      // the last stage's reads of w
#pragma unroll
  for (int q = 0; q < (K_MAX + G - 1) / G; ++q) {
    const int k = lane + q * G;
    if (k < nv) {
      const T* a = st.f + k * st.rsf;
      const T* b = st.f + (k + 1 == nv ? 0 : k + 1) * st.rsf;
      const T* prv = st.f + (k == 0 ? nv - 1 : k - 1) * st.rsf;
      const T a_p[3] = {a[0] - p[0], a[1] - p[1], a[2] - p[2]};
      const T b_p[3] = {b[0] - p[0], b[1] - p[1], b[2] - p[2]};
      T c[3];
      cross3(a_p, b_p, c);
      in = in && (dot3(c, p) >= T(0));
      const T a_i = tri_area(prv, a, p);
      const T a_n = tri_area(a, b, p);
      st.w[k] = bk[q] / (a_i * a_n);
    }
  }
  const bool inside = __all_sync(gmask, in);
  __syncwarp(gmask);
  T wsum = T(0);
  for (int k = 0; k < nv; ++k) wsum = wsum + st.w[k];
  const T inv = T(1) / wsum;
  __syncwarp(gmask);
#pragma unroll
  for (int q = 0; q < (K_MAX + G - 1) / G; ++q) {
    const int k = lane + q * G;
    if (k < nv) st.w[k] = st.w[k] * inv;
  }
  __syncwarp(gmask);
  return inside;
}

// One stage's window of one snapshot: the profile at layers s..s+W-1, in
// registers.  W is WT unless WT is W_MAX (the run-time width).
template <typename T, int WT>
struct Window {
  int s, Wrt, L;
  T z[WT];
  __device__ __forceinline__ int width() const {
    return WT == W_MAX ? Wrt : WT;
  }
  // z[l] for a run-time l in [0, W): a select over the registers.
  __device__ __forceinline__ T sel(int l) const {
    T v = z[0];
#pragma unroll
    for (int m = 1; m < WT; ++m) v = m == l ? z[m] : v;
    return v;
  }
  // z at global layer lg, +BIG above the window and -BIG below it (zw_at).
  __device__ __forceinline__ T at(int lg) const {
    return lg < s ? big<T>() : (lg >= s + width() ? -big<T>() : sel(lg - s));
  }
};

// Depth within EPS_LAYER of an inner window edge (miss_of).
template <typename T, int WT>
__device__ __forceinline__
bool window_miss(const Window<T, WT>& win, T d) {
  const int W = win.width();
  return (win.s > 0 && d >= win.z[0] - eps_layer<T>()) ||
         (win.s + W < win.L && d <= win.sel(W - 1) + eps_layer<T>());
}

// layer_binary over the window with the sentinels; surface z0, bottom zL.
template <typename T, int WT>
__device__ __forceinline__
int layer_binary_w(const Window<T, WT>& win, T d, T z0, T zL) {
  const int L = win.L;
  bool above = d > z0 + eps_layer<T>();
  bool below = d < zL - eps_layer<T>();
  int lo = 1, hi = L - 1, ans = 1;
  int trips = 2;
  for (int m = 1; m < (L > 2 ? L : 2); m <<= 1) ++trips;
  for (int it = 0; it < trips && lo <= hi; ++it) {
    int mid = (lo + hi) >> 1;
    T top = win.at(mid - 1), bot = win.at(mid);
    if (d <= top + eps_layer<T>() && d >= bot - eps_layer<T>()) {
      ans = mid;
      break;
    }
    if (d > top + eps_layer<T>()) hi = mid - 1; else lo = mid + 1;
  }
  ans = ans < 1 ? 1 : (ans > L - 1 ? L - 1 : ans);
  return above ? 1 : (below ? L - 1 : ans);
}

// The first-hit linear search (layer_linear_column's) over the window's
// intervals (layers s+1 .. s+W-1), as the loop that stops at the first hit.
template <typename T, int WT>
__device__ __forceinline__
int layer_linear_w(const Window<T, WT>& win, T d, T z0, T zL,
                   bool& ok) {
  const int W = win.width();
  const bool above = d > z0 + eps_layer<T>();
  const bool below = d < zL - eps_layer<T>();
  int first = 1;
  bool found = false;
#pragma unroll
  for (int l = 1; l < WT; ++l) {
    if (l < W && !found && d <= win.z[l - 1] + eps_layer<T>() &&
        d >= win.z[l] - eps_layer<T>()) {
      first = win.s + l;
      found = true;
    }
  }
  ok = above || below || found;
  return above ? 1 : (below ? win.L - 1 : first);
}

template <typename T, int WT>
__device__ __forceinline__
T lerp_t_w(const Window<T, WT>& win, int layer, T d,
           bool& ok_denom) {
  const T z_dn = win.at(layer), z_up = win.at(layer - 1);
  T x = d < z_dn ? z_dn : d;
  x = x > z_up ? z_up : x;
  const T denom = z_up - z_dn;
  ok_denom = fabs(denom) >= eps_zero<T>();
  return (x - z_dn) / (ok_denom ? denom : T(1));
}

// Wachspress sum of a staged value, sum_k w_k * rec[k*rs + off] in the
// order k = 0..nv-1 with explicit fused multiply-adds (K1's and K2's column
// sums are the same), zero for off < 0 (a layer outside the window,
// field_pick, or an attribute slot >= A).
template <typename T>
__device__ __forceinline__
T wachspress_sum(const T* w, const T* rec, int rs, int nv, int off) {
  T acc = T(0);
  if (off >= 0)
    for (int k = 0; k < nv; ++k) acc = fma(w[k], rec[k * rs + off], acc);
  return acc;
}

// Clamp started at the window's top (z_window's clamp).
template <typename T, int WT>
__device__ __forceinline__ void clamp_window(Window<T, WT>& win) {
  const int W = win.width();
#pragma unroll
  for (int l = 1; l < WT; ++l)
    if (l < W && win.z[l] > win.z[l - 1])
      win.z[l] = win.z[l - 1] - ztop_clamp<T>();
}

// Values of one snapshot's picks, in job order: velocity at layer-1 (3) and
// layer (3), vertical velocity at layer-1 and layer, then each attribute
// slot at layer-1 (A_MAX) and at layer (A_MAX).
constexpr int kPicks = 8 + 2 * A_MAX;

// Part offset of pick m of a snapshot whose stage layer is ``layer``, or -1
// when its layer lies outside the window or its attribute slot >= A.
__device__ __forceinline__ int pick_offset(int m, int layer, int s, int W,
                                           int A) {
  const bool up = m < 3 || m == 6 || (m >= 8 && m < 8 + A_MAX);
  const int lw = (up ? layer - 1 : layer) - s;
  if (lw < 0 || lw >= W) return -1;
  if (m < 6) return W + 3 * lw + (m % 3);
  if (m < 8) return 4 * W + lw;
  const int ai = (m - 8) % A_MAX;
  return ai < A ? 5 * W + A * lw + ai : -1;
}

// One stage of the window step at p, by the particle's group (K3 when
// !PATH, K4 when PATH; eval_streamline and eval_column_stage on the
// window).
// The independent Wachspress sums of the stage are spread over the group's
// lanes, each sum taken over k in order, and gathered into every lane's
// registers with shuffles: first the window profiles (front, then back)
// and the front's surface and bottom, then, once every lane has found the
// layers, the picks.  layer is the front snapshot's; miss the OR of both.
template <typename T, int WT, bool PATH>
__device__ __forceinline__
bool eval_window_stage(const Staged<T>& st, int s, int W, int L,
                       const T* bk, const T* p, T a, unsigned gmask,
                       int lane, T* hv, T& wv, T* at, int& layer,
                       bool& miss) {
  constexpr int NS = PATH ? 2 : 1;              // snapshots
  constexpr int G = group_size<T, PATH>();
  const bool inside = geometry_group<G>(st, bk, p, gmask, lane);
  const int nv = st.nv;
  const T d = st.d;

  // profiles and column ends: job j < WT front layer j, then the back
  // snapshot's (pathline), then the surface and the bottom
  constexpr int NA = NS * WT + 2;
  constexpr int RA = (NA + G - 1) / G;
  T acc_a[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int j = lane + r * G;
    int off = -1;
    const T* rec = st.f;
    int rs = st.rsf;
    if (j < WT) {
      off = j < W ? 5 + j : -1;
    } else if (PATH && j < 2 * WT) {
      rec = st.b;
      rs = st.rsb;
      off = j - WT < W ? j - WT : -1;
    } else if (j == NS * WT) {
      off = 3;
    } else if (j == NS * WT + 1) {
      off = 4;
    }
    acc_a[r] = wachspress_sum(st.w, rec, rs, nv, off);
  }
  Window<T, WT> win[NS];
  T z0 = T(0), zL = T(0);
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const T v = __shfl_sync(gmask, acc_a[j / G], j % G, G);
    if (j < NS * WT) win[j / WT].z[j % WT] = v;
    else if (j == NS * WT) z0 = v;
    else zL = v;
  }
  int lay[NS];
  bool ok_col = true, ok_mag = true;
  T t[NS];
  miss = false;
#pragma unroll
  for (int sn = 0; sn < NS; ++sn) {
    win[sn].s = s;
    win[sn].Wrt = W;
    win[sn].L = L;
    clamp_window(win[sn]);
    bool ok_layer = true, ok_denom;
    lay[sn] = PATH ? layer_linear_w(win[sn], d, z0, zL, ok_layer)
                   : layer_binary_w(win[sn], d, z0, zL);
    miss = miss || window_miss(win[sn], d);
    t[sn] = lerp_t_w(win[sn], lay[sn], d, ok_denom);
    ok_col = ok_col && ok_layer && ok_denom;
  }
  layer = lay[0];

  // the picks: job j is pick j % NP of snapshot j / NP
  constexpr int NP = PATH ? kPicks : 8;         // no attributes in K3
  constexpr int NB = NS * NP;
  constexpr int RB = (NB + G - 1) / G;
  T acc_b[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int j = lane + r * G;
    const int sn = j / NP;
    int off = -1;
    if (j < NB)
      off = pick_offset(j % NP, sn == 0 ? lay[0] : lay[NS - 1], s, W, st.A);
    const bool front = sn == 0;
    acc_b[r] = wachspress_sum(st.w, front ? st.f + 5 : st.b,
                              front ? st.rsf : st.rsb, nv, off);
  }
  T hv_s[NS][3], wv_s[NS], at_s[NS][A_MAX];
#pragma unroll
  for (int sn = 0; sn < NS; ++sn) {
    T v[kPicks];
#pragma unroll
    for (int m = 0; m < kPicks; ++m) {
      const int j = sn * NP + m;
      v[m] = m < NP ? __shfl_sync(gmask, acc_b[j / G], j % G, G) : T(0);
    }
    const T ts = t[sn];
    if (!PATH)
      ok_mag = norm3(v + 3) >= eps_zero<T>() && norm3(v) >= eps_zero<T>();
#pragma unroll
    for (int c = 0; c < 3; ++c)
      hv_s[sn][c] = ts * v[c] + (T(1) - ts) * v[3 + c];
    wv_s[sn] = ts * v[6] + (T(1) - ts) * v[7];
#pragma unroll
    for (int ai = 0; ai < A_MAX; ++ai)
      at_s[sn][ai] = ts * v[8 + ai] + (T(1) - ts) * v[8 + A_MAX + ai];
  }
  if (!PATH) {                          // eval_streamline's guards
    for (int c = 0; c < 3; ++c) hv[c] = hv_s[0][c];
    wv = wv_s[0];
    const bool ok = inside && ok_col && ok_mag && norm3(hv) >= eps_zero<T>();
    if (!ok) {
      hv[0] = hv[1] = hv[2] = T(0);
      wv = T(0);
    }
    return ok;
  }
  const bool ok = inside && ok_col;     // the pathline blend
  for (int c = 0; c < 3; ++c)
    hv[c] = ok ? a * hv_s[NS - 1][c] + (T(1) - a) * hv_s[0][c] : T(0);
  wv = ok ? a * wv_s[NS - 1] + (T(1) - a) * wv_s[0] : T(0);
  for (int ai = 0; ai < st.A; ++ai)
    at[ai] = ok ? a * at_s[NS - 1][ai] + (T(1) - a) * at_s[0][ai] : T(0);
  return ok;
}

__device__ inline int clamp_start(int s, int L, int W) {
  return s < 0 ? 0 : (s > L - W ? L - W : s);
}

// T values of one particle's slot: weights (K), front records, back
// records (K4), made odd so that the groups of a warp, which read their
// slots at the same offsets, fall on different banks.
__host__ __device__ inline int slot_values(int K, int W, int A,
                                           bool pathline) {
  const int part = (5 + A) * W;
  int S = K + K * (5 + part) + (pathline ? K * part : 0);
  return S + (S % 2 == 0);
}

// The window step of one particle by its group (K3 when !PATH, K4 when
// PATH): outputs as the TPU kernel's, miss lanes not repaired.
template <typename T, int WT, bool PATH>
__device__ void window_step(const T* __restrict__ pos,
                            const T* __restrict__ depth_neg,
                            const int32_t* __restrict__ nv_in,
                            const int32_t* __restrict__ vids,
                            const int32_t* __restrict__ s_in,
                            const T* __restrict__ table_f,
                            const T* __restrict__ table_b, int n, int K,
                            int F, int L, int W, int n_attrs, T dt, T a1,
                            T a2, T a4, int euler, T* __restrict__ new_pos,
                            T* __restrict__ hvel, T* __restrict__ wvel,
                            bool* __restrict__ ok_out,
                            int32_t* __restrict__ layer_out,
                            bool* __restrict__ miss_out,
                            T* __restrict__ attr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int G = group_size<T, PATH>();
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const int i = blockIdx.x * (blockDim.x / G) + g;
  if (i >= n) return;                     // the whole group leaves
  const unsigned gmask = group_mask<G>();
  const int A = PATH ? n_attrs : 0;
  const int part = (5 + A) * W;
  T* slot = reinterpret_cast<T*>(smem_raw) +
            (size_t)g * slot_values(K, W, A, PATH);
  const int nvr = nv_in[i];
  const int nv = nvr < K ? nvr : K;
  const int s = clamp_start(s_in[i], L, W);
  Staged<T> st;
  st.w = slot;
  T* rec_f = slot + K;
  T* rec_b = rec_f + K * (5 + part);
  st.f = rec_f;
  st.b = PATH ? rec_b : nullptr;
  st.rsf = 5 + part;
  st.rsb = part;
  st.nv = nv;
  st.A = A;
  st.d = depth_neg[i];
  stage_rows<G>(rec_f, PATH ? rec_b : (T*)nullptr, table_f, table_b,
             vids + (int64_t)i * K, nv, F, L, W, A, s, lane);
  __syncwarp(gmask);
  T bk[(K_MAX + G - 1) / G];
  vertex_bk<G>(st, lane, bk);
  const T p0[3] = {pos[3 * (int64_t)i], pos[3 * (int64_t)i + 1],
                   pos[3 * (int64_t)i + 2]};
  int layer = 1;
  bool miss = false;
  auto eval = [&](const T* p, int stage, T* hv, T& wv, T* at) {
    int lay;
    bool m;
    const T a = stage == 0 ? a1 : (stage == 3 ? a4 : a2);
    const bool ok = eval_window_stage<T, WT, PATH>(
        st, s, W, L, bk, p, a, gmask, lane, hv, wv, at, lay, m);
    if (stage == 0) layer = lay;
    miss = miss || m;
    return ok;
  };
  T hv[3], wv, np_[3], at[A_MAX];
  const bool ok = rk_step(p0, dt, euler, A, eval, np_, hv, wv, at);
  if (lane != 0) return;
  for (int c = 0; c < 3; ++c) {
    new_pos[3 * (int64_t)i + c] = np_[c];
    hvel[3 * (int64_t)i + c] = hv[c];
  }
  wvel[i] = wv;
  ok_out[i] = ok;
  layer_out[i] = layer < 1 ? 1 : (layer > L - 1 ? L - 1 : layer);
  miss_out[i] = miss;
  if (PATH && attr != nullptr) {          // slots >= n_attrs are zero
    attr[3 * (int64_t)i] = A > 0 ? at[0] : T(0);
    attr[3 * (int64_t)i + 1] = A > 1 ? at[1] : T(0);
    attr[3 * (int64_t)i + 2] = T(0);
  }
}

#define WINDOW_KERNEL_PARAMS                                                  \
  const T *__restrict__ pos, const T *__restrict__ depth_neg,                \
      const int32_t *__restrict__ nv_in, const int32_t *__restrict__ vids,   \
      const int32_t *__restrict__ s_in, const T *__restrict__ table_f,       \
      const T *__restrict__ table_b, int n, int K, int F, int L, int W,      \
      int n_attrs, T dt, T a1, T a2, T a4, int euler,                        \
      T *__restrict__ new_pos, T *__restrict__ hvel, T *__restrict__ wvel,   \
      bool *__restrict__ ok_out, int32_t *__restrict__ layer_out,            \
      bool *__restrict__ miss_out, T *__restrict__ attr
#define WINDOW_KERNEL_ARGS                                                    \
  pos, depth_neg, nv_in, vids, s_in, table_f, table_b, n, K, F, L, W,        \
      n_attrs, dt, a1, a2, a4, euler, new_pos, hvel, wvel, ok_out,           \
      layer_out, miss_out, attr

// Occupancy is bounded by shared memory, not registers: no cap below 255.
template <typename T, int WT>
__global__ void __launch_bounds__(kBlockThreads, 1)
window_streamline_kernel(WINDOW_KERNEL_PARAMS) {
  window_step<T, WT, false>(WINDOW_KERNEL_ARGS);
}

template <typename T, int WT>
__global__ void __launch_bounds__(kBlockThreads, 1)
window_pathline_kernel(WINDOW_KERNEL_PARAMS) {
  window_step<T, WT, true>(WINDOW_KERNEL_ARGS);
}

template <typename T, int WT, bool PATH>
constexpr auto window_kernel() {
  if constexpr (PATH) return window_pathline_kernel<T, WT>;
  else return window_streamline_kernel<T, WT>;
}

// Launch a window kernel: particles per block from the slot's size, as many
// as fit kWindowSmemTarget (whole warps where possible, at most
// kBlockThreads / G).
template <typename T, int WT, bool PATH>
int launch_window(WINDOW_KERNEL_PARAMS, void* stream) {
  const size_t slot = (size_t)slot_values(K, W, PATH ? n_attrs : 0, PATH) *
                      sizeof(T);
  if (slot > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  int P = (int)(kWindowSmemTarget / slot);
  constexpr int G = group_size<T, PATH>();
  P = P < kBlockThreads / G ? P : kBlockThreads / G;
  if (P >= 32 / G) P -= P % (32 / G);
  if (P < 1) P = 1;
  const int smem = (int)(P * slot);
  auto kernel = window_kernel<T, WT, PATH>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0)
    kernel<<<(n + P - 1) / P, P * G, smem, (cudaStream_t)stream>>>(
        WINDOW_KERNEL_ARGS);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the full-column steps (K1, K2)
// ---------------------------------------------------------------------------
//
// K1 and K2 take K3's and K4's form on the whole column.  A group of G lanes
// of one warp advances one particle (kStreamGroup lanes for K1, kPathGroup
// for K2).  Before stage 1 the group copies, for each of the cell's nv
// vertex rows, xyz and ztop[0..L) of the (front) table, and for K2
// ztop[0..L) of the back table, into the particle's slot of shared memory
// (cp.async, one element a lane): the values a stage reads L at a time.  A
// stage's weights come from geometry_group, as K3's and K4's.  Per
// snapshot, lane j then sums the profile at layers j, j+G, ... (each a
// Wachspress sum over k in order with explicit fma, as the window sums)
// into its registers, and the group clamps, searches and lerps that
// distributed profile with shuffles and votes:
// - the clamp (_clamp_profile(exact=True)): the sequential recurrence
//   changes nothing unless some raw pair ascends, z[l] > z[l-1] (by
//   induction the clamped z'[l-1] is then the raw z[l-1] >= z[l]).  The
//   group tests every pair at once (the neighbour by __shfl_up_sync, then
//   __any_sync) and runs the recurrence, a shuffle a layer, only when one
//   ascends;
// - K1's bisection: every lane takes the same probes, z[mid-1] and z[mid]
//   shuffled from the lanes that hold them.  It stays a bisection: the
//   clamp spaces a plateau 1e-9 apart, under EPS_LAYER, so several
//   intervals can hold one depth, and a first-hit search would return
//   another layer than the reference's bisection;
// - K2's first-hit linear search: each lane tests its layers' intervals, one
//   ballot a register, and the lowest set bit of the first non-empty ballot
//   is the layer where the ascending loop stops;
// - the lerp's z[layer-1] and z[layer] come from the lanes that hold them.
// The picks at the layers found (K1's 8, K2's 2 x kPicks) are independent
// sums, one a lane, read straight from the tables' rows; shuffles bring them
// to every lane, the guards (K1) or the blend (K2) and the RK move run in
// every lane, and lane 0 writes the outputs.  Every rounding is K3's (K4's),
// so a window step that does not miss is bit-equal to this one.
//
// The masked form (the window paths' repair, launched after every K3/K4
// step with under 0.5 % of the lanes flagged): warps read the flags of 32
// particles at a time with one load and a ballot, and their groups step
// the flagged ones, so a launch without a flag costs a scan of the n
// flags.  The layer it writes for the start position is stage 1's (front)
// layer: stage 1 is evaluated there.  Each kernel keeps its own scan and
// grid (streamline_step_kernel, pathline_step_kernel).
//
// Each kernel's lanes a particle, register cap and table loads in flight
// stand beside it (kStreamGroup, kPathGroup).

// Shared memory a block aims at.
constexpr int kColumnSmemTarget = 32 * 1024;

// T values of one slot: weights (K), front records xyz(3) + ztop(L), and
// with two snapshots (K2) back records ztop(L); odd, as slot_values.
__host__ __device__ inline int column_slot_values(int K, int L, int NS) {
  const int S = K + K * (3 + L) + (NS - 1) * K * L;
  return S + (S % 2 == 0);
}

// The group's copy of the particle's cell into its slot: xyz and ztop[0..L)
// of table_f's rows to rec_f (st.f, 3+L apart) and, with NS = 2,
// ztop[0..L) of table_b's to rec_b (st.b, L apart); then B_k of the lane's
// vertices into bk.  Every lane of the group must call it.
template <int G, int NS, typename T>
__device__ __forceinline__ void stage_columns(const Staged<T>& st, T* rec_f,
                                              T* rec_b, const T* table_f,
                                              const T* table_b,
                                              const int32_t* vid, int F,
                                              int L, unsigned gmask, int lane,
                                              T* bk) {
  __syncwarp(gmask);                      // the slot's last step is done
  for (int k = 0; k < st.nv; ++k) {
    const int64_t row = (int64_t)vid[k] * F;
    for (int e = lane; e < 3 + L; e += G)
      cp_async(rec_f + k * (3 + L) + e, table_f + row + e);
    if (NS == 2)
      for (int e = lane; e < L; e += G)
        cp_async(rec_b + k * L + e, table_b + row + 3 + e);
  }
  cp_async_wait_all();
  __syncwarp(gmask);
  vertex_bk<G>(st, lane, bk);
}

// One snapshot's clamped (or raw) profile at a stage, spread over the
// group: lane j holds layers l = j + r*G in z[r], and z[l-1] in p[r]
// (meaningless at layer 0) once neighbours() has run.  LT is the layer
// ceiling (L <= LT).
template <typename T, int G, int LT>
struct Column {
  static constexpr int R = (LT + G - 1) / G;
  int L;
  T z[R], p[R];
  __device__ __forceinline__ void neighbours(unsigned gmask, int lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r * G >= L) break;
      const T up = __shfl_up_sync(gmask, z[r], 1, G);
      const T last = __shfl_sync(gmask, z[r > 0 ? r - 1 : 0], G - 1, G);
      p[r] = lane > 0 ? up : last;
    }
  }
  // z[l] for a layer l that every lane of the group names.
  __device__ __forceinline__ T at(int l, unsigned gmask) const {
    const int r = l / G;
    T v = z[0];
#pragma unroll
    for (int m = 1; m < R; ++m) v = m == r ? z[m] : v;
    return __shfl_sync(gmask, v, l % G, G);
  }
  // The Wachspress profile sum_k w_k * rec[k*rs + l] at the lane's layers,
  // k = 0..nv-1 in order with explicit fma (wachspress_sum's order), k
  // outermost so that the lane's R sums advance together.
  __device__ __forceinline__ void sum(const T* w, const T* rec, int rs,
                                      int nv, int lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) z[r] = T(0);
    for (int k = 0; k < nv; ++k) {
      const T wk = w[k];
      const T* row = rec + k * rs + lane;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (lane + r * G < L) z[r] = fma(wk, row[r * G], z[r]);
    }
  }
};

// _clamp_profile(exact=True) on the group's profile; with NEED_P (K2's
// linear search reads z[l-1]) it leaves p set.
template <bool NEED_P, typename T, int G, int LT>
__device__ __forceinline__ void clamp_column(Column<T, G, LT>& col,
                                             unsigned gmask, int lane) {
  using C = Column<T, G, LT>;
  const int L = col.L;
  col.neighbours(gmask, lane);
  bool ascends = false;
#pragma unroll
  for (int r = 0; r < C::R; ++r) {
    const int l = lane + r * G;
    if (r * G < L)
      ascends = ascends || (l >= 1 && l < L && col.z[r] > col.p[r]);
  }
  if (!__any_sync(gmask, ascends)) return;
  T p = col.at(0, gmask);                 // z'[l-1], every lane
#pragma unroll
  for (int r = 0; r < C::R; ++r) {
    for (int src = r == 0 ? 1 : 0; src < G && r * G + src < L; ++src) {
      const T cur = __shfl_sync(gmask, col.z[r], src, G);
      const T z = cur > p ? p - ztop_clamp<T>() : cur;
      if (lane == src) col.z[r] = z;
      p = z;
    }
  }
  if (NEED_P) col.neighbours(gmask, lane);
}

// Streamline layer resolution (reference kernel :903-944, layer_binary_w's
// on the full column): above the surface -> 1, below the bottom -> L-1,
// else bisection with the TPU kernel's fixed trip count
// ceil(log2(max(2, L))) + 2; not found -> 1, then clip to [1, L-1].  Every
// lane of the group takes the same probes.
template <typename T, int G, int LT>
__device__ __forceinline__ int layer_binary_column(const Column<T, G, LT>& col,
                                                   T d, unsigned gmask) {
  const int L = col.L;
  const bool above = d > col.at(0, gmask) + eps_layer<T>();
  const bool below = d < col.at(L - 1, gmask) - eps_layer<T>();
  int lo = 1, hi = L - 1, ans = 1;
  int trips = 2;
  for (int m = 1; m < (L > 2 ? L : 2); m <<= 1) ++trips;
  for (int it = 0; it < trips && lo <= hi; ++it) {
    const int mid = (lo + hi) >> 1;
    const T top = col.at(mid - 1, gmask), bot = col.at(mid, gmask);
    if (d <= top + eps_layer<T>() && d >= bot - eps_layer<T>()) {
      ans = mid;
      break;
    }
    if (d > top + eps_layer<T>()) hi = mid - 1; else lo = mid + 1;
  }
  ans = ans < 1 ? 1 : (ans > L - 1 ? L - 1 : ans);
  return above ? 1 : (below ? L - 1 : ans);
}

// layer_linear on the group's clamped profile (reference TBB kernel
// :1182-1222): above the surface -> 1, below the bottom -> L-1, else the
// first k in [1, L-1] whose interval holds the depth; ok is above | below
// | found.
template <typename T, int G, int LT>
__device__ __forceinline__ int layer_linear_column(const Column<T, G, LT>& col,
                                                   T d, unsigned gmask,
                                                   int lane, bool& ok) {
  const int L = col.L;
  const bool above = d > col.at(0, gmask) + eps_layer<T>();
  const bool below = d < col.at(L - 1, gmask) - eps_layer<T>();
  const int base = (threadIdx.x & 31) & ~(G - 1);   // the group's lane 0
  int first = -1;
#pragma unroll
  for (int r = 0; r < Column<T, G, LT>::R; ++r) {
    if (r * G >= L) break;
    const int l = lane + r * G;
    const bool hit = l >= 1 && l < L && d <= col.p[r] + eps_layer<T>() &&
                     d >= col.z[r] - eps_layer<T>();
    const unsigned bits = (__ballot_sync(gmask, hit) & gmask) >> base;
    if (first < 0 && bits != 0u) first = r * G + __ffs(bits) - 1;
  }
  ok = above || below || first >= 0;
  return above ? 1 : (below ? L - 1 : (first >= 0 ? first : 1));
}

// Vertical lerp parameter on the group's profile; fail if
// |z_up - z_dn| < 1e-12 (reference :958-985).
template <typename T, int G, int LT>
__device__ __forceinline__ T lerp_t_column(const Column<T, G, LT>& col,
                                           int layer, T d, unsigned gmask,
                                           bool& ok_denom) {
  const T z_dn = col.at(layer, gmask), z_up = col.at(layer - 1, gmask);
  T x = d < z_dn ? z_dn : d;
  x = x > z_up ? z_up : x;
  const T denom = z_up - z_dn;
  ok_denom = fabs(denom) >= eps_zero<T>();
  return (x - z_dn) / (ok_denom ? denom : T(1));
}

// Row offset of pick m (pick_offset's order) at the stage layer ``layer``,
// or -1 for an attribute slot >= A.  The vertical velocity's interfaces
// are layer-1 and layer (the reference's min(max(layer-1, 0), L) and
// min(layer, L) for layer in [1, L-1]).
__device__ __forceinline__ int pick_column(int m, int layer, int L, int A) {
  const bool up = m < 3 || m == 6 || (m >= 8 && m < 8 + A_MAX);
  const int l = up ? layer - 1 : layer;
  if (m < 6) return 3 + L + 3 * l + (m % 3);
  if (m < 8) return 3 + 4 * L + l;
  const int ai = (m - 8) % A_MAX;
  return ai < A ? 4 + 5 * L + A * l + ai : -1;
}

// The lane's RB pick sums acc[r] = sum_k w_k * src[r][row of vertex k]
// (zero where !has[r]), k = 0..nv-1 in order with explicit fma, from LOADS
// table loads at a time.
template <typename T, int RB, int LOADS>
__device__ __forceinline__ void pick_sums(const T* const* src,
                                          const bool* has,
                                          const int32_t* vid, const T* w,
                                          int nv, int F, T* acc) {
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = T(0);
  for (int k0 = 0; k0 < nv; k0 += LOADS) {
    T v[LOADS][RB];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const bool real = k0 + u < nv;
      const int64_t row = real ? (int64_t)vid[k0 + u] * F : 0;
#pragma unroll
      for (int r = 0; r < RB; ++r)
        v[u][r] = real && has[r] ? src[r][row] : T(0);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (k0 + u < nv && has[r]) acc[r] = fma(w[k0 + u], v[u][r], acc[r]);
  }
}

// Bytes of a slot and particles a block of a full-column step (NS
// snapshots, G lanes a particle): as many whole warps as fit
// kColumnSmemTarget, at least one, at most kBlockThreads lanes.
inline void column_layout(int G, int NS, int K, int L, int size, int* slot,
                          int* P) {
  *slot = column_slot_values(K, L, NS) * size;
  const int warps = kColumnSmemTarget / (*slot * (32 / G));
  *P = (32 / G) * (warps < 1 ? 1 : (warps > kBlockThreads / 32
                                    ? kBlockThreads / 32 : warps));
}

// Blocks of ``kernel`` (``threads`` lanes, ``smem`` bytes of shared memory
// a block) that the current device holds at once.  The runtime is asked
// once per kernel, device and shape; later launches read the answer.
template <typename Args>
cudaError_t resident_wave(void (*kernel)(Args), int threads, int smem,
                          int* blocks) {
  struct Known {
    const void* kernel;
    int dev, threads, smem, blocks;
  };
  static std::mutex mu;
  static std::vector<Known> known;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> hold(mu);
  for (const Known& k : known)
    if (k.kernel == (const void*)kernel && k.dev == dev &&
        k.threads == threads && k.smem == smem) {
      *blocks = k.blocks;
      return cudaSuccess;
    }
  int sms, per_sm;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return e;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  known.push_back({(const void*)kernel, dev, threads, smem, *blocks});
  return cudaSuccess;
}

// Launch a full-column step kernel (NS snapshots, G lanes a particle): the
// LT = 64 instance k64 for L <= 64 (the main path's 60 layers: fewer
// registers a lane) or the L_MAX one, P groups a block (column_layout).
// Plain, a group a particle.  Masked, the kernel's scan sets the grid:
// with ONE_WAVE (K1) the grid is one wave of resident blocks whose warps
// step through the flag chunks grid-stride; without (K2) a warp takes one
// chunk of 32 flags.
template <int G, int NS, bool ONE_WAVE, typename T, typename Args>
int launch_column(void (*k64)(Args), void (*k_max)(Args), const Args& a,
                  void* stream) {
  int slot, P;
  column_layout(G, NS, a.K, a.L, (int)sizeof(T), &slot, &P);
  const int smem = P * slot;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = a.L <= 64 ? k64 : k_max;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess || a.n == 0) return (int)e;
  int blocks = a.only != nullptr ? (a.n + P * G - 1) / (P * G)
                                 : (a.n + P - 1) / P;
  if (ONE_WAVE && a.only != nullptr) {
    int wave;
    if ((e = resident_wave(kernel, P * G, smem, &wave)) != cudaSuccess)
      return (int)e;
    blocks = blocks < wave ? blocks : wave;
  }
  kernel<<<blocks, P * G, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- K1 ----

// Lanes a particle: 8 of 8, 16 and 32, the fastest at f32 on the H100 at
// the main path's shape (PERF.md).  K1's stage has half K2's profile work
// and one search; at L = 60 a lane holds eight layers.
constexpr int kStreamGroup = 8;
// Table loads a pick lane issues before it sums them: the vertices' rows
// are scattered, so one load after another would wait on each in turn (8:
// 0.59 against 0.62 ms for 4 at f32).
constexpr int kStreamLoads = 8;
// Blocks of kBlockThreads lanes an SM must hold, which caps the registers
// a lane: 3 caps the plain f32 L <= 64 instance at 80 registers (96
// uncapped; 64 spill) without spills, so that an SM holds 96 particles
// (shared memory allows 108), 0.57-0.59 against 0.70-0.71 ms uncapped.  At
// f64 shared memory bounds occupancy first; the masked form and the
// generic width are not capped.
template <typename T, int LT, bool MASKED>
constexpr int stream_min_blocks() {
  return MASKED || LT > 64 || sizeof(T) == 8 ? 1 : 3;
}

template <typename T>
struct StreamlineArgs {
  const T* pos;
  const T* depth_neg;
  const int32_t* nv;
  const int32_t* vids;
  const T* table;
  int n, K, F, L;
  T dt;
  int euler;
  T* new_pos;
  T* hvel;
  T* wvel;
  bool* ok;
  const bool* only;
  int32_t* layer;
};

// CalcVelocityAt(pos, cell) (streamline) by the particle's group: returns
// ok, writes hv (zero when not ok), wv and the stage's layer.
template <typename T, int LT>
__device__ __forceinline__
bool eval_streamline_stage(const StreamlineArgs<T>& a, const Staged<T>& st,
                           const int32_t* vid, const T* bk, const T* p,
                           unsigned gmask, int lane, T* hv, T& wv,
                           int& layer) {
  constexpr int G = kStreamGroup;
  const bool inside = geometry_group<G>(st, bk, p, gmask, lane);
  const T d = st.d;
  Column<T, G, LT> col;
  col.L = a.L;
  col.sum(st.w, st.f + 3, st.rsf, st.nv, lane);
  clamp_column<false>(col, gmask, lane);
  layer = layer_binary_column(col, d, gmask);
  bool ok_denom;
  const T t = lerp_t_column(col, layer, d, gmask, ok_denom);

  // the picks: job j < 8 is pick j (pick_offset's order, no attributes)
  constexpr int RB = (8 + G - 1) / G;
  const T* src[RB];
  bool has[RB];
  T acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int j = lane + r * G;
    has[r] = j < 8;
    src[r] = a.table + (j < 8 ? pick_column(j, layer, a.L, 0) : 0);
  }
  pick_sums<T, RB, kStreamLoads>(src, has, vid, st.w, st.nv, a.F, acc);
  T v[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) v[m] = __shfl_sync(gmask, acc[m / G], m % G, G);
  const bool ok_mag = norm3(v + 3) >= eps_zero<T>() && norm3(v) >= eps_zero<T>();
#pragma unroll
  for (int c = 0; c < 3; ++c) hv[c] = t * v[c] + (T(1) - t) * v[3 + c];
  wv = t * v[6] + (T(1) - t) * v[7];
  const bool ok = inside && ok_denom && ok_mag && norm3(hv) >= eps_zero<T>();
  if (!ok) {
    hv[0] = hv[1] = hv[2] = T(0);
    wv = T(0);
  }
  return ok;
}

// The step of particle i by its group, in the group's slot.
template <typename T, int LT>
__device__ void streamline_group_step(const StreamlineArgs<T>& a, int i,
                                      T* slot, unsigned gmask, int lane) {
  constexpr int G = kStreamGroup;
  const int K = a.K, L = a.L;
  const int nvr = a.nv[i];
  const int32_t* vid = a.vids + (int64_t)i * K;
  Staged<T> st;
  st.w = slot;
  st.f = slot + K;
  st.b = nullptr;
  st.rsf = 3 + L;
  st.rsb = 0;
  st.nv = nvr < K ? nvr : K;
  st.A = 0;
  st.d = a.depth_neg[i];
  T bk[(K_MAX + G - 1) / G];
  stage_columns<G, 1>(st, slot + K, (T*)nullptr, a.table, (const T*)nullptr,
                      vid, a.F, L, gmask, lane, bk);
  const T p0[3] = {a.pos[3 * (int64_t)i], a.pos[3 * (int64_t)i + 1],
                   a.pos[3 * (int64_t)i + 2]};
  int layer = 1;
  auto eval = [&](const T* p, int stage, T* hv, T& wv, T*) {
    int lay;
    const bool ok = eval_streamline_stage<T, LT>(a, st, vid, bk, p, gmask,
                                                 lane, hv, wv, lay);
    if (stage == 0) layer = lay;
    return ok;
  };
  T hv[3], wv, np_[3];
  const bool ok = rk_step(p0, a.dt, a.euler, 0, eval, np_, hv, wv,
                          (T*)nullptr);
  if (lane != 0) return;
  for (int c = 0; c < 3; ++c) {
    a.new_pos[3 * (int64_t)i + c] = np_[c];
    a.hvel[3 * (int64_t)i + c] = hv[c];
  }
  a.wvel[i] = wv;
  a.ok[i] = ok;
  if (a.only != nullptr)
    a.layer[i] = layer < 1 ? 1 : (layer > L - 1 ? L - 1 : layer);
}

// K1's particles.  Plain: group g of block b steps particle b*P + g.
// Masked (only set): the grid is one resident wave (launch_column), and
// warp w scans the flags of particles 32w .., 32(w + W) .., ... (W warps
// in the grid), 32 with one load and a ballot; each of its 32/G groups
// keeps the next flagged particle, and the groups step theirs together
// once each holds one, or at the end.  A step's latency, not the number of
// flagged lanes, is what a masked launch waits on: one warp a chunk took a
// step a wave (60 against 45 us at f32 on the H100, PERF.md).
template <int G, bool MASKED, typename Step>
__device__ __forceinline__ void for_particles(int n, const bool* only,
                                              Step step) {
  if constexpr (!MASKED) {
    const int i = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
    if (i < n) step(i);
  } else {
    const int lane = threadIdx.x & 31, sub = lane / G;
    const int stride = gridDim.x * blockDim.x;       // 32 x warps
    int next = (blockIdx.x * blockDim.x + threadIdx.x) & ~31, base = 0;
    unsigned flags = 0u;                  // all of these are the warp's
    for (;;) {
      int mine = -1, held = 0;            // a round: a particle a group
      while (held < 32 / G) {
        if (flags == 0u) {
          if (next >= n) break;
          base = next;
          next += stride;
          flags = __ballot_sync(0xffffffffu,
                                base + lane < n && only[base + lane]);
          continue;
        }
        if (held == sub) mine = base + __ffs(flags) - 1;
        flags &= flags - 1u;
        ++held;
      }
      if (held == 0) return;
      if (mine >= 0) step(mine);
    }
  }
}

template <typename T, int LT, bool MASKED>
__global__ void __launch_bounds__(kBlockThreads,
                                  stream_min_blocks<T, LT, MASKED>())
streamline_step_kernel(StreamlineArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int G = kStreamGroup;
  T* slot = reinterpret_cast<T*>(smem_raw) +
            (size_t)(threadIdx.x / G) * column_slot_values(a.K, a.L, 1);
  const unsigned gmask = group_mask<G>();
  const int lane = threadIdx.x % G;
  for_particles<G, MASKED>(a.n, a.only, [&](int i) {
    streamline_group_step<T, LT>(a, i, slot, gmask, lane);
  });
}

template <typename T>
int launch_streamline(const StreamlineArgs<T>& a, void* stream) {
  if (a.K > K_MAX || a.L > L_MAX || a.L < 2) return (int)cudaErrorInvalidValue;
  constexpr int G = kStreamGroup;
  return a.only != nullptr
             ? launch_column<G, 1, true, T>(
                   streamline_step_kernel<T, 64, true>,
                   streamline_step_kernel<T, L_MAX, true>, a, stream)
             : launch_column<G, 1, true, T>(
                   streamline_step_kernel<T, 64, false>,
                   streamline_step_kernel<T, L_MAX, false>, a, stream);
}

// ---- K2 ----

// Lanes a particle: the fastest of 4, 8, 16 and 32 on the H100 at the main
// path's shape, f32 and f64 (PERF.md); at L = 60 a lane holds two layers.
constexpr int kPathGroup = 32;
// Table loads a pick lane issues before it sums them (4 measured as fast
// as 8 with fewer registers).
constexpr int kPathLoads = 4;
// Blocks of kBlockThreads lanes an SM must hold, which caps the registers a
// lane.  Occupancy, set by registers, is what a K2 stage waits on: the main
// path's instance (L <= 64, unmasked) is capped at 64 registers at f32 and
// 128 at f64, without spills, so that an SM holds 32 (f32) or 16 (f64)
// warps (1.39 against 1.79 ms uncapped at f32 on the H100, PERF.md).  The
// masked form (a few lanes a launch) and the generic width are not capped.
template <typename T, int LT, bool MASKED>
constexpr int path_min_blocks() {
  return MASKED || LT > 64 ? 1 : (sizeof(T) == 8 ? 2 : 4);
}

template <typename T>
struct PathlineArgs {
  const T* pos;
  const T* depth_neg;
  const int32_t* nv;
  const int32_t* vids;
  const T* table_f;
  const T* table_b;
  int n, K, F, L, n_attrs;
  T dt, a1, a2, a4;
  int euler;
  T* new_pos;
  T* hvel;
  T* wvel;
  bool* ok;
  T* attr;
  const bool* only;
  int32_t* layer;
};

// CalcVelocityAt(pos, cell, alpha) (pathline) by the particle's group: both
// snapshots blended by alpha, failed lanes carrying zeros; layer is the
// front snapshot's.
template <typename T, int LT>
__device__ __forceinline__
bool eval_column_stage(const PathlineArgs<T>& a, const Staged<T>& st,
                       const int32_t* vid, const T* bk, const T* p, T alpha,
                       unsigned gmask, int lane, T* hv, T& wv, T* at,
                       int& layer) {
  constexpr int G = kPathGroup;
  const bool inside = geometry_group<G>(st, bk, p, gmask, lane);
  const int nv = st.nv;
  const T d = st.d;
  int lay[2];
  T t[2];
  bool ok_col = true;
#pragma unroll
  for (int sn = 0; sn < 2; ++sn) {
    Column<T, G, LT> col;
    col.L = a.L;
    col.sum(st.w, sn == 0 ? st.f + 3 : st.b, sn == 0 ? st.rsf : st.rsb, nv,
            lane);
    clamp_column<true>(col, gmask, lane);
    bool ok_layer, ok_denom;
    lay[sn] = layer_linear_column(col, d, gmask, lane, ok_layer);
    t[sn] = lerp_t_column(col, lay[sn], d, gmask, ok_denom);
    ok_col = ok_col && ok_layer && ok_denom;
  }
  layer = lay[0];

  // the picks: job j is pick j % kPicks of snapshot j / kPicks
  constexpr int NB = 2 * kPicks;
  constexpr int RB = (NB + G - 1) / G;
  const T* src[RB];
  bool has[RB];
  T acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int j = lane + r * G;
    const bool front = j < kPicks;
    const int off = j < NB ? pick_column(j % kPicks, front ? lay[0] : lay[1],
                                         a.L, st.A)
                           : -1;
    has[r] = off >= 0;
    src[r] = (front ? a.table_f : a.table_b) + (off >= 0 ? off : 0);
  }
  pick_sums<T, RB, kPathLoads>(src, has, vid, st.w, nv, a.F, acc);
  T hv_s[2][3], wv_s[2], at_s[2][A_MAX];
#pragma unroll
  for (int sn = 0; sn < 2; ++sn) {
    T v[kPicks];
#pragma unroll
    for (int m = 0; m < kPicks; ++m) {
      const int j = sn * kPicks + m;
      v[m] = __shfl_sync(gmask, acc[j / G], j % G, G);
    }
    const T ts = t[sn];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      hv_s[sn][c] = ts * v[c] + (T(1) - ts) * v[3 + c];
    wv_s[sn] = ts * v[6] + (T(1) - ts) * v[7];
#pragma unroll
    for (int ai = 0; ai < A_MAX; ++ai)
      at_s[sn][ai] = ts * v[8 + ai] + (T(1) - ts) * v[8 + A_MAX + ai];
  }
  const bool ok = inside && ok_col;
  for (int c = 0; c < 3; ++c)
    hv[c] = ok ? alpha * hv_s[1][c] + (T(1) - alpha) * hv_s[0][c] : T(0);
  wv = ok ? alpha * wv_s[1] + (T(1) - alpha) * wv_s[0] : T(0);
  for (int ai = 0; ai < st.A; ++ai)
    at[ai] = ok ? alpha * at_s[1][ai] + (T(1) - alpha) * at_s[0][ai] : T(0);
  return ok;
}

// The step of particle i by its group, in the group's slot.
template <typename T, int LT>
__device__ void pathline_group_step(const PathlineArgs<T>& a, int i, T* slot,
                                    unsigned gmask, int lane) {
  constexpr int G = kPathGroup;
  const int K = a.K, L = a.L;
  const int nvr = a.nv[i];
  const int32_t* vid = a.vids + (int64_t)i * K;
  T* rec_b = slot + K + K * (3 + L);
  Staged<T> st;
  st.w = slot;
  st.f = slot + K;
  st.b = rec_b;
  st.rsf = 3 + L;
  st.rsb = L;
  st.nv = nvr < K ? nvr : K;
  st.A = a.n_attrs;
  st.d = a.depth_neg[i];
  T bk[(K_MAX + G - 1) / G];
  stage_columns<G, 2>(st, slot + K, rec_b, a.table_f, a.table_b, vid, a.F, L,
                      gmask, lane, bk);
  const T p0[3] = {a.pos[3 * (int64_t)i], a.pos[3 * (int64_t)i + 1],
                   a.pos[3 * (int64_t)i + 2]};
  int layer = 1;
  auto eval = [&](const T* p, int stage, T* hv, T& wv, T* at) {
    int lay;
    const T alpha = stage == 0 ? a.a1 : (stage == 3 ? a.a4 : a.a2);
    const bool ok = eval_column_stage<T, LT>(a, st, vid, bk, p, alpha, gmask,
                                             lane, hv, wv, at, lay);
    if (stage == 0) layer = lay;
    return ok;
  };
  T hv[3], wv, np_[3], at[A_MAX];
  const bool ok = rk_step(p0, a.dt, a.euler, a.n_attrs, eval, np_, hv, wv,
                          at);
  if (lane != 0) return;
  for (int c = 0; c < 3; ++c) {
    a.new_pos[3 * (int64_t)i + c] = np_[c];
    a.hvel[3 * (int64_t)i + c] = hv[c];
  }
  a.wvel[i] = wv;
  a.ok[i] = ok;
  if (a.attr != nullptr) {                // slots >= n_attrs are zero
    a.attr[3 * (int64_t)i] = a.n_attrs > 0 ? at[0] : T(0);
    a.attr[3 * (int64_t)i + 1] = a.n_attrs > 1 ? at[1] : T(0);
    a.attr[3 * (int64_t)i + 2] = T(0);
  }
  if (a.only != nullptr)
    a.layer[i] = layer < 1 ? 1 : (layer > L - 1 ? L - 1 : layer);
}

// Plain: group g of block b steps particle b*P + g.  Masked (a.only set):
// warp w of the grid scans particles 32w .. 32w+31, and in each round its
// 32/G groups take the next 32/G flagged ones, one each.  The warps of
// different chunks step their flags at once (a resident wave stepping a
// warp's chunks in turn took 56 against 46 us at f32 on the H100).
template <typename T, int LT, bool MASKED>
__global__ void __launch_bounds__(kBlockThreads,
                                  path_min_blocks<T, LT, MASKED>())
pathline_step_kernel(PathlineArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int G = kPathGroup;
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  T* slot = reinterpret_cast<T*>(smem_raw) +
            (size_t)g * column_slot_values(a.K, a.L, 2);
  const unsigned gmask = group_mask<G>();
  if constexpr (!MASKED) {
    const int i = blockIdx.x * (blockDim.x / G) + g;
    if (i < a.n) pathline_group_step<T, LT>(a, i, slot, gmask, lane);
    return;
  }
  const int base = (blockIdx.x * blockDim.x + threadIdx.x) & ~31;
  const int j = base + (threadIdx.x & 31);
  unsigned flags = __ballot_sync(0xffffffffu, j < a.n && a.only[j]);
  const int sub = (threadIdx.x & 31) / G;
  while (flags != 0u) {
    unsigned mine = flags;
    for (int q = 0; q < 32 / G; ++q) {
      if (q < sub) mine &= mine - 1u;     // the group's flag of the round
      flags &= flags - 1u;                // the round's flags are taken
    }
    if (mine != 0u)
      pathline_group_step<T, LT>(a, base + __ffs(mine) - 1, slot, gmask,
                                 lane);
  }
}

template <typename T>
int launch_pathline(const PathlineArgs<T>& a, void* stream) {
  if (a.n_attrs < 0 || a.n_attrs > A_MAX || a.K > K_MAX || a.L > L_MAX ||
      a.L < 2)
    return (int)cudaErrorInvalidValue;
  constexpr int G = kPathGroup;
  return a.only != nullptr
             ? launch_column<G, 2, false, T>(
                   pathline_step_kernel<T, 64, true>,
                   pathline_step_kernel<T, L_MAX, true>, a, stream)
             : launch_column<G, 2, false, T>(
                   pathline_step_kernel<T, 64, false>,
                   pathline_step_kernel<T, L_MAX, false>, a, stream);
}

// The window kernels for W == 8 (the main path's) or any W <= W_MAX.
template <typename T, bool PATH>
int launch_window_any(WINDOW_KERNEL_PARAMS, void* stream) {
  if (W < 2 || W > W_MAX || W > L) return (int)cudaErrorInvalidValue;
  if (n_attrs < 0 || n_attrs > A_MAX || K > K_MAX)
    return (int)cudaErrorInvalidValue;
  return W == 8 ? launch_window<T, 8, PATH>(WINDOW_KERNEL_ARGS, stream)
                : launch_window<T, W_MAX, PATH>(WINDOW_KERNEL_ARGS, stream);
}

}  // namespace

// The entries below are built as separate translation units, one per kernel
// and dtype, compiled in parallel and linked into one library:
// -DSTAGE_PART=p keeps entry p only (1-8), and no STAGE_PART keeps all.
#ifndef STAGE_PART
#define STAGE_PART 0
#endif
#define STAGE_HAS(p) (STAGE_PART == 0 || STAGE_PART == (p))

extern "C" {

#if STAGE_HAS(1)
int stage_kernel_k_max() { return K_MAX; }
int stage_kernel_l_max() { return L_MAX; }
int stage_kernel_a_max() { return A_MAX; }
int stage_kernel_w_max() { return W_MAX; }
// K1's and K2's shared memory a particle (bytes) and particles a block.
void streamline_step_layout(int K, int L, int itemsize, int* slot_bytes,
                            int* particles) {
  column_layout(kStreamGroup, 1, K, L, itemsize, slot_bytes, particles);
}
void pathline_step_layout(int K, int L, int itemsize, int* slot_bytes,
                          int* particles) {
  column_layout(kPathGroup, 2, K, L, itemsize, slot_bytes, particles);
}
#endif

// K1 and K2: ``only`` and ``layer`` are null for a plain step, and the miss
// flags and the window's layer output for the repair of a window step.
#define STREAMLINE_ENTRY(T, tag)                                               \
  int streamline_step_##tag(                                                   \
      const T* pos, const T* depth_neg, const int32_t* nv,                     \
      const int32_t* vids, const T* table, int n, int K, int F, int L, T dt,   \
      int euler, T* new_pos, T* hvel, T* wvel, bool* ok, const bool* only,     \
      int32_t* layer, void* stream) {                                          \
    return launch_streamline<T>({pos, depth_neg, nv, vids, table, n, K, F, L,  \
                                 dt, euler, new_pos, hvel, wvel, ok, only,     \
                                 layer},                                       \
                                stream);                                       \
  }

#define PATHLINE_ENTRY(T, tag)                                                 \
  int pathline_step_##tag(                                                     \
      const T* pos, const T* depth_neg, const int32_t* nv,                     \
      const int32_t* vids, const T* table_f, const T* table_b, int n, int K,   \
      int F, int L, int n_attrs, T dt, T a1, T a2, T a4, int euler,            \
      T* new_pos, T* hvel, T* wvel, bool* ok, T* attr, const bool* only,       \
      int32_t* layer, void* stream) {                                          \
    return launch_pathline<T>(                                                 \
        {pos, depth_neg, nv, vids, table_f, table_b, n, K, F, L, n_attrs, dt,  \
         a1, a2, a4, euler, new_pos, hvel, wvel, ok, attr, only, layer},       \
        stream);                                                               \
  }

#define WINDOW_STREAMLINE_ENTRY(T, tag)                                        \
  int window_streamline_step_##tag(                                            \
      const T* pos, const T* depth_neg, const int32_t* nv,                     \
      const int32_t* vids, const int32_t* s, const T* table, int n, int K,     \
      int F, int L, int W, T dt, int euler, T* new_pos, T* hvel, T* wvel,      \
      bool* ok, int32_t* layer, bool* miss, void* stream) {                    \
    return launch_window_any<T, false>(                                        \
        pos, depth_neg, nv, vids, s, table, table, n, K, F, L, W, 0, dt, T(0), \
        T(0), T(0), euler, new_pos, hvel, wvel, ok, layer, miss, (T*)nullptr,  \
        stream);                                                               \
  }

#define WINDOW_PATHLINE_ENTRY(T, tag)                                          \
  int window_pathline_step_##tag(                                              \
      const T* pos, const T* depth_neg, const int32_t* nv,                     \
      const int32_t* vids, const int32_t* s, const T* table_f,                 \
      const T* table_b, int n, int K, int F, int L, int W, int n_attrs, T dt,  \
      T a1, T a2, T a4, int euler, T* new_pos, T* hvel, T* wvel, bool* ok,     \
      int32_t* layer, bool* miss, T* attr, void* stream) {                     \
    return launch_window_any<T, true>(                                         \
        pos, depth_neg, nv, vids, s, table_f, table_b, n, K, F, L, W, n_attrs, \
        dt, a1, a2, a4, euler, new_pos, hvel, wvel, ok, layer, miss, attr,     \
        stream);                                                               \
  }

#if STAGE_HAS(1)
STREAMLINE_ENTRY(float, f32)
#endif
#if STAGE_HAS(2)
STREAMLINE_ENTRY(double, f64)
#endif
#if STAGE_HAS(3)
PATHLINE_ENTRY(float, f32)
#endif
#if STAGE_HAS(4)
PATHLINE_ENTRY(double, f64)
#endif
#if STAGE_HAS(5)
WINDOW_STREAMLINE_ENTRY(float, f32)
#endif
#if STAGE_HAS(6)
WINDOW_STREAMLINE_ENTRY(double, f64)
#endif
#if STAGE_HAS(7)
WINDOW_PATHLINE_ENTRY(float, f32)
#endif
#if STAGE_HAS(8)
WINDOW_PATHLINE_ENTRY(double, f64)
#endif

}  // extern "C"
