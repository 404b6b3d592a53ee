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
// One thread advances one particle through a whole time step: spherical
// containment, Wachspress weights over the cell's nv <= K vertices, the
// Wachspress ztop profile with the sequential 1e-9 monotonic clamp, the
// layer search, the vertical lerp of velocity and vertical velocity, and
// RK4 with Rodrigues mid-stage moves and the endpoint renormalised to the
// old radius (or Euler).  K1 searches layers by bisection and guards the
// velocities at 1e-12.  K2 evaluates each stage against two snapshots: one
// weight set, then an independent profile, first-hit linear layer search
// and lerp in each snapshot, blended as a*back + (1-a)*front with the stage
// alphas (a1, a2, a2, a4), no per-snapshot |v| guard, and up to two named
// attributes lerped and blended like the velocity.  All four kernels share
// the geometry and RK device functions below, and K1/K2 the column ones.
//
// K3 and K4 read only W layers [s, s+W) of each column per stage, s being a
// per-particle start placed around the layer of the previous step: the
// profile is summed over the window and clamped from its top, layers outside
// read as +BIG above and -BIG below, and the surface and bottom tests use
// the unclamped column ends (the front snapshot's for both snapshots, as the
// TPU kernel reads them from one static row).  A depth within EPS_LAYER of an
// inner window edge could belong to a layer outside: that stage is a miss.
// Off the miss lanes every comparison resolves as on the full column, so the
// step is K1's (K2's).  The TPU batch repairs its miss lanes afterwards with
// a second, full-column step; here the thread that missed runs K1's (K2's)
// step itself, so the outputs are final for every lane, and the window
// kernel also returns the start position's layer (the next window's centre)
// and the miss flag.
//
// Input layout.  The TPU kernels take columns pre-gathered by XLA into a
// (K, F, N) lanes-minor block, and K3/K4 a (W, K*C, N) window slice gathered
// from a (cell, window start) table that exists because a TPU gather pays
// per descriptor.  Here each thread reads its own K vertex rows straight
// from the packed (nV, F) tables by vertex id, so neither materialisation
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
// The simple design does one thing about it: each profile walks each row
// contiguously (see z_profile).  Otherwise one thread per particle, rows
// read with scalar loads, the profile kept in thread-local memory;
// warp-per-particle row reads, shared-memory staging and TMA are later work.
//
// Numerics: IEEE division and square root are required.  Do not build with
// --use_fast_math or -ffast-math-style flags: the containment test relies on
// isfinite(p); Euler divides by |pos x hv| with no guard and the reference
// relies on the resulting NaN for its downstream cleanup; Wachspress divides
// by triangle areas that can be zero.  FMA contraction is allowed; it moves
// f64 results by about an ulp against the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

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

// The state one particle carries through its step.
template <typename T>
struct Particle {
  int L;
  int nv;                 // real vertices of the frozen cell
  const T* row[K_MAX];    // this cell's vertex rows (the front table's)
  T vp[K_MAX][3];         // vertex positions
  T depth_neg;
  T z[L_MAX];             // ztop profile at the current stage position
};

// ---------------------------------------------------------------------------
// geometry
// ---------------------------------------------------------------------------

// Spherical point-in-polygon (inside iff cross(A_k, B_k) . p >= 0 on every
// edge; a non-finite p is outside) and the Wachspress weights
// w_k = B_k / (A_k * A_{k+1}), normalised.  Returns inside.
// The edge test is evaluated as cross(A_k - p, B_k - p) . p, the same
// determinant (subtracting p from two of its columns leaves it unchanged)
// without the cancellation of cross(A_k, B_k): at float32, products of
// 6.4e6-m coordinates misplace the edge plane by tens of metres, so a
// particle that stops that close to an edge fails the test in the cell that
// relocation (nearest centre) gives it, fails every stage at its start
// position and, under FailMode.ZERO, never moves again.
template <typename T>
__device__ bool geometry(const T (*vp)[3], int nv, const T* p, T* w) {
  bool inside = isfinite(p[0]) && isfinite(p[1]) && isfinite(p[2]);
  for (int k = 0; k < nv; ++k) {
    const T* b = vp[(k + 1) % nv];
    const T a_p[3] = {vp[k][0] - p[0], vp[k][1] - p[1], vp[k][2] - p[2]};
    const T b_p[3] = {b[0] - p[0], b[1] - p[1], b[2] - p[2]};
    T c[3];
    cross3(a_p, b_p, c);
    inside = inside && (dot3(c, p) >= T(0));
  }
  T wsum = T(0);
  for (int k = 0; k < nv; ++k) {
    const T* prv = vp[k == 0 ? nv - 1 : k - 1];
    const T* nxt = vp[(k + 1) % nv];
    T a_i = tri_area(prv, vp[k], p);
    T a_n = tri_area(vp[k], nxt, p);
    T b_k = tri_area(prv, vp[k], nxt);
    w[k] = b_k / (a_i * a_n);
    wsum = wsum + w[k];
  }
  T inv = T(1) / wsum;
  for (int k = 0; k < nv; ++k) w[k] = w[k] * inv;
  return inside;
}

// ---------------------------------------------------------------------------
// column machinery (one snapshot's rows)
// ---------------------------------------------------------------------------

// The helpers below take the particle's scalars (nv, L, depth) as values,
// loaded once per stage evaluation: read through the Particle, they would
// be reloaded from its local-memory copy after every store to the profile.

// ztop profile + sequential monotonic clamp (reference :861-867) into z.
// Each thread streams one vertex row at a time (k outer): the row's cache
// lines are used up before the next row is touched.  With l outer a thread
// holds K rows' lines at once, and the ~900 resident threads of an SM evict
// them before reuse.  Both orders sum over k in the same order.
template <typename T>
__device__ void z_profile(T* z, const T* const* row, const T* w, int nv,
                          int L) {
  for (int l = 0; l < L; ++l) z[l] = T(0);
  for (int k = 0; k < nv; ++k) {
    const T* zr = row[k] + 3;
    const T wk = w[k];
    for (int l = 0; l < L; ++l) z[l] = z[l] + wk * zr[l];
  }
  for (int l = 1; l < L; ++l)
    if (z[l] > z[l - 1]) z[l] = z[l - 1] - ztop_clamp<T>();
}

// Streamline layer resolution (reference :903-944): above the surface -> 1,
// below the bottom -> L-1, else bisection; not found -> 1, then clip to
// [1, L-1].  The trip count is the TPU kernel's fixed
// ceil(log2(max(2, L))) + 2.
template <typename T>
__device__ int layer_binary(const T* z, int L, T d) {
  bool above = d > z[0] + eps_layer<T>();
  bool below = d < z[L - 1] - eps_layer<T>();
  int lo = 1, hi = L - 1, ans = 1;
  int trips = 2;
  for (int m = 1; m < (L > 2 ? L : 2); m <<= 1) ++trips;
  for (int it = 0; it < trips && lo <= hi; ++it) {
    int mid = (lo + hi) >> 1;
    T top = z[mid - 1], bot = z[mid];
    if (d <= top + eps_layer<T>() && d >= bot - eps_layer<T>()) {
      ans = mid;
      break;
    }
    if (d > top + eps_layer<T>()) hi = mid - 1; else lo = mid + 1;
  }
  ans = ans < 1 ? 1 : (ans > L - 1 ? L - 1 : ans);
  return above ? 1 : (below ? L - 1 : ans);
}

// Pathline layer resolution (reference TBB kernel :1182-1222): above the
// surface -> 1 (the reference's layer 0, clamped), below the bottom -> L-1,
// else the first k in [1, L-1] whose interval holds the depth.  ok is
// above | below | found.
template <typename T>
__device__ int layer_linear(const T* z, int L, T d, bool& ok) {
  const bool above = d > z[0] + eps_layer<T>();
  const bool below = d < z[L - 1] - eps_layer<T>();
  int first = 1;
  bool found = false;
  for (int k = 1; k < L; ++k) {
    if (d <= z[k - 1] + eps_layer<T>() && d >= z[k] - eps_layer<T>()) {
      first = k;
      found = true;
      break;
    }
  }
  ok = above || below || found;
  return above ? 1 : (below ? L - 1 : first);
}

// Vertical lerp parameter; fail if |z_up - z_dn| < 1e-12 (:958-985).
template <typename T>
__device__ T lerp_t(const T* z, int layer, T d, bool& ok_denom) {
  const T z_dn = z[layer], z_up = z[layer - 1];
  T x = d < z_dn ? z_dn : d;
  x = x > z_up ? z_up : x;
  const T denom = z_up - z_dn;
  ok_denom = fabs(denom) >= eps_zero<T>();
  return (x - z_dn) / (ok_denom ? denom : T(1));
}

// Wachspress-weighted velocities at layer-1 (v_up) and layer (v_dn).
template <typename T>
__device__ void pick_velocity(const T* const* row, const T* w, int nv, int L,
                              int layer, T* v_up, T* v_dn) {
  const int ov = 3 + L;
  for (int c = 0; c < 3; ++c) {
    T au = T(0), ad = T(0);
    for (int k = 0; k < nv; ++k) {
      au = au + w[k] * row[k][ov + 3 * (layer - 1) + c];
      ad = ad + w[k] * row[k][ov + 3 * layer + c];
    }
    v_up[c] = au;
    v_dn[c] = ad;
  }
}

// Vertical velocity on interfaces, lerped: dn_if = min(layer, L),
// up_if = min(max(layer-1, 0), L).
template <typename T>
__device__ T pick_wvel(const T* const* row, const T* w, int nv, int L,
                       int layer, T t) {
  const int ow = 3 + 4 * L, lp1 = L + 1;
  const int dn_if = layer < lp1 - 1 ? layer : lp1 - 1;
  int up_if = layer - 1 > 0 ? layer - 1 : 0;
  up_if = up_if < lp1 - 1 ? up_if : lp1 - 1;
  T wu = T(0), wd = T(0);
  for (int k = 0; k < nv; ++k) {
    wu = wu + w[k] * row[k][ow + up_if];
    wd = wd + w[k] * row[k][ow + dn_if];
  }
  return t * wu + (T(1) - t) * wd;
}

// Attribute ai of n_attrs, lerped between layer-1 and layer (reference TBB
// kernel :1263-1317).
template <typename T>
__device__ T pick_attr(const T* const* row, const T* w, int nv, int L,
                       int n_attrs, int ai, int layer, T t) {
  const int oa = 3 + 4 * L + L + 1;
  T au = T(0), ad = T(0);
  for (int k = 0; k < nv; ++k) {
    au = au + w[k] * row[k][oa + n_attrs * (layer - 1) + ai];
    ad = ad + w[k] * row[k][oa + n_attrs * layer + ai];
  }
  return t * au + (T(1) - t) * ad;
}

// ---------------------------------------------------------------------------
// stage evaluations
// ---------------------------------------------------------------------------

// CalcVelocityAt (streamline): returns ok, writes hv (zero when not ok) and wv.
template <typename T>
__device__ bool eval_streamline(Particle<T>& s, const T* const* row,
                                const T* p, T* hv, T& wv) {
  const int nv = s.nv, L = s.L;
  const T d = s.depth_neg;
  T w[K_MAX];
  const bool inside = geometry(s.vp, nv, p, w);
  z_profile(s.z, row, w, nv, L);
  const int layer = layer_binary(s.z, L, d);
  bool ok_denom;
  const T t = lerp_t(s.z, layer, d, ok_denom);
  T v_up[3], v_dn[3];
  pick_velocity(row, w, nv, L, layer, v_up, v_dn);
  const bool ok_mag = norm3(v_dn) >= eps_zero<T>() && norm3(v_up) >= eps_zero<T>();
  for (int c = 0; c < 3; ++c) hv[c] = t * v_up[c] + (T(1) - t) * v_dn[c];
  const bool ok_final = norm3(hv) >= eps_zero<T>();
  wv = pick_wvel(row, w, nv, L, layer, t);

  const bool ok = inside && ok_denom && ok_mag && ok_final;
  if (!ok) {
    hv[0] = hv[1] = hv[2] = T(0);
    wv = T(0);
  }
  return ok;
}

// One snapshot's column of a pathline stage: profile, linear search, lerp
// and picks.  Returns ok_layer && ok_denom.
template <typename T>
__device__ bool pathline_column(T* z, const T* const* row, const T* w,
                                int nv, int L, T d, int n_attrs, T* hv, T& wv,
                                T* at) {
  z_profile(z, row, w, nv, L);
  bool ok_layer, ok_denom;
  const int layer = layer_linear(z, L, d, ok_layer);
  const T t = lerp_t(z, layer, d, ok_denom);
  T v_up[3], v_dn[3];
  pick_velocity(row, w, nv, L, layer, v_up, v_dn);
  for (int c = 0; c < 3; ++c) hv[c] = t * v_up[c] + (T(1) - t) * v_dn[c];
  wv = pick_wvel(row, w, nv, L, layer, t);
  for (int ai = 0; ai < n_attrs; ++ai)
    at[ai] = pick_attr(row, w, nv, L, n_attrs, ai, layer, t);
  return ok_layer && ok_denom;
}

// CalcVelocityAt(pos, cell, alpha) (pathline): both snapshots blended by a;
// failed lanes carry zeros.
template <typename T>
__device__ bool eval_pathline(Particle<T>& s, const T* const* row_f,
                              const T* const* row_b, int n_attrs, const T* p,
                              T a, T* hv, T& wv, T* at) {
  const int nv = s.nv, L = s.L;
  const T d = s.depth_neg;
  T w[K_MAX];
  const bool inside = geometry(s.vp, nv, p, w);
  T hv_f[3], hv_b[3], wv_f, wv_b, at_f[A_MAX], at_b[A_MAX];
  const bool ok_f = pathline_column(s.z, row_f, w, nv, L, d, n_attrs, hv_f,
                                    wv_f, at_f);
  const bool ok_b = pathline_column(s.z, row_b, w, nv, L, d, n_attrs, hv_b,
                                    wv_b, at_b);
  const bool ok = inside && ok_f && ok_b;
  for (int c = 0; c < 3; ++c)
    hv[c] = ok ? a * hv_b[c] + (T(1) - a) * hv_f[c] : T(0);
  wv = ok ? a * wv_b + (T(1) - a) * wv_f : T(0);
  for (int ai = 0; ai < n_attrs; ++ai)
    at[ai] = ok ? a * at_b[ai] + (T(1) - a) * at_f[ai] : T(0);
  return ok;
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

// Loads the particle's frozen cell: nv (clipped to K), its vertex rows in
// the front table (and in the back table when row_b is given), and the
// vertex positions from the front table.
template <typename T>
__device__ void load_cell(Particle<T>& s, int i, const int32_t* nv_in,
                          const int32_t* vids, int K, int F, int L,
                          const T* depth_neg, const T* table,
                          const T* table_b, const T** row_b) {
  s.L = L;
  const int nv = nv_in[i];
  s.nv = nv < K ? nv : K;
  s.depth_neg = depth_neg[i];
  for (int k = 0; k < s.nv; ++k) {
    const int64_t v = (int64_t)vids[(int64_t)i * K + k] * F;
    s.row[k] = table + v;
    if (row_b != nullptr) row_b[k] = table_b + v;
    for (int c = 0; c < 3; ++c) s.vp[k][c] = s.row[k][c];
  }
}

// One RK4 (or Euler) step from p0.  eval(p, stage, hv, wv, at) evaluates
// stage 0..3 at p and returns its ok; attributes 0..n_attrs-1 are averaged
// like the velocity.
template <typename T, typename Eval>
__device__ bool rk_step(const T* p0, T dt, int euler, int n_attrs, Eval eval,
                        T* np_, T* hv, T& wv, T* at) {
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

template <typename T>
__global__ void __launch_bounds__(128)
streamline_step_kernel(const T* __restrict__ pos, const T* __restrict__ depth_neg,
                       const int32_t* __restrict__ nv_in,
                       const int32_t* __restrict__ vids,
                       const T* __restrict__ table, int n, int K, int F, int L,
                       T dt, int euler, T* __restrict__ new_pos,
                       T* __restrict__ hvel, T* __restrict__ wvel,
                       bool* __restrict__ ok_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Particle<T> s;
  load_cell(s, i, nv_in, vids, K, F, L, depth_neg, table, (const T*)nullptr,
            (const T**)nullptr);
  const T p0[3] = {pos[3 * (int64_t)i], pos[3 * (int64_t)i + 1],
                   pos[3 * (int64_t)i + 2]};
  auto eval = [&](const T* p, int, T* hv, T& wv, T*) {
    return eval_streamline(s, s.row, p, hv, wv);
  };
  T hv[3], wv, np_[3];
  const bool ok = rk_step(p0, dt, euler, 0, eval, np_, hv, wv, (T*)nullptr);
  for (int c = 0; c < 3; ++c) {
    new_pos[3 * (int64_t)i + c] = np_[c];
    hvel[3 * (int64_t)i + c] = hv[c];
  }
  wvel[i] = wv;
  ok_out[i] = ok;
}

template <typename T>
__global__ void __launch_bounds__(128)
pathline_step_kernel(const T* __restrict__ pos, const T* __restrict__ depth_neg,
                     const int32_t* __restrict__ nv_in,
                     const int32_t* __restrict__ vids,
                     const T* __restrict__ table_f,
                     const T* __restrict__ table_b, int n, int K, int F, int L,
                     int n_attrs, T dt, T a1, T a2, T a4, int euler,
                     T* __restrict__ new_pos, T* __restrict__ hvel,
                     T* __restrict__ wvel, bool* __restrict__ ok_out,
                     T* __restrict__ attr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Particle<T> s;
  const T* row_b[K_MAX];
  load_cell(s, i, nv_in, vids, K, F, L, depth_neg, table_f, table_b, row_b);
  const T p0[3] = {pos[3 * (int64_t)i], pos[3 * (int64_t)i + 1],
                   pos[3 * (int64_t)i + 2]};
  auto eval = [&](const T* p, int stage, T* hv, T& wv, T* at) {
    const T a = stage == 0 ? a1 : (stage == 3 ? a4 : a2);
    return eval_pathline(s, s.row, row_b, n_attrs, p, a, hv, wv, at);
  };
  T hv[3], wv, np_[3], at[A_MAX];
  const bool ok = rk_step(p0, dt, euler, n_attrs, eval, np_, hv, wv, at);
  for (int c = 0; c < 3; ++c) {
    new_pos[3 * (int64_t)i + c] = np_[c];
    hvel[3 * (int64_t)i + c] = hv[c];
  }
  wvel[i] = wv;
  ok_out[i] = ok;
  if (attr != nullptr) {                // slots >= n_attrs are zero
    attr[3 * (int64_t)i] = n_attrs > 0 ? at[0] : T(0);
    attr[3 * (int64_t)i + 1] = n_attrs > 1 ? at[1] : T(0);
    attr[3 * (int64_t)i + 2] = T(0);
  }
}


// ---------------------------------------------------------------------------
// the layer window (K3, K4)
// ---------------------------------------------------------------------------

// One stage's window of one snapshot: the profile at layers s..s+W-1.
template <typename T>
struct Window {
  int s, W, L;
  T z[W_MAX];
  // z at global layer lg, +BIG above the window and -BIG below it (zw_at).
  __device__ T at(int lg) const {
    return lg < s ? big<T>() : (lg >= s + W ? -big<T>() : z[lg - s]);
  }
};

// Window profile + the clamp started at the window's top (z_window).
template <typename T>
__device__ void z_window(Window<T>& win, const T* const* row, const T* w,
                         int nv) {
  const int W = win.W;
  for (int l = 0; l < W; ++l) win.z[l] = T(0);
  for (int k = 0; k < nv; ++k) {
    const T* zr = row[k] + 3 + win.s;
    const T wk = w[k];
    for (int l = 0; l < W; ++l) win.z[l] = win.z[l] + wk * zr[l];
  }
  for (int l = 1; l < W; ++l)
    if (win.z[l] > win.z[l - 1]) win.z[l] = win.z[l - 1] - ztop_clamp<T>();
}

// Depth within EPS_LAYER of an inner window edge (miss_of).
template <typename T>
__device__ bool window_miss(const Window<T>& win, T d) {
  return (win.s > 0 && d >= win.z[0] - eps_layer<T>()) ||
         (win.s + win.W < win.L && d <= win.z[win.W - 1] + eps_layer<T>());
}

// layer_binary over the window with the sentinels; surface z0, bottom zL.
template <typename T>
__device__ int layer_binary_w(const Window<T>& win, T d, T z0, T zL) {
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

// layer_linear over the window's intervals (layers s+1 .. s+W-1).
template <typename T>
__device__ int layer_linear_w(const Window<T>& win, T d, T z0, T zL,
                              bool& ok) {
  const bool above = d > z0 + eps_layer<T>();
  const bool below = d < zL - eps_layer<T>();
  int first = 1;
  bool found = false;
  for (int l = 1; l < win.W; ++l) {
    if (d <= win.z[l - 1] + eps_layer<T>() && d >= win.z[l] - eps_layer<T>()) {
      first = win.s + l;
      found = true;
      break;
    }
  }
  ok = above || below || found;
  return above ? 1 : (below ? win.L - 1 : first);
}

template <typename T>
__device__ T lerp_t_w(const Window<T>& win, int layer, T d, bool& ok_denom) {
  const T z_dn = win.at(layer), z_up = win.at(layer - 1);
  T x = d < z_dn ? z_dn : d;
  x = x > z_up ? z_up : x;
  const T denom = z_up - z_dn;
  ok_denom = fabs(denom) >= eps_zero<T>();
  return (x - z_dn) / (ok_denom ? denom : T(1));
}

// Wachspress sum of the value at row offset off + stride*lg (+ c) at global
// layer lg, zero when lg lies outside the window (field_pick).
template <typename T>
__device__ T pick_w(const Window<T>& win, const T* const* row, const T* w,
                    int nv, int off, int stride, int lg) {
  if (lg < win.s || lg >= win.s + win.W) return T(0);
  T acc = T(0);
  const int o = off + stride * lg;
  for (int k = 0; k < nv; ++k) acc = acc + w[k] * row[k][o];
  return acc;
}

// Surface and bottom ztop (unclamped column ends) at the stage's weights.
template <typename T>
__device__ void column_ends(const T* const* row, const T* w, int nv, int L,
                            T& z0, T& zL) {
  z0 = T(0);
  zL = T(0);
  for (int k = 0; k < nv; ++k) {
    z0 = z0 + w[k] * row[k][3];
    zL = zL + w[k] * row[k][3 + L - 1];
  }
}

// The window form of eval_streamline; layer and miss are the stage's.
template <typename T>
__device__ bool eval_streamline_w(Particle<T>& s, Window<T>& win,
                                  const T* p, T* hv, T& wv, int& layer,
                                  bool& miss) {
  const int nv = s.nv, L = s.L;
  const T d = s.depth_neg;
  const T* const* row = s.row;
  T w[K_MAX];
  const bool inside = geometry(s.vp, nv, p, w);
  T z0, zL;
  column_ends(row, w, nv, L, z0, zL);
  z_window(win, row, w, nv);
  layer = layer_binary_w(win, d, z0, zL);
  miss = window_miss(win, d);
  bool ok_denom;
  const T t = lerp_t_w(win, layer, d, ok_denom);
  T v_up[3], v_dn[3];
  for (int c = 0; c < 3; ++c) {
    v_up[c] = pick_w(win, row, w, nv, 3 + L + c, 3, layer - 1);
    v_dn[c] = pick_w(win, row, w, nv, 3 + L + c, 3, layer);
  }
  const bool ok_mag = norm3(v_dn) >= eps_zero<T>() && norm3(v_up) >= eps_zero<T>();
  for (int c = 0; c < 3; ++c) hv[c] = t * v_up[c] + (T(1) - t) * v_dn[c];
  const bool ok_final = norm3(hv) >= eps_zero<T>();
  const int ow = 3 + 4 * L;
  wv = t * pick_w(win, row, w, nv, ow, 1, layer - 1) +
       (T(1) - t) * pick_w(win, row, w, nv, ow, 1, layer);
  const bool ok = inside && ok_denom && ok_mag && ok_final;
  if (!ok) {
    hv[0] = hv[1] = hv[2] = T(0);
    wv = T(0);
  }
  return ok;
}

// One snapshot's window column of a pathline stage (pathline_column).
template <typename T>
__device__ bool pathline_column_w(Window<T>& win, const T* const* row,
                                  const T* w, int nv, int L, T d, T z0, T zL,
                                  int n_attrs, T* hv, T& wv, T* at,
                                  int& layer, bool& miss) {
  z_window(win, row, w, nv);
  bool ok_layer, ok_denom;
  layer = layer_linear_w(win, d, z0, zL, ok_layer);
  miss = window_miss(win, d);
  const T t = lerp_t_w(win, layer, d, ok_denom);
  for (int c = 0; c < 3; ++c)
    hv[c] = t * pick_w(win, row, w, nv, 3 + L + c, 3, layer - 1) +
            (T(1) - t) * pick_w(win, row, w, nv, 3 + L + c, 3, layer);
  const int ow = 3 + 4 * L, oa = 3 + 4 * L + L + 1;
  wv = t * pick_w(win, row, w, nv, ow, 1, layer - 1) +
       (T(1) - t) * pick_w(win, row, w, nv, ow, 1, layer);
  for (int ai = 0; ai < n_attrs; ++ai)
    at[ai] = t * pick_w(win, row, w, nv, oa + ai, n_attrs, layer - 1) +
             (T(1) - t) * pick_w(win, row, w, nv, oa + ai, n_attrs, layer);
  return ok_layer && ok_denom;
}

// The window form of eval_pathline; layer is the front snapshot's.
template <typename T>
__device__ bool eval_pathline_w(Particle<T>& s, Window<T>& win,
                                const T* const* row_b, int n_attrs,
                                const T* p, T a, T* hv, T& wv, T* at,
                                int& layer, bool& miss) {
  const int nv = s.nv, L = s.L;
  const T d = s.depth_neg;
  T w[K_MAX];
  const bool inside = geometry(s.vp, nv, p, w);
  T z0, zL;
  column_ends(s.row, w, nv, L, z0, zL);
  T hv_f[3], hv_b[3], wv_f, wv_b, at_f[A_MAX], at_b[A_MAX];
  int layer_b;
  bool miss_f, miss_b;
  const bool ok_f = pathline_column_w(win, s.row, w, nv, L, d, z0, zL,
                                      n_attrs, hv_f, wv_f, at_f, layer,
                                      miss_f);
  const bool ok_b = pathline_column_w(win, row_b, w, nv, L, d, z0, zL,
                                      n_attrs, hv_b, wv_b, at_b, layer_b,
                                      miss_b);
  miss = miss_f || miss_b;
  const bool ok = inside && ok_f && ok_b;
  for (int c = 0; c < 3; ++c)
    hv[c] = ok ? a * hv_b[c] + (T(1) - a) * hv_f[c] : T(0);
  wv = ok ? a * wv_b + (T(1) - a) * wv_f : T(0);
  for (int ai = 0; ai < n_attrs; ++ai)
    at[ai] = ok ? a * at_b[ai] + (T(1) - a) * at_f[ai] : T(0);
  return ok;
}

// The full column's layer at the start position p0 (the layer the TPU
// step loop's repair returns): binary search for a streamline, first-hit linear
// search (front snapshot) for a pathline.
template <typename T>
__device__ int start_layer(Particle<T>& s, const T* p0, bool pathline) {
  T w[K_MAX];
  geometry(s.vp, s.nv, p0, w);
  z_profile(s.z, s.row, w, s.nv, s.L);
  bool ok;
  return pathline ? layer_linear(s.z, s.L, s.depth_neg, ok)
                  : layer_binary(s.z, s.L, s.depth_neg);
}

__device__ inline int clamp_start(int s, int L, int W) {
  return s < 0 ? 0 : (s > L - W ? L - W : s);
}

template <typename T>
__global__ void __launch_bounds__(128)
window_streamline_kernel(const T* __restrict__ pos,
                         const T* __restrict__ depth_neg,
                         const int32_t* __restrict__ nv_in,
                         const int32_t* __restrict__ vids,
                         const int32_t* __restrict__ s_in,
                         const T* __restrict__ table, int n, int K, int F,
                         int L, int W, T dt, int euler,
                         T* __restrict__ new_pos, T* __restrict__ hvel,
                         T* __restrict__ wvel, bool* __restrict__ ok_out,
                         int32_t* __restrict__ layer_out,
                         bool* __restrict__ miss_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Particle<T> s;
  load_cell(s, i, nv_in, vids, K, F, L, depth_neg, table, (const T*)nullptr,
            (const T**)nullptr);
  Window<T> win;
  win.s = clamp_start(s_in[i], L, W);
  win.W = W;
  win.L = L;
  const T p0[3] = {pos[3 * (int64_t)i], pos[3 * (int64_t)i + 1],
                   pos[3 * (int64_t)i + 2]};
  int layer = 1;
  bool miss = false;
  auto eval = [&](const T* p, int stage, T* hv, T& wv, T*) {
    int lay;
    bool m;
    const bool ok = eval_streamline_w(s, win, p, hv, wv, lay, m);
    if (stage == 0) layer = lay;
    miss = miss || m;
    return ok;
  };
  T hv[3], wv, np_[3];
  bool ok = rk_step(p0, dt, euler, 0, eval, np_, hv, wv, (T*)nullptr);
  if (miss) {            // the full column: K1's step and the start layer
    auto full = [&](const T* p, int, T* hv_, T& wv_, T*) {
      return eval_streamline(s, s.row, p, hv_, wv_);
    };
    ok = rk_step(p0, dt, euler, 0, full, np_, hv, wv, (T*)nullptr);
    layer = start_layer(s, p0, false);
  }
  for (int c = 0; c < 3; ++c) {
    new_pos[3 * (int64_t)i + c] = np_[c];
    hvel[3 * (int64_t)i + c] = hv[c];
  }
  wvel[i] = wv;
  ok_out[i] = ok;
  layer_out[i] = layer < 1 ? 1 : (layer > L - 1 ? L - 1 : layer);
  miss_out[i] = miss;
}

template <typename T>
__global__ void __launch_bounds__(128)
window_pathline_kernel(const T* __restrict__ pos,
                       const T* __restrict__ depth_neg,
                       const int32_t* __restrict__ nv_in,
                       const int32_t* __restrict__ vids,
                       const int32_t* __restrict__ s_in,
                       const T* __restrict__ table_f,
                       const T* __restrict__ table_b, int n, int K, int F,
                       int L, int W, int n_attrs, T dt, T a1, T a2, T a4,
                       int euler, T* __restrict__ new_pos,
                       T* __restrict__ hvel, T* __restrict__ wvel,
                       bool* __restrict__ ok_out,
                       int32_t* __restrict__ layer_out,
                       bool* __restrict__ miss_out, T* __restrict__ attr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Particle<T> s;
  const T* row_b[K_MAX];
  load_cell(s, i, nv_in, vids, K, F, L, depth_neg, table_f, table_b, row_b);
  Window<T> win;
  win.s = clamp_start(s_in[i], L, W);
  win.W = W;
  win.L = L;
  const T p0[3] = {pos[3 * (int64_t)i], pos[3 * (int64_t)i + 1],
                   pos[3 * (int64_t)i + 2]};
  int layer = 1;
  bool miss = false;
  auto eval = [&](const T* p, int stage, T* hv, T& wv, T* at) {
    const T a = stage == 0 ? a1 : (stage == 3 ? a4 : a2);
    int lay;
    bool m;
    const bool ok = eval_pathline_w(s, win, row_b, n_attrs, p, a, hv, wv, at,
                                    lay, m);
    if (stage == 0) layer = lay;
    miss = miss || m;
    return ok;
  };
  T hv[3], wv, np_[3], at[A_MAX];
  bool ok = rk_step(p0, dt, euler, n_attrs, eval, np_, hv, wv, at);
  if (miss) {            // the full columns: K2's step and the start layer
    auto full = [&](const T* p, int stage, T* hv_, T& wv_, T* at_) {
      const T a = stage == 0 ? a1 : (stage == 3 ? a4 : a2);
      return eval_pathline(s, s.row, row_b, n_attrs, p, a, hv_, wv_, at_);
    };
    ok = rk_step(p0, dt, euler, n_attrs, full, np_, hv, wv, at);
    layer = start_layer(s, p0, true);
  }
  for (int c = 0; c < 3; ++c) {
    new_pos[3 * (int64_t)i + c] = np_[c];
    hvel[3 * (int64_t)i + c] = hv[c];
  }
  wvel[i] = wv;
  ok_out[i] = ok;
  layer_out[i] = layer < 1 ? 1 : (layer > L - 1 ? L - 1 : layer);
  miss_out[i] = miss;
  if (attr != nullptr) {                // slots >= n_attrs are zero
    attr[3 * (int64_t)i] = n_attrs > 0 ? at[0] : T(0);
    attr[3 * (int64_t)i + 1] = n_attrs > 1 ? at[1] : T(0);
    attr[3 * (int64_t)i + 2] = T(0);
  }
}

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename T>
int launch_streamline(const T* pos, const T* depth_neg, const int32_t* nv,
                      const int32_t* vids, const T* table, int n, int K, int F,
                      int L, T dt, int euler, T* new_pos, T* hvel, T* wvel,
                      bool* ok, void* stream) {
  if (n > 0)
    streamline_step_kernel<T><<<blocks_for(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        pos, depth_neg, nv, vids, table, n, K, F, L, dt, euler, new_pos, hvel,
        wvel, ok);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pathline(const T* pos, const T* depth_neg, const int32_t* nv,
                    const int32_t* vids, const T* table_f, const T* table_b,
                    int n, int K, int F, int L, int n_attrs, T dt, T a1, T a2,
                    T a4, int euler, T* new_pos, T* hvel, T* wvel, bool* ok,
                    T* attr, void* stream) {
  if (n_attrs < 0 || n_attrs > A_MAX) return (int)cudaErrorInvalidValue;
  if (n > 0)
    pathline_step_kernel<T><<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
        pos, depth_neg, nv, vids, table_f, table_b, n, K, F, L, n_attrs, dt,
        a1, a2, a4, euler, new_pos, hvel, wvel, ok, attr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_window_streamline(const T* pos, const T* depth_neg,
                             const int32_t* nv, const int32_t* vids,
                             const int32_t* s, const T* table, int n, int K,
                             int F, int L, int W, T dt, int euler, T* new_pos,
                             T* hvel, T* wvel, bool* ok, int32_t* layer,
                             bool* miss, void* stream) {
  if (W < 2 || W > W_MAX || W > L) return (int)cudaErrorInvalidValue;
  if (n > 0)
    window_streamline_kernel<T><<<blocks_for(n), kThreads, 0,
                                  (cudaStream_t)stream>>>(
        pos, depth_neg, nv, vids, s, table, n, K, F, L, W, dt, euler, new_pos,
        hvel, wvel, ok, layer, miss);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_window_pathline(const T* pos, const T* depth_neg,
                           const int32_t* nv, const int32_t* vids,
                           const int32_t* s, const T* table_f,
                           const T* table_b, int n, int K, int F, int L,
                           int W, int n_attrs, T dt, T a1, T a2, T a4,
                           int euler, T* new_pos, T* hvel, T* wvel, bool* ok,
                           int32_t* layer, bool* miss, T* attr,
                           void* stream) {
  if (W < 2 || W > W_MAX || W > L) return (int)cudaErrorInvalidValue;
  if (n_attrs < 0 || n_attrs > A_MAX) return (int)cudaErrorInvalidValue;
  if (n > 0)
    window_pathline_kernel<T><<<blocks_for(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        pos, depth_neg, nv, vids, s, table_f, table_b, n, K, F, L, W, n_attrs,
        dt, a1, a2, a4, euler, new_pos, hvel, wvel, ok, layer, miss, attr);
  return (int)cudaGetLastError();
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

int streamline_step_f32(const float* pos, const float* depth_neg,
                        const int32_t* nv, const int32_t* vids,
                        const float* table, int n, int K, int F, int L,
                        float dt, int euler, float* new_pos, float* hvel,
                        float* wvel, bool* ok, void* stream) {
  return launch_streamline<float>(pos, depth_neg, nv, vids, table, n, K, F, L,
                                  dt, euler, new_pos, hvel, wvel, ok, stream);
}
#endif

#if STAGE_HAS(2)
int streamline_step_f64(const double* pos, const double* depth_neg,
                        const int32_t* nv, const int32_t* vids,
                        const double* table, int n, int K, int F, int L,
                        double dt, int euler, double* new_pos, double* hvel,
                        double* wvel, bool* ok, void* stream) {
  return launch_streamline<double>(pos, depth_neg, nv, vids, table, n, K, F, L,
                                   dt, euler, new_pos, hvel, wvel, ok, stream);
}
#endif

#if STAGE_HAS(3)
int pathline_step_f32(const float* pos, const float* depth_neg,
                      const int32_t* nv, const int32_t* vids,
                      const float* table_f, const float* table_b, int n, int K,
                      int F, int L, int n_attrs, float dt, float a1, float a2,
                      float a4, int euler, float* new_pos, float* hvel,
                      float* wvel, bool* ok, float* attr, void* stream) {
  return launch_pathline<float>(pos, depth_neg, nv, vids, table_f, table_b, n,
                                K, F, L, n_attrs, dt, a1, a2, a4, euler,
                                new_pos, hvel, wvel, ok, attr, stream);
}
#endif

#if STAGE_HAS(4)
int pathline_step_f64(const double* pos, const double* depth_neg,
                      const int32_t* nv, const int32_t* vids,
                      const double* table_f, const double* table_b, int n,
                      int K, int F, int L, int n_attrs, double dt, double a1,
                      double a2, double a4, int euler, double* new_pos,
                      double* hvel, double* wvel, bool* ok, double* attr,
                      void* stream) {
  return launch_pathline<double>(pos, depth_neg, nv, vids, table_f, table_b, n,
                                 K, F, L, n_attrs, dt, a1, a2, a4, euler,
                                 new_pos, hvel, wvel, ok, attr, stream);
}
#endif

#define WINDOW_STREAMLINE_ENTRY(T, tag)                                        \
  int window_streamline_step_##tag(                                            \
      const T* pos, const T* depth_neg, const int32_t* nv,                     \
      const int32_t* vids, const int32_t* s, const T* table, int n, int K,     \
      int F, int L, int W, T dt, int euler, T* new_pos, T* hvel, T* wvel,      \
      bool* ok, int32_t* layer, bool* miss, void* stream) {                    \
    return launch_window_streamline<T>(pos, depth_neg, nv, vids, s, table, n,  \
                                       K, F, L, W, dt, euler, new_pos, hvel,   \
                                       wvel, ok, layer, miss, stream);         \
  }

#define WINDOW_PATHLINE_ENTRY(T, tag)                                          \
  int window_pathline_step_##tag(                                              \
      const T* pos, const T* depth_neg, const int32_t* nv,                     \
      const int32_t* vids, const int32_t* s, const T* table_f,                 \
      const T* table_b, int n, int K, int F, int L, int W, int n_attrs, T dt,  \
      T a1, T a2, T a4, int euler, T* new_pos, T* hvel, T* wvel, bool* ok,     \
      int32_t* layer, bool* miss, T* attr, void* stream) {                     \
    return launch_window_pathline<T>(pos, depth_neg, nv, vids, s, table_f,     \
                                     table_b, n, K, F, L, W, n_attrs, dt, a1,  \
                                     a2, a4, euler, new_pos, hvel, wvel, ok,   \
                                     layer, miss, attr, stream);               \
  }

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
