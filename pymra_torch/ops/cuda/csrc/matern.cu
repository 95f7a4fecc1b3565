// The Matern covariance of general smoothness nu and its pullback in the
// length scale and the variance, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package evaluates the general-nu Matern
// (pymra_tpu/ops/special.py::matern_general, kv_frac) as elementwise XLA
// arithmetic that its compiler fuses. The port's plain twin,
// pymra_torch/ops/special.py::kv_frac and matern_general, is the same
// arithmetic as ~1,700 PyTorch launches a covariance call, each over the
// whole [C, ..., p, q] block and each saving a tensor of that size under
// autograd: at the N = 10^6 tree (16,384 leaves of 64 against 56 ancestor
// knots, four parameter sets, ~503 M entries a call) that does not fit in
// the card's 80 GB. For the points a [B, p, dim] and b [B, q, dim] shared
// by C parameter sets (or a distance block d [B, p, q]) and l, sig [C] it
// writes
//
//   out[c, e] = sig_c 2^(1-nu) / Gamma(nu) s^nu K_nu(s),
//   s = sqrt(2 nu) d_e / l_c,
//
// with out = sig_c where s <= 0 (d = 0), and its backward the sums over the
// entries of the cotangent g times
//
//   d out / d l   = sig_c 2^(1-nu) / Gamma(nu) s^(nu+1) K_(nu-1)(s) / l_c,
//   d out / d sig = out / sig_c,
//
// from d/ds [s^nu K_nu(s)] = -s^nu K_(nu-1)(s) and ds/dl = -s / l. The
// backward recomputes every entry from the points instead of reading a
// saved tensor: nothing of the size of the output outlives the forward.
//
// The distance is the twin's on the card, bit for bit: each coordinate's
// difference squared and summed in order, in the points' type, rounded
// at each step (__f*_rn / __d*_rn: no contraction), then the correctly
// rounded square root; it is taken once per entry for all C sets. The
// Bessel pair s^nu (K_nu(s), K_(nu-1)(s)) is then evaluated in float64 and
// the result rounded once to the output's type.
//
// The pair comes from a table of the exponentially scaled functions
//
//   E0(x) = e^x x^nu K_nu(x),   E1(x) = e^x x^nu K_(nu-1)(x),
//
// built once per nu on the host (matern_table, pymra_matern_table; the
// wrapper caches it by nu and device and uploads it once): 4 sub-intervals
// of equal width in each octave from x_lo = 2^-12 to x_hi = 2^10, on each
// the degree-9 polynomial in t in [-1, 1] that interpolates the function
// at the 10 Chebyshev nodes, stored as its monomial coefficients (880
// doubles a function, 14,080 bytes both). Each interval is analytic (the
// pair's only singularity is the branch point at 0, the non-analytic
// x^(2 nu) included), and at a fixed ratio of width to distance from 0
// the interpolant's relative error is the same in every octave:
// build_table checks it at 20 points an interval against the evaluator
// and keeps the table only at <= 1e-10 relative (it reads <= 5e-13 at nu
// from 0.05 to 10 and refuses nu above ~12, where the kernels take the
// series and CF2 everywhere; the host test holds the lookup to scipy at
// 1e-10). A lookup is integer work on x's bits (the exponent picks the
// octave, the top two mantissa bits the interval, the rest are t
// exactly), 9 float64 FMAs a function in Horner's form and one float64
// e^-x: the same short straight line for every lane of a warp. Where the
// table does not cover x (below x_lo, at or above x_hi, NaN or inf; or no
// table for this nu), the pair is evaluated as before the table, which
// also builds the table:
// Temme's series for x <= 2 and Steed's continued fraction CF2 above
// (Numerical Recipes ch. 6.7, bessik), each stopped when its term falls
// below eps of its sum (1e-10 in the kernel, 1e-17 for the table; at most
// 32 and 64 steps), for the pair (K_mu, K_(mu+1)) at the fractional order
// |mu| <= 1/2, lifted by the upward recurrence K_(m+1) = K_(m-1) + (2 m /
// s) K_m. The order is chosen so that K_nu and K_(nu-1) are both members
// of that chain, never a difference of them: mu = nu - n, n = floor(nu +
// 1/2) >= 1, for nu >= 1/2 (n - 1 steps end at (K_(nu-1), K_nu)); mu =
// -nu for nu < 1/2, where (K_mu, K_(mu+1)) = (K_nu, K_(1-nu)) = (K_nu,
// K_(nu-1)). (The twin lifts from mu in [0, 1) and takes the upward
// recurrence for nu >= 1.) A NaN distance or parameter gives NaN, and a
// huge s underflows to 0 through e^-s, as in the twin. The forward counts
// the entries times sets with s > 0 that the table did not cover where the
// caller passes a counter (one atomic add a block). Built without
// fast-math.
//
// What bounds it on the card: at grid1m's tree under 4 sets (~503 M
// entries a call) it writes ~2 GB (0.6 ms at 3.35 TB/s), and each entry
// and set costs a few dozen float64 operations (the lookup, one
// exponential, in the forward the division by l): float64 arithmetic, not
// bytes. The table sits in shared memory, copied by every block (the
// forward's grid is one wave of resident blocks looping over the entries):
// the lanes of a warp read different intervals, which __constant__ memory
// would serialise. At that shape (4 x 16384 x 64 x 120) on an NVIDIA H100
// 80GB HBM3 at 700 W the forward takes 4.1 ms and the pullback 5.5 ms,
// 15% and 11% of the bytes bound. The series and CF2 per entry took 26.2
// and 24.4 ms (2.3-2.5%): 5 to 32 float64 steps an entry, up to 48
// divisions among them, the regime and the step count varying between the
// lanes of a warp (55.6 and 110.6 ms in their first version, with
// divisions and pow). One thread per entry (b, i, j), consecutive threads
// along j so that the stores coalesce, a grid-stride loop; the forward
// loops over the sets, the backward takes one set a block row (the
// distance again per set: a few float32 operations beside the lookup's;
// the set's divisions once a thread), keeps two float64 sums a thread and
// reduces them within its block (warp shuffles, then shared memory) to one
// partial sum per block, which the host adds up: no atomics, the same sums
// on every run.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr double kEps = 1e-10;  // the kernels' stop outside the table
constexpr double kBuildEps = 1e-17;  // the same for the table's values
constexpr int kSeriesSteps = 32, kCf2Steps = 64;

// The table: kOctaves octaves from 2^kOctaveLo, 2^kSubBits intervals of
// equal width each, kCoefs monomial coefficients in t an interval; E0's
// block of kFuncSize doubles, then E1's.
constexpr int kOctaveLo = -12, kOctaves = 22, kSubBits = 2;
constexpr int kDegree = 9, kCoefs = kDegree + 1;
constexpr int kIntervals = kOctaves << kSubBits;
constexpr int kFuncSize = kIntervals * kCoefs;
constexpr int kTableSize = 2 * kFuncSize;
constexpr double kTableTol = 1e-10;  // build_table keeps a table this close

// The order-dependent constants, computed once on the host.
struct Order {
  double nu, mu, gam1, gam2, gampl, gammi, fact, coef, root2nu;
  int steps;  // upward recurrence steps from (K_mu, K_(mu+1))
  int swap;   // nu < 1/2: (K_mu, K_(mu+1)) is (K_nu, K_(nu-1))
  // Temme's step i: 1/i, 1/(i^2 - mu^2), 1/(i - mu), 1/(i + mu)
  double inv_i[kSeriesSteps + 1], inv_ff[kSeriesSteps + 1],
      inv_p[kSeriesSteps + 1], inv_q[kSeriesSteps + 1];
  // CF2's step i: a_i = -(1/4 - mu^2) - i (i - 1), 1/a_i, -a_i / i
  double cf_a[kCf2Steps + 1], cf_inv_a[kCf2Steps + 1],
      cf_c[kCf2Steps + 1];
};

Order order_of(double nu) {
  Order o;
  o.nu = nu;
  int n;
  if (nu < 0.5) {
    o.mu = -nu;
    n = 1;
    o.swap = 1;
  } else {
    n = (int)floor(nu + 0.5);
    o.mu = nu - n;
    o.swap = 0;
  }
  o.steps = o.swap ? 0 : n - 1;
  const double mu = o.mu;
  o.gampl = tgamma(1.0 + mu);
  o.gammi = tgamma(1.0 - mu);
  // (1/Gamma(1-mu) - 1/Gamma(1+mu)) / (2 mu), -euler_gamma at mu = 0
  o.gam1 = fabs(mu) < 1e-12 ? -0.5772156649015329
                            : (1.0 / o.gammi - 1.0 / o.gampl) / (2.0 * mu);
  o.gam2 = (1.0 / o.gammi + 1.0 / o.gampl) / 2.0;
  const double pimu = M_PI * mu;
  o.fact = fabs(pimu) < 1e-12 ? 1.0 : pimu / sin(pimu);
  o.coef = pow(2.0, 1.0 - nu) / tgamma(nu);
  o.root2nu = sqrt(2.0 * nu);
  for (int i = 1; i <= kSeriesSteps; ++i) {
    o.inv_i[i] = 1.0 / i;
    o.inv_ff[i] = 1.0 / ((double)i * i - mu * mu);
    o.inv_p[i] = 1.0 / (i - mu);
    o.inv_q[i] = 1.0 / (i + mu);
  }
  const double a1 = 0.25 - mu * mu;
  for (int i = 2; i <= kCf2Steps; ++i) {
    o.cf_a[i] = -a1 - (double)i * (i - 1);
    o.cf_inv_a[i] = 1.0 / o.cf_a[i];
    o.cf_c[i] = -o.cf_a[i] / i;
  }
  return o;
}

// sinh(e) / e: its series below 0.1 (where (e^e - e^-e) / 2 cancels),
// the difference above
__host__ __device__ __forceinline__ double sinhc(double e, double ee,
                                                 double einv) {
  if (fabs(e) < 0.1) {
    const double e2 = e * e;
    return 1.0 + e2 * (1.0 / 6 + e2 * (1.0 / 120 + e2 * (1.0 / 5040 +
                                                        e2 / 362880)));
  }
  return 0.5 * (ee - einv) / e;
}

// Temme's series for x^nu (K_mu, K_(mu+1)), 0 < x <= 2, |mu| <= 1/2;
// times e^x where scaled.
__host__ __device__ __forceinline__ void temme(double x, const Order& o,
                                               double eps, bool scaled,
                                               double& k0, double& k1) {
  const double mu = o.mu;
  const double lx = log(0.5 * x), d = -lx, e = mu * d;
  const double ee = exp(e), einv = 1.0 / ee;
  double ff = o.fact * (o.gam1 * 0.5 * (ee + einv)
                        + o.gam2 * sinhc(e, ee, einv) * d);
  double p = 0.5 * ee * o.gampl, q = 0.5 * einv * o.gammi;
  double c = 1.0, sum = ff, sum1 = p;
  const double dd = 0.25 * x * x;
  for (int i = 1; i <= kSeriesSteps; ++i) {
    const double fi = (double)i;
    ff = (fi * ff + p + q) * o.inv_ff[i];
    c *= dd * o.inv_i[i];
    p *= o.inv_p[i];
    q *= o.inv_q[i];
    const double del = c * ff;
    sum += del;
    sum1 += c * (p - fi * ff);
    if (fabs(del) < eps * fabs(sum)) break;
  }
  const double xnu = exp(o.nu * (lx + M_LN2) + (scaled ? x : 0.0));
  k0 = xnu * sum;
  k1 = xnu * sum1 * 2.0 / x;
}

// Steed's CF2 for x^nu (K_mu, K_(mu+1)), x > 2, |mu| <= 1/2; times e^x
// where scaled.
__host__ __device__ __forceinline__ void steed(double x, const Order& o,
                                               double eps, bool scaled,
                                               double& k0, double& k1) {
  const double mu = o.mu, a1 = 0.25 - mu * mu;
  double b = 2.0 * (1.0 + x), d = 1.0 / b, h = d, delh = d;
  double q1 = 0.0, q2 = 1.0, q = a1, c = a1;
  double s = 1.0 + q * delh;
  for (int i = 2; i <= kCf2Steps; ++i) {
    const double a = o.cf_a[i];
    c *= o.cf_c[i];
    const double qnew = (q1 - b * q2) * o.cf_inv_a[i];
    q1 = q2;
    q2 = qnew;
    q += c * qnew;
    b += 2.0;
    d = 1.0 / (b + a * d);
    delh = (b * d - 1.0) * delh;
    h += delh;
    const double dels = q * delh;
    s += dels;
    if (fabs(dels) < eps * fabs(s)) break;
  }
  // x^nu e^-x in one exponential: no underflow before the product does
  k0 = exp(scaled ? o.nu * log(x) : o.nu * log(x) - x) *
       sqrt(M_PI / (2.0 * x)) / s;
  k1 = k0 * (mu + x + 0.5 - a1 * h) / x;
}

// x^nu (K_nu(x), K_(nu-1)(x)) for x > 0 (NaN for a NaN x) by the series
// or CF2, stopped at eps; times e^x where scaled.
__host__ __device__ __forceinline__ void bessel_pair(double x,
                                                     const Order& o,
                                                     double eps, bool scaled,
                                                     double& knu,
                                                     double& knm1) {
  double k0, k1;
  if (x <= 2.0)
    temme(x, o, eps, scaled, k0, k1);
  else
    steed(x, o, eps, scaled, k0, k1);
  if (o.swap) {
    knu = k0;
    knm1 = k1;
    return;
  }
  const double xinv = 2.0 / x;
  double m = o.mu + 1.0;
  for (int i = 0; i < o.steps; ++i) {
    const double k2 = k0 + m * xinv * k1;
    k0 = k1;
    k1 = k2;
    m += 1.0;
  }
  knu = k1;
  knm1 = k0;
}

__host__ __device__ __forceinline__ unsigned long long bits_of(double x) {
#if defined(__CUDA_ARCH__)
  return (unsigned long long)__double_as_longlong(x);
#else
  unsigned long long b;
  memcpy(&b, &x, sizeof b);
  return b;
#endif
}

// The table's interval of x > 0 and x's place t in [-1, 1] there, from
// x's bits alone (t exact); false where x lies outside [x_lo, x_hi): 0,
// subnormal, NaN and inf included.
__host__ __device__ __forceinline__ bool locate(double x, int& idx,
                                                double& t) {
  const unsigned long long bits = bits_of(x);
  const unsigned octave = (unsigned)((int)(bits >> 52) - 1023 - kOctaveLo);
  if (octave >= (unsigned)kOctaves) return false;
  constexpr int kRest = 52 - kSubBits;  // mantissa bits below the interval's
  idx = (int)(octave << kSubBits) |
        (int)((bits >> kRest) & ((1u << kSubBits) - 1));
  const double r = (double)(bits & ((1ull << kRest) - 1));
  t = fma(r, 1.0 / (double)(1ull << (kRest - 1)), -1.0);
  return true;
}

__host__ __device__ __forceinline__ double horner(const double* c,
                                                  double t) {
  double v = c[kDegree];
#pragma unroll
  for (int j = kDegree - 1; j >= 0; --j) v = fma(v, t, c[j]);
  return v;
}

// x^nu (K_nu(x), K_(nu-1)(x)) for x > 0 (NaN for a NaN x): the table tab
// (E0's block, and E1's after it where with_m1; null: none) where it
// covers x, else the series or CF2. knm1 is E1's only where with_m1 (the
// series' and CF2's always). Returns whether the table covered x.
template <bool with_m1>
__host__ __device__ __forceinline__ bool pair_at(double x, const double* tab,
                                                 const Order& o, double& knu,
                                                 double& knm1) {
  int idx;
  double t;
  if (tab != nullptr && locate(x, idx, t)) {
    const double ex = exp(-x);
    knu = horner(tab + idx * kCoefs, t) * ex;
    if (with_m1) knm1 = horner(tab + kFuncSize + idx * kCoefs, t) * ex;
    return true;
  }
  bessel_pair(x, o, kEps, false, knu, knm1);
  return false;
}

// Fills table[kTableSize] for the order o: at each interval the degree
// kDegree interpolant at the Chebyshev nodes of the scaled pair from the
// series or CF2 (stopped at kBuildEps), as monomial coefficients in t.
// Returns the largest relative error it finds at 2 kCoefs points an
// interval (its ends among them) against the same evaluator.
double build_table(const Order& o, double* table) {
  double tnode[kCoefs], cheb[kCoefs][kCoefs];  // T_j(t_i)
  for (int i = 0; i < kCoefs; ++i) {
    tnode[i] = cos(M_PI * (i + 0.5) / kCoefs);
    for (int j = 0; j < kCoefs; ++j)
      cheb[i][j] = cos(M_PI * j * (i + 0.5) / kCoefs);
  }
  // mono[j][k]: T_j's coefficient of t^k
  double mono[kCoefs][kCoefs] = {};
  mono[0][0] = 1.0;
  mono[1][1] = 1.0;
  for (int j = 2; j < kCoefs; ++j)
    for (int k = 0; k < kCoefs; ++k)
      mono[j][k] = (k ? 2.0 * mono[j - 1][k - 1] : 0.0) - mono[j - 2][k];
  double worst = 0.0;
  for (int idx = 0; idx < kIntervals; ++idx) {
    const double unit = ldexp(1.0, kOctaveLo + (idx >> kSubBits));
    const double w = ldexp(unit, -kSubBits);
    const double lo = unit + (idx & ((1 << kSubBits) - 1)) * w;
    double val[2][kCoefs];
    for (int i = 0; i < kCoefs; ++i)
      bessel_pair(lo + 0.5 * (tnode[i] + 1.0) * w, o, kBuildEps, true,
                  val[0][i], val[1][i]);
    for (int f = 0; f < 2; ++f) {
      double* out = table + f * kFuncSize + idx * kCoefs;
      for (int k = 0; k < kCoefs; ++k) out[k] = 0.0;
      for (int j = 0; j < kCoefs; ++j) {
        double c = 0.0;
        for (int i = 0; i < kCoefs; ++i) c += val[f][i] * cheb[i][j];
        c *= (j ? 2.0 : 1.0) / kCoefs;
        for (int k = 0; k <= j; ++k) out[k] += c * mono[j][k];
      }
    }
    for (int i = 0; i < 2 * kCoefs; ++i) {
      const double t = -1.0 + 2.0 * i / (2 * kCoefs - 1);
      double want[2];
      bessel_pair(lo + 0.5 * (t + 1.0) * w, o, kBuildEps, true, want[0],
                  want[1]);
      for (int f = 0; f < 2; ++f) {
        const double got = horner(table + f * kFuncSize + idx * kCoefs, t);
        const double err = fabs(got - want[f]) / fabs(want[f]);
        worst = err > worst || err != err ? err : worst;
      }
    }
  }
  return worst;
}

// the rounded operations of the points' type, without contraction
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// Entry e = (row, j), row = bb p + i, of the [B, p, q] block: the twin's
// distance between a[bb, i] and b[bb, j], or dist[e].
template <typename T>
__device__ __forceinline__ double distance(const T* a, const T* b,
                                           const T* dist, long long e, int p,
                                           int q, int dim) {
  if (dist != nullptr) return (double)dist[e];
  const long long row = e / q;
  const long long bb = row / p;
  const T* u = a + row * dim;
  const T* v = b + (bb * q + e % q) * dim;
  T acc = 0;
  for (int k = 0; k < dim; ++k) {
    const T diff = sub_rn(u[k], v[k]);
    const T sq = mul_rn(diff, diff);
    acc = k ? add_rn(acc, sq) : sq;
  }
  return (double)sqrt_rn(acc);
}

// Writes the entry's value for every set; returns how many of its sets had
// x > 0 outside the table (NaN not counted).
template <typename T>
__device__ __forceinline__ int forward_entry(const T* a, const T* b,
                                             const T* dist, const T* l,
                                             const T* sig, T* out,
                                             const double* tab,
                                             const Order& o, int sets,
                                             long long pairs, long long e,
                                             int p, int q, int dim) {
  const double d = distance(a, b, dist, e, p, q, dim);
  int missed = 0;
#pragma unroll 1
  for (int c = 0; c < sets; ++c) {
    const double x = o.root2nu * d / (double)l[c];
    double unit = 1.0;  // out / sig: 1 where x <= 0, NaN where x is
    if (!(x <= 0.0)) {
      double knu, knm1;
      const bool covered = pair_at<false>(x, tab, o, knu, knm1);
      missed += !covered && x > 0.0;
      unit = o.coef * knu;
    }
    out[(size_t)c * pairs + e] = (T)((double)sig[c] * unit);
  }
  return missed;
}

// A set's constants of the pullback: x = scale d, and d out / d l =
// dl x^(nu+1) K_(nu-1)(x)
struct SetTerms {
  double scale, dl;
};

template <typename T>
__host__ __device__ __forceinline__ SetTerms set_terms(const T* l,
                                                      const T* sig,
                                                      const Order& o, int c) {
  const double lc = (double)l[c];
  return {o.root2nu / lc, (double)sig[c] * o.coef / lc};
}

// Adds the entry's terms for set c to acc: d/dl over the set's dl (the
// caller multiplies the sum by it), d/dsig. Where x <= 0 the masked value
// has no gradient in l (the twin's neither).
template <typename T>
__device__ __forceinline__ void pullback_entry(const T* a, const T* b,
                                               const T* dist, const T* g,
                                               const double* tab,
                                               const Order& o,
                                               const SetTerms& st, int c,
                                               long long pairs, long long e,
                                               int p, int q, int dim,
                                               double (&acc)[2]) {
  const double x = st.scale * distance(a, b, dist, e, p, q, dim);
  const double gv = (double)g[(size_t)c * pairs + e];
  if (x <= 0.0) {
    acc[1] += gv;
    return;
  }
  double knu, knm1;
  pair_at<true>(x, tab, o, knu, knm1);
  acc[0] += gv * (x * knm1);
  acc[1] += gv * (o.coef * knu);
}

#if defined(__CUDACC__)
// The block's copy of n doubles of the table (null stays null).
__device__ __forceinline__ const double* stage(const double* table,
                                               double* smem, int n) {
  if (table == nullptr) return nullptr;
  for (int i = threadIdx.x; i < n; i += kThreads) smem[i] = table[i];
  __syncthreads();
  return smem;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    matern_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ dist, const T* __restrict__ l,
                  const T* __restrict__ sig, T* __restrict__ out,
                  const double* __restrict__ table,
                  unsigned long long* __restrict__ fallback,
                  const __grid_constant__ Order o, int sets, long long pairs,
                  int p, int q, int dim) {
  __shared__ double tab[kFuncSize];
  __shared__ unsigned long long red[kThreads / 32];
  const double* t = stage(table, tab, kFuncSize);
  unsigned long long missed = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < pairs; e += stride)
    missed += forward_entry(a, b, dist, l, sig, out, t, o, sets, pairs, e,
                            p, q, dim);
  if (fallback == nullptr) return;
  for (int off = 16; off > 0; off /= 2)
    missed += __shfl_down_sync(0xffffffffu, missed, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = missed;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long n = 0;
    for (int w = 0; w < kThreads / 32; ++w) n += red[w];
    if (n) atomicAdd(fallback, n);
  }
}

// partial [2, sets, gridDim.x]: block x's sums of d/dl, then d/dsig, for
// the set blockIdx.y
template <typename T>
__global__ void __launch_bounds__(kThreads)
    matern_pullback_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           const T* __restrict__ dist,
                           const T* __restrict__ l, const T* __restrict__ sig,
                           const T* __restrict__ g,
                           const double* __restrict__ table,
                           double* __restrict__ partial,
                           const __grid_constant__ Order o, int sets,
                           long long pairs, int p, int q, int dim) {
  __shared__ double tab[kTableSize];
  __shared__ double red[kThreads / 32][2];
  const double* t = stage(table, tab, kTableSize);
  const int c = blockIdx.y;
  const SetTerms st = set_terms(l, sig, o, c);
  double acc[2] = {0.0, 0.0};
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < pairs; e += stride)
    pullback_entry(a, b, dist, g, t, o, st, c, pairs, e, p, q, dim, acc);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    double v = acc[k];
    for (int off = 16; off > 0; off /= 2)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    const int k = threadIdx.x;
    double v = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) v += red[w][k];
    partial[((size_t)k * sets + c) * gridDim.x + blockIdx.x] =
        k ? v : v * st.dl;
  }
}
#endif

}  // namespace

// The table of the order nu: with table null, its size in doubles;
// else fills table (capacity doubles) and err[0] with the largest relative
// error build_table found, and returns the size, or 0 where that error is
// above 1e-10 (the kernels then take no table: pass null), or -1 for a nu
// or capacity it does not take.
extern "C" int pymra_matern_table(double nu, void* table, int capacity,
                                  void* err) {
  if (table == nullptr) return kTableSize;
  if (!(nu > 0.0) || capacity < kTableSize) return -1;
  const Order o = order_of(nu);
  const double worst = build_table(o, (double*)table);
  if (err != nullptr) *(double*)err = worst;
  return worst <= kTableTol ? kTableSize : 0;
}

#if defined(__CUDACC__)
namespace {

template <typename T>
int launch_forward(const void* a, const void* b, const void* dist,
                   const void* l, const void* sig, void* out,
                   const void* table, void* fallback, const Order& o,
                   int sets, long long pairs, int p, int q, int dim,
                   int device, cudaStream_t stream) {
  // one wave of resident blocks, each looping over the entries: the
  // table is copied once a block
  static int wave[64][2];
  int& blocks = wave[device & 63][sizeof(T) == 8];
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, matern_kernel<T>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long want = (pairs + kThreads - 1) / kThreads;
  const int grid = (int)(want < blocks ? want : blocks);
  matern_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)a, (const T*)b, (const T*)dist, (const T*)l, (const T*)sig,
      (T*)out, (const double*)table, (unsigned long long*)fallback, o, sets,
      pairs, p, q, dim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pullback(const void* a, const void* b, const void* dist,
                    const void* l, const void* sig, const void* g,
                    const void* table, void* partial, int blocks,
                    const Order& o, int sets, long long pairs, int p, int q,
                    int dim, cudaStream_t stream) {
  const dim3 grid(blocks, sets);
  matern_pullback_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)a, (const T*)b, (const T*)dist, (const T*)l, (const T*)sig,
      (const T*)g, (const double*)table, (double*)partial, o, sets, pairs,
      p, q, dim);
  return (int)cudaGetLastError();
}

bool valid(const void* a, const void* b, const void* dist, double nu,
           int sets, long long pairs, int p, int q, int dim) {
  const bool points = a != nullptr && b != nullptr && dist == nullptr &&
                      p > 0 && q > 0 && dim > 0;
  return (points || (dist != nullptr && a == nullptr && b == nullptr)) &&
         nu > 0.0 && sets > 0 && sets <= 65535 && pairs > 0;
}

}  // namespace

// The covariance out [sets, pairs] (pairs = B p q entries a set) from the
// points a [B, p, dim] and b [B, q, dim], or from dist [B, p, q] (a and b
// null), and l, sig [sets]; float32 throughout, or float64 where f64.
// table: pymra_matern_table's for nu on this device, or null (the series
// and CF2 for every entry); fallback: an int64 the kernel adds the
// entries times sets with s > 0 outside the table to, or null. Launches
// on `stream`; allocates nothing. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int pymra_matern(const void* a, const void* b, const void* dist,
                            const void* l, const void* sig, void* out,
                            const void* table, void* fallback, int f64,
                            double nu, int sets, long long pairs, int p,
                            int q, int dim, int device, void* stream) {
  if (!valid(a, b, dist, nu, sets, pairs, p, q, dim))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Order o = order_of(nu);
  return f64 ? launch_forward<double>(a, b, dist, l, sig, out, table,
                                      fallback, o, sets, pairs, p, q, dim,
                                      device, (cudaStream_t)stream)
             : launch_forward<float>(a, b, dist, l, sig, out, table,
                                     fallback, o, sets, pairs, p, q, dim,
                                     device, (cudaStream_t)stream);
}

// The pullback: partial [2, sets, blocks] float64, block x's sums over its
// entries of g times d out / d l (first) and d out / d sig, g [sets,
// pairs] the cotangent of pymra_matern's out; the caller adds the blocks'
// sums. Same arguments otherwise.
extern "C" int pymra_matern_pullback(const void* a, const void* b,
                                     const void* dist, const void* l,
                                     const void* sig, const void* g,
                                     const void* table, void* partial,
                                     int blocks, int f64, double nu,
                                     int sets, long long pairs, int p, int q,
                                     int dim, int device, void* stream) {
  if (!valid(a, b, dist, nu, sets, pairs, p, q, dim) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Order o = order_of(nu);
  return f64 ? launch_pullback<double>(a, b, dist, l, sig, g, table,
                                       partial, blocks, o, sets, pairs, p, q,
                                       dim, (cudaStream_t)stream)
             : launch_pullback<float>(a, b, dist, l, sig, g, table, partial,
                                      blocks, o, sets, pairs, p, q, dim,
                                      (cudaStream_t)stream);
}
#endif
