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
// Bessel functions are then evaluated in float64 and the result rounded
// once to the output's type: one regime per entry, Temme's series for
// s <= 2 and Steed's continued fraction CF2 above (Numerical Recipes ch.
// 6.7, bessik), each stopped when its term falls below 1e-10 of its sum
// (at most 32 and 48 steps; CF2 takes 32 at s = 2 and 7 at s = 30), for
// the pair (K_mu, K_(mu+1)) at the fractional
// order |mu| <= 1/2, lifted by the upward recurrence K_(m+1) = K_(m-1) +
// (2 m / s) K_m. The order is chosen so that K_nu and K_(nu-1) are both
// members of that chain, never a difference of them: mu = nu - n, n =
// floor(nu + 1/2) >= 1, for nu >= 1/2 (n - 1 steps end at (K_(nu-1),
// K_nu)); mu = -nu for nu < 1/2, where (K_mu, K_(mu+1)) = (K_nu,
// K_(1-nu)) = (K_nu, K_(nu-1)). (The twin lifts from mu in [0, 1) and
// takes the upward recurrence for nu >= 1.) A NaN distance or parameter
// gives NaN, as in the twin. Built without fast-math.
//
// What bounds it on the card: at grid1m's tree under 4 sets (~503 M
// entries a call) it writes ~2 GB (0.6 ms at 3.35 TB/s) for a series or
// continued fraction of 5 to 32 float64 steps per entry, the regime and
// the step count varying between the lanes of a warp: float64
// arithmetic, not bytes. Design: the steps' divisions by constants of
// the order and the step (1/i, 1/(i^2 - mu^2), 1/(i -+ mu), CF2's 1/a_i
// and -a_i/i) are multiplications by tables the host fills (kernel
// parameters, read alike by a warp's lanes, which step together), so a
// series step has no division and a CF2 step one; cosh and sinh come from one exponential;
// s^nu and e^-s are one exponential of nu log s (- s). One thread per
// entry (b, i, j), consecutive threads along j so that the stores
// coalesce, a grid-stride loop; the forward loops over the sets, the
// backward takes one set a block row (the distance again per set: a few
// float32 operations beside the Bessel's hundreds), keeps two float64
// sums a thread and reduces them within its block (warp shuffles, then
// shared memory) to one partial sum per block, which the host adds up:
// no atomics, the same sums on every run. (The first version, with
// divisions and pow, took 55.6 ms forward and 110.6 ms backward at that
// shape on an NVIDIA H100 80GB HBM3 at 700 W.)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr double kEps = 1e-10;
constexpr int kSeriesSteps = 32, kCf2Steps = 48;

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
__device__ __forceinline__ double sinhc(double e, double ee, double einv) {
  if (fabs(e) < 0.1) {
    const double e2 = e * e;
    return 1.0 + e2 * (1.0 / 6 + e2 * (1.0 / 120 + e2 * (1.0 / 5040 +
                                                        e2 / 362880)));
  }
  return 0.5 * (ee - einv) / e;
}

// Temme's series for x^nu (K_mu, K_(mu+1)), 0 < x <= 2, |mu| <= 1/2.
__device__ __forceinline__ void temme(double x, const Order& o, double& k0,
                                      double& k1) {
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
    if (fabs(del) < kEps * fabs(sum)) break;
  }
  const double xnu = exp(o.nu * (lx + M_LN2));
  k0 = xnu * sum;
  k1 = xnu * sum1 * 2.0 / x;
}

// Steed's CF2 for x^nu (K_mu, K_(mu+1)), x > 2, |mu| <= 1/2.
__device__ __forceinline__ void steed(double x, const Order& o, double& k0,
                                      double& k1) {
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
    if (fabs(dels) < kEps * fabs(s)) break;
  }
  // x^nu e^-x in one exponential: no underflow before the product does
  k0 = exp(o.nu * log(x) - x) * sqrt(M_PI / (2.0 * x)) / s;
  k1 = k0 * (mu + x + 0.5 - a1 * h) / x;
}

// x^nu (K_nu(x), K_(nu-1)(x)) for x > 0 (NaN for a NaN x).
__device__ __forceinline__ void bessel_pair(double x, const Order& o,
                                            double& knu, double& knm1) {
  double k0, k1;
  if (x <= 2.0)
    temme(x, o, k0, k1);
  else
    steed(x, o, k0, k1);
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

// out / sig at scaled distance x: 1 where x <= 0
__device__ __forceinline__ double unit_value(double x, const Order& o) {
  if (x <= 0.0) return 1.0;
  double knu, knm1;
  bessel_pair(x, o, knu, knm1);
  return o.coef * knu;
}

// (d out / d l, d out / d sig) at distance d; false where x <= 0, whose
// masked value has no gradient in l (the twin's neither)
__device__ __forceinline__ bool pullback_terms(double d, double l, double sig,
                                               const Order& o, double& dl,
                                               double& dsig) {
  const double x = o.root2nu * d / l;
  if (x <= 0.0) {
    dl = 0.0;
    dsig = 1.0;
    return false;
  }
  double knu, knm1;
  bessel_pair(x, o, knu, knm1);
  dsig = o.coef * knu;
  dl = sig * o.coef * x * knm1 / l;
  return true;
}

template <typename T>
__device__ __forceinline__ void forward_entry(const T* a, const T* b,
                                              const T* dist, const T* l,
                                              const T* sig, T* out,
                                              const Order& o, int sets,
                                              long long pairs, long long e,
                                              int p, int q, int dim) {
  const double d = distance(a, b, dist, e, p, q, dim);
#pragma unroll 1
  for (int c = 0; c < sets; ++c) {
    const double x = o.root2nu * d / (double)l[c];
    out[(size_t)c * pairs + e] = (T)((double)sig[c] * unit_value(x, o));
  }
}

// Adds the entry's terms for set c to acc: d/dl, d/dsig.
template <typename T>
__device__ __forceinline__ void pullback_entry(const T* a, const T* b,
                                               const T* dist, const T* l,
                                               const T* sig, const T* g,
                                               const Order& o, int c,
                                               long long pairs, long long e,
                                               int p, int q, int dim,
                                               double (&acc)[2]) {
  const double d = distance(a, b, dist, e, p, q, dim);
  double dl, dsig;
  const bool in_l = pullback_terms(d, (double)l[c], (double)sig[c], o, dl,
                                   dsig);
  const double gv = (double)g[(size_t)c * pairs + e];
  if (in_l) acc[0] += gv * dl;
  acc[1] += gv * dsig;
}

#if defined(__CUDACC__)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    matern_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ dist, const T* __restrict__ l,
                  const T* __restrict__ sig, T* __restrict__ out,
                  const __grid_constant__ Order o, int sets, long long pairs,
                  int p, int q, int dim) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < pairs; e += stride)
    forward_entry(a, b, dist, l, sig, out, o, sets, pairs, e, p, q, dim);
}

// partial [2, sets, gridDim.x]: block x's sums of d/dl, then d/dsig, for
// the set blockIdx.y
template <typename T>
__global__ void __launch_bounds__(kThreads)
    matern_pullback_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           const T* __restrict__ dist,
                           const T* __restrict__ l, const T* __restrict__ sig,
                           const T* __restrict__ g,
                           double* __restrict__ partial,
                           const __grid_constant__ Order o, int sets,
                           long long pairs, int p, int q, int dim) {
  __shared__ double red[kThreads / 32][2];
  const int c = blockIdx.y;
  double acc[2] = {0.0, 0.0};
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < pairs; e += stride)
    pullback_entry(a, b, dist, l, sig, g, o, c, pairs, e, p, q, dim, acc);
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
    partial[((size_t)k * sets + c) * gridDim.x + blockIdx.x] = v;
  }
}
#endif

}  // namespace

#if defined(__CUDACC__)
namespace {

template <typename T>
int launch_forward(const void* a, const void* b, const void* dist,
                   const void* l, const void* sig, void* out, const Order& o,
                   int sets, long long pairs, int p, int q, int dim,
                   cudaStream_t stream) {
  const long long want = (pairs + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (1 << 30) ? want : (1 << 30));
  matern_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)a, (const T*)b, (const T*)dist, (const T*)l, (const T*)sig,
      (T*)out, o, sets, pairs, p, q, dim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pullback(const void* a, const void* b, const void* dist,
                    const void* l, const void* sig, const void* g,
                    void* partial, int blocks, const Order& o, int sets,
                    long long pairs, int p, int q, int dim,
                    cudaStream_t stream) {
  const dim3 grid(blocks, sets);
  matern_pullback_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)a, (const T*)b, (const T*)dist, (const T*)l, (const T*)sig,
      (const T*)g, (double*)partial, o, sets, pairs, p, q, dim);
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
// Launches on `stream`; allocates nothing. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int pymra_matern(const void* a, const void* b, const void* dist,
                            const void* l, const void* sig, void* out,
                            int f64, double nu, int sets, long long pairs,
                            int p, int q, int dim, int device, void* stream) {
  if (!valid(a, b, dist, nu, sets, pairs, p, q, dim))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Order o = order_of(nu);
  return f64 ? launch_forward<double>(a, b, dist, l, sig, out, o, sets,
                                      pairs, p, q, dim, (cudaStream_t)stream)
             : launch_forward<float>(a, b, dist, l, sig, out, o, sets, pairs,
                                     p, q, dim, (cudaStream_t)stream);
}

// The pullback: partial [2, sets, blocks] float64, block x's sums over its
// entries of g times d out / d l (first) and d out / d sig, g [sets,
// pairs] the cotangent of pymra_matern's out; the caller adds the blocks'
// sums. Same arguments otherwise.
extern "C" int pymra_matern_pullback(const void* a, const void* b,
                                     const void* dist, const void* l,
                                     const void* sig, const void* g,
                                     void* partial, int blocks, int f64,
                                     double nu, int sets, long long pairs,
                                     int p, int q, int dim, int device,
                                     void* stream) {
  if (!valid(a, b, dist, nu, sets, pairs, p, q, dim) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Order o = order_of(nu);
  return f64 ? launch_pullback<double>(a, b, dist, l, sig, g, partial,
                                       blocks, o, sets, pairs, p, q, dim,
                                       (cudaStream_t)stream)
             : launch_pullback<float>(a, b, dist, l, sig, g, partial, blocks,
                                      o, sets, pairs, p, q, dim,
                                      (cudaStream_t)stream);
}
#endif
