// The error locator as the port built it before the one-warp-a-column
// redesign, for one timing run beside the
// kernel of csrc/cyclic_locator.cu (included whole, so the new kernel, its
// dispatch and launcher are the ones the port builds). Built and timed by
// draco_tpu_torch/obs/locator_ab.py, and by chip_smoke.py's locator phase,
// which holds the new kernel to the plain version at least as well as this
// one at n >= 32; nothing of the port launches it.
//
//   old_cyclic_locator_kernel   one thread block of 64 threads a column,
//                               one thread a row, the scalar chain (the
//                               Jacobi solve, the pivot searches, the
//                               sums) on thread 0 in the plain version's
//                               order; verbatim but for its name and its
//                               namespace
//
// draco_ab_locator_old takes draco_cyclic_locator's arguments. The new
// kernel is built here with its phase marks (DRACO_LOCATOR_MARKS): column
// 0's clock64() at each phase boundary, read by draco_ab_locator_marks; a
// second build adds DRACO_LOCATOR_IEEE_ROTATION, the Jacobi rotation on
// IEEE division and square root.

#define DRACO_LOCATOR_MARKS
#include "../csrc/cyclic_locator.cu"

namespace block_locator {

constexpr int kThreads = 64;
constexpr int kMaxN = 64;
constexpr float kTiny = 1e-30f;

// max that propagates NaN, as jnp.max / jnp.maximum (and torch's max and
// clamp) do; fmaxf would return the other operand and drop it
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

struct Layout {
  int n, s, m, M;  // M = 2s
  // float offsets
  int er, ei, pres, energy, mag, devm, e2r, e2i, big, vv, rhs, x, polr, poli;
  int recr, reci, invr, invi, srkr, srki, sikr, siki, fr, fi, eselr, eseli, qr,
      qi, xs;
  int floats;
  // int offsets (after the floats)
  int idx, honest, rank;
  int ints;
  __host__ __device__ Layout(int n_, int s_) : n(n_), s(s_) {
    m = n - 2 * s;
    M = 2 * s;
    int o = 0;
    er = o; o += n; ei = o; o += n; pres = o; o += n; energy = o; o += n;
    mag = o; o += n; devm = o; o += n; xs = o; o += n;
    e2r = o; o += M; e2i = o; o += M;
    big = o; o += M * M; vv = o; o += M * M; rhs = o; o += M; x = o; o += M;
    polr = o; o += s + 1; poli = o; o += s + 1;
    recr = o; o += m * m; reci = o; o += m * m;
    invr = o; o += m * m; invi = o; o += m * m;
    srkr = o; o += m; srki = o; o += m; sikr = o; o += m; siki = o; o += m;
    fr = o; o += m; fi = o; o += m;
    eselr = o; o += m; eseli = o; o += m; qr = o; o += m; qi = o; o += m;
    floats = o;
    int p = 0;
    idx = p; p += m; honest = p; p += n; rank = p; p += n;
    ints = p;
  }
  size_t bytes() const { return (size_t)floats * 4 + (size_t)ints * 4 + 64; }
};

// One-sided Jacobi truncated least squares on the M×M system in shared
// memory (row-major W = big, V = identity), thread 0 only: x = V Σ⁻² Wᵀ b
// over kept singular values. Mirrors the reference's jacobi_lstsq.
__device__ void jacobi_lstsq(float* W, float* V, const float* b, float* x,
                             int M, int sweeps, float rcond2, float lam2,
                             bool use_lam) {
  for (int r = 0; r < M; ++r)
    for (int c = 0; c < M; ++c) V[r * M + c] = (r == c) ? 1.f : 0.f;
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int p = 0; p < M - 1; ++p) {
      for (int q = p + 1; q < M; ++q) {
        float alpha = 0.f, beta = 0.f, gamma = 0.f;
        for (int r = 0; r < M; ++r) {
          const float wp = W[r * M + p], wq = W[r * M + q];
          alpha += wp * wp;
          beta += wq * wq;
          gamma += wp * wq;
        }
        const bool live = fabsf(gamma) > kTiny;
        const float g_safe = live ? gamma : 1.f;
        const float zeta = (beta - alpha) / (2.f * g_safe);
        const float sgn = zeta >= 0.f ? 1.f : -1.f;
        float t = sgn / (fabsf(zeta) + sqrtf(1.f + zeta * zeta));
        t = live ? t : 0.f;
        const float c = 1.f / sqrtf(1.f + t * t);
        const float s = c * t;
        for (int r = 0; r < M; ++r) {
          const float wp = W[r * M + p], wq = W[r * M + q];
          W[r * M + p] = c * wp - s * wq;
          W[r * M + q] = s * wp + c * wq;
          const float vp = V[r * M + p], vq = V[r * M + q];
          V[r * M + p] = c * vp - s * vq;
          V[r * M + q] = s * vp + c * vq;
        }
      }
    }
  }
  float sig2max = -INFINITY;
  float coef[2 * kMaxN];
  float sig2[2 * kMaxN];
  for (int c = 0; c < M; ++c) {
    float a = 0.f;
    for (int r = 0; r < M; ++r) a += W[r * M + c] * W[r * M + c];
    sig2[c] = a;
    sig2max = nan_max(sig2max, a);
  }
  for (int c = 0; c < M; ++c) {
    bool keep = sig2[c] > rcond2 * sig2max;
    if (use_lam) keep = keep && (sig2[c] > lam2);
    float wtb = 0.f;
    for (int r = 0; r < M; ++r) wtb += W[r * M + c] * b[r];
    coef[c] = keep ? wtb / nan_max(sig2[c], kTiny) : 0.f;
  }
  for (int r = 0; r < M; ++r) {
    float a = 0.f;
    for (int c = 0; c < M; ++c) a += V[r * M + c] * coef[c];
    x[r] = a;
  }
}

__global__ void __launch_bounds__(kThreads)
old_cyclic_locator_kernel(const float* __restrict__ e_re_g,
                      const float* __restrict__ e_im_g,
                      const float* __restrict__ c2h_re,
                      const float* __restrict__ c2h_im,
                      const float* __restrict__ c1_re,
                      const float* __restrict__ c1_im,
                      const float* __restrict__ est_re,
                      const float* __restrict__ est_im,
                      const float* __restrict__ pres_g,
                      float* __restrict__ v_re_g, float* __restrict__ v_im_g,
                      uint8_t* __restrict__ honest_g,
                      uint8_t* __restrict__ flagged_g,
                      uint8_t* __restrict__ loud_g,
                      float* __restrict__ resid_g, int n, int s, int sweeps,
                      float rcond2, float lam, float lam2, float gate,
                      float bias_coef, float rel2, float loud_tol,
                      float spread_phi) {
  extern __shared__ float sm[];
  const Layout Y(n, s);
  const int m = Y.m, M = Y.M;
  int* si = reinterpret_cast<int*>(sm + Y.floats);
  float* er = sm + Y.er;
  float* ei = sm + Y.ei;
  float* pres = sm + Y.pres;
  float* energy = sm + Y.energy;
  float* mag = sm + Y.mag;
  int* idx = si + Y.idx;
  int* honest = si + Y.honest;
  int* rank = si + Y.rank;
  __shared__ float s_msq, s_syn, s_scale, s_cb, s_med;
  __shared__ int s_cnt, s_piv;

  const int l = blockIdx.x;
  const int t = threadIdx.x;
  const bool use_lam = lam > 0.f;

  if (t < n) {
    er[t] = e_re_g[(long long)l * n + t];
    ei[t] = e_im_g[(long long)l * n + t];
    pres[t] = pres_g[t];
    energy[t] = er[t] * er[t] + ei[t] * ei[t];
  }
  __syncthreads();
  if (t == 0) {
    float a = 0.f, p = 0.f;
    for (int i = 0; i < n; ++i) { a += energy[i] * pres[i]; p += pres[i]; }
    s_msq = a / nan_max(p, 1.f);
  }
  __syncthreads();
  const float msq = s_msq;

  if (s > 0) {
    // 2. syndrome E2 = C2^H e: two real sums each, then combined
    float* e2r = sm + Y.e2r;
    float* e2i = sm + Y.e2i;
    if (t < M) {
      float rr = 0.f, ii = 0.f, ri = 0.f, ir = 0.f;
      for (int i = 0; i < n; ++i) {
        rr += er[i] * c2h_re[t * n + i];
        ii += ei[i] * c2h_im[t * n + i];
        ri += er[i] * c2h_im[t * n + i];
        ir += ei[i] * c2h_re[t * n + i];
      }
      e2r[t] = rr - ii;
      e2i[t] = ri + ir;
    }
    __syncthreads();
    // 3. Hankel system, normalised, solved on thread 0
    if (t == 0) {
      float mx = 0.f;
      for (int r = 0; r < M; ++r) mx = nan_max(mx, e2r[r] * e2r[r] + e2i[r] * e2i[r]);
      const float syn = sqrtf(nan_max(mx, 0.f));
      const float scale = use_lam ? nan_max(sqrtf(msq), 1e-30f) : syn;
      float* big = sm + Y.big;
      float* rhs = sm + Y.rhs;
      for (int i = 0; i < s; ++i) {
        for (int j = 0; j < s; ++j) {
          const float ar = e2r[s - 1 - i + j], ai = e2i[s - 1 - i + j];
          big[i * M + j] = ar / scale;
          big[i * M + j + s] = -ai / scale;
          big[(i + s) * M + j] = ai / scale;
          big[(i + s) * M + j + s] = ar / scale;
        }
        rhs[i] = e2r[2 * s - 1 - i] / scale;
        rhs[i + s] = e2i[2 * s - 1 - i] / scale;
      }
      float* x = sm + Y.x;
      jacobi_lstsq(big, sm + Y.vv, rhs, x, M, sweeps, rcond2, lam2, use_lam);
      float* polr = sm + Y.polr;
      float* poli = sm + Y.poli;
      for (int j = 0; j < s; ++j) { polr[j] = -x[j]; poli[j] = -x[s + j]; }
      polr[s] = 1.f;
      poli[s] = 0.f;
      s_syn = syn;
      s_scale = scale;
    }
    __syncthreads();
    // 4. locator values on the DFT grid
    if (t < n) {
      const float* polr = sm + Y.polr;
      const float* poli = sm + Y.poli;
      const int S1 = s + 1;
      float a = 0.f, b = 0.f, c = 0.f, d = 0.f;
      for (int j = 0; j < S1; ++j) {
        a += polr[j] * est_re[t * S1 + j];
        b += poli[j] * est_im[t * S1 + j];
        c += polr[j] * est_im[t * S1 + j];
        d += poli[j] * est_re[t * S1 + j];
      }
      const float vr = a - b, vi = c + d;
      float mg = vr * vr + vi * vi;
      if (use_lam && !((s_syn / s_scale) > gate)) mg = 1.f;
      mag[t] = mg;
    }
  } else if (t < n) {
    mag[t] = 1.f;
  }
  __syncthreads();

  // tie-break bias: index, or spread rank on the λ path; absent rows -1
  if (t == 0) {
    float a = 0.f;
    for (int i = 0; i < n; ++i) a += mag[i];
    s_cb = bias_coef * (a / (float)n);
  }
  __syncthreads();
  if (t < n) {
    float bias;
    if (use_lam) {
      float kt = (float)t * spread_phi;
      kt = kt - floorf(kt);
      int r = 0;
      for (int j = 0; j < n; ++j) {
        float kj = (float)j * spread_phi;
        kj = kj - floorf(kj);
        r += kj < kt;
      }
      bias = (float)r;
    } else {
      bias = (float)t;
    }
    const float mg = mag[t] + bias * s_cb;
    mag[t] = pres[t] > 0.f ? mg : -1.f;
  }
  __syncthreads();

  // 5. honest set: pairwise rank, ties to the lower index
  if (t < n) {
    int r = 0;
    for (int j = 0; j < n; ++j)
      r += (mag[j] > mag[t]) || (mag[j] == mag[t] && j < t);
    honest[t] = r < m;
  }
  __syncthreads();
  if (t == 0) {
    int c = 0;
    for (int i = 0; i < n && c < m; ++i)
      if (honest[i]) idx[c++] = i;
    s_cnt = c;
  }
  __syncthreads();
  const int cnt = s_cnt;
  float* recr = sm + Y.recr;
  float* reci = sm + Y.reci;
  float* invr = sm + Y.invr;
  float* invi = sm + Y.invi;
  for (int e = t; e < m * m; e += blockDim.x) {
    const int r = e / m, c = e % m;
    recr[e] = r < cnt ? c1_re[idx[r] * m + c] : 0.f;
    reci[e] = r < cnt ? c1_im[idx[r] * m + c] : 0.f;
    invr[e] = r == c ? 1.f : 0.f;
    invi[e] = 0.f;
  }
  if (t < m) {
    sm[Y.eselr + t] = t < cnt ? er[idx[t]] : 0.f;
    sm[Y.eseli + t] = t < cnt ? ei[idx[t]] : 0.f;
  }
  __syncthreads();

  // one complex Gauss–Jordan inverse of the (m, m) honest-row submatrix
  float* srkr = sm + Y.srkr;
  float* srki = sm + Y.srki;
  float* sikr = sm + Y.sikr;
  float* siki = sm + Y.siki;
  float* fr = sm + Y.fr;
  float* fi = sm + Y.fi;
  for (int k = 0; k < m; ++k) {
    if (t == 0) {
      float mx = -INFINITY;
      for (int r = k; r < m; ++r) {
        const float md = recr[r * m + k] * recr[r * m + k] + reci[r * m + k] * reci[r * m + k];
        mx = nan_max(mx, md);
      }
      // a NaN modulus makes the maximum NaN and no row equal to it: the
      // reference then swaps row k with no row (piv = -1 below)
      int piv = -1;
      for (int r = k; r < m; ++r) {
        const float md = recr[r * m + k] * recr[r * m + k] + reci[r * m + k] * reci[r * m + k];
        if (md == mx) { piv = r; break; }
      }
      s_piv = piv;
    }
    __syncthreads();
    const int piv = s_piv;
    if (t < m && piv != k) {
      // the reference's arithmetic swap: row_k + (row_r − row_k), with a
      // zero row_r when no row was chosen
      float* mats[4] = {recr, reci, invr, invi};
      for (int q = 0; q < 4; ++q) {
        float* T = mats[q];
        const float a = T[k * m + t], b = piv < 0 ? 0.f : T[piv * m + t];
        T[k * m + t] = a + (b - a);
        if (piv >= 0) T[piv * m + t] = b + (a - b);
      }
    }
    __syncthreads();
    if (t < m) {
      const float pr = recr[k * m + k], pi = reci[k * m + k];
      const float pm = nan_max(pr * pr + pi * pi, kTiny);
      const float ipr = pr / pm, ipi = -pi / pm;
      const float rkr = recr[k * m + t], rki = reci[k * m + t];
      const float ikr = invr[k * m + t], iki = invi[k * m + t];
      srkr[t] = rkr * ipr - rki * ipi;
      srki[t] = rkr * ipi + rki * ipr;
      sikr[t] = ikr * ipr - iki * ipi;
      siki[t] = ikr * ipi + iki * ipr;
      fr[t] = t == k ? 0.f : recr[t * m + k];
      fi[t] = t == k ? 0.f : reci[t * m + k];
    }
    __syncthreads();
    for (int e = t; e < m * m; e += blockDim.x) {
      const int r = e / m, c = e % m;
      if (r == k) {
        recr[e] = srkr[c];
        reci[e] = srki[c];
        invr[e] = sikr[c];
        invi[e] = siki[c];
      } else {
        recr[e] = recr[e] - (fr[r] * srkr[c] - fi[r] * srki[c]);
        reci[e] = reci[e] - (fr[r] * srki[c] + fi[r] * srkr[c]);
        invr[e] = invr[e] - (fr[r] * sikr[c] - fi[r] * siki[c]);
        invi[e] = invi[e] - (fr[r] * siki[c] + fi[r] * sikr[c]);
      }
    }
    __syncthreads();
  }

  // v = row 0 of the inverse, scattered to the honest rows
  if (t < n) {
    float vr = 0.f, vi = 0.f;
    for (int r = 0; r < cnt; ++r)
      if (idx[r] == t) { vr = invr[r]; vi = invi[r]; }
    v_re_g[(long long)l * n + t] = vr;
    v_im_g[(long long)l * n + t] = vi;
    honest_g[(long long)l * n + t] = (uint8_t)honest[t];
  }
  // health fit: q̂ = rec⁻¹ e_sel
  float* qr = sm + Y.qr;
  float* qi = sm + Y.qi;
  if (t < m) {
    const float* esr = sm + Y.eselr;
    const float* esi = sm + Y.eseli;
    float a = 0.f, b = 0.f, c = 0.f, d = 0.f;
    for (int j = 0; j < m; ++j) {
      a += invr[t * m + j] * esr[j];
      b += invi[t * m + j] * esi[j];
      c += invr[t * m + j] * esi[j];
      d += invi[t * m + j] * esr[j];
    }
    qr[t] = a - b;
    qi[t] = c + d;
  }
  __syncthreads();
  // codeword = C1 q̂; per-row deviation; flagged rows
  float* devm = sm + Y.devm;
  float* xs = sm + Y.xs;
  if (t < n) {
    float a = 0.f, b = 0.f, c = 0.f, d = 0.f;
    for (int r = 0; r < m; ++r) {
      a += c1_re[t * m + r] * qr[r];
      b += c1_im[t * m + r] * qi[r];
      c += c1_re[t * m + r] * qi[r];
      d += c1_im[t * m + r] * qr[r];
    }
    const float fit_r = a - b, fit_i = c + d;
    const float dr = er[t] - fit_r, di = ei[t] - fit_i;
    const float dev = dr * dr + di * di;
    const bool flag = (dev > rel2 * msq) && (pres[t] > 0.f);
    flagged_g[(long long)l * n + t] = (uint8_t)flag;
    devm[t] = (flag ? 0.f : dev) * pres[t];
    const bool valid = pres[t] > 0.f && !isnan(energy[t]);
    xs[t] = valid ? energy[t] : 0.f;
    rank[t] = valid;  // the median mask, until ranks replace it below
  }
  __syncthreads();
  // masked median of the energies: pairwise ranks among valid rows
  int my_rank = 0;
  if (t < n) {
    for (int j = 0; j < n; ++j)
      my_rank += rank[j] && ((xs[j] < xs[t]) || (xs[j] == xs[t] && j < t));
  }
  __syncthreads();
  if (t < n) honest[t] = rank[t];  // keep the mask; honest already written out
  __syncthreads();
  if (t < n) rank[t] = my_rank;
  __syncthreads();
  if (t == 0) {
    float p = 0.f, a = 0.f, e = 0.f;
    for (int i = 0; i < n; ++i) {
      p += (float)honest[i];
      a += devm[i];
      e += energy[i] * pres[i];
    }
    resid_g[l] = sqrtf(a / nan_max(e, kTiny));
    const float k1 = floorf((p - 1.f) * 0.5f), k2 = floorf(p * 0.5f);
    float h1 = 0.f, h2 = 0.f;
    for (int i = 0; i < n; ++i) {
      if (honest[i] && (float)rank[i] == k1) h1 += xs[i];
      if (honest[i] && (float)rank[i] == k2) h2 += xs[i];
    }
    s_med = p > 0.f ? 0.5f * (h1 + h2) : NAN;
  }
  __syncthreads();
  if (t < n)
    loud_g[(long long)l * n + t] =
        (uint8_t)((energy[t] > loud_tol * s_med) && (pres[t] > 0.f));
}

// dynamic shared bytes of one column's block at (n, s); the launcher and
// the audit share it
inline size_t locator_smem(long long n, long long s) {
  return Layout((int)n, (int)s).bytes();
}

}  // namespace block_locator

extern "C" {

// the phase marks of the last launch of this library's new kernel
int draco_ab_locator_marks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_locator_marks,
                                   sizeof(long long) * kMarks);
}

int draco_ab_locator_old(const float* e_re, const float* e_im,
                         const float* c2h_re, const float* c2h_im,
                         const float* c1_re, const float* c1_im,
                         const float* est_re, const float* est_im,
                         const float* pres, float* v_re, float* v_im,
                         uint8_t* honest, uint8_t* flagged, uint8_t* loud,
                         float* resid, int L, int n, int s, int sweeps,
                         float rcond2, float lam, float lam2, float gate,
                         float bias_coef, float rel2, float loud_tol,
                         float spread_phi, void* stream) {
  if (n < 1 || n > block_locator::kMaxN || s < 0 || n <= 4 * s)
    return (int)cudaErrorInvalidValue;
  if (L < 1) return (int)cudaSuccess;
  const size_t smem = block_locator::locator_smem(n, s);
  if (smem > draco_audit::kDefaultDynamicLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        block_locator::old_cyclic_locator_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  block_locator::old_cyclic_locator_kernel<<<
      L, block_locator::kThreads, smem, (cudaStream_t)stream>>>(
      e_re, e_im, c2h_re, c2h_im, c1_re, c1_im, est_re, est_im, pres, v_re,
      v_im, honest, flagged, loud, resid, n, s, sweeps, rcond2, lam, lam2,
      gate, bias_coef, rel2, loud_tol, spread_phi);
  return (int)cudaGetLastError();
}

}  // extern "C"
