// Native proximal kernels — the framework's host runtime layer.
//
// The reference's only native code is two MEX kernels in the TT-TRPCA
// vendored repo (SURVEY §2.4):
//   * cappedsimplexprojection.cpp — Euclidean projection onto
//     {x : 0 <= x <= 1, sum x = s} by sorted breakpoint search
//   * flsa.c — Fused Lasso Signal Approximator via the dual SFA method
//
// These are fresh implementations of the same mathematical operators with a
// plain C ABI for ctypes: the simplex projection by bisection-refined exact
// breakpoint search, the FLSA by Condat's direct total-variation algorithm
// (L. Condat, "A direct algorithm for 1-D total variation denoising", IEEE
// SPL 2013) followed by soft-thresholding — exact, O(n) typical case.
//
// Build: runtime/build.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Project v (length n) onto {x : 0 <= x <= 1, sum x = s}; writes x.
// Exact: the KKT solution is x = clip(v - tau, 0, 1) where
// phi(tau) = sum clip(v - tau, 0, 1) is piecewise linear and monotone
// decreasing with breakpoints at {v_i} and {v_i - 1}; we locate the segment
// containing s by sorting the 2n breakpoints and interpolating.
void capped_simplex_projection(const double* v, int64_t n, double s, double* x) {
    if (n <= 0) return;
    if (s <= 0.0) {
        std::fill(x, x + n, 0.0);
        return;
    }
    if (s >= static_cast<double>(n)) {
        std::fill(x, x + n, 1.0);
        return;
    }
    std::vector<double> bp;
    bp.reserve(2 * n);
    for (int64_t i = 0; i < n; ++i) {
        bp.push_back(v[i]);
        bp.push_back(v[i] - 1.0);
    }
    std::sort(bp.begin(), bp.end());

    auto phi = [&](double tau) {
        double acc = 0.0;
        for (int64_t i = 0; i < n; ++i) {
            double xi = v[i] - tau;
            if (xi > 1.0) xi = 1.0;
            if (xi < 0.0) xi = 0.0;
            acc += xi;
        }
        return acc;
    };

    // binary search over breakpoints for the segment with phi(bp) >= s
    // (phi decreasing in tau). Between adjacent breakpoints phi is linear.
    int64_t lo = 0, hi = static_cast<int64_t>(bp.size()) - 1;
    // phi(bp[0]) is the max (all clipped to 1 below lowest breakpoint keeps
    // phi <= n); handle boundaries by linear solve on the bracketing segment.
    while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (phi(bp[mid]) >= s) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    // segment is [bp[lo-1], bp[lo]] with phi(bp[lo-1]) >= s > phi(bp[lo])
    double t0 = (lo > 0) ? bp[lo - 1] : bp[0] - 1.0;
    double t1 = bp[lo];
    double p0 = phi(t0), p1 = phi(t1);
    double tau;
    if (p0 == p1) {
        tau = t0;
    } else {
        tau = t0 + (p0 - s) * (t1 - t0) / (p0 - p1);
    }
    for (int64_t i = 0; i < n; ++i) {
        double xi = v[i] - tau;
        if (xi > 1.0) xi = 1.0;
        if (xi < 0.0) xi = 0.0;
        x[i] = xi;
    }
}

// Condat's direct 1-D TV denoising: min_x 0.5||x - y||^2 + lam*TV(x).
static void tv1d_condat(const double* y, int64_t n, double lam, double* x) {
    if (n <= 0) return;
    if (n == 1 || lam <= 0.0) {
        std::copy(y, y + n, x);
        if (lam <= 0.0) return;
    }
    int64_t k = 0, k0 = 0, km = 0, kp = 0;
    double vmin = y[0] - lam, vmax = y[0] + lam;
    double umin = lam, umax = -lam;
    while (true) {
        if (k == n - 1) {
            if (umin < 0.0) {
                do { x[k0++] = vmin; } while (k0 <= km);
                vmin = y[k0];
                umin = lam;
                k = km = k0;
                umax = vmin + umin - vmax;
            } else if (umax > 0.0) {
                do { x[k0++] = vmax; } while (k0 <= kp);
                vmax = y[k0];
                umax = -lam;
                k = kp = k0;
                umin = vmax + umax - vmin;
            } else {
                vmin += umin / (k - k0 + 1);
                do { x[k0++] = vmin; } while (k0 <= k);
                return;
            }
        }
        if (k == n - 1) continue;
        umin += y[k + 1] - vmin;
        if (umin < -lam) {
            do { x[k0++] = vmin; } while (k0 <= km);
            vmin = y[k0];
            umin = lam;
            vmax = vmin + 2.0 * lam;
            umax = -lam;
            k = km = kp = k0;
        } else {
            umax += y[k + 1] - vmax;
            if (umax > lam) {
                do { x[k0++] = vmax; } while (k0 <= kp);
                vmax = y[k0];
                umax = -lam;
                vmin = vmax - 2.0 * lam;
                umin = lam;
                k = km = kp = k0;
            } else {
                ++k;
                if (umin >= lam) {
                    vmin += (umin - lam) / (k - k0 + 1);
                    umin = lam;
                    km = k;
                }
                if (umax <= -lam) {
                    vmax += (umax + lam) / (k - k0 + 1);
                    umax = -lam;
                    kp = k;
                }
            }
        }
    }
}

// FLSA: min_x 0.5||x - v||^2 + lam1||x||_1 + lam2 sum |x[i+1]-x[i]|.
// Classical decomposition: soft-threshold(tv_prox(v, lam2), lam1).
void flsa(const double* v, int64_t n, double lam1, double lam2, double* x) {
    tv1d_condat(v, n, lam2, x);
    for (int64_t i = 0; i < n; ++i) {
        double t = std::fabs(x[i]) - lam1;
        x[i] = (t > 0.0) ? (x[i] > 0.0 ? t : -t) : 0.0;
    }
}

// Batched soft threshold (used by the artifact pipeline for host-side
// post-processing without bouncing through the accelerator).
void soft_threshold(const double* v, int64_t n, double lam, double* x) {
    for (int64_t i = 0; i < n; ++i) {
        double t = std::fabs(v[i]) - lam;
        x[i] = (t > 0.0) ? (v[i] > 0.0 ? t : -t) : 0.0;
    }
}

}  // extern "C"
