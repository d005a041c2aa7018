// Host-side collocation numerics of pockit_tpu_torch: the JAX package's
// native/colloc.cpp, kept as the port's own copy so that both packages
// take their LGL and LGR nodes from the same C++ (bit for bit, where the
// library builds).
//
// Provides Legendre-Gauss-Lobatto / -Radau / -Legendre nodes & weights and
// barycentric integral-matrix assembly in C++ (upstream pockit's
// equivalents, pockit/lobatto/discretization.py:80-136 and
// radau/discretization.py:89-140, lean on scipy/LAPACK).
//
// Nodes come from the Golub-Welsch eigenvalue method: the Gauss nodes of a
// Jacobi(alpha, beta) weight are the eigenvalues of the symmetric
// tridiagonal Jacobi matrix, computed here with an implicit-shift QL
// iteration (no LAPACK dependency). Weights use the closed-form Legendre
// formulas. Everything is double precision.
//
// Built at first use by pockit_tpu_torch/numerics/native.py with the host
// compiler: $CXX -O3 -fPIC -std=c++17 -Wall -shared (native/Makefile's flags).

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Symmetric tridiagonal eigenvalues (implicit QL with Wilkinson shifts).
// d: diagonal (length n), e: off-diagonal (length n, e[n-1] unused).
// On return d holds the eigenvalues in ascending order.
// ---------------------------------------------------------------------
int tql_eigenvalues(int n, double* d, double* e) {
    if (n <= 1) return 0;
    e[n - 1] = 0.0;
    for (int l = 0; l < n; ++l) {
        int iter = 0;
        int m_idx;
        do {
            for (m_idx = l; m_idx < n - 1; ++m_idx) {
                double dd = std::fabs(d[m_idx]) + std::fabs(d[m_idx + 1]);
                if (std::fabs(e[m_idx]) <= 1e-300 + 1e-16 * dd) break;
            }
            if (m_idx != l) {
                if (++iter > 60) return 1;  // no convergence
                double g = (d[l + 1] - d[l]) / (2.0 * e[l]);
                double r = std::hypot(g, 1.0);
                g = d[m_idx] - d[l] + e[l] / (g + (g >= 0 ? std::fabs(r) : -std::fabs(r)));
                double s = 1.0, c = 1.0, p = 0.0;
                for (int i = m_idx - 1; i >= l; --i) {
                    double f = s * e[i];
                    double b = c * e[i];
                    r = std::hypot(f, g);
                    e[i + 1] = r;
                    if (r == 0.0) {
                        d[i + 1] -= p;
                        e[m_idx] = 0.0;
                        break;
                    }
                    s = f / r;
                    c = g / r;
                    g = d[i + 1] - p;
                    r = (d[i] - g) * s + 2.0 * c * b;
                    p = s * r;
                    d[i + 1] = g + p;
                    g = c * r - b;
                }
                if (r == 0.0 && m_idx - 1 >= l) continue;
                d[l] -= p;
                e[l] = g;
                e[m_idx] = 0.0;
            }
        } while (m_idx != l);
    }
    // insertion sort ascending
    for (int i = 1; i < n; ++i) {
        double key = d[i];
        int j = i - 1;
        while (j >= 0 && d[j] > key) {
            d[j + 1] = d[j];
            --j;
        }
        d[j + 1] = key;
    }
    return 0;
}

// Jacobi(alpha, beta) Gauss nodes of degree n via Golub-Welsch.
int jacobi_gauss_nodes(int n, double alpha, double beta, double* x) {
    if (n <= 0) return 0;
    std::vector<double> d(n), e(n, 0.0);
    double ab = alpha + beta;
    for (int k = 0; k < n; ++k) {
        double denom = (2.0 * k + ab) * (2.0 * k + ab + 2.0);
        d[k] = (denom == 0.0)
                   ? (beta - alpha) / (ab + 2.0 > 0 ? ab + 2.0 : 1.0)
                   : (beta * beta - alpha * alpha) / denom;
        if (k > 0) {
            double num = 4.0 * k * (k + alpha) * (k + beta) * (k + ab);
            double den = (2.0 * k + ab) * (2.0 * k + ab) *
                         (2.0 * k + ab + 1.0) * (2.0 * k + ab - 1.0);
            e[k - 1] = std::sqrt(num / den);
        }
    }
    // special case k = 0 diagonal for ab == 0 handled above (0/0 -> 0)
    if (ab == 0.0) d[0] = 0.0;
    else d[0] = (beta - alpha) / (ab + 2.0);
    int rc = tql_eigenvalues(n, d.data(), e.data());
    if (rc) return rc;
    std::memcpy(x, d.data(), n * sizeof(double));
    return 0;
}

// Legendre P_n(x) by recurrence.
double legendre(int n, double x) {
    if (n == 0) return 1.0;
    double p0 = 1.0, p1 = x;
    for (int k = 2; k <= n; ++k) {
        double p2 = ((2.0 * k - 1.0) * x * p1 - (k - 1.0) * p0) / k;
        p0 = p1;
        p1 = p2;
    }
    return p1;
}

// One Newton polish of LGL interior nodes on q(x) = P'_{n}(x).
void polish_lgl_interior(int deg, double* x, int count) {
    for (int it = 0; it < 2; ++it) {
        for (int i = 0; i < count; ++i) {
            double t = x[i];
            // P'_n and P''_n via recurrences on P
            double pn = legendre(deg, t), pnm1 = legendre(deg - 1, t);
            double d1 = deg * (pnm1 - t * pn) / (1.0 - t * t);
            // derivative of d1 (P''): use ODE (1-x^2)P'' - 2xP' + n(n+1)P = 0
            double d2 = (2.0 * t * d1 - deg * (deg + 1.0) * pn) / (1.0 - t * t);
            if (d2 != 0.0) x[i] = t - d1 / d2;
        }
    }
}

}  // namespace

extern "C" {

// LGL nodes/weights on [-1, 1]; x, w have length num_point.
int pockit_lgl(int num_point, double* x, double* w) {
    if (num_point <= 0) return 1;
    if (num_point == 1) {
        x[0] = 0.0;
        w[0] = 2.0;
        return 0;
    }
    int n = num_point - 1;  // polynomial degree
    if (num_point > 2) {
        // interior nodes = Gauss-Jacobi(1,1) of degree n-1
        if (jacobi_gauss_nodes(n - 1, 1.0, 1.0, x + 1)) return 2;
        polish_lgl_interior(n, x + 1, n - 1);
    }
    x[0] = -1.0;
    x[num_point - 1] = 1.0;
    double c = 2.0 / (n * (n + 1.0));
    for (int i = 0; i < num_point; ++i) {
        double p = legendre(n, x[i]);
        w[i] = c / (p * p);
    }
    return 0;
}

// Left LGR nodes/weights on [-1, 1]; x, w have length num_point.
int pockit_lgr(int num_point, double* x, double* w) {
    if (num_point <= 0) return 1;
    if (num_point == 1) {
        x[0] = -1.0;
        w[0] = 2.0;
        return 0;
    }
    if (jacobi_gauss_nodes(num_point - 1, 0.0, 1.0, x + 1)) return 2;
    x[0] = -1.0;
    for (int i = 0; i < num_point; ++i) {
        double p = legendre(num_point, x[i]);
        double np = num_point * p;
        w[i] = (1.0 - x[i]) / (np * np);
    }
    return 0;
}

// Gauss-Legendre nodes/weights on [-1, 1] (for quadrature of basis
// integrals); x, w have length n.
int pockit_gauss(int n, double* x, double* w) {
    if (n <= 0) return 1;
    if (jacobi_gauss_nodes(n, 0.0, 0.0, x)) return 2;
    for (int i = 0; i < n; ++i) {
        double t = x[i];
        double pn = legendre(n, t), pnm1 = legendre(n - 1, t);
        double d1 = n * (pnm1 - t * pn) / (1.0 - t * t);
        w[i] = 2.0 / ((1.0 - t * t) * d1 * d1);
    }
    return 0;
}

// Integral matrix: out[k*n + j] = ∫_{1}^{nodes_out[k]} L_j(t) dt where L_j
// is the Lagrange basis over nodes_in (length n); out is (m x n) row-major.
int pockit_integral_matrix(const double* nodes_in, int n,
                           const double* nodes_out, int m, double* out) {
    if (n == 0 || m == 0) return 0;
    // barycentric weights
    std::vector<double> bw(n, 1.0);
    for (int j = 0; j < n; ++j)
        for (int k = 0; k < n; ++k)
            if (k != j) bw[j] /= (nodes_in[j] - nodes_in[k]);

    int q = n * 3 > 30 ? n * 3 : 30;
    std::vector<double> gx(q), gw(q);
    if (pockit_gauss(q, gx.data(), gw.data())) return 2;

    std::vector<double> terms(n);
    for (int k = 0; k < m; ++k) {
        double b = nodes_out[k];
        double* row = out + (size_t)k * n;
        std::memset(row, 0, n * sizeof(double));
        if (std::fabs(b - 1.0) <= 1e-13) continue;
        double alpha = 0.5 * (b - 1.0), beta = 0.5 * (b + 1.0);
        for (int qq = 0; qq < q; ++qq) {
            double t = alpha * gx[qq] + beta;
            double wq = alpha * gw[qq];
            // barycentric basis values at t
            double denom = 0.0;
            int exact = -1;
            for (int j = 0; j < n; ++j) {
                double diff = t - nodes_in[j];
                if (std::fabs(diff) < 1e-14) {
                    exact = j;
                    break;
                }
                terms[j] = bw[j] / diff;
                denom += terms[j];
            }
            if (exact >= 0) {
                row[exact] += wq;
            } else {
                for (int j = 0; j < n; ++j) row[j] += wq * terms[j] / denom;
            }
        }
    }
    return 0;
}

}  // extern "C"
