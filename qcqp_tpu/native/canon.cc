// Native canonicalization + problem-bank IO for qcqp_tpu.
//
// Role: the host-side equivalent of the reference's native canonicalization
// layer (CVXcanon C++ under CVXPY 0.4's QuadCoeffExtractor — reference:
// qcqp/utilities.py:29,329; setup.py:13) plus a binary instance-bank
// loader for the scenario-parallel serving path the reference lacks.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// All matrices are dense row-major float64; the Python layer owns allocation.
//
// Build: make -C qcqp_tpu/native   (g++ -O3 -fopenmp -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Canonicalization kernels (the per-atom coefficient emitters)
// ---------------------------------------------------------------------------

// square(affine): for each scalar element j of the atom,
//   P[j] += w * c_j c_j^T,  q[j] += w * 2 d_j c_j,  r[j] += w * d_j^2
// C: (s, n) row-major Jacobian rows; d: (s,).  Threaded over s.
void qn_square_accumulate(const double* C, const double* d, int64_t s,
                          int64_t n, double w, double* P, double* q,
                          double* r) {
  int64_t nthreads = std::min<int64_t>(s, std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> pool;
  auto work = [&](int64_t t0, int64_t t1) {
    for (int64_t j = t0; j < t1; ++j) {
      const double* cj = C + j * n;
      double* Pj = P + j * n * n;
      for (int64_t a = 0; a < n; ++a) {
        const double ca = w * cj[a];
        double* row = Pj + a * n;
        for (int64_t b = 0; b < n; ++b) row[b] += ca * cj[b];
      }
      double* qj = q + j * n;
      const double dj2 = 2.0 * w * d[j];
      for (int64_t a = 0; a < n; ++a) qj[a] += dj2 * cj[a];
      r[j] += w * d[j] * d[j];
    }
  };
  int64_t chunk = (s + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(s, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// (affine)*(affine) elementwise: symmetrized cross outer products.
//   P[j] += w * (ca_j cb_j^T + cb_j ca_j^T)/2
//   q[j] += w * (da_j cb_j + db_j ca_j);  r[j] += w * da_j db_j
void qn_mul_accumulate(const double* Ca, const double* da, const double* Cb,
                       const double* db, int64_t s, int64_t n, double w,
                       double* P, double* q, double* r) {
  int64_t nthreads = std::min<int64_t>(s, std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> pool;
  auto work = [&](int64_t t0, int64_t t1) {
    for (int64_t j = t0; j < t1; ++j) {
      const double* aj = Ca + j * n;
      const double* bj = Cb + j * n;
      double* Pj = P + j * n * n;
      for (int64_t a = 0; a < n; ++a) {
        const double ha = 0.5 * w * aj[a];
        const double hb = 0.5 * w * bj[a];
        double* row = Pj + a * n;
        for (int64_t b = 0; b < n; ++b) row[b] += ha * bj[b] + hb * aj[b];
      }
      double* qj = q + j * n;
      for (int64_t a = 0; a < n; ++a)
        qj[a] += w * (da[j] * bj[a] + db[j] * aj[a]);
      r[j] += w * da[j] * db[j];
    }
  };
  int64_t chunk = (s + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(s, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// Problem-bank IO: a flat binary format for batched QCQP instances
// ---------------------------------------------------------------------------
// Layout: header {magic, version, count, n, m} (5 x int64) followed by
// `count` records of [P (m+1)*n*n | q (m+1)*n | r (m+1) | is_eq m (int8)].

static const int64_t QN_MAGIC = 0x51435150'42414e4bLL;  // "QCQPBANK"

struct BankHeader {
  int64_t magic, version, count, n, m;
};

int64_t qn_bank_write(const char* path, int64_t count, int64_t n, int64_t m,
                      const double* P, const double* q, const double* r,
                      const int8_t* is_eq) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  BankHeader h{QN_MAGIC, 1, count, n, m};
  if (std::fwrite(&h, sizeof(h), 1, f) != 1) { std::fclose(f); return -2; }
  const int64_t k = m + 1;
  for (int64_t i = 0; i < count; ++i) {
    std::fwrite(P + i * k * n * n, sizeof(double), k * n * n, f);
    std::fwrite(q + i * k * n, sizeof(double), k * n, f);
    std::fwrite(r + i * k, sizeof(double), k, f);
    std::fwrite(is_eq + i * m, sizeof(int8_t), m, f);
  }
  std::fclose(f);
  return 0;
}

int64_t qn_bank_info(const char* path, int64_t* count, int64_t* n,
                     int64_t* m) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  BankHeader h;
  if (std::fread(&h, sizeof(h), 1, f) != 1 || h.magic != QN_MAGIC) {
    std::fclose(f);
    return -2;
  }
  *count = h.count; *n = h.n; *m = h.m;
  std::fclose(f);
  return 0;
}

// Load records [start, start+batch) into caller-allocated stacked buffers,
// threaded across records (the multithreaded batch-assembly data-loader).
int64_t qn_bank_load(const char* path, int64_t start, int64_t batch,
                     double* P, double* q, double* r, int8_t* is_eq) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  BankHeader h;
  if (std::fread(&h, sizeof(h), 1, f) != 1 || h.magic != QN_MAGIC) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  if (start < 0 || start + batch > h.count) return -3;
  const int64_t k = h.m + 1;
  const int64_t rec = (k * h.n * h.n + k * h.n + k) * (int64_t)sizeof(double)
                      + h.m * (int64_t)sizeof(int8_t);
  int64_t nthreads = std::min<int64_t>(batch, 8);
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> pool;
  std::vector<int64_t> status(nthreads, 0);
  auto work = [&](int64_t tid, int64_t lo, int64_t hi) {
    FILE* g = std::fopen(path, "rb");
    if (!g) { status[tid] = -1; return; }
    for (int64_t i = lo; i < hi; ++i) {
      if (std::fseek(g, (long)(sizeof(BankHeader) + (start + i) * rec), SEEK_SET)) {
        status[tid] = -4; break;
      }
      size_t ok = 0;
      ok += std::fread(P + i * k * h.n * h.n, sizeof(double), k * h.n * h.n, g);
      ok += std::fread(q + i * k * h.n, sizeof(double), k * h.n, g);
      ok += std::fread(r + i * k, sizeof(double), k, g);
      ok += std::fread(is_eq + i * h.m, sizeof(int8_t), h.m, g);
      if ((int64_t)ok != k * h.n * h.n + k * h.n + k + h.m) {
        status[tid] = -5;
        break;
      }
    }
    std::fclose(g);
  };
  int64_t chunk = (batch + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(batch, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(work, t, lo, hi);
  }
  for (auto& th : pool) th.join();
  for (int64_t t = 0; t < nthreads; ++t)
    if (status[t] != 0) return status[t];
  return 0;
}

}  // extern "C"
