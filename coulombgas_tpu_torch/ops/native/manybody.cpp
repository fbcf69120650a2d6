// Native many-body state enumeration for coulombgas_tpu_torch (the port's
// copy of coulombgas_tpu/ops/native/manybody.cpp, same C ABI).
//
// Enumerates all n-fermion occupations (strictly increasing orbital indices)
// of M energy-sorted orbitals whose total energy does not exceed a cutoff —
// the combinatorial host-side core of manybody_orbitals (see
// coulombgas_tpu_torch/physics/orbitals.py; reference behavior:
// src/orbitals.py:3-20,57-79).  The search is exponential in the worst case,
// so the hot enumeration runs natively; Python keeps a fallback.
//
// C ABI (ctypes):
//   count = cg_enumerate_subsets(Es, M, n, Emax_total, out, max_states)
// Es: int64[M] ascending orbital energies.
// out: int64[max_states * n] occupation index buffer, or NULL to count only.
// Returns the number of states (or -1 if out was given and overflowed).

#include <cstdint>
#include <vector>

extern "C" {

int64_t cg_enumerate_subsets(const int64_t* Es, int64_t M, int64_t n,
                             int64_t Emax_total, int64_t* out,
                             int64_t max_states) {
  // prefix sums for the cheapest-completion bound: the k smallest energies
  // at or above slot i are Es[i..i+k) since Es is ascending.
  std::vector<int64_t> cum(M + 1, 0);
  for (int64_t i = 0; i < M; ++i) cum[i + 1] = cum[i] + Es[i];
  auto tail_min = [&](int64_t i, int64_t k) { return cum[i + k] - cum[i]; };

  std::vector<int64_t> chosen(n);
  int64_t count = 0;

  // Iterative DFS with explicit depth/position state.
  // frame: (depth, next candidate index, energy so far)
  struct Frame {
    int64_t depth, i, etot;
  };
  std::vector<Frame> stack;
  stack.push_back({0, 0, 0});
  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    if (f.depth > 0) chosen[f.depth - 1] = f.i - 1;  // the index we committed
    if (f.depth == n) {
      if (out != nullptr) {
        if (count >= max_states) return -1;
        for (int64_t j = 0; j < n; ++j) out[count * n + j] = chosen[j];
      }
      ++count;
      continue;
    }
    int64_t remaining = n - f.depth;
    // Push candidates in reverse so the DFS explores ascending order first
    // (matches the Python fallback's ordering before the energy sort).
    for (int64_t i = M - remaining; i >= f.i; --i) {
      int64_t e_new = f.etot + Es[i];
      if (e_new + tail_min(i + 1, remaining - 1) > Emax_total) continue;
      // record the committed index through the child frame's i-1
      Frame child{f.depth + 1, i + 1, e_new};
      stack.push_back(child);
    }
  }
  return count;
}

}  // extern "C"
