// The pivot floor of the deflating, pivot-free Cholesky eliminations, shared
// by fused_logp.cu and chol_logdet.cu (through chol_blocked.cuh).
//
// Semantics (identical to ops/logdet.py:chol_logdet_ref of the port and to
// the reference's coulombgas_tpu/ops/logdet.py): at step k the pivot
// d = A[k][k]; if d < PIVOT_FLOOR the step is deflated — it contributes
// log(PIVOT_FLOOR) and its column takes no part in the update — so a singular
// matrix gives a large negative, finite log-determinant, never NaN.
// Otherwise log d is added and the trailing block gets the rank-1 update
// A[r][c] -= A[r][k] A[c][k] / d.
//
// Only the lower triangle (row >= column) is read and updated: step k reads
// column k below the diagonal, and nothing later reads above it.  So a caller
// needs to fill the lower triangle only.
#pragma once
#include <math.h>

#define CG_PIVOT_FLOOR 1e-30f
