// K2's polarized instances (sub-slice (e)) in the plain OPD mode: gen_grad.cu
// built with GRAD_POL 1 and GRAD_MODE = OPD_PLAIN, into a library of its own,
// so that it builds in parallel and the unpolarized libraries keep the code
// they had before (e).
#include "gen_trace_common.cuh"
#define GRAD_MODE OPD_PLAIN
#define GRAD_POL 1
#include "gen_grad.cu"
