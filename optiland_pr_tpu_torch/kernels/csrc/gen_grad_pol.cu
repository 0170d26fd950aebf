// K2's polarized instances (sub-slice (e)) in the plain OPD mode: gen_grad.cu
// built with GRAD_POL 1 and GRAD_MODE = OPD_PLAIN, into a library of its own,
// so that it builds in parallel and the unpolarized libraries keep the code
// they had before (e). Its WIDE instances are gen_grad_pol_wide.cuh's.
#include "gen_trace_common.cuh"
#define GRAD_MODE OPD_PLAIN
#define GRAD_POL 1
#define POL_WIDE_FUSED 1
#include "gen_grad.cu"
