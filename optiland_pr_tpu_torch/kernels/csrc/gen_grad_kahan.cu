// K2 in the Kahan OPD mode: gen_grad.cu built with GRAD_MODE = OPD_KAHAN,
// into a library of its own, so that the three modes build in parallel.
#include "gen_trace_common.cuh"
#define GRAD_MODE OPD_KAHAN
#include "gen_grad.cu"
