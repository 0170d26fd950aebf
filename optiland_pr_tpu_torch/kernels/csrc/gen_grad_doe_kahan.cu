// K2's instances that take the gratings and phase surfaces (sub-slice (f)),
// in the Kahan OPD mode: gen_grad.cu built with WITH_DOE 1 and GRAD_MODE =
// OPD_KAHAN, into a library of its own, so that it builds in parallel and
// the other libraries keep the code they had before (f).
#define WITH_DOE 1
#include "gen_trace_common.cuh"
#define GRAD_MODE OPD_KAHAN
#include "gen_grad.cu"
