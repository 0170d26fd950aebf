// K1's polarized instances (sub-slice (e)): gen_trace.cu built with
// TRACE_POL 1 into a library of its own, so that it builds in parallel and
// the unpolarized library keeps the code it had before (e).
#define TRACE_POL 1
#include "gen_trace.cu"
