from .gen_grad import (GenTrace, gen_trace_bwd_cuda, gen_trace_bwd_plain)
from .gen_trace import (gen_eligible, gen_trace_conic, gen_trace_cuda,
                        gen_trace_plain, model_flags, pack_asphere_coeffs,
                        pack_surface_constants, supports_model)
from .huygens import (fresnel_sum_cuda, fresnel_sum_plain,
                      huygens_fresnel_plain, huygens_fresnel_ref, huygens_sum,
                      huygens_sum_cuda, huygens_sum_plain, rereference)
# K3's entry point is trace_conic.trace_conic: the package keeps the name
# trace_conic for the module
from .trace_conic import trace_cuda, trace_plain

__all__ = ["GenTrace", "fresnel_sum_cuda", "fresnel_sum_plain",
           "gen_eligible", "gen_trace_bwd_cuda", "gen_trace_bwd_plain",
           "gen_trace_conic", "gen_trace_cuda", "gen_trace_plain",
           "huygens_fresnel_plain", "huygens_fresnel_ref", "huygens_sum",
           "huygens_sum_cuda", "huygens_sum_plain", "model_flags",
           "pack_asphere_coeffs", "pack_surface_constants", "rereference",
           "supports_model", "trace_cuda", "trace_plain"]
