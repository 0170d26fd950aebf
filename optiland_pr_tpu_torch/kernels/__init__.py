from .gen_grad import (GenTrace, gen_trace_bwd_cuda, gen_trace_bwd_plain)
from .gen_trace import (gen_eligible, gen_trace_conic, gen_trace_cuda,
                        gen_trace_plain, model_flags, pack_asphere_coeffs,
                        pack_surface_constants, supports_model)

__all__ = ["GenTrace", "gen_eligible", "gen_trace_bwd_cuda",
           "gen_trace_bwd_plain", "gen_trace_conic", "gen_trace_cuda",
           "gen_trace_plain", "model_flags", "pack_asphere_coeffs",
           "pack_surface_constants", "supports_model"]
