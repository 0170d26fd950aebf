from .gen_trace import (gen_eligible, gen_trace_conic, gen_trace_cuda,
                        gen_trace_plain, model_flags, pack_asphere_coeffs,
                        pack_surface_constants, supports_model)

__all__ = ["gen_eligible", "gen_trace_conic", "gen_trace_cuda",
           "gen_trace_plain", "model_flags", "pack_asphere_coeffs",
           "pack_surface_constants", "supports_model"]
