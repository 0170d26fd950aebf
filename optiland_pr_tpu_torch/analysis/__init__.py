from .spot import SpotData, encircled_energy, spot_diagram, spot_from_rays

__all__ = ["SpotData", "encircled_energy", "spot_diagram", "spot_from_rays"]
