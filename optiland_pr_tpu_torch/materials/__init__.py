from .base import (AIR, MIRROR, AbbeMaterial, FormulaMaterial, IdealMaterial,
                   MaterialModel, Mirror, TabulatedMaterial)
from .catalog import catalog_names, glass, resolve_material
from .dispersion import evaluate_formula, nair_edlen

__all__ = ["AIR", "MIRROR", "AbbeMaterial", "FormulaMaterial", "IdealMaterial",
           "MaterialModel", "Mirror", "TabulatedMaterial", "catalog_names",
           "glass", "resolve_material", "evaluate_formula", "nair_edlen"]
