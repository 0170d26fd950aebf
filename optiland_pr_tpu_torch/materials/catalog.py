"""Material catalog lookup and material resolution
(port of ``optiland_pr_tpu/materials/catalog.py``).

Reads the JAX package's refractiveindex.info extract by path: a row-ordered
JSON index (``nk_catalog_index.json``) and an NPZ of tabulated n/k arrays.
Name resolution is the same similarity search: a case-insensitive substring
filter, optional reference/wavelength filters, then minimum-Levenshtein
ranking with row-order tie-breaking.
"""
from __future__ import annotations

import json
from functools import lru_cache

import numpy as np

from .base import (AIR, MIRROR, DATA_DIR, AbbeMaterial, FormulaMaterial,
                   IdealMaterial, MaterialModel, TabulatedMaterial)

__all__ = ["glass", "material", "resolve_material", "catalog_names",
           "find_material"]


@lru_cache(maxsize=1)
def _index() -> list:
    with open(DATA_DIR / "nk_catalog_index.json") as fh:
        return json.load(fh)


@lru_cache(maxsize=1)
def _tables():
    return np.load(DATA_DIR / "nk_catalog_tables.npz")


@lru_cache(maxsize=1)
def _search_keys():
    """Pre-lowered search fields, one tuple per catalog row."""
    return [(r["category_name"].lower(), r["name"].lower(),
             r["filename_no_ext"].lower(), r["category_name_full"].lower(),
             r["reference"].lower(), r["filename"].lower())
            for r in _index()]


def catalog_names():
    return sorted({r["category_name"] for r in _index()})


def _levenshtein(s1: str, s2: str) -> int:
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    prev = list(range(len(s2) + 1))
    for i, c1 in enumerate(s1, 1):
        cur = [i]
        for j, c2 in enumerate(s2, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (c1 != c2)))
        prev = cur
    return prev[-1]


@lru_cache(maxsize=512)
def find_material(name: str, reference: str | None = None,
                  min_wavelength: float | None = None,
                  max_wavelength: float | None = None) -> int:
    """Catalog row id for a material name; raises ValueError on no match."""
    nm = name.lower()
    rows = _index()
    keys = _search_keys()
    cand = [i for i, k in enumerate(keys)
            if nm in k[0] or nm in k[1] or nm in k[2]]
    if reference:
        ref = reference.lower()
        cand = [i for i in cand
                if ref in keys[i][0] or ref in keys[i][3]
                or ref in keys[i][4] or ref in keys[i][1]
                or ref in keys[i][5]]
    if min_wavelength is not None:
        cand = [i for i in cand
                if rows[i]["min_wavelength"] <= min_wavelength
                <= rows[i]["max_wavelength"]]
    if max_wavelength is not None:
        cand = [i for i in cand
                if rows[i]["min_wavelength"] <= max_wavelength
                <= rows[i]["max_wavelength"]]
    if not cand:
        raise ValueError(f"No matches found for material {name}"
                         + (f" with reference {reference}" if reference
                            else ""))
    scores = np.array([min(_levenshtein(nm, keys[i][0]),
                           _levenshtein(nm, keys[i][1]),
                           _levenshtein(nm, keys[i][2])) for i in cand])
    # the unstable quicksort permutation the JAX package (and pandas) use
    order = np.argsort(scores, kind="quicksort")
    return cand[int(order[0])]


def _entry_to_material(rec: dict, row_id: int):
    if "error" in rec:
        raise ValueError(f"Material data file {rec['filename']} has no "
                         f"refractive-index data ({rec['error']})")
    tabs = _tables()
    has_k = f"{row_id}_kv" in tabs
    kw = tabs[f"{row_id}_kw"] if has_k else None
    kv = tabs[f"{row_id}_kv"] if has_k else None
    if "formula" in rec:
        model = FormulaMaterial(rec["formula"], len(rec["coefficients"]),
                                has_k_table=has_k,
                                k_table_len=len(kv) if has_k else 0,
                                has_thermal="thermal" in rec)
        params = model.default_params(
            coefficients=rec["coefficients"], k_wavelength=kw, k_values=kv,
            t0_celsius=rec.get("t0"), thermal_dispersion=rec.get("thermal"))
    else:
        nw = tabs[f"{row_id}_nw"]
        nv = tabs[f"{row_id}_nv"]
        model = TabulatedMaterial(len(nv), has_k_table=has_k,
                                  k_table_len=len(kv) if has_k else 0)
        params = model.default_params(n_wavelength=nw, n_values=nv,
                                      k_wavelength=kw, k_values=kv)
    return model, params


def material(name: str, reference: str | None = None,
             min_wavelength: float | None = None,
             max_wavelength: float | None = None):
    """(MaterialModel, host params) for a database material."""
    row_id = find_material(name, reference, min_wavelength, max_wavelength)
    return _entry_to_material(_index()[row_id], row_id)


def glass(name: str, reference: str | None = None):
    """Alias of :func:`material`."""
    return material(name, reference)


def resolve_material(spec):
    """Resolve an ``add_surface(material=...)`` spec to (model, host params).

    Accepts None/"air", "mirror", a number (ideal index), a glass name, a
    (name, reference) tuple, ``("abbe", n, v)``, a MaterialModel, or an
    explicit (MaterialModel, params) pair.
    """
    if spec is None or (isinstance(spec, str) and spec.lower() == "air"):
        return AIR, AIR.default_params()
    if isinstance(spec, str) and spec.lower() == "mirror":
        return MIRROR, {}
    if isinstance(spec, (int, float)):
        m = IdealMaterial()
        return m, m.default_params(n=float(spec))
    if isinstance(spec, str):
        return glass(spec)
    if isinstance(spec, tuple):
        if len(spec) == 2 and isinstance(spec[0], str) and isinstance(spec[1], str):
            return glass(*spec)
        if len(spec) == 3 and spec[0] == "abbe":
            m = AbbeMaterial()
            return m, m.default_params(n=spec[1], abbe=spec[2])
        if len(spec) == 2 and isinstance(spec[0], MaterialModel):
            return spec
    if isinstance(spec, MaterialModel):
        return spec, spec.default_params()
    raise ValueError(f"Cannot resolve material spec: {spec!r}")
