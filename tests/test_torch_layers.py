"""The port's module seams, read from the source (no import, no device).

- No module of the package imports or reads an underscore-prefixed
  function, class or constant of another of its modules: what two modules
  share is public where it lives (the light terms and the per-vertex
  estimator in ``integrator/shading.py``). The kernel wrappers' private
  build module ``ops/_build`` is the one exemption.
- ``integrator/regen.py`` does not import ``integrator/wavefront.py``:
  the two integrators meet only in ``integrator/shading.py``."""

import ast
import os

PKG = "monte_carlo_path_tracing_tpu_torch"
ROOT = os.path.join(os.path.dirname(__file__), "..", PKG)
EXEMPT = {f"{PKG}.ops._build"}


def _modules() -> dict:
    """{dotted module name: parsed source} of every module of the package."""
    mods = {}
    for dirpath, _, files in os.walk(ROOT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3].split(os.sep)
                if rel[-1] == "__init__":
                    rel = rel[:-1]
                name = ".".join([PKG, *rel])
                with open(os.path.join(dirpath, f)) as fh:
                    mods[name] = ast.parse(fh.read())
    return mods


def _private(name: str) -> bool:
    return name.startswith("_") and not name.startswith("__")


def _reaches(mod: str, tree: ast.Module, mods: dict) -> list:
    """(line, what) of each underscore name of another package module that
    ``mod`` imports, or reads as an attribute of a module it imported."""
    found, aliases = [], {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in mods and a.name != mod:
                    aliases[a.asname or a.name] = a.name
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith(PKG):
            for a in node.names:
                sub = f"{node.module}.{a.name}"
                if sub in mods:                   # a module: its attributes are checked below
                    aliases[a.asname or a.name] = sub
                    if _private(a.name) and sub not in EXEMPT:
                        found.append((node.lineno, sub))
                elif _private(a.name) and node.module != mod:
                    found.append((node.lineno, sub))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id in aliases and _private(node.attr)
                and aliases[node.value.id] not in EXEMPT):
            found.append((node.lineno, f"{aliases[node.value.id]}.{node.attr}"))
    return found


def test_no_module_reaches_into_another_modules_private_names():
    mods = _modules()
    assert f"{PKG}.integrator.shading" in mods and f"{PKG}.integrator.regen" in mods
    bad = {m: hits for m, tree in mods.items() if (hits := _reaches(m, tree, mods))}
    assert not bad, bad


def test_regen_does_not_import_wavefront():
    tree = _modules()[f"{PKG}.integrator.regen"]
    wavefront = f"{PKG}.integrator.wavefront"
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
            imported |= {f"{node.module}.{a.name}" for a in node.names}
    assert not {m for m in imported if m == wavefront or m.startswith(wavefront + ".")}, imported
