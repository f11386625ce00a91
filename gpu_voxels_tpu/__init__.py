"""Former import name of `gpu_voxels_jax`, kept so that existing code still
imports.

Importing this package warns once and returns `gpu_voxels_jax` itself; a
module under it (`<this package>.maps.voxelmap`, ...) is the module of
`gpu_voxels_jax` with the same path. Both names therefore share one module
object per file: classes, isinstance checks and compiled-function caches are
the same whichever name imported them.
"""
from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import gpu_voxels_jax

_FORMER = __name__
_TARGET = gpu_voxels_jax.__name__


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves `<former name>.x.y` to the module `gpu_voxels_jax.x.y`."""

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(_FORMER + "."):
            return None
        if importlib.util.find_spec(_TARGET + fullname[len(_FORMER):]) is None:
            return None
        return importlib.util.spec_from_loader(fullname, self)

    def create_module(self, spec):
        module = importlib.import_module(_TARGET + spec.name[len(_FORMER):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamps the alias's spec on the shared module;
        # give the module its own back
        module.__spec__ = module.__spec__.loader_state


warnings.warn(
    f"the package {_FORMER!r} is now {_TARGET!r}; import {_TARGET!r} instead",
    DeprecationWarning,
    stacklevel=2,
)
sys.meta_path.insert(0, _AliasFinder())
sys.modules[_FORMER] = gpu_voxels_jax
