"""Plugin registry.

Replaces the reference's Dassl ``TRAINER_REGISTRY`` / ``DATASET_REGISTRY``
(used at e.g. reference trainers/mudpt.py:186, datasets/oxford_pets.py:11)
with a small typed registry that gives good error messages instead of
KeyErrors and supports case-insensitive lookup.
"""

from __future__ import annotations

from typing import Dict, Iterable, TypeVar

T = TypeVar("T")


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, object] = {}

    def register(self, obj: T = None, *, name: str | None = None):
        """Use as ``@REG.register()`` or ``REG.register(obj, name=...)``."""
        if obj is None:
            def deco(inner):
                self._do_register(name or inner.__name__, inner)
                return inner
            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def _do_register(self, name: str, obj) -> None:
        if name in self._obj_map and self._obj_map[name] is not obj:
            raise KeyError(f"{name!r} already registered in {self._name} registry")
        self._obj_map[name] = obj

    def get(self, name: str):
        if name in self._obj_map:
            return self._obj_map[name]
        # case-insensitive fallback
        lowered = {k.lower(): v for k, v in self._obj_map.items()}
        if name.lower() in lowered:
            return lowered[name.lower()]
        raise KeyError(
            f"{name!r} not found in {self._name} registry. "
            f"Available: {sorted(self._obj_map)}"
        )

    def __contains__(self, name: str) -> bool:
        try:
            self.get(name)
            return True
        except KeyError:
            return False

    def keys(self) -> Iterable[str]:
        return self._obj_map.keys()


TRAINER_REGISTRY = Registry("trainer")
DATASET_REGISTRY = Registry("dataset")
EVALUATOR_REGISTRY = Registry("evaluator")
