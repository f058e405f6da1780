"""Generic class registry with alias support.

Reference: ``python/mxnet/registry.py`` — used by optimizer/metric/initializer
registries to ``register``/``alias``/``create`` by name (case-insensitive),
including the ``name, **kwargs`` and json-spec creation forms.
"""

from __future__ import annotations

import json

from .base import MXNetError

_REGISTRIES = {}


def get_registry(base_class):
    return dict(_REGISTRIES.setdefault(base_class, {}))


def get_register_func(base_class, nickname):
    registry = _REGISTRIES.setdefault(base_class, {})

    def register(klass, name=None):
        assert issubclass(klass, base_class), (
            f"Can only register subclass of {base_class.__name__}"
        )
        nm = (name or klass.__name__).lower()
        registry[nm] = klass
        return klass

    register.__doc__ = f"Register {nickname} to the {nickname} factory"
    return register


def get_alias_func(base_class, nickname):
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass

        return reg

    return alias


def get_create_func(base_class, nickname):
    registry = _REGISTRIES.setdefault(base_class, {})

    def create(*args, **kwargs):
        if len(args) == 0:
            raise MXNetError(f"{nickname} is required to create")
        name = args[0]
        args = args[1:]
        if isinstance(name, base_class):
            assert not args and not kwargs
            return name
        if isinstance(name, str) and name.startswith("["):
            name, kw = json.loads(name)
            return create(name, **kw)
        nm = name.lower()
        if nm not in registry:
            raise MXNetError(
                f"Cannot find {nickname} {name}; candidates: {sorted(registry)}"
            )
        return registry[nm](*args, **kwargs)

    return create
