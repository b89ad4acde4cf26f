"""Name -> class registry (counterpart of fsvlm_tpu.utils.registry):
decorator registration, duplicate detection, a did-you-mean hint on a
missing name."""

import difflib


class Registry:
    def __init__(self, name):
        self._name = name
        self._obj_map = {}

    def register(self, name=None):
        """A decorator that registers a class or function under ``name``, by
        default its own name."""
        def wrapper(cls):
            key = name or cls.__name__
            if key in self._obj_map:
                raise KeyError(f'An object named "{key}" was already registered in '
                               f'"{self._name}" registry')
            self._obj_map[key] = cls
            return cls

        return wrapper

    def get(self, name):
        if name not in self._obj_map:
            suggestion = difflib.get_close_matches(name, self._obj_map.keys(), n=1)
            hint = f" Did you mean: {suggestion[0]}?" if suggestion else ""
            raise KeyError(
                f'Object name "{name}" does not exist in "{self._name}" registry.'
                f" Available: {sorted(self._obj_map.keys())}.{hint}")
        return self._obj_map[name]

    def registered_names(self):
        return sorted(self._obj_map.keys())

    def __contains__(self, name):
        return name in self._obj_map
