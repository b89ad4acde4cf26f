from . import synthetic  # noqa: F401  (registers the datasets)
