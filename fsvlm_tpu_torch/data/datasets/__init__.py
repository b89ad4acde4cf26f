from . import recognition, synthetic  # noqa: F401  (registers the datasets)
