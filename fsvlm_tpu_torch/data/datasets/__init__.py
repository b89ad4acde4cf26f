from . import legacy, recognition, synthetic  # noqa: F401  (registers the datasets)
