"""The ported trainers; importing the package registers them in
``engine.trainer.TRAINER_REGISTRY``."""

from . import cocoop, coop, ivlp, promptsrc  # noqa: F401
