"""The ported trainers; importing the package registers them in
``engine.trainer.TRAINER_REGISTRY``."""

from . import cocoop, coop, ivlp, linear_probe, lora, maple, plip, promptsrc, zsclip  # noqa: F401
