from .optim import build_optimizer, make_lr_schedule
from .trainer import TRAINER_REGISTRY, SimpleTrainer, build_trainer
