from .optim import build_optimizer, make_lr_schedule
from .trainer import SimpleTrainer
