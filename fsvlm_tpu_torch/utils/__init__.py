from .logger import Logger, setup_logger
from .meters import AverageMeter, MetricMeter
from .registry import Registry
from .tools import (
    collect_env_info,
    listdir_nohidden,
    mkdir_if_missing,
    read_image,
    read_json,
    set_random_seed,
    write_json,
)
