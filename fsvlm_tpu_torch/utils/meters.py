"""Running metric meters (counterpart of fsvlm_tpu.utils.meters)."""

from collections import defaultdict


class AverageMeter:
    """The current value, running average, sum and count."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += self.val * n
        self.count += n
        self.avg = self.sum / self.count


class MetricMeter:
    """A dict of AverageMeters printed as ``name val (avg)``."""

    def __init__(self):
        self.meters = defaultdict(AverageMeter)

    def update(self, input_dict):
        for k, v in input_dict.items():
            self.meters[k].update(v)

    def __str__(self):
        return " ".join(f"{name} {meter.val:.4f} ({meter.avg:.4f})"
                                   for name, meter in self.meters.items())
