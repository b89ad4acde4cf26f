"""On-device image preprocessing for the deterministic eval path
(counterpart of fsvlm_tpu.ops.preprocess.normalize_only)."""

import torch

# CLIP's pixel statistics (fsvlm_tpu/data/transforms.py:21-22)
CLIP_PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
CLIP_PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]


def normalize_only(images, mean=None, std=None):
    """uint8 (B, S, S, 3) -> normalized float32 on the images' device."""
    mean = torch.tensor(mean if mean is not None else CLIP_PIXEL_MEAN,
                        dtype=torch.float32, device=images.device)
    std = torch.tensor(std if std is not None else CLIP_PIXEL_STD,
                       dtype=torch.float32, device=images.device)
    return ((images.to(torch.float32) / 255.0) - mean) / std
